"""VP9 frame decoder (profile 0, 8-bit) — numpy host implementation.

Written from the spec; structure parallels the encoder's serialization so
that every syntax rule is exercised from both sides.  Supports key /
intra-only frames and (progressively) inter frames.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream import tokenize as tok
from tpu_vp9_torch.bitstream.bool_coder import BoolDecoder
from tpu_vp9_torch.bitstream.headers import (
    BitReader, FrameHeader, LoopFilterParams, tile_log2_limits,
)
from tpu_vp9_torch.bitstream.tables import (
    BlockSize, IntraMode, Partition, TxSize, TxType,
)
from tpu_vp9_torch.codec import modeinfo as MI
from tpu_vp9_torch.codec.intra_frame import (
    TX_PX, plane_block_geometry, tx_blocks_of,
)
from tpu_vp9_torch.ops import intra as intra_ops
from tpu_vp9_torch.ops import txfm

DIFF_UPDATE_PROB = 252


# ---------------------------------------------------------------------------
# Uncompressed header
# ---------------------------------------------------------------------------


def parse_uncompressed_header(data: bytes) -> tuple:
    """Returns (FrameHeader, header_size_bytes, first_partition_size)."""
    rb = BitReader(data)
    h = FrameHeader()
    marker = rb.literal(2)
    if marker != 2:
        raise ValueError("bad frame marker")
    profile = rb.bit() | (rb.bit() << 1)
    if profile != 0:
        raise ValueError(f"unsupported profile {profile}")
    if rb.bit():  # show_existing_frame
        h.show_existing_frame = True
        h.show_existing_frame_index = rb.literal(3)
        return h, rb.bytes_read(), 0
    h.is_keyframe = rb.bit() == 0
    h.show_frame = rb.bit() == 1
    h.error_resilient = rb.bit() == 1

    def sync():
        if (rb.literal(8), rb.literal(8), rb.literal(8)) != (0x49, 0x83, 0x42):
            raise ValueError("bad sync code")

    def colorspace():
        h.color_space = rb.literal(3)
        if h.color_space != 7:  # != SRGB
            h.color_range = rb.bit()
        else:
            rb.bit()

    def frame_size():
        h.width = rb.literal(16) + 1
        h.height = rb.literal(16) + 1
        if rb.bit():  # render size differs
            rb.literal(16)
            rb.literal(16)

    if h.is_keyframe:
        sync()
        colorspace()
        frame_size()
        h.refresh_frame_mask = 0xFF
    else:
        h.intra_only = False if h.show_frame else rb.bit() == 1
        h.reset_frame_context = 0 if h.error_resilient else rb.literal(2)
        if h.intra_only:
            sync()
            h.refresh_frame_mask = rb.literal(8)
            frame_size()
        else:
            h.refresh_frame_mask = rb.literal(8)
            idx = []
            bias = []
            for _ in range(3):
                idx.append(rb.literal(3))
                bias.append(rb.bit())
            h.ref_dpb_index = tuple(idx)
            h.ref_sign_bias = tuple(bias)
            found = False
            for _ in range(3):
                if rb.bit():
                    found = True
                    raise NotImplementedError(
                        "frame size from refs not supported")
            if not found:
                h.width = rb.literal(16) + 1
                h.height = rb.literal(16) + 1
            if rb.bit():
                rb.literal(16)
                rb.literal(16)
            h.allow_high_precision_mv = rb.bit() == 1
            if rb.bit():
                h.interp_filter = T.InterpFilter.SWITCHABLE
            else:
                lit = rb.literal(2)
                h.interp_filter = T.InterpFilter(
                    {1: 0, 0: 1, 2: 2, 3: 3}[lit])
    if not h.error_resilient:
        h.refresh_frame_context = rb.bit() == 1
        h.frame_parallel_decoding_mode = rb.bit() == 1
    else:
        h.refresh_frame_context = False
        h.frame_parallel_decoding_mode = True
    h.frame_context_idx = rb.literal(2)

    lf = LoopFilterParams()
    lf.filter_level = rb.literal(6)
    lf.sharpness_level = rb.literal(3)
    lf.mode_ref_delta_enabled = rb.bit() == 1
    if lf.mode_ref_delta_enabled:
        lf.mode_ref_delta_update = rb.bit() == 1
        if lf.mode_ref_delta_update:
            rd = list(lf.ref_deltas)
            for i in range(4):
                if rb.bit():
                    rd[i] = rb.signed_literal(6)
            md = list(lf.mode_deltas)
            for i in range(2):
                if rb.bit():
                    md[i] = rb.signed_literal(6)
            lf.ref_deltas, lf.mode_deltas = tuple(rd), tuple(md)
    h.loop_filter = lf

    h.base_qindex = rb.literal(8)

    def delta_q():
        return rb.signed_literal(4) if rb.bit() else 0

    h.y_dc_delta_q = delta_q()
    h.uv_dc_delta_q = delta_q()
    h.uv_ac_delta_q = delta_q()

    if rb.bit():
        raise NotImplementedError("segmentation not supported")

    min_log2, max_log2 = tile_log2_limits(h.mi_cols)
    log2_cols = min_log2
    while log2_cols < max_log2 and rb.bit():
        log2_cols += 1
    h.log2_tile_cols = log2_cols
    h.log2_tile_rows = 0
    if rb.bit():
        h.log2_tile_rows = 1 + rb.bit()

    header_size = rb.bytes_read()
    first_part_size = rb.literal(16)
    return h, rb.bytes_read(), first_part_size


# ---------------------------------------------------------------------------
# Compressed header
# ---------------------------------------------------------------------------


def _inv_recenter_nonneg(v: int, m: int) -> int:
    if v > 2 * m:
        return v
    return m - ((v + 1) >> 1) if (v & 1) else m + (v >> 1)


_INV_MAP = None


def _inv_remap_prob(v: int, m: int) -> int:
    global _INV_MAP
    if _INV_MAP is None:
        table = T.tbl("subexp_map_table")
        _INV_MAP = np.zeros(254, np.int64)
        _INV_MAP[table] = np.arange(254)
    v = int(_INV_MAP[v])
    m = m - 1
    if (m << 1) <= 255:
        return 1 + _inv_recenter_nonneg(v + 1, m)
    return 255 - _inv_recenter_nonneg(v + 1, 254 - m)


def _decode_term_subexp(bd: BoolDecoder) -> int:
    if not bd.read_bit(128):
        return bd.read_literal(4)
    if not bd.read_bit(128):
        return bd.read_literal(4) + 16
    if not bd.read_bit(128):
        return bd.read_literal(5) + 32
    v = bd.read_literal(7)
    if v < 65:
        return v + 64
    return (v << 1) - 1 + bd.read_bit(128)


def _diff_update_prob(bd: BoolDecoder, prob: int,
                      upd: int = DIFF_UPDATE_PROB) -> int:
    if bd.read_bit(upd):
        delta = _decode_term_subexp(bd)
        return _inv_remap_prob(delta, prob)
    return prob


def parse_compressed_header(h: FrameHeader, data: bytes, fc) -> None:
    """Parse compressed header, updating FrameContext `fc` in place."""
    bd = BoolDecoder(data)
    if h.lossless():
        h.tx_mode = T.TxMode.ONLY_4X4
    else:
        lit = bd.read_literal(2)
        if lit == 3 and bd.read_bit(128):
            h.tx_mode = T.TxMode.TX_MODE_SELECT
        else:
            h.tx_mode = T.TxMode(lit)
        if h.tx_mode == T.TxMode.TX_MODE_SELECT:
            for i in range(2):
                for j in range(1):
                    fc.tx_probs_8x8[i, j] = _diff_update_prob(
                        bd, int(fc.tx_probs_8x8[i, j]))
            for i in range(2):
                for j in range(2):
                    fc.tx_probs_16x16[i, j] = _diff_update_prob(
                        bd, int(fc.tx_probs_16x16[i, j]))
            for i in range(2):
                for j in range(3):
                    fc.tx_probs_32x32[i, j] = _diff_update_prob(
                        bd, int(fc.tx_probs_32x32[i, j]))
    max_tx = {T.TxMode.ONLY_4X4: 0, T.TxMode.ALLOW_8X8: 1,
              T.TxMode.ALLOW_16X16: 2, T.TxMode.ALLOW_32X32: 3,
              T.TxMode.TX_MODE_SELECT: 3}[h.tx_mode]
    for ts in list(TxSize)[: max_tx + 1]:
        if bd.read_bit(128):
            cp = fc.coef_probs[ts]
            for pt in range(2):
                for ref in range(2):
                    for band in range(6):
                        for ctx in range(6 if band else 3):
                            for node in range(3):
                                cp[pt, ref, band, ctx, node] = (
                                    _diff_update_prob(
                                        bd, int(cp[pt, ref, band, ctx, node])))
    for i in range(3):
        fc.skip_probs[i] = _diff_update_prob(bd, int(fc.skip_probs[i]))

    if not (h.is_keyframe or h.intra_only):
        for i in range(7):
            for j in range(3):
                fc.inter_mode_probs[i, j] = _diff_update_prob(
                    bd, int(fc.inter_mode_probs[i, j]))
        if h.interp_filter == T.InterpFilter.SWITCHABLE:
            for i in range(4):
                for j in range(2):
                    fc.interp_probs[i, j] = _diff_update_prob(
                        bd, int(fc.interp_probs[i, j]))
        for i in range(4):
            fc.intra_inter_probs[i] = _diff_update_prob(
                bd, int(fc.intra_inter_probs[i]))
        # frame reference mode (spec 6.3.12)
        h.reference_mode = 0
        if len(set(h.ref_sign_bias)) > 1:
            if bd.read_bit(128):
                h.reference_mode = 2 if bd.read_bit(128) else 1
        if h.reference_mode == 2:
            for i in range(5):
                fc.comp_inter_probs[i] = _diff_update_prob(
                    bd, int(fc.comp_inter_probs[i]))
        if h.reference_mode != 1:
            for i in range(5):
                for j in range(2):
                    fc.single_ref_probs[i, j] = _diff_update_prob(
                        bd, int(fc.single_ref_probs[i, j]))
        if h.reference_mode != 0:
            for i in range(5):
                fc.comp_ref_probs[i] = _diff_update_prob(
                    bd, int(fc.comp_ref_probs[i]))
        for i in range(4):
            for j in range(9):
                fc.if_y_probs[i, j] = _diff_update_prob(
                    bd, int(fc.if_y_probs[i, j]))
        for i in range(16):
            for j in range(3):
                fc.partition_probs[i, j] = _diff_update_prob(
                    bd, int(fc.partition_probs[i, j]))
        # mv probs
        nmv = fc.nmv
        for i in range(3):
            nmv.joints[i] = _diff_update_prob(bd, int(nmv.joints[i]), 252)
        for comp in nmv.comps:
            comp.sign = _diff_update_prob(bd, comp.sign, 252)
            for i in range(10):
                comp.classes[i] = _diff_update_prob(bd, int(comp.classes[i]), 252)
            comp.class0[0] = _diff_update_prob(bd, int(comp.class0[0]), 252)
            for i in range(10):
                comp.bits[i] = _diff_update_prob(bd, int(comp.bits[i]), 252)
        for comp in nmv.comps:
            for i in range(2):
                for j in range(3):
                    comp.class0_fp[i, j] = _diff_update_prob(
                        bd, int(comp.class0_fp[i, j]), 252)
            for j in range(3):
                comp.fp[j] = _diff_update_prob(bd, int(comp.fp[j]), 252)
        if h.allow_high_precision_mv:
            for comp in nmv.comps:
                comp.class0_hp = _diff_update_prob(bd, comp.class0_hp, 252)
                comp.hp = _diff_update_prob(bd, comp.hp, 252)


# ---------------------------------------------------------------------------
# Tile decode (intra frames)
# ---------------------------------------------------------------------------


@dataclass
class DecState:
    h: FrameHeader
    fc: object
    planes: list  # recon np arrays (aligned)
    plane_dims: list  # (crop_w, crop_h, ss)
    mig: MI.ModeInfoGrid
    pctx: MI.PartitionContext
    planes_ctx: list
    refs: list = None  # border-extended [y, u, v] of the LAST reference
    prev_mvs: object = None  # (ref0, mv) grids of the previous frame
    counts: dict = None  # symbol counters for backward adaptation


def _decode_tx_block_intra(st: DecState, bd: BoolDecoder, plane_idx: int,
                           mode: IntraMode, mi_row: int, mi_col: int,
                           x4: int, y4: int, tx: TxSize, tx_type: TxType,
                           block_w4: int, skip: bool, probs_full,
                           dc_q: int, ac_q: int):
    recon = st.planes[plane_idx]
    crop_w, crop_h, ss = st.plane_dims[plane_idx]
    n = TX_PX[tx]
    px = ((mi_col * 8) >> ss) + x4 * 4
    py = ((mi_row * 8) >> ss) + y4 * 4
    have_above = py > 0
    have_left = px > ((st.mig.tile_mi_start * 8) >> ss)
    have_right = (x4 + (1 << int(tx))) < block_w4
    above, al, left = intra_ops.build_ref_samples(
        recon, px, py, n, crop_w, crop_h, have_above, have_left, have_right)
    pred = intra_ops.predict_block_full(
        mode, above, al, left, have_above, have_left, n)
    if skip:
        recon[py : py + n, px : px + n] = pred.astype(np.uint8)
        return 0
    pc = st.planes_ctx[plane_idx]
    gx4 = ((mi_col * 2) >> ss) + x4
    gy4 = ((mi_row * 2) >> ss) + y4
    ctx0 = pc.get_ctx(gx4, gy4, tx)
    cnt = ecnt = None
    if st.counts is not None:
        cnt = st.counts[("coef", tx)][1 if plane_idx else 0, 0]
        ecnt = st.counts[("eob", tx)][1 if plane_idx else 0, 0]
    deq, eob = tok.read_coeffs(bd, tx, tx_type, probs_full, ctx0, dc_q, ac_q,
                               cnt, ecnt)
    if eob == 0:
        out = pred.astype(np.uint8)
    else:
        out = txfm.inv_txfm_add(
            deq[None].astype(np.int64), pred[None], tx, tx_type)[0]
    recon[py : py + n, px : px + n] = out
    mi_cols, mi_rows = st.mig.mi_cols, st.mig.mi_rows
    pc.set_ctx(gx4, gy4, tx, eob > 0, (mi_cols * 2) >> ss, (mi_rows * 2) >> ss)
    return eob


def _visible(st: DecState, ss: int, mi_row: int, mi_col: int,
             x4: int, y4: int) -> bool:
    gx4 = ((mi_col * 2) >> ss) + x4
    gy4 = ((mi_row * 2) >> ss) + y4
    return (gx4 < ((st.mig.mi_cols * 2) >> ss)
            and gy4 < ((st.mig.mi_rows * 2) >> ss))


def _decode_tx_block_inter(st: DecState, bd: BoolDecoder, plane_idx: int,
                           pred_full, mi_row: int, mi_col: int,
                           x4: int, y4: int, tx: TxSize, probs_full,
                           dc_q: int, ac_q: int):
    recon = st.planes[plane_idx]
    _, _, ss = st.plane_dims[plane_idx]
    n = TX_PX[tx]
    px = ((mi_col * 8) >> ss) + x4 * 4
    py = ((mi_row * 8) >> ss) + y4 * 4
    pred = pred_full[y4 * 4 : y4 * 4 + n, x4 * 4 : x4 * 4 + n]
    pc = st.planes_ctx[plane_idx]
    gx4 = ((mi_col * 2) >> ss) + x4
    gy4 = ((mi_row * 2) >> ss) + y4
    ctx0 = pc.get_ctx(gx4, gy4, tx)
    cnt = ecnt = None
    if st.counts is not None:
        cnt = st.counts[("coef", tx)][1 if plane_idx else 0, 1]
        ecnt = st.counts[("eob", tx)][1 if plane_idx else 0, 1]
    deq, eob = tok.read_coeffs(bd, tx, TxType.DCT_DCT, probs_full, ctx0,
                               dc_q, ac_q, cnt, ecnt)
    if eob == 0:
        out = pred.astype(np.uint8)
    else:
        out = txfm.inv_txfm_add(
            deq[None].astype(np.int64), pred[None].astype(np.int32),
            tx, TxType.DCT_DCT)[0]
    recon[py : py + n, px : px + n] = out
    mi_cols, mi_rows = st.mig.mi_cols, st.mig.mi_rows
    pc.set_ctx(gx4, gy4, tx, eob > 0, (mi_cols * 2) >> ss,
               (mi_rows * 2) >> ss)


def _decode_intra_block(st: DecState, bd: BoolDecoder, mi_row: int,
                        mi_col: int, bsize: BlockSize, full_probs) -> None:
    h = st.h
    fc = st.fc
    sctx = MI.skip_ctx(st.mig, mi_row, mi_col)
    skip = bd.read_bit(int(fc.skip_probs[sctx])) == 1
    if st.counts is not None:
        st.counts["skip"][sctx, 1 if skip else 0] += 1
    if bsize < BlockSize.BLOCK_8X8:
        if not (h.is_keyframe or h.intra_only):
            from tpu_vp9_torch.codec.inter_frame import intra_inter_ctx

            iictx = intra_inter_ctx(st.mig, mi_row, mi_col)
            is_inter = bd.read_bit(int(fc.intra_inter_probs[iictx])) == 1
            if st.counts is not None:
                st.counts["intra_inter"][iictx, 1 if is_inter else 0] += 1
            if is_inter:
                _decode_sub8x8_inter(st, bd, mi_row, mi_col, bsize, skip,
                                     full_probs)
                if skip:
                    _reset_skip_ctx(st, mi_row, mi_col,
                                    BlockSize.BLOCK_8X8)
                return
        _decode_sub8x8_intra(st, bd, mi_row, mi_col, bsize, skip,
                             full_probs)
        return
    max_tx = T.MAX_TX_SIZE[bsize]
    tx_allowed = {T.TxMode.ONLY_4X4: 0, T.TxMode.ALLOW_8X8: 1,
                  T.TxMode.ALLOW_16X16: 2, T.TxMode.ALLOW_32X32: 3,
                  T.TxMode.TX_MODE_SELECT: 3}[h.tx_mode]

    is_inter = False
    if not (h.is_keyframe or h.intra_only):
        from tpu_vp9_torch.codec.inter_frame import intra_inter_ctx

        iictx = intra_inter_ctx(st.mig, mi_row, mi_col)
        is_inter = bd.read_bit(int(fc.intra_inter_probs[iictx])) == 1
        if st.counts is not None:
            st.counts["intra_inter"][iictx, 1 if is_inter else 0] += 1

    # tx size (read_tx_size: coded under TX_MODE_SELECT when the block
    # has coefficients or is intra)
    if (h.tx_mode == T.TxMode.TX_MODE_SELECT
            and bsize >= BlockSize.BLOCK_8X8
            and (not skip or not is_inter)):
        y_tx = MI.read_tx_size_coded(bd, fc, st.mig, mi_row, mi_col, bsize)
        if st.counts is not None:
            txctx = MI.tx_size_ctx(st.mig, mi_row, mi_col, bsize)
            key = {3: "tx_p32", 2: "tx_p16",
                   1: "tx_p8"}[int(T.MAX_TX_SIZE[bsize])]
            st.counts[key][txctx, int(y_tx)] += 1
    else:
        y_tx = TxSize(min(int(max_tx), tx_allowed))

    if is_inter:
        _decode_inter_block_body(st, bd, mi_row, mi_col, bsize, y_tx, skip,
                                 full_probs)
        if skip:
            _reset_skip_ctx(st, mi_row, mi_col, bsize)
        return

    if h.is_keyframe or h.intra_only:
        am = MI.kf_above_mode(st.mig, mi_row, mi_col)
        lm = MI.kf_left_mode(st.mig, mi_row, mi_col)
        y_mode = IntraMode(T.read_token(
            bd, "intra_mode_tree", T.kf_y_mode_probs()[am][lm]))
        uv_mode = IntraMode(T.read_token(
            bd, "intra_mode_tree", T.kf_uv_mode_probs()[int(y_mode)]))
    else:
        grp = T.SIZE_GROUP[bsize]
        y_mode = IntraMode(T.read_token(
            bd, "intra_mode_tree", fc.if_y_probs[grp]))
        uv_mode = IntraMode(T.read_token(
            bd, "intra_mode_tree", fc.if_uv_probs[int(y_mode)]))
        if st.counts is not None:
            st.counts["y_mode"][grp, int(y_mode)] += 1
            st.counts["uv_mode"][int(y_mode), int(uv_mode)] += 1
    mi = MI.ModeInfo(bsize=bsize, y_mode=y_mode, uv_mode=uv_mode,
                     tx_size=y_tx, skip=skip, is_inter=False)
    st.mig.set_block(mi_row, mi_col, bsize, mi)

    dc_q = T.dc_quant(h.base_qindex, h.y_dc_delta_q)
    ac_q = T.ac_quant(h.base_qindex)
    dc_q_uv = T.dc_quant(h.base_qindex, h.uv_dc_delta_q)
    ac_q_uv = T.ac_quant(h.base_qindex, h.uv_ac_delta_q)
    tx_type = MI.y_tx_type(y_mode, False, h.lossless(), y_tx)
    w4y, _ = plane_block_geometry(bsize, 0)
    for x4, y4 in tx_blocks_of(bsize, y_tx, 0):
        if not _visible(st, 0, mi_row, mi_col, x4, y4):
            continue
        _decode_tx_block_intra(st, bd, 0, y_mode, mi_row, mi_col, x4, y4,
                               y_tx, tx_type, w4y, skip,
                               full_probs[(y_tx, False, False)], dc_q, ac_q)
    uv_tx = MI.uv_tx_size(bsize, y_tx)
    w4uv, _ = plane_block_geometry(bsize, 1)
    for pidx in (1, 2):
        for x4, y4 in tx_blocks_of(bsize, uv_tx, 1):
            if not _visible(st, 1, mi_row, mi_col, x4, y4):
                continue
            _decode_tx_block_intra(st, bd, pidx, uv_mode, mi_row, mi_col,
                                   x4, y4, uv_tx, TxType.DCT_DCT, w4uv, skip,
                                   full_probs[(uv_tx, True, False)],
                                   dc_q_uv, ac_q_uv)
    if skip:
        _reset_skip_ctx(st, mi_row, mi_col, bsize)


def _sub8x8_loop(bsize: BlockSize):
    """(num4w, num4h, [j indices read]) for the bmi read loop."""
    w, hh = T.BLOCK_WH[bsize]
    num4w = 2 if w == 8 else 1
    num4h = 2 if hh == 8 else 1
    js = [idy * 2 + idx for idy in range(0, 2, num4h)
          for idx in range(0, 2, num4w)]
    return num4w, num4h, js


def _decode_sub8x8_intra(st: DecState, bd: BoolDecoder, mi_row: int,
                         mi_col: int, bsize: BlockSize, skip: bool,
                         full_probs) -> None:
    """Sub-8x8 intra block (4X4/4X8/8X4): per-sub-block modes (bmi),
    one uv mode; token/recon geometry is the enclosing 8x8
    (libvpx decode_block: plane_bsize = max(bsize, BLOCK_8X8))."""
    h = st.h
    fc = st.fc
    keyish = h.is_keyframe or h.intra_only
    above_mi = st.mig.above(mi_row, mi_col)
    left_mi = st.mig.left(mi_row, mi_col)
    kf_y = T.kf_y_mode_probs()
    num4w, num4h, js = _sub8x8_loop(bsize)
    sub = [None] * 4
    for j in js:
        if keyish:
            # vp9_above_block_mode / vp9_left_block_mode context chain
            if j < 2:
                a = (MI._neighbor_sub_mode(above_mi, j + 2)
                     if above_mi is not None else IntraMode.DC_PRED)
            else:
                a = IntraMode(sub[j - 2])
            if j % 2 == 0:
                l = (MI._neighbor_sub_mode(left_mi, j + 1)
                     if left_mi is not None else IntraMode.DC_PRED)
            else:
                l = IntraMode(sub[j - 1])
            m = IntraMode(T.read_token(
                bd, "intra_mode_tree", kf_y[int(a)][int(l)]))
        else:
            m = IntraMode(T.read_token(
                bd, "intra_mode_tree", fc.if_y_probs[0]))
            if st.counts is not None:
                st.counts["y_mode"][0, int(m)] += 1
        sub[j] = m
        if num4h == 2:
            sub[j + 2] = m
        if num4w == 2:
            sub[j + 1] = m
    y_mode = sub[3]
    if keyish:
        uv_mode = IntraMode(T.read_token(
            bd, "intra_mode_tree", T.kf_uv_mode_probs()[int(y_mode)]))
    else:
        uv_mode = IntraMode(T.read_token(
            bd, "intra_mode_tree", fc.if_uv_probs[int(y_mode)]))
        if st.counts is not None:
            st.counts["uv_mode"][int(y_mode), int(uv_mode)] += 1
    mi = MI.ModeInfo(bsize=bsize, y_mode=y_mode,
                     uv_mode=uv_mode, tx_size=TxSize.TX_4X4, skip=skip,
                     is_inter=False, sub_modes=tuple(sub))
    st.mig.set_block(mi_row, mi_col, bsize, mi)

    eff = BlockSize.BLOCK_8X8
    dc_q = T.dc_quant(h.base_qindex, h.y_dc_delta_q)
    ac_q = T.ac_quant(h.base_qindex)
    dc_q_uv = T.dc_quant(h.base_qindex, h.uv_dc_delta_q)
    ac_q_uv = T.ac_quant(h.base_qindex, h.uv_ac_delta_q)
    w4y, _ = plane_block_geometry(eff, 0)
    for i, (x4, y4) in enumerate(tx_blocks_of(eff, TxSize.TX_4X4, 0)):
        if not _visible(st, 0, mi_row, mi_col, x4, y4):
            continue
        mode_i = IntraMode(sub[i])
        tt = MI.y_tx_type(mode_i, False, h.lossless(), TxSize.TX_4X4)
        _decode_tx_block_intra(
            st, bd, 0, mode_i, mi_row, mi_col, x4, y4, TxSize.TX_4X4, tt,
            w4y, skip, full_probs[(TxSize.TX_4X4, False, False)],
            dc_q, ac_q)
    w4uv, _ = plane_block_geometry(eff, 1)
    for pidx in (1, 2):
        for x4, y4 in tx_blocks_of(eff, TxSize.TX_4X4, 1):
            if not _visible(st, 1, mi_row, mi_col, x4, y4):
                continue
            _decode_tx_block_intra(
                st, bd, pidx, uv_mode, mi_row, mi_col, x4, y4,
                TxSize.TX_4X4, TxType.DCT_DCT, w4uv, skip,
                full_probs[(TxSize.TX_4X4, True, False)], dc_q_uv, ac_q_uv)
    if skip:
        _reset_skip_ctx(st, mi_row, mi_col, eff)


def _reset_skip_ctx(st: DecState, mi_row: int, mi_col: int,
                    bsize: BlockSize) -> None:
    for pidx in (0, 1, 2):
        ss = st.plane_dims[pidx][2]
        pc = st.planes_ctx[pidx]
        w4, h4 = plane_block_geometry(bsize, ss)
        bx4 = (mi_col * 2) >> ss
        by4 = (mi_row * 2) >> ss
        pc.above[bx4 : bx4 + w4] = 0
        pc.left[by4 : by4 + h4] = 0


def _read_ref_frames(st: DecState, bd: BoolDecoder, mi_row: int,
                     mi_col: int):
    """spec read_ref_frames; returns (ref_frames, compound)."""
    from tpu_vp9_torch.bitstream.tables import RefFrame
    from tpu_vp9_torch.codec import inter_frame as IF

    h = st.h
    fc = st.fc
    sign_bias = (0,) + tuple(h.ref_sign_bias)
    compound = False
    if h.reference_mode == 2:
        fixed_ref, _ = IF.compound_refs(sign_bias)
        cctx = IF.comp_inter_ctx(st.mig, mi_row, mi_col, fixed_ref)
        compound = bd.read_bit(int(fc.comp_inter_probs[cctx])) == 1
        if st.counts is not None:
            st.counts["comp_inter"][cctx, 1 if compound else 0] += 1
    elif h.reference_mode == 1:
        compound = True
    if compound:
        fixed_ref, var_refs = IF.compound_refs(sign_bias)
        rctx = IF.comp_ref_ctx(st.mig, mi_row, mi_col, sign_bias)
        bit = bd.read_bit(int(fc.comp_ref_probs[rctx]))
        if st.counts is not None:
            st.counts["comp_ref"][rctx, bit] += 1
        idx = sign_bias[fixed_ref]
        rf = [0, 0]
        rf[idx] = fixed_ref
        rf[1 - idx] = var_refs[bit]
        ref_frames = (rf[0], rf[1])
    else:
        rctx = IF.single_ref_p1_ctx(st.mig, mi_row, mi_col)
        not_last = bd.read_bit(int(fc.single_ref_probs[rctx, 0]))
        if st.counts is not None:
            st.counts["single_ref"][rctx, 0, not_last] += 1
        if not_last:
            rctx2 = IF.single_ref_p2_ctx(st.mig, mi_row, mi_col)
            is_alt = bd.read_bit(int(fc.single_ref_probs[rctx2, 1]))
            if st.counts is not None:
                st.counts["single_ref"][rctx2, 1, is_alt] += 1
            ref_frames = (int(RefFrame.ALTREF) if is_alt
                          else int(RefFrame.GOLDEN), -1)
        else:
            ref_frames = (int(RefFrame.LAST), -1)
    n_refs = 2 if compound else 1
    for r in ref_frames[:n_refs]:
        if st.refs.get(r) is None:
            raise ValueError(f"reference {r} unavailable")
    return ref_frames, compound


def _decode_sub8x8_inter(st: DecState, bd: BoolDecoder, mi_row: int,
                         mi_col: int, bsize: BlockSize, skip: bool,
                         full_probs) -> None:
    """Sub-8x8 inter block (bmi MVs): per-sub-block inter modes and MVs
    (vp9 read_inter_block_mode_info sub-8x8 branch /
    vp9_bitstream.c:360 write_modes_b bmi loop), per-4x4 luma MC, one
    4x4 chroma MC at the q4-averaged MV, 8x8 token geometry."""
    from tpu_vp9_torch.codec import mv as MV
    from tpu_vp9_torch.ops import inter as inter_ops

    h = st.h
    fc = st.fc
    sign_bias = (0,) + tuple(h.ref_sign_bias)
    ref_frames, compound = _read_ref_frames(st, bd, mi_row, mi_col)
    n_refs = 2 if compound else 1
    # block-level mv scan: mode_context + the NEWMV mvd reference
    nearests, mode_context = [], 0
    for i in range(n_refs):
        mv_list, mctx = MV.find_mv_refs(
            st.mig, mi_row, mi_col, bsize, ref_frames[i],
            st.mig.tile_mi_start, st.mig.tile_mi_end, prev_mvs=st.prev_mvs,
            sign_bias=sign_bias)
        if i == 0:
            mode_context = mctx
        nst, _ = MV.find_best_ref_mvs(
            mv_list, h.allow_high_precision_mv, mi_row, mi_col, bsize,
            st.mig.mi_rows, st.mig.mi_cols)
        nearests.append(nst)
    num4w, num4h, js = _sub8x8_loop(bsize)
    bmi = [[(0, 0), (0, 0)] for _ in range(4)]  # [sub][ref]
    sub_modes = [0] * 4
    for j in js:
        b_mode = T.read_token(bd, "inter_mode_tree",
                              fc.inter_mode_probs[mode_context])
        if st.counts is not None:
            st.counts["inter_mode"][mode_context, b_mode] += 1
        for i in range(n_refs):
            if b_mode in (0, 1):
                nst, nr = MV.append_sub8x8_mvs(
                    st.mig, mi_row, mi_col, bsize, ref_frames[i], j,
                    [bmi[k][i] for k in range(4)],
                    st.mig.tile_mi_start, st.mig.tile_mi_end,
                    prev_mvs=st.prev_mvs, sign_bias=sign_bias)
                mv = nst if b_mode == 0 else nr
            elif b_mode == 2:
                mv = (0, 0)
            else:
                mv = MV.read_mv(bd, nearests[i], fc.nmv,
                                h.allow_high_precision_mv)
                if st.counts is not None:
                    from tpu_vp9_torch.codec.adapt import inc_mv

                    inc_mv(st.counts, (mv[0] - nearests[i][0],
                                       mv[1] - nearests[i][1]))
            bmi[j][i] = tuple(mv)
        sub_modes[j] = b_mode
        if num4h == 2:
            bmi[j + 2] = list(bmi[j])
            sub_modes[j + 2] = b_mode
        if num4w == 2:
            bmi[j + 1] = list(bmi[j])
            sub_modes[j + 1] = b_mode
    mi = MI.ModeInfo(bsize=bsize, tx_size=TxSize.TX_4X4, skip=skip,
                     is_inter=True, ref_frame=ref_frames,
                     mv=(tuple(bmi[3][0]), tuple(bmi[3][1])),
                     inter_mode=sub_modes[3],
                     sub_mvs=tuple((tuple(b[0]), tuple(b[1]))
                                   for b in bmi),
                     sub_modes=tuple(sub_modes))
    st.mig.set_block(mi_row, mi_col, bsize, mi)

    # --- reconstruction: per-4x4 luma MC, averaged-MV 4x4 chroma MC ---
    dc_q = T.dc_quant(h.base_qindex, h.y_dc_delta_q)
    ac_q = T.ac_quant(h.base_qindex)
    dc_q_uv = T.dc_quant(h.base_qindex, h.uv_dc_delta_q)
    ac_q_uv = T.ac_quant(h.base_qindex, h.uv_ac_delta_q)
    eff = BlockSize.BLOCK_8X8
    for pidx in range(3):
        _, _, ss = st.plane_dims[pidx]
        pred = np.zeros((8 >> ss, 8 >> ss), np.uint8)
        if ss == 0:
            for j in range(4):
                x_off, y_off = (j % 2) * 4, (j // 2) * 4
                for i in range(n_refs):
                    p = inter_ops.predict_inter_block(
                        st.refs[ref_frames[i]][pidx], mi_row, mi_col,
                        x_off, y_off, 4, 4, bmi[j][i], 0,
                        st.mig.mi_rows, st.mig.mi_cols, h.interp_filter)
                    if i == 0:
                        sub_pred = p
                    else:
                        sub_pred = ((sub_pred.astype(np.uint16)
                                     + p.astype(np.uint16) + 1)
                                    >> 1).astype(np.uint8)
                pred[y_off : y_off + 4, x_off : x_off + 4] = sub_pred
        else:
            for i in range(n_refs):
                mv_avg = MV.mi_mv_pred_q4([bmi[k][i] for k in range(4)])
                p = inter_ops.predict_inter_block(
                    st.refs[ref_frames[i]][pidx], mi_row, mi_col, 0, 0,
                    4, 4, mv_avg, 1, st.mig.mi_rows, st.mig.mi_cols,
                    h.interp_filter)
                if i == 0:
                    pred = p
                else:
                    pred = ((pred.astype(np.uint16)
                             + p.astype(np.uint16) + 1) >> 1) \
                        .astype(np.uint8)
        px = (mi_col * 8) >> ss
        py = (mi_row * 8) >> ss
        bwp = 8 >> ss
        if skip:
            st.planes[pidx][py : py + bwp, px : px + bwp] = pred
            continue
        probs = full_probs[(TxSize.TX_4X4, pidx > 0, True)]
        dq, aq = (dc_q, ac_q) if pidx == 0 else (dc_q_uv, ac_q_uv)
        for x4, y4 in tx_blocks_of(eff, TxSize.TX_4X4, ss):
            if not _visible(st, ss, mi_row, mi_col, x4, y4):
                continue
            _decode_tx_block_inter(st, bd, pidx, pred, mi_row, mi_col,
                                   x4, y4, TxSize.TX_4X4, probs, dq, aq)


def _decode_inter_block_body(st: DecState, bd: BoolDecoder, mi_row: int,
                             mi_col: int, bsize: BlockSize, y_tx: TxSize,
                             skip: bool, full_probs) -> None:
    from tpu_vp9_torch.codec import mv as MV
    from tpu_vp9_torch.ops import inter as inter_ops

    h = st.h
    fc = st.fc
    sign_bias = (0,) + tuple(h.ref_sign_bias)
    ref_frames, compound = _read_ref_frames(st, bd, mi_row, mi_col)
    n_refs = 2 if compound else 1
    nearests, nears, mode_context = [], [], 0
    for i in range(n_refs):
        mv_list, mctx = MV.find_mv_refs(
            st.mig, mi_row, mi_col, bsize, ref_frames[i],
            st.mig.tile_mi_start, st.mig.tile_mi_end, prev_mvs=st.prev_mvs,
            sign_bias=sign_bias)
        if i == 0:
            mode_context = mctx
        nst, nr = MV.find_best_ref_mvs(
            mv_list, h.allow_high_precision_mv, mi_row, mi_col, bsize,
            st.mig.mi_rows, st.mig.mi_cols)
        nearests.append(nst)
        nears.append(nr)
    inter_mode = T.read_token(bd, "inter_mode_tree",
                              fc.inter_mode_probs[mode_context])
    if st.counts is not None:
        st.counts["inter_mode"][mode_context, inter_mode] += 1
    mvs = []
    for i in range(n_refs):
        if inter_mode == 0:
            mvs.append(nearests[i])
        elif inter_mode == 1:
            mvs.append(nears[i])
        elif inter_mode == 2:
            mvs.append((0, 0))
        else:
            mvv = MV.read_mv(bd, nearests[i], fc.nmv,
                             h.allow_high_precision_mv)
            if st.counts is not None:
                from tpu_vp9_torch.codec.adapt import inc_mv

                inc_mv(st.counts, (mvv[0] - nearests[i][0],
                                   mvv[1] - nearests[i][1]))
            mvs.append(mvv)
    if n_refs == 1:
        mvs.append((0, 0))
    mi = MI.ModeInfo(bsize=bsize, tx_size=y_tx, skip=skip, is_inter=True,
                     ref_frame=ref_frames, mv=(mvs[0], mvs[1]),
                     inter_mode=inter_mode)
    st.mig.set_block(mi_row, mi_col, bsize, mi)

    dc_q = T.dc_quant(h.base_qindex, h.y_dc_delta_q)
    ac_q = T.ac_quant(h.base_qindex)
    dc_q_uv = T.dc_quant(h.base_qindex, h.uv_dc_delta_q)
    ac_q_uv = T.ac_quant(h.base_qindex, h.uv_ac_delta_q)
    for pidx in range(3):
        _, _, ss = st.plane_dims[pidx]
        w, hh = T.BLOCK_WH[bsize]
        bw, bh = w >> ss, hh >> ss
        pred = inter_ops.predict_inter_block(
            st.refs[ref_frames[0]][pidx], mi_row, mi_col, 0, 0, bw, bh,
            mvs[0], ss, st.mig.mi_rows, st.mig.mi_cols,
            h.interp_filter)
        if compound:
            pred2 = inter_ops.predict_inter_block(
                st.refs[ref_frames[1]][pidx], mi_row, mi_col, 0, 0, bw, bh,
                mvs[1], ss, st.mig.mi_rows, st.mig.mi_cols,
                h.interp_filter)
            pred = ((pred.astype(np.uint16) + pred2.astype(np.uint16) + 1)
                    >> 1).astype(np.uint8)
        px = (mi_col * 8) >> ss
        py = (mi_row * 8) >> ss
        if skip:
            st.planes[pidx][py : py + bh, px : px + bw] = pred
            continue
        txs = y_tx if pidx == 0 else MI.uv_tx_size(bsize, y_tx)
        probs = full_probs[(txs, pidx > 0, True)]
        dq, aq = (dc_q, ac_q) if pidx == 0 else (dc_q_uv, ac_q_uv)
        for x4, y4 in tx_blocks_of(bsize, txs, ss):
            if not _visible(st, ss, mi_row, mi_col, x4, y4):
                continue
            _decode_tx_block_inter(st, bd, pidx, pred, mi_row, mi_col,
                                   x4, y4, txs, probs, dq, aq)


def _decode_partition(st: DecState, bd: BoolDecoder, mi_row: int,
                      mi_col: int, bsize: BlockSize, full_probs) -> None:
    mi_rows, mi_cols = st.mig.mi_rows, st.mig.mi_cols
    if mi_row >= mi_rows or mi_col >= mi_cols:
        return
    has_rows, has_cols = MI.partition_rule(bsize, mi_row, mi_col,
                                           mi_rows, mi_cols)
    ctx = st.pctx.ctx(mi_row, mi_col, bsize)
    if st.h.is_keyframe or st.h.intra_only:
        probs = T.kf_partition_probs()[ctx]
    else:
        probs = st.fc.partition_probs[ctx]
    part = MI.read_partition(bd, probs, has_rows, has_cols)
    if st.counts is not None and not (st.h.is_keyframe or st.h.intra_only):
        st.counts["partition"][ctx, int(part)] += 1
    sub = T.SUBSIZE[(part, bsize)]
    bw = 1 << MI.MI_WIDTH_LOG2[bsize]
    half = bw >> 1
    if bsize == BlockSize.BLOCK_8X8 and part != Partition.NONE:
        # every 8x8 partition maps to ONE sub-8x8 mi (4X8/8X4/4X4 with
        # per-sub-block bmi entries), not two half blocks
        _decode_intra_block(st, bd, mi_row, mi_col, sub, full_probs)
        st.pctx.update(mi_row, mi_col, sub, bsize)
        return
    if part == Partition.NONE:
        _decode_intra_block(st, bd, mi_row, mi_col, bsize, full_probs)
    elif part == Partition.HORZ:
        _decode_intra_block(st, bd, mi_row, mi_col, sub, full_probs)
        if mi_row + half < mi_rows:
            _decode_intra_block(st, bd, mi_row + half, mi_col, sub, full_probs)
    elif part == Partition.VERT:
        _decode_intra_block(st, bd, mi_row, mi_col, sub, full_probs)
        if mi_col + half < mi_cols:
            _decode_intra_block(st, bd, mi_row, mi_col + half, sub, full_probs)
    else:
        _decode_partition(st, bd, mi_row, mi_col, sub, full_probs)
        _decode_partition(st, bd, mi_row, mi_col + half, sub, full_probs)
        _decode_partition(st, bd, mi_row + half, mi_col, sub, full_probs)
        _decode_partition(st, bd, mi_row + half, mi_col + half, sub, full_probs)
    if part != Partition.SPLIT:
        st.pctx.update(mi_row, mi_col, sub, bsize)


def decode_frame(payload: bytes, fc=None, dpb=None, fc_state=None,
                 prev_mvs=None, last_was_key: bool = False):
    """Decode one frame payload. Returns (y, u, v, FrameHeader) with crop
    applied, or (None, None, None, header) for show_existing_frame.

    dpb: list of 8 slots, each (refs_padded [y,u,v], crop_w, crop_h) or
    None; required for inter frames.
    fc_state: persistent list of 4 frame contexts (non-error-resilient
    streams); managed per spec reset/refresh rules."""
    h, hdr_size, first_part = parse_uncompressed_header(payload)
    if h.show_existing_frame:
        return None, None, None, h
    if h.error_resilient:
        # setup_past_independence zeroes ref_frame_sign_bias AFTER the
        # header parse (spec 7.2; vp9_entropymode.c) — compound is thus
        # never allowed and mv-ref derivation sees zero biases.
        h.ref_sign_bias = (0, 0, 0)
    if fc_state is not None:
        # setup_past_independence / context selection
        if (h.is_keyframe or h.intra_only or h.error_resilient
                or h.reset_frame_context == 3):
            for i in range(4):
                fc_state[i] = T.default_frame_context()
        elif h.reset_frame_context == 2:
            fc_state[h.frame_context_idx] = T.default_frame_context()
        fc = fc_state[h.frame_context_idx].copy()
    elif fc is None:
        fc = T.default_frame_context()
    else:
        fc = fc.copy()
    # backward adaptation rebases on the context BEFORE forward updates
    do_adapt = (not h.error_resilient
                and not h.frame_parallel_decoding_mode)
    pre_fc = fc.copy() if do_adapt else None
    compressed = payload[hdr_size : hdr_size + first_part]
    parse_compressed_header(h, compressed, fc)
    if (fc_state is not None and h.refresh_frame_context
            and h.frame_parallel_decoding_mode):
        # fpdm=1: save right after header parse (no adaptation)
        fc_state[h.frame_context_idx] = fc.copy()
    tile_data = payload[hdr_size + first_part :]
    if h.log2_tile_rows:
        raise NotImplementedError("tile rows not supported")
    refs = None
    if not (h.is_keyframe or h.intra_only):
        if dpb is None:
            raise ValueError("inter frame requires a DPB")
        refs = {}
        for i, ref_id in enumerate((1, 2, 3)):  # LAST, GOLDEN, ALTREF
            slot = dpb[h.ref_dpb_index[i]]
            refs[ref_id] = slot[0] if slot is not None else None
        if refs[1] is None:
            raise ValueError("LAST reference slot is empty")

    mi_rows, mi_cols = h.mi_rows, h.mi_cols
    planes = []
    plane_dims = []
    for ss in (0, 1, 1):
        # +64 overhang padding: see make_frame_state
        hp = ((mi_rows * 8) >> ss) + 64
        wp = ((mi_cols * 8) >> ss) + 64
        planes.append(np.zeros((hp, wp), np.uint8))
        crop_w = (h.width + ss) >> ss
        crop_h = (h.height + ss) >> ss
        plane_dims.append((crop_w, crop_h, ss))
    st = DecState(
        h=h, fc=fc, planes=planes, plane_dims=plane_dims,
        mig=MI.ModeInfoGrid(mi_rows, mi_cols),
        pctx=MI.PartitionContext(mi_rows, mi_cols),
        planes_ctx=[tok.PlaneContext(mi_cols, mi_rows, 0),
                    tok.PlaneContext(mi_cols, mi_rows, 1),
                    tok.PlaneContext(mi_cols, mi_rows, 1)],
        refs=refs,
        prev_mvs=prev_mvs,
    )
    if do_adapt:
        from tpu_vp9_torch.codec.adapt import new_mode_counts
        from tpu_vp9_torch.codec.intra_frame import new_counts_sink

        st.counts = {**new_counts_sink(), **new_mode_counts()}
    full_probs = {
        (ts, uv, ref): tok.full_probs_for(fc, ts, uv, is_inter=ref)
        for ts in TxSize for uv in (False, True) for ref in (False, True)
    }
    from tpu_vp9_torch.codec.intra_frame import tile_mi_offsets

    offs = tile_mi_offsets(mi_cols, h.log2_tile_cols)
    n_tiles = len(offs) - 1
    pos = 0
    for t in range(n_tiles):
        if t != n_tiles - 1:
            tsize = int.from_bytes(tile_data[pos : pos + 4], "big")
            pos += 4
        else:
            tsize = len(tile_data) - pos
        tdata = tile_data[pos : pos + tsize]
        pos += tsize
        st.mig.tile_mi_start, st.mig.tile_mi_end = offs[t], offs[t + 1]
        st.pctx.left[:] = 0
        st.planes_ctx = [tok.PlaneContext(mi_cols, mi_rows, 0),
                         tok.PlaneContext(mi_cols, mi_rows, 1),
                         tok.PlaneContext(mi_cols, mi_rows, 1)]
        bd = BoolDecoder(tdata)
        for sb_r in range(0, mi_rows, 8):
            for sb_c in range(offs[t], offs[t + 1], 8):
                _decode_partition(st, bd, sb_r, sb_c, BlockSize.BLOCK_64X64,
                                  full_probs)
    if do_adapt:
        from tpu_vp9_torch.codec.adapt import adapt_frame_context

        adapted = adapt_frame_context(
            pre_fc, st.counts,
            is_key=h.is_keyframe or h.intra_only,
            after_key=last_was_key,
            tx_select=h.tx_mode == T.TxMode.TX_MODE_SELECT,
            final_fc=fc)
        if fc_state is not None and h.refresh_frame_context:
            fc_state[h.frame_context_idx] = adapted
    if h.loop_filter.filter_level:
        from tpu_vp9_torch.ops.loopfilter import loop_filter_frame

        lf = h.loop_filter
        # +8 slack: see encoder _apply_loop_filter
        views = [planes[0][: mi_rows * 8 + 8, : mi_cols * 8 + 8],
                 planes[1][: mi_rows * 4 + 8, : mi_cols * 4 + 8],
                 planes[2][: mi_rows * 4 + 8, : mi_cols * 4 + 8]]
        loop_filter_frame(views, st.mig, lf.filter_level,
                          lf.sharpness_level, lf.ref_deltas, lf.mode_deltas,
                          lf.mode_ref_delta_enabled)
    y = planes[0][: h.height, : h.width]
    u = planes[1][: (h.height + 1) >> 1, : (h.width + 1) >> 1]
    v = planes[2][: (h.height + 1) >> 1, : (h.width + 1) >> 1]
    h.mv_snapshot = st.mig.snapshot_mvs()
    return y, u, v, h


def decode_ivf(fh):
    """Decode all frames of an IVF stream with DPB management;
    yields (y, u, v, header) for shown frames."""
    from tpu_vp9_torch.bitstream.ivf import read_ivf
    from tpu_vp9_torch.ops.inter import extend_borders

    from tpu_vp9_torch.bitstream.headers import split_superframe

    dpb = [None] * 8
    fc_state = [T.default_frame_context() for _ in range(4)]
    last = None  # (header, mv_snapshot) of the previous decoded frame
    last_was_key = False
    payloads = (sub for pkt in read_ivf(fh)
                for sub in split_superframe(pkt.payload))
    for payload in payloads:
        # use_prev_frame_mvs (vp9 decoder rule)
        prev_mvs = None
        hdr0, _, _ = parse_uncompressed_header(payload)
        if (last is not None and not hdr0.show_existing_frame
                and not hdr0.error_resilient and not hdr0.is_keyframe
                and not hdr0.intra_only):
            lh, lsnap = last
            if (lh.width == hdr0.width and lh.height == hdr0.height
                    and not lh.is_keyframe and not lh.intra_only
                    and lh.show_frame):
                prev_mvs = lsnap
        y, u, v, h = decode_frame(payload, dpb=dpb, fc_state=fc_state,
                                  prev_mvs=prev_mvs,
                                  last_was_key=last_was_key)
        if h.show_existing_frame:
            slot = dpb[h.show_existing_frame_index]
            yield slot[3][0], slot[3][1], slot[3][2], h
            continue
        # store into DPB per refresh mask (planes trimmed to mi-aligned)
        mi_w, mi_h = h.mi_cols * 8, h.mi_rows * 8
        planes = [y, u, v]
        padded = []
        for pidx, pl in enumerate(planes):
            ss = 0 if pidx == 0 else 1
            full = np.zeros(((mi_h >> ss), (mi_w >> ss)), np.uint8)
            full[: pl.shape[0], : pl.shape[1]] = pl
            padded.append(extend_borders(full, pl.shape[1], pl.shape[0]))
        entry = (padded, h.width, h.height, (y, u, v))
        for slot in range(8):
            if h.refresh_frame_mask & (1 << slot):
                dpb[slot] = entry
        last = (h, getattr(h, "mv_snapshot", None))
        last_was_key = h.is_keyframe
        if h.show_frame:
            yield y, u, v, h
