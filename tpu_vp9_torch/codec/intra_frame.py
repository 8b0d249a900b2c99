"""Intra (key / intra-only) frame encoder — host oracle path.

This is the minimum end-to-end slice (SURVEY.md §7.2 step 2): fixed-size
partitioning, exact recon via shared ops, two passes:
  pass A: per-block mode decision + reconstruction (decode order),
  pass B: syntax + token serialization into the tile bool partition.

The TPU batched path replaces pass A's per-block loop; pass B stays a host
serialization.  Parity reference for the syntax walk: vendored libvpx
``vp9_bitstream.c:360`` (write_modes_b) / ``vp9_tokenize.c`` in SVT-VP9.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream import tokenize as tok
from tpu_vp9_torch.bitstream.bool_coder import BoolEncoder
from tpu_vp9_torch.bitstream.tables import (
    BlockSize, IntraMode, Partition, TxSize, TxType,
)
from tpu_vp9_torch.codec import modeinfo as MI
from tpu_vp9_torch.ops import intra as intra_ops
from tpu_vp9_torch.ops import txfm

TX_PX = {TxSize.TX_4X4: 4, TxSize.TX_8X8: 8, TxSize.TX_16X16: 16,
         TxSize.TX_32X32: 32}


@dataclass
class Plane:
    recon: np.ndarray  # aligned (Hp, Wp) uint8
    source: np.ndarray  # aligned same size
    width: int  # real (crop) width
    height: int
    subsampling: int  # 0 for Y, 1 for U/V


@dataclass
class FrameState:
    mi_rows: int
    mi_cols: int
    planes: list  # [y, u, v]
    mig: MI.ModeInfoGrid
    levels: dict = field(default_factory=dict)  # (plane, y4, x4) -> (N,N) int
    eobs: dict = field(default_factory=dict)
    header_updates: object = None  # forward prob updates for assemble_frame
    tile_mi_start: int = 0  # current tile column origin (encode walk)

    @property
    def sb_rows(self):
        return (self.mi_rows + 7) >> 3

    @property
    def sb_cols(self):
        return (self.mi_cols + 7) >> 3


def make_frame_state(frame, mi_rows: int, mi_cols: int) -> FrameState:
    """frame: utils.yuv.Frame420."""
    planes = []
    for arr, ss in ((frame.y, 0), (frame.u, 1), (frame.v, 1)):
        h, w = arr.shape
        # +64: blocks may legally overhang the mi grid (partition rules only
        # check the half-way point); overhang recon is never referenced.
        hp = ((mi_rows * 8) >> ss) + 64
        wp = ((mi_cols * 8) >> ss) + 64
        src = np.zeros((hp, wp), np.uint8)
        src[:h, :w] = arr
        # edge-extend source padding (keeps residuals small off-frame)
        if w < wp:
            src[:h, w:] = src[:h, w - 1 : w]
        if h < hp:
            src[h:, :] = src[h - 1 : h, :]
        planes.append(
            Plane(recon=np.zeros((hp, wp), np.uint8), source=src,
                  width=w, height=h, subsampling=ss))
    return FrameState(mi_rows=mi_rows, mi_cols=mi_cols, planes=planes,
                      mig=MI.ModeInfoGrid(mi_rows, mi_cols))


def tile_mi_offsets(mi_cols: int, log2_tile_cols: int):
    """Tile column mi boundaries (spec get_tile_offset)."""
    sb_cols = (mi_cols + 7) >> 3
    n = 1 << log2_tile_cols
    return [min(((sb_cols * i) >> log2_tile_cols) << 3, mi_cols)
            for i in range(n + 1)]


def walk_partition_fixed(mi_rows: int, mi_cols: int, target: BlockSize,
                         log2_tile_cols: int = 0):
    """Decode-order event list for a fixed-size partitioning.

    Events: ('tile', tile_start_mi, tile_end_mi, ...), then per node
    ('part', mi_row, mi_col, bsize, partition) / ('leaf', ...).
    """
    events = []

    def node(mi_row, mi_col, bsize):
        if mi_row >= mi_rows or mi_col >= mi_cols:
            return
        has_rows, has_cols = MI.partition_rule(
            bsize, mi_row, mi_col, mi_rows, mi_cols)
        bw = 1 << MI.MI_WIDTH_LOG2[bsize]
        if int(bsize) > int(target) and (
            bsize in (BlockSize.BLOCK_64X64, BlockSize.BLOCK_32X32,
                      BlockSize.BLOCK_16X16)):
            part = Partition.SPLIT
        elif has_rows and has_cols:
            part = Partition.NONE
        else:
            part = Partition.SPLIT  # forced descent at edges
        events.append(("part", mi_row, mi_col, bsize, part))
        if part == Partition.NONE:
            events.append(("leaf", mi_row, mi_col, bsize, None))
        else:
            sub = T.SUBSIZE[(Partition.SPLIT, bsize)]
            half = bw >> 1
            node(mi_row, mi_col, sub)
            node(mi_row, mi_col + half, sub)
            node(mi_row + half, mi_col, sub)
            node(mi_row + half, mi_col + half, sub)

    offs = tile_mi_offsets(mi_cols, log2_tile_cols)
    for t in range(len(offs) - 1):
        events.append(("tile", offs[t], offs[t + 1], None, None))
        for sb_r in range(0, mi_rows, 8):
            for sb_c in range(offs[t], offs[t + 1], 8):
                node(sb_r, sb_c, BlockSize.BLOCK_64X64)
    return events


def decide_partition_tree_intra(y: np.ndarray, mi_rows: int, mi_cols: int,
                                qindex: int, min_bs: BlockSize,
                                max_bs: BlockSize, log2_tile_cols: int = 0,
                                split_bias: float = 16.0):
    """Open-loop quadtree partition RDO for intra frames.

    The MDC kernel's prediction_partition_loop analogue
    (EbModeDecisionConfigurationProcess.c:1899): per-node cost is a
    rate-distortion proxy from the block's luma variance against the
    quantizer scale — splitting pays off exactly where quadrants are
    heterogeneous (parent variance ≫ pooled child variance).  Returns a
    decode-order event list compatible with walk_partition_fixed's.
    """
    h, w = y.shape
    r8, c8 = mi_rows, mi_cols
    # pad to a whole-SB multiple by edge replication so overhang area
    # doesn't skew the stats
    hp = ((r8 * 8 + 63) // 64) * 64
    wp = ((c8 * 8 + 63) // 64) * 64
    yp = np.pad(y.astype(np.float64), ((0, hp - h), (0, wp - w)),
                mode="edge")

    def level_energy(n):
        """Per-nxn-block open-loop intra residual energy: min over
        {DC, V, H} source-predictor residual variances (the OIS-histogram
        proxy of EbMotionEstimationProcess.c's open-loop intra search,
        vectorized whole-frame)."""
        R, C = hp // n, wp // n
        b = yp.reshape(R, n, C, n)
        dc = b.var(axis=(1, 3))
        v = ((b - b[:, :1]) ** 2).mean(axis=(1, 3))
        hh = ((b - b[:, :, :, :1]) ** 2).mean(axis=(1, 3))
        return np.minimum(dc, np.minimum(v, hh))

    en = {k: level_energy(8 << k) for k in (0, 1, 2, 3)}
    q2 = max((T.ac_quant(qindex) / 8.0) ** 2, 1.0)
    lvl_of = {BlockSize.BLOCK_8X8: 0, BlockSize.BLOCK_16X16: 1,
              BlockSize.BLOCK_32X32: 2, BlockSize.BLOCK_64X64: 3}
    allow_4x4 = int(min_bs) < int(BlockSize.BLOCK_8X8)
    if allow_4x4:
        v4 = level_energy(4)
    # split_bias: per-leaf syntax overhead in npix*log2(1+var/q2) units

    def node_cost(mi_row, mi_col, bsize):
        k = lvl_of[bsize]
        r, c = mi_row >> k, mi_col >> k
        r = min(r, en[k].shape[0] - 1)
        c = min(c, en[k].shape[1] - 1)
        var = en[k][r, c]
        npix = (8 << k) ** 2
        return npix * np.log2(1.0 + var / q2)

    def node(mi_row, mi_col, bsize):
        if mi_row >= mi_rows or mi_col >= mi_cols:
            return 0.0, []
        has_rows, has_cols = MI.partition_rule(
            bsize, mi_row, mi_col, mi_rows, mi_cols)
        forced = not (has_rows and has_cols)
        can_none = not forced and int(bsize) <= int(max_bs)
        can_split = int(bsize) > int(min_bs)
        if can_none and not can_split:
            return node_cost(mi_row, mi_col, bsize), [
                ("part", mi_row, mi_col, bsize, Partition.NONE),
                ("leaf", mi_row, mi_col, bsize, None)]
        if bsize == BlockSize.BLOCK_8X8:
            # 8x8 vs 4x4-bmi (one leaf, 4 sub-modes — no recursion)
            cost4 = 2 * split_bias
            for dr, dc in ((0, 0), (0, 1), (1, 0), (1, 1)):
                r4 = min(mi_row * 2 + dr * 1, v4.shape[0] - 1)
                c4 = min(mi_col * 2 + dc * 1, v4.shape[1] - 1)
                cost4 += 16 * np.log2(1.0 + v4[r4, c4] / q2)
            if can_none:
                cost8 = node_cost(mi_row, mi_col, bsize)
                if cost8 <= cost4:
                    return cost8, [
                        ("part", mi_row, mi_col, bsize, Partition.NONE),
                        ("leaf", mi_row, mi_col, bsize, None)]
            return cost4, [
                ("part", mi_row, mi_col, bsize, Partition.SPLIT),
                ("leaf", mi_row, mi_col, BlockSize.BLOCK_4X4, None)]
        sub = T.SUBSIZE[(Partition.SPLIT, bsize)]
        half = (1 << MI.MI_WIDTH_LOG2[bsize]) >> 1
        cost_split, sub_ev = 3 * split_bias, []
        for dr, dc in ((0, 0), (0, half), (half, 0), (half, half)):
            cst, ev = node(mi_row + dr, mi_col + dc, sub)
            cost_split += cst
            sub_ev.extend(ev)
        if can_none:
            cost_none = node_cost(mi_row, mi_col, bsize)
            if cost_none <= cost_split:
                return cost_none, [
                    ("part", mi_row, mi_col, bsize, Partition.NONE),
                    ("leaf", mi_row, mi_col, bsize, None)]
        return cost_split, ([("part", mi_row, mi_col, bsize,
                              Partition.SPLIT)] + sub_ev)

    events = []
    offs = tile_mi_offsets(mi_cols, log2_tile_cols)
    for t in range(len(offs) - 1):
        events.append(("tile", offs[t], offs[t + 1], None, None))
        for sb_r in range(0, mi_rows, 8):
            for sb_c in range(offs[t], offs[t + 1], 8):
                _, ev = node(sb_r, sb_c, BlockSize.BLOCK_64X64)
                events.extend(ev)
    return events


def _sub8x8_rc_steps(bsize: BlockSize):
    """bmi read/write order for a sub-8x8 block: [(j, num4w, num4h)]
    with j = idy*2 + idx (vp9 read_inter_block_mode_info loop)."""
    w, h = T.BLOCK_WH[bsize]
    num4w = 2 if w == 8 else 1
    num4h = 2 if h == 8 else 1
    return [(idy * 2 + idx, num4w, num4h)
            for idy in range(0, 2, num4h)
            for idx in range(0, 2, num4w)]


def plane_block_geometry(bsize: BlockSize, plane_ss: int):
    """(w4, h4): plane block size in 4px units."""
    w, h = T.BLOCK_WH[BlockSize(bsize)]
    return max(1, (w >> plane_ss) // 4), max(1, (h >> plane_ss) // 4)


def tx_blocks_of(bsize: BlockSize, tx: TxSize, plane_ss: int):
    """Yield (x4, y4) tx-block origins (4px units) raster within the block."""
    w4, h4 = plane_block_geometry(bsize, plane_ss)
    t4 = 1 << int(tx)
    for y4 in range(0, h4, t4):
        for x4 in range(0, w4, t4):
            yield x4, y4


def _visible(st: FrameState, plane_idx: int, mi_row: int, mi_col: int,
             x4: int, y4: int) -> bool:
    ss = st.planes[plane_idx].subsampling
    gx4 = ((mi_col * 2) >> ss) + x4
    gy4 = ((mi_row * 2) >> ss) + y4
    return gx4 < ((st.mi_cols * 2) >> ss) and gy4 < ((st.mi_rows * 2) >> ss)


def encode_tx_block_intra(st: FrameState, plane_idx: int, mode: IntraMode,
                          mi_row: int, mi_col: int, x4: int, y4: int,
                          tx: TxSize, tx_type: TxType, dc_q: int, ac_q: int,
                          block_w4: int, qbias: float = 0.38):
    """Predict + transform + quantize + reconstruct one tx block.

    Returns (levels, eob, dist).  Mutates the recon plane.
    """
    pl = st.planes[plane_idx]
    n = TX_PX[tx]
    ss = pl.subsampling
    px = ((mi_col * 8) >> ss) + x4 * 4
    py = ((mi_row * 8) >> ss) + y4 * 4
    have_above = py > 0
    have_left = px > ((st.tile_mi_start * 8) >> ss)
    have_right = (x4 + (1 << int(tx))) < block_w4
    above, al, left = intra_ops.build_ref_samples(
        pl.recon, px, py, n, pl.width, pl.height,
        have_above, have_left, have_right)
    pred = intra_ops.predict_block_full(
        mode, above, al, left, have_above, have_left, n)
    src = pl.source[py : py + n, px : px + n].astype(np.int32)
    resid = src - pred
    coeffs = txfm.fwd_txfm2d(resid[None], tx, tx_type)
    levels = txfm.quantize_block(coeffs, dc_q, ac_q, tx, bias=qbias)[0]
    deq = txfm.dequant_block(levels[None], dc_q, ac_q, tx)
    recon = txfm.inv_txfm_add(deq.astype(np.int64), pred[None], tx, tx_type)[0]
    pl.recon[py : py + n, px : px + n] = recon
    nz = np.nonzero(levels.reshape(-1)[T.scan_order(tx, tx_type)[0]])[0]
    eob = int(nz[-1]) + 1 if nz.size else 0
    dist = int(((recon.astype(np.int32) - src) ** 2).sum())
    return levels, eob, dist


def decide_block_mode(st: FrameState, mi_row: int, mi_col: int,
                      bsize: BlockSize, dc_q: int, ac_q: int):
    """Choose Y and UV intra modes by prediction SSE (open at tx granularity
    for multi-tx blocks: uses the first tx block's reference samples)."""
    pl = st.planes[0]
    w, h = T.BLOCK_WH[bsize]
    px, py = mi_col * 8, mi_row * 8
    n = min(w, h, 32)
    have_above, have_left = py > 0, px > st.tile_mi_start * 8
    above, al, left = intra_ops.build_ref_samples(
        pl.recon, px, py, n, pl.width, pl.height, have_above, have_left, False)
    preds = intra_ops.predict_all_modes(
        above[None], np.array([al]), left[None],
        np.array([have_above]), np.array([have_left]), n)[0]
    src = pl.source[py : py + n, px : px + n].astype(np.int32)
    sse = ((preds - src[None]) ** 2).sum(axis=(1, 2))
    y_mode = IntraMode(int(np.argmin(sse)))

    # UV: joint SSE over both chroma planes at chroma block size
    uv_bsize = T.CHROMA_BSIZE_420[bsize]
    cw, ch = T.BLOCK_WH[uv_bsize]
    cn = min(cw, ch, 32)
    usse = np.zeros(10, np.int64)
    for pidx in (1, 2):
        cpl = st.planes[pidx]
        cx, cy = px >> 1, py >> 1
        ha, hl = cy > 0, cx > 0
        a, c_al, l = intra_ops.build_ref_samples(
            cpl.recon, cx, cy, cn, cpl.width, cpl.height, ha, hl, False)
        cpreds = intra_ops.predict_all_modes(
            a[None], np.array([c_al]), l[None], np.array([ha]),
            np.array([hl]), cn)[0]
        csrc = cpl.source[cy : cy + cn, cx : cx + cn].astype(np.int32)
        usse += ((cpreds - csrc[None]) ** 2).sum(axis=(1, 2))
    uv_mode = IntraMode(int(np.argmin(usse)))
    return y_mode, uv_mode


def encode_leaf_sub8x8(st: FrameState, mi_row: int, mi_col: int,
                       qindex: int, qbias: float = 0.38):
    """Pass A for a BLOCK_4X4 leaf: per-4x4 mode search + recon in bmi
    order (b1's prediction sees b0's reconstruction, like the decoder)."""
    dc_q = T.dc_quant(qindex)
    ac_q = T.ac_quant(qindex)
    pl = st.planes[0]
    eff = BlockSize.BLOCK_8X8
    sub = []
    all_zero = True
    for x4, y4 in tx_blocks_of(eff, TxSize.TX_4X4, 0):
        if not _visible(st, 0, mi_row, mi_col, x4, y4):
            sub.append(int(IntraMode.DC_PRED))
            continue
        px = mi_col * 8 + x4 * 4
        py = mi_row * 8 + y4 * 4
        ha = py > 0
        hl = px > st.tile_mi_start * 8
        hr = (x4 + 1) < 2
        above, al, left = intra_ops.build_ref_samples(
            pl.recon, px, py, 4, pl.width, pl.height, ha, hl, hr)
        preds = intra_ops.predict_all_modes(
            above[None], np.array([al]), left[None], np.array([ha]),
            np.array([hl]), 4)[0]
        src = pl.source[py : py + 4, px : px + 4].astype(np.int32)
        sse = ((preds - src[None]) ** 2).sum(axis=(1, 2))
        mode = IntraMode(int(np.argmin(sse)))
        sub.append(int(mode))
        tt = MI.y_tx_type(mode, False, False, TxSize.TX_4X4)
        levels, eob, _ = encode_tx_block_intra(
            st, 0, mode, mi_row, mi_col, x4, y4, TxSize.TX_4X4, tt,
            dc_q, ac_q, 2, qbias)
        st.levels[(0, mi_row * 2 + y4, mi_col * 2 + x4)] = levels
        st.eobs[(0, mi_row * 2 + y4, mi_col * 2 + x4)] = eob
        all_zero &= eob == 0
    # uv at 4x4 (chroma of the 8x8 cell): best joint-SSE mode
    usse = np.zeros(10, np.int64)
    for pidx in (1, 2):
        cpl = st.planes[pidx]
        cx, cy = mi_col * 4, mi_row * 4
        ha, hl = cy > 0, cx > (st.tile_mi_start * 4)
        a, c_al, l = intra_ops.build_ref_samples(
            cpl.recon, cx, cy, 4, cpl.width, cpl.height, ha, hl, False)
        cpreds = intra_ops.predict_all_modes(
            a[None], np.array([c_al]), l[None], np.array([ha]),
            np.array([hl]), 4)[0]
        csrc = cpl.source[cy : cy + 4, cx : cx + 4].astype(np.int32)
        usse += ((cpreds - csrc[None]) ** 2).sum(axis=(1, 2))
    uv_mode = IntraMode(int(np.argmin(usse)))
    mi = MI.ModeInfo(bsize=BlockSize.BLOCK_4X4, y_mode=IntraMode(sub[3]),
                     uv_mode=uv_mode, tx_size=TxSize.TX_4X4, skip=False,
                     is_inter=False, sub_modes=tuple(sub))
    st.mig.set_block(mi_row, mi_col, BlockSize.BLOCK_4X4, mi)
    for pidx in (1, 2):
        for x4, y4 in tx_blocks_of(eff, TxSize.TX_4X4, 1):
            if not _visible(st, pidx, mi_row, mi_col, x4, y4):
                continue
            levels, eob, _ = encode_tx_block_intra(
                st, pidx, uv_mode, mi_row, mi_col, x4, y4, TxSize.TX_4X4,
                TxType.DCT_DCT, dc_q, ac_q, 1, qbias)
            st.levels[(pidx, mi_row + y4, mi_col + x4)] = levels
            st.eobs[(pidx, mi_row + y4, mi_col + x4)] = eob
            all_zero &= eob == 0
    mi.skip = all_zero


def encode_leaf(st: FrameState, mi_row: int, mi_col: int, bsize: BlockSize,
                qindex: int, qbias: float = 0.38, mode_hint=None):
    """Pass A for one leaf: decide modes, transform, recon, record."""
    if bsize == BlockSize.BLOCK_4X4:
        return encode_leaf_sub8x8(st, mi_row, mi_col, qindex, qbias)
    dc_q_y = T.dc_quant(qindex)
    ac_q_y = T.ac_quant(qindex)
    if mode_hint is not None:
        y_mode, uv_mode = mode_hint
    else:
        y_mode, uv_mode = decide_block_mode(st, mi_row, mi_col, bsize,
                                            dc_q_y, ac_q_y)
    y_tx = T.MAX_TX_SIZE[bsize]
    mi = MI.ModeInfo(bsize=bsize, y_mode=y_mode, uv_mode=uv_mode,
                     tx_size=y_tx, skip=False, is_inter=False)
    st.mig.set_block(mi_row, mi_col, bsize, mi)

    all_zero = True
    tx_type = MI.y_tx_type(y_mode, False, False, y_tx)
    w4y, _ = plane_block_geometry(bsize, 0)
    for x4, y4 in tx_blocks_of(bsize, y_tx, 0):
        if not _visible(st, 0, mi_row, mi_col, x4, y4):
            continue
        levels, eob, _ = encode_tx_block_intra(
            st, 0, y_mode, mi_row, mi_col, x4, y4, y_tx, tx_type,
            dc_q_y, ac_q_y, w4y, qbias)
        st.levels[(0, mi_row * 2 + y4, mi_col * 2 + x4)] = levels
        st.eobs[(0, mi_row * 2 + y4, mi_col * 2 + x4)] = eob
        all_zero &= eob == 0

    uv_tx = MI.uv_tx_size(bsize, y_tx)
    w4uv, _ = plane_block_geometry(bsize, 1)
    for pidx in (1, 2):
        for x4, y4 in tx_blocks_of(bsize, uv_tx, 1):
            if not _visible(st, pidx, mi_row, mi_col, x4, y4):
                continue
            levels, eob, _ = encode_tx_block_intra(
                st, pidx, uv_mode, mi_row, mi_col, x4, y4, uv_tx,
                TxType.DCT_DCT, dc_q_y, ac_q_y, w4uv, qbias)
            st.levels[(pidx, mi_row + y4, mi_col + x4)] = levels
            st.eobs[(pidx, mi_row + y4, mi_col + x4)] = eob
            all_zero &= eob == 0

    mi.skip = all_zero
    if mi.skip:
        pass  # recon already equals prediction (all eobs zero)


def new_counts_sink():
    """Empty symbol-count accumulator for forward prob updates."""
    return {
        **{("coef", ts): np.zeros((2, 2, 6, 6, 12), np.int64)
           for ts in TxSize},
        **{("eob", ts): np.zeros((2, 2, 6, 6), np.int64) for ts in TxSize},
        "skip": np.zeros((3, 2), np.int64),
    }


def _serialize_sub8x8_leaf(st, enc, mi, mi_row, mi_col, kf_y_probs,
                           kf_uv_probs, full_probs, planes_ctx,
                           counts_sink) -> None:
    """Write a BLOCK_4X4 keyframe leaf: 4 bmi sub-modes (chained
    above/left contexts per vp9_above/left_block_mode), one uv mode,
    tokens with the enclosing-8x8 geometry."""
    from tpu_vp9_torch.bitstream.tables import IntraMode

    above_mi = st.mig.above(mi_row, mi_col)
    left_mi = st.mig.left(mi_row, mi_col)
    sub = [int(s) for s in mi.sub_modes]
    for i in range(4):
        if i < 2:
            a = (MI._neighbor_sub_mode(above_mi, i + 2)
                 if above_mi is not None else IntraMode.DC_PRED)
        else:
            a = IntraMode(sub[i - 2])
        if i % 2 == 0:
            l = (MI._neighbor_sub_mode(left_mi, i + 1)
                 if left_mi is not None else IntraMode.DC_PRED)
        else:
            l = IntraMode(sub[i - 1])
        T.write_token(enc, "intra_mode_tree", kf_y_probs[int(a)][int(l)],
                      sub[i])
    T.write_token(enc, "intra_mode_tree", kf_uv_probs[sub[3]],
                  int(mi.uv_mode))
    eff = BlockSize.BLOCK_8X8
    if mi.skip:
        for pidx in (0, 1, 2):
            ss = st.planes[pidx].subsampling
            pc = planes_ctx[pidx]
            w4, h4 = plane_block_geometry(eff, ss)
            bx4 = (mi_col * 2) >> ss
            by4 = (mi_row * 2) >> ss
            pc.above[bx4 : bx4 + w4] = 0
            pc.left[by4 : by4 + h4] = 0
        return
    for i, (x4, y4) in enumerate(tx_blocks_of(eff, TxSize.TX_4X4, 0)):
        if not _visible(st, 0, mi_row, mi_col, x4, y4):
            continue
        tt = MI.y_tx_type(IntraMode(sub[i]), False, False, TxSize.TX_4X4)
        pc = planes_ctx[0]
        gx4 = mi_col * 2 + x4
        gy4 = mi_row * 2 + y4
        levels = st.levels[(0, gy4, gx4)]
        ctx0 = pc.get_ctx(gx4, gy4, TxSize.TX_4X4)
        cnt = ecnt = None
        if counts_sink is not None:
            cnt = counts_sink[("coef", TxSize.TX_4X4)][0, 0]
            ecnt = counts_sink[("eob", TxSize.TX_4X4)][0, 0]
        eob = tok.write_coeffs_any(enc, levels, TxSize.TX_4X4, tt,
                                   full_probs[(TxSize.TX_4X4, False)],
                                   ctx0, cnt, ecnt)
        pc.set_ctx(gx4, gy4, TxSize.TX_4X4, eob > 0, st.mi_cols * 2,
                   st.mi_rows * 2)
    for pidx in (1, 2):
        pc = planes_ctx[pidx]
        for x4, y4 in tx_blocks_of(eff, TxSize.TX_4X4, 1):
            if not _visible(st, pidx, mi_row, mi_col, x4, y4):
                continue
            gx4 = mi_col + x4
            gy4 = mi_row + y4
            levels = st.levels[(pidx, gy4, gx4)]
            ctx0 = pc.get_ctx(gx4, gy4, TxSize.TX_4X4)
            cnt = ecnt = None
            if counts_sink is not None:
                cnt = counts_sink[("coef", TxSize.TX_4X4)][1, 0]
                ecnt = counts_sink[("eob", TxSize.TX_4X4)][1, 0]
            eob = tok.write_coeffs_any(enc, levels, TxSize.TX_4X4,
                                       TxType.DCT_DCT,
                                       full_probs[(TxSize.TX_4X4, True)],
                                       ctx0, cnt, ecnt)
            pc.set_ctx(gx4, gy4, TxSize.TX_4X4, eob > 0, st.mi_cols,
                       st.mi_rows)


def serialize_frame(st: FrameState, events, qindex: int,
                    fc=None, counts_sink=None) -> bytes:
    """Pass B: write the single-tile bool partition.

    counts_sink: optional dict from new_counts_sink(); when provided,
    symbol counts are accumulated (used by the forward-update pass; the
    emitted bytes are then discarded).
    """
    if fc is None:
        fc = T.default_frame_context()
    from tpu_vp9_torch.native import make_bool_encoder

    tiles = []
    enc = None
    pctx = MI.PartitionContext(st.mi_rows, st.mi_cols)
    planes_ctx = None
    kf_part_probs = T.kf_partition_probs()
    kf_y_probs = T.kf_y_mode_probs()
    kf_uv_probs = T.kf_uv_mode_probs()
    full_probs = {
        (ts, uv): tok.full_probs_for(fc, ts, uv, is_inter=False)
        for ts in TxSize for uv in (False, True)
    }
    dc_q, ac_q = T.dc_quant(qindex), T.ac_quant(qindex)

    for ev, mi_row, mi_col, bsize, part in events:
        if ev == "tile":
            if enc is not None:
                tiles.append(enc.finalize())
            enc = make_bool_encoder()
            st.mig.tile_mi_start, st.mig.tile_mi_end = mi_row, mi_col
            # left contexts reset at each tile (entropy independence)
            pctx.left[:] = 0
            planes_ctx = [
                tok.PlaneContext(st.mi_cols, st.mi_rows, 0),
                tok.PlaneContext(st.mi_cols, st.mi_rows, 1),
                tok.PlaneContext(st.mi_cols, st.mi_rows, 1),
            ]
            continue
        if ev == "part":
            has_rows, has_cols = MI.partition_rule(
                bsize, mi_row, mi_col, st.mi_rows, st.mi_cols)
            ctx = pctx.ctx(mi_row, mi_col, bsize)
            MI.write_partition(enc, kf_part_probs[ctx], part,
                               has_rows, has_cols)
            if part != Partition.SPLIT or bsize == BlockSize.BLOCK_8X8:
                sub = T.SUBSIZE[(part, bsize)]
                pctx.update(mi_row, mi_col, sub, bsize)
            continue
        # leaf
        mi = st.mig.get(mi_row, mi_col)
        # skip flag
        sctx = MI.skip_ctx(st.mig, mi_row, mi_col)
        enc.put_bit(1 if mi.skip else 0, int(fc.skip_probs[sctx]))
        if counts_sink is not None:
            counts_sink["skip"][sctx, 1 if mi.skip else 0] += 1
        if bsize < BlockSize.BLOCK_8X8:
            _serialize_sub8x8_leaf(st, enc, mi, mi_row, mi_col, kf_y_probs,
                                   kf_uv_probs, full_probs, planes_ctx,
                                   counts_sink)
            continue
        # y mode (kf context from above/left neighbor modes)
        am = MI.kf_above_mode(st.mig, mi_row, mi_col)
        lm = MI.kf_left_mode(st.mig, mi_row, mi_col)
        T.write_token(enc, "intra_mode_tree", kf_y_probs[am][lm],
                      int(mi.y_mode))
        T.write_token(enc, "intra_mode_tree", kf_uv_probs[int(mi.y_mode)],
                      int(mi.uv_mode))
        # tokens
        y_tx = mi.tx_size
        uv_tx = MI.uv_tx_size(bsize, y_tx)
        if mi.skip:
            for pidx, txs in ((0, y_tx), (1, uv_tx), (2, uv_tx)):
                ss = st.planes[pidx].subsampling
                pc = planes_ctx[pidx]
                w4, h4 = plane_block_geometry(bsize, ss)
                bx4 = (mi_col * 2) >> ss
                by4 = (mi_row * 2) >> ss
                pc.above[bx4 : bx4 + w4] = 0
                pc.left[by4 : by4 + h4] = 0
            continue
        tx_type = MI.y_tx_type(mi.y_mode, False, False, y_tx)
        for pidx, txs, tt in ((0, y_tx, tx_type), (1, uv_tx, TxType.DCT_DCT),
                              (2, uv_tx, TxType.DCT_DCT)):
            ss = st.planes[pidx].subsampling
            pc = planes_ctx[pidx]
            probs = full_probs[(txs, pidx > 0)]
            for x4, y4 in tx_blocks_of(bsize, txs, ss):
                if not _visible(st, pidx, mi_row, mi_col, x4, y4):
                    continue
                gx4 = ((mi_col * 2) >> ss) + x4
                gy4 = ((mi_row * 2) >> ss) + y4
                if pidx == 0:
                    levels = st.levels[(0, mi_row * 2 + y4, mi_col * 2 + x4)]
                else:
                    levels = st.levels[(pidx, mi_row + y4, mi_col + x4)]
                ctx0 = pc.get_ctx(gx4, gy4, txs)
                cnt = ecnt = None
                if counts_sink is not None:
                    cnt = counts_sink[("coef", txs)][1 if pidx else 0, 0]
                    ecnt = counts_sink[("eob", txs)][1 if pidx else 0, 0]
                eob = tok.write_coeffs_any(enc, levels, txs, tt, probs, ctx0,
                                           cnt, ecnt)
                pc.set_ctx(gx4, gy4, txs, eob > 0,
                           (st.mi_cols * 2) >> ss, (st.mi_rows * 2) >> ss)
    tiles.append(enc.finalize())
    return pack_tiles(tiles)


def pack_tiles(tiles) -> bytes:
    """Concatenate tile partitions (4-byte big-endian size, last bare)."""
    out = bytearray()
    for i, t in enumerate(tiles):
        if i != len(tiles) - 1:
            out += len(t).to_bytes(4, "big")
        out += t
    return bytes(out)


def openloop_mode_hints_np(plane, n: int, qindex: int):
    """Open-loop keyframe mode hints for all nxn blocks.

    In the JAX package this is the numpy stand-in for
    ``pipeline/tpu_intra.decide_modes_openloop`` and is built from that
    module's helpers; the port has no ``tpu_intra`` yet, so the route is
    refused rather than silently encoded without hints."""
    raise NotImplementedError(
        "tpu_vp9_torch: the open-loop keyframe mode hints (tpu_intra) are "
        "not ported yet (ROADMAP.md Queue A item 10)")


def encode_keyframe_wavefront(st: FrameState, events, qindex: int,
                              block_size: BlockSize, y_hints,
                              qbias: float):
    """Pass A via anti-diagonal batching: blocks on one diagonal have all
    their above/left reference pixels reconstructed, so each diagonal is
    one batched predict+transform+recon step (the EncDec wavefront of
    SURVEY.md §2.7 without threads).

    Covers the aligned interior grid of `block_size` leaves; fringe
    leaves (forced splits at the bottom/right frame edge) are left to
    the sequential fallback — they only depend on above/left recon,
    which the wavefront completes first, and interior blocks never read
    fringe recon (cross-block above-right is never used, matching
    encode_tx_block_intra's have_right rule).

    Returns the set of handled (mi_row, mi_col) leaves, or None to
    request a full sequential pass.
    """
    if y_hints is None or y_hints.ndim != 2 or y_hints.size == 0:
        return None
    n = T.BLOCK_WH[block_size][0]
    mi_n = n // 8
    aligned, fringe = [], []
    for e in events:
        if e[0] != "leaf":
            continue
        if (e[3] == block_size and e[1] % mi_n == 0 and e[2] % mi_n == 0):
            aligned.append((e[1] // mi_n, e[2] // mi_n))
        else:
            fringe.append((e[1], e[2]))
    if not aligned:
        return None
    rows = max(r for r, _ in aligned) + 1
    cols = max(c for _, c in aligned) + 1
    if len(aligned) != rows * cols or len(set(aligned)) != len(aligned):
        return None  # not a dense grid (shouldn't happen with fixed walk)
    # fringe leaves must sit strictly below/right of the aligned region
    if any(mr < rows * mi_n and mc < cols * mi_n for mr, mc in fringe):
        return None
    hr, hc = y_hints.shape

    dc_q, ac_q = T.dc_quant(qindex), T.ac_quant(qindex)
    y_tx = T.MAX_TX_SIZE[block_size]
    uv_tx = MI.uv_tx_size(block_size, y_tx)
    uv_n = TX_PX[uv_tx]

    for r in range(rows):
        for c in range(cols):
            m = IntraMode(int(y_hints[min(r, hr - 1), min(c, hc - 1)]))
            mi = MI.ModeInfo(bsize=block_size, y_mode=m, uv_mode=m,
                             tx_size=y_tx, skip=False, is_inter=False)
            st.mig.set_block(r * mi_n, c * mi_n, block_size, mi)

    for d in range(rows + cols - 1):
        blocks = [(r, d - r) for r in range(max(0, d - cols + 1),
                                            min(rows, d + 1))]
        for pidx, txs, bn in ((0, y_tx, n), (1, uv_tx, uv_n),
                              (2, uv_tx, uv_n)):
            pl = st.planes[pidx]
            b = len(blocks)
            above = np.empty((b, 2 * bn), np.int32)
            left = np.empty((b, bn), np.int32)
            al = np.empty(b, np.int32)
            ha = np.empty(b, bool)
            hl = np.empty(b, bool)
            srcs = np.empty((b, bn, bn), np.int32)
            modes = np.empty(b, np.int32)
            for i, (r, c) in enumerate(blocks):
                px, py = c * bn, r * bn
                a, aal, l = intra_ops.build_ref_samples(
                    pl.recon, px, py, bn, pl.width, pl.height,
                    py > 0, px > 0, False)
                above[i], al[i], left[i] = a, aal, l
                ha[i], hl[i] = py > 0, px > 0
                srcs[i] = pl.source[py : py + bn, px : px + bn]
                modes[i] = int(y_hints[min(r, hr - 1), min(c, hc - 1)])
            preds = np.empty((b, bn, bn), np.int32)
            for m in set(modes.tolist()):
                sel = np.nonzero(modes == m)[0]
                preds[sel] = intra_ops.predict_mode_batch(
                    IntraMode(int(m)), above[sel], al[sel], left[sel],
                    ha[sel], hl[sel], bn)
            resid = srcs - preds
            tt_all = [MI.y_tx_type(IntraMode(int(m)), False, False, txs)
                      if pidx == 0 else TxType.DCT_DCT for m in modes]
            # group by tx_type for the batched transforms
            for tt in set(tt_all):
                idxs = [i for i, t in enumerate(tt_all) if t == tt]
                sel = np.asarray(idxs)
                coeffs = txfm.fwd_txfm2d(resid[sel], txs, tt)
                levels = txfm.quantize_block(coeffs, dc_q, ac_q, txs,
                                             bias=qbias)
                deq = txfm.dequant_block(levels, dc_q, ac_q, txs)
                recon = txfm.inv_txfm_add(deq.astype(np.int64), preds[sel],
                                          txs, tt)
                scan = T.scan_order(txs, tt)[0]
                lv_s = levels.reshape(levels.shape[0], -1)[:, scan]
                nz = lv_s != 0
                eobs = np.where(nz.any(axis=1),
                                bn * bn - np.argmax(nz[:, ::-1], axis=1), 0)
                for k, i in enumerate(idxs):
                    r, c = blocks[i]
                    px, py = c * bn, r * bn
                    pl.recon[py : py + bn, px : px + bn] = recon[k]
                    if pidx == 0:
                        key = (0, r * mi_n * 2, c * mi_n * 2)
                    else:
                        key = (pidx, r * mi_n, c * mi_n)
                    st.levels[key] = levels[k]
                    st.eobs[key] = int(eobs[k])
    # skip flags
    for r in range(rows):
        for c in range(cols):
            mi = st.mig.get(r * mi_n, c * mi_n)
            zero = (st.eobs[(0, r * mi_n * 2, c * mi_n * 2)] == 0
                    and st.eobs[(1, r * mi_n, c * mi_n)] == 0
                    and st.eobs[(2, r * mi_n, c * mi_n)] == 0)
            mi.skip = zero
            if zero:
                st.mig.f_skip[r * mi_n : r * mi_n + mi_n,
                              c * mi_n : c * mi_n + mi_n] = True
    return {(r * mi_n, c * mi_n) for r, c in aligned}


def encode_keyframe(frame, qindex: int, block_size=BlockSize.BLOCK_32X32,
                    qbias: float = 0.38, y_mode_hints=None,
                    prob_update: bool = True, log2_tile_cols: int = 0,
                    fc_base=None, open_loop_md: bool = False,
                    part_depths=None):
    """Encode one intra frame; returns (tile_bytes, FrameState).

    y_mode_hints: optional (R, C) array of IntraMode per target-size block
    (from the TPU open-loop analysis); edge/odd-size leaves fall back to
    the local search.  open_loop_md computes hints on the host when not
    supplied, enabling the wavefront-batched reconstruction pass.
    part_depths: (min_bs, max_bs) engages the variance-quadtree partition
    RDO instead of the fixed-size walk (quality presets).
    """
    h, w = frame.y.shape
    mi_rows, mi_cols = (h + 7) >> 3, (w + 7) >> 3
    st = make_frame_state(frame, mi_rows, mi_cols)
    if part_depths is not None:
        events = decide_partition_tree_intra(
            frame.y, mi_rows, mi_cols, qindex, part_depths[0],
            part_depths[1], log2_tile_cols)
        y_mode_hints = None  # hint grid is target-size based
    else:
        events = walk_partition_fixed(mi_rows, mi_cols, block_size,
                                      log2_tile_cols)
    n_px = T.BLOCK_WH[block_size][0]
    if (y_mode_hints is None and open_loop_md
            and w >= n_px and h >= n_px):
        y_mode_hints = openloop_mode_hints_np(frame.y, n_px, qindex)
    handled = None
    if y_mode_hints is not None and log2_tile_cols == 0:
        handled = encode_keyframe_wavefront(
            st, events, qindex, block_size, np.asarray(y_mode_hints), qbias)
    if handled is None:
        handled = set()
    for ev, mi_row, mi_col, bsize, _ in events:
        if ev == "tile":
            st.tile_mi_start = mi_row  # ('tile', start, end, ...)
            st.mig.tile_mi_start, st.mig.tile_mi_end = mi_row, mi_col
            continue
        if ev == "leaf" and (mi_row, mi_col) not in handled:
            hint = None
            if y_mode_hints is not None and bsize == block_size:
                br, bc = (mi_row * 8) // n_px, (mi_col * 8) // n_px
                hints = np.asarray(y_mode_hints)
                # clamp at the hint-grid edge (overhang rows/cols reuse
                # the nearest analyzed block's mode)
                m = IntraMode(int(hints[min(br, hints.shape[0] - 1),
                                        min(bc, hints.shape[1] - 1)]))
                hint = (m, m)
            encode_leaf(st, mi_row, mi_col, bsize, qindex, qbias, hint)
    if prob_update:
        from tpu_vp9_torch.codec.fwd_update import serialize_with_updates

        tile, st.header_updates, st.fc_final, st.counts = \
            serialize_with_updates(
            st, events, qindex, serialize_frame, fc_base)
    else:
        tile = serialize_frame(st, events, qindex, fc=fc_base)
        st.fc_final = fc_base
    return tile, st
