"""VP9 motion-vector reference derivation and MV entropy coding.

Parity reference: vendored libvpx ``vp9_mvref_common.{c,h}`` (candidate
scan, mode_context), ``vp9_entropymv.{c,h}`` + ``vp9_encodemv.c``
(joint/class/fp/hp coding) in SVT-VP9.  All rules must match any
conformant decoder bit-exactly.
"""

from __future__ import annotations

import numpy as np

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream.tables import BlockSize, RefFrame
from tpu_vp9_torch.codec import modeinfo as MI

MV_BORDER = 16 << 3  # 1/8-pel units
MAX_MV_REF_CANDIDATES = 2

# mode_2_counter[combined mode 0..13]
MODE_2_COUNTER = [9] * 10 + [0, 0, 3, 1]  # intra x10, NEAREST, NEAR, ZERO, NEW
COUNTER_TO_CONTEXT = [2, 3, 4, 1, 3, 9, 0, 9, 9, 5, 5, 9, 5, 9, 9, 9, 9, 9, 6]

MV_REF_BLOCKS = {
    BlockSize.BLOCK_4X4: [(-1, 0), (0, -1), (-1, -1), (-2, 0), (0, -2),
                          (-2, -1), (-1, -2), (-2, -2)],
    BlockSize.BLOCK_4X8: [(-1, 0), (0, -1), (-1, -1), (-2, 0), (0, -2),
                          (-2, -1), (-1, -2), (-2, -2)],
    BlockSize.BLOCK_8X4: [(-1, 0), (0, -1), (-1, -1), (-2, 0), (0, -2),
                          (-2, -1), (-1, -2), (-2, -2)],
    BlockSize.BLOCK_8X8: [(-1, 0), (0, -1), (-1, -1), (-2, 0), (0, -2),
                          (-2, -1), (-1, -2), (-2, -2)],
    BlockSize.BLOCK_8X16: [(0, -1), (-1, 0), (1, -1), (-1, -1), (0, -2),
                           (-2, 0), (-2, -1), (-1, -2)],
    BlockSize.BLOCK_16X8: [(-1, 0), (0, -1), (-1, 1), (-1, -1), (-2, 0),
                           (0, -2), (-1, -2), (-2, -1)],
    BlockSize.BLOCK_16X16: [(-1, 0), (0, -1), (-1, 1), (1, -1), (-1, -1),
                            (-3, 0), (0, -3), (-3, -3)],
    BlockSize.BLOCK_16X32: [(0, -1), (-1, 0), (2, -1), (-1, -1), (-1, 1),
                            (0, -3), (-3, 0), (-3, -3)],
    BlockSize.BLOCK_32X16: [(-1, 0), (0, -1), (-1, 2), (-1, -1), (1, -1),
                            (-3, 0), (0, -3), (-3, -3)],
    BlockSize.BLOCK_32X32: [(-1, 1), (1, -1), (-1, 2), (2, -1), (-1, -1),
                            (-3, 0), (0, -3), (-3, -3)],
    BlockSize.BLOCK_32X64: [(0, -1), (-1, 0), (4, -1), (-1, 2), (-1, -1),
                            (0, -3), (-3, 0), (2, -1)],
    BlockSize.BLOCK_64X32: [(-1, 0), (0, -1), (-1, 4), (2, -1), (-1, -1),
                            (-3, 0), (0, -3), (-1, 2)],
    BlockSize.BLOCK_64X64: [(-1, 3), (3, -1), (-1, 4), (4, -1), (-1, -1),
                            (-1, 0), (0, -1), (-1, 6)],
}


def combined_mode(mi: MI.ModeInfo) -> int:
    """Unified mode numbering: intra modes 0..9, inter 10..13."""
    if mi.is_inter:
        return 10 + int(mi.inter_mode)
    return int(mi.y_mode)


def _mb_edges(mi_row, mi_col, bsize, mi_rows, mi_cols):
    bw, bh = MI.BLOCK_MI_WH[BlockSize(bsize)]
    to_left = -(mi_col * 8) * 8
    to_right = ((mi_cols - bw - mi_col) * 8) * 8
    to_top = -(mi_row * 8) * 8
    to_bottom = ((mi_rows - bh - mi_row) * 8) * 8
    return to_left, to_right, to_top, to_bottom


def _clamp(mv, lo_col, hi_col, lo_row, hi_row):
    return (min(max(mv[0], lo_row), hi_row), min(max(mv[1], lo_col), hi_col))


# idx_n_column_to_subblock (vp9_mvref_common.c): which bmi entry of a
# sub-8x8 NEIGHBOR faces sub-block `block` of the current mi; second
# index: 1 when the candidate is in the same column (above/below),
# 0 when in the same row (left/right)
IDX_N_COLUMN_TO_SUBBLOCK = ((1, 2), (1, 3), (3, 2), (3, 3))


def _sub_block_mv(cand: MI.ModeInfo, which: int, search_col: int,
                  block_idx: int):
    """get_sub_block_mv: a sub-8x8 neighbor contributes the bmi MV of
    the sub-block facing us when scanning for a sub-block candidate."""
    if (block_idx >= 0 and cand.bsize < BlockSize.BLOCK_8X8
            and getattr(cand, "sub_mvs", ())):
        j = IDX_N_COLUMN_TO_SUBBLOCK[block_idx][1 if search_col == 0 else 0]
        return tuple(cand.sub_mvs[j][which])
    return cand.mv[which]


def find_mv_refs(mig: MI.ModeInfoGrid, mi_row: int, mi_col: int,
                 bsize: BlockSize, ref_frame: int,
                 tile_mi_col_start: int = 0, tile_mi_col_end: int = 1 << 30,
                 return_stable: bool = False, prev_mvs=None,
                 sign_bias=(0, 0, 0, 0), block_idx: int = -1):
    """Returns (mv_ref_list[2], mode_context[, stable_count]).

    prev_mvs: (ref0, ref1, mv0, mv1) grids of the previous decoded frame
    (ModeInfoGrid.snapshot_mvs) or None when use_prev_frame_mvs is off.
    sign_bias: per-ref-id sign biases indexed by RefFrame value (entry 0
    unused); candidates from a ref with a different bias are negated
    (spec scale_mv / vp9_mvref_common.h:139).

    stable_count = candidates found by the same-ref spatial scans, i.e.
    BEFORE the point where a conformant decoder would insert temporal
    (prev-frame) MVs.  For non-error-resilient streams the encoder must
    only rely on list entries below stable_count (the reference's
    restriction scheme, vp9_mvref_common.c:96: use_prev_frame_mvs
    early-outs) — entries past it can differ in decoders that track
    temporal MVs, which this implementation does not.
    """
    search = MV_REF_BLOCKS[BlockSize(bsize)]
    mv_list = []
    context_counter = 0
    different_ref_found = False
    this_bias = sign_bias[ref_frame]

    def inside(pos):
        r, c = mi_row + pos[0], mi_col + pos[1]
        return (r >= 0 and c >= tile_mi_col_start and r < mig.mi_rows
                and c < min(mig.mi_cols, tile_mi_col_end))

    def flip(mv, cand_ref):
        if sign_bias[cand_ref] != this_bias:
            return (-mv[0], -mv[1])
        return mv

    def add(mv):
        # ADD_MV_REF_LIST semantics: unique-2 early exit
        if mv_list:
            if mv != mv_list[0]:
                mv_list.append(mv)
                return True  # done
        else:
            mv_list.append(mv)
        return False

    done = False
    for i, pos in enumerate(search[:2]):
        if not inside(pos):
            continue
        cand = mig.grid[mi_row + pos[0], mi_col + pos[1]]
        context_counter += MODE_2_COUNTER[combined_mode(cand)]
        different_ref_found = True
        if cand.is_inter and cand.ref_frame[0] == ref_frame:
            if add(_sub_block_mv(cand, 0, pos[1], block_idx)):
                done = True
                break
        elif cand.is_inter and cand.ref_frame[1] == ref_frame:
            if add(_sub_block_mv(cand, 1, pos[1], block_idx)):
                done = True
                break
    if not done:
        for pos in search[2:]:
            if not inside(pos):
                continue
            cand = mig.grid[mi_row + pos[0], mi_col + pos[1]]
            different_ref_found = True
            if cand.is_inter and cand.ref_frame[0] == ref_frame:
                if add(cand.mv[0]):
                    done = True
                    break
            elif cand.is_inter and cand.ref_frame[1] == ref_frame:
                if add(cand.mv[1]):
                    done = True
                    break
    stable_count = len(mv_list)  # decoder inserts temporal MVs after here
    # temporal pass 1: same-ref MV of the co-located prev-frame MV_REF
    # (use_prev_frame_mvs)
    if not done and prev_mvs is not None:
        pref0, pref1, pmv0, pmv1 = prev_mvs
        if pref0[mi_row, mi_col] == ref_frame:
            if add((int(pmv0[mi_row, mi_col, 0]),
                    int(pmv0[mi_row, mi_col, 1]))):
                done = True
        elif pref1[mi_row, mi_col] == ref_frame:
            if add((int(pmv1[mi_row, mi_col, 0]),
                    int(pmv1[mi_row, mi_col, 1]))):
                done = True
    if not done and different_ref_found:
        # different-ref pass with sign-bias scaling
        # (IF_DIFF_REF_FRAME_ADD_MV, vp9_mvref_common.h:166)
        for pos in search:
            if not inside(pos):
                continue
            cand = mig.grid[mi_row + pos[0], mi_col + pos[1]]
            if cand.is_inter:
                if cand.ref_frame[0] != ref_frame:
                    if add(flip(cand.mv[0], cand.ref_frame[0])):
                        done = True
                        break
                if (cand.ref_frame[1] > 0 and cand.ref_frame[1] != ref_frame
                        and cand.mv[1] != cand.mv[0]):
                    if add(flip(cand.mv[1], cand.ref_frame[1])):
                        done = True
                        break

    # temporal pass 2: different-ref MVs of the co-located prev-frame
    # MV_REF, sign-bias scaled
    if not done and prev_mvs is not None:
        pref0, pref1, pmv0, pmv1 = prev_mvs
        p0 = int(pref0[mi_row, mi_col])
        if p0 != ref_frame and p0 > 0:
            mv0 = (int(pmv0[mi_row, mi_col, 0]), int(pmv0[mi_row, mi_col, 1]))
            if add(flip(mv0, p0)):
                done = True
        if not done:
            p1 = int(pref1[mi_row, mi_col])
            mv0 = (int(pmv0[mi_row, mi_col, 0]), int(pmv0[mi_row, mi_col, 1]))
            mv1 = (int(pmv1[mi_row, mi_col, 0]), int(pmv1[mi_row, mi_col, 1]))
            if p1 > 0 and p1 != ref_frame and mv1 != mv0:
                add(flip(mv1, p1))

    while len(mv_list) < MAX_MV_REF_CANDIDATES:
        mv_list.append((0, 0))
    mode_context = COUNTER_TO_CONTEXT[context_counter]
    # clamp_mv_ref
    tl, tr, tt, tb = _mb_edges(mi_row, mi_col, bsize, mig.mi_rows, mig.mi_cols)
    mv_list = [
        _clamp(mv, tl - MV_BORDER, tr + MV_BORDER, tt - MV_BORDER,
               tb + MV_BORDER)
        for mv in mv_list
    ]
    if return_stable:
        return mv_list, mode_context, stable_count
    return mv_list, mode_context


def append_sub8x8_mvs(mig: MI.ModeInfoGrid, mi_row: int, mi_col: int,
                      bsize: BlockSize, ref_frame: int, block: int,
                      bmi_mvs, tile_mi_col_start: int = 0,
                      tile_mi_col_end: int = 1 << 30, prev_mvs=None,
                      sign_bias=(0, 0, 0, 0)):
    """(nearest, near) for sub-block `block` of a sub-8x8 mi
    (vp9_append_sub8x8_mvs_for_idx): earlier sub-blocks' MVs lead the
    candidate list, then the block-level scan (which itself extracts
    facing bmi entries from sub-8x8 neighbours).  bmi_mvs: this mi's
    already-decided sub MVs indexed 0..3 (for this ref).  NOTE: unlike
    find_best_ref_mvs, the results are NOT precision-lowered."""
    mv_list, _ = find_mv_refs(
        mig, mi_row, mi_col, bsize, ref_frame, tile_mi_col_start,
        tile_mi_col_end, prev_mvs=prev_mvs, sign_bias=sign_bias,
        block_idx=block)
    if block == 0:
        return tuple(mv_list[0]), tuple(mv_list[1])
    if block in (1, 2):
        cands = [tuple(bmi_mvs[0]), tuple(mv_list[0]), tuple(mv_list[1])]
    else:
        cands = [tuple(bmi_mvs[2]), tuple(bmi_mvs[1]), tuple(bmi_mvs[0]),
                 tuple(mv_list[0]), tuple(mv_list[1])]
    nearest = cands[0]
    near = (0, 0)
    for c in cands[1:]:
        if c != nearest:
            near = c
            break
    return nearest, near


def mi_mv_pred_q4(bmi_mvs):
    """Chroma (420) MV for a sub-8x8 mi: rounded average of the 4 sub
    MVs (vp9_reconinter.c mi_mv_pred_q4 / round_mv_comp_q4)."""

    def rnd(v):
        # C truncating division of (v +- 2) / 4
        s = v - 2 if v < 0 else v + 2
        return -((-s) // 4) if s < 0 else s // 4

    sr = sum(m[0] for m in bmi_mvs)
    sc = sum(m[1] for m in bmi_mvs)
    return (rnd(sr), rnd(sc))


def use_mv_hp(ref_mv) -> bool:
    COMPANDED_MVREF_THRESH = 8
    return (abs(ref_mv[0]) >> 3) < COMPANDED_MVREF_THRESH and \
           (abs(ref_mv[1]) >> 3) < COMPANDED_MVREF_THRESH


def lower_mv_precision(mv, allow_hp: bool):
    row, col = mv
    if not (allow_hp and use_mv_hp(mv)):
        if row & 1:
            row += -1 if row > 0 else 1
        if col & 1:
            col += -1 if col > 0 else 1
    return (row, col)


LEFT_TOP_MARGIN = (160 - 4) << 3  # VP9_ENC_BORDER_IN_PIXELS=160, INTERP_EXTEND=4
RIGHT_BOTTOM_MARGIN = (160 - 4) << 3


def find_best_ref_mvs(mv_list, allow_hp: bool, mi_row, mi_col, bsize,
                      mi_rows, mi_cols):
    """lower precision + clamp_mv2; returns (nearest, near)."""
    tl, tr, tt, tb = _mb_edges(mi_row, mi_col, bsize, mi_rows, mi_cols)
    out = []
    for mv in mv_list:
        mv = lower_mv_precision(mv, allow_hp)
        mv = _clamp(mv, tl - LEFT_TOP_MARGIN, tr + RIGHT_BOTTOM_MARGIN,
                    tt - LEFT_TOP_MARGIN, tb + RIGHT_BOTTOM_MARGIN)
        out.append(mv)
    return out[0], out[1]


# ---------------------------------------------------------------------------
# MV entropy coding
# ---------------------------------------------------------------------------


def _mv_class(z: int):
    """(class, offset) for magnitude-1 value z (eb_vp9_get_mv_class)."""
    if z >= 2 * 4096:
        c = 10
    else:
        n = z >> 3
        c = n.bit_length() - 1 if n > 0 else 0
    base = 0 if c == 0 else 2 << (c + 2)
    return c, z - base


def _write_mv_component(enc, comp: int, ctx, usehp: bool) -> None:
    sign = 1 if comp < 0 else 0
    mag = -comp if sign else comp
    z = mag - 1
    c, offset = _mv_class(z)
    d = offset >> 3
    fr = (offset >> 1) & 3
    hp = offset & 1
    enc.put_bit(sign, int(ctx.sign))
    T.write_token(enc, "mv_class_tree", ctx.classes, c)
    if c == 0:
        enc.put_bit(d, int(ctx.class0[0]))
    else:
        n = c + 1 - 1  # CLASS0_BITS - 1 + c
        for i in range(n):
            enc.put_bit((d >> i) & 1, int(ctx.bits[i]))
    fp_probs = ctx.class0_fp[d] if c == 0 else ctx.fp
    T.write_token(enc, "mv_fp_tree", fp_probs, fr)
    if usehp:
        enc.put_bit(hp, int(ctx.class0_hp if c == 0 else ctx.hp))


def write_mv(enc, mv, ref_mv, nmv, allow_hp: bool) -> None:
    """Encode mv given its reference (best) mv."""
    diff = (mv[0] - ref_mv[0], mv[1] - ref_mv[1])
    usehp = allow_hp and use_mv_hp(ref_mv)
    joint = (1 if diff[1] else 0) | (2 if diff[0] else 0)
    T.write_token(enc, "mv_joint_tree", nmv.joints, joint)
    if diff[0]:
        _write_mv_component(enc, diff[0], nmv.comps[0], usehp)
    if diff[1]:
        _write_mv_component(enc, diff[1], nmv.comps[1], usehp)


def _read_mv_component(dec, ctx, usehp: bool) -> int:
    sign = dec.read_bit(int(ctx.sign))
    c = T.read_token(dec, "mv_class_tree", ctx.classes)
    if c == 0:
        d = dec.read_bit(int(ctx.class0[0]))
    else:
        d = 0
        for i in range(c):
            d |= dec.read_bit(int(ctx.bits[i])) << i
    fp_probs = ctx.class0_fp[d] if c == 0 else ctx.fp
    fr = T.read_token(dec, "mv_fp_tree", fp_probs)
    if usehp:
        hp = dec.read_bit(int(ctx.class0_hp if c == 0 else ctx.hp))
    else:
        hp = 1
    base = 0 if c == 0 else 2 << (c + 2)
    mag = base + ((d << 3) | (fr << 1) | hp) + 1
    return -mag if sign else mag


def read_mv(dec, ref_mv, nmv, allow_hp: bool):
    usehp = allow_hp and use_mv_hp(ref_mv)
    joint = T.read_token(dec, "mv_joint_tree", nmv.joints)
    drow = _read_mv_component(dec, nmv.comps[0], usehp) if joint & 2 else 0
    dcol = _read_mv_component(dec, nmv.comps[1], usehp) if joint & 1 else 0
    return (ref_mv[0] + drow, ref_mv[1] + dcol)
