"""Inter (P) frame encoder — host oracle path.

Single-reference (LAST) low-delay P frames: per-block candidate search
over {NEARESTMV, NEARMV, ZEROMV, NEWMV(ME), intra DC} with exact MC
prediction, then conformant serialization.  Parity reference for the
syntax: vendored libvpx ``vp9_bitstream.c`` pack_inter_mode_mvs in
SVT-VP9; candidate structure mirrors ``EbModeDecision.c`` candidate
injection, re-expressed per SURVEY.md §7.

MVs use q3 (1/8 luma pel) units everywhere.
"""

from __future__ import annotations

import numpy as np

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream import tokenize as tok
from tpu_vp9_torch.bitstream.bool_coder import BoolEncoder
from tpu_vp9_torch.bitstream.tables import (
    BlockSize, IntraMode, Partition, RefFrame, TxSize, TxType,
)
from tpu_vp9_torch.codec import modeinfo as MI
from tpu_vp9_torch.codec import mv as MV
from tpu_vp9_torch.codec.intra_frame import (
    TX_PX, FrameState, _visible, encode_tx_block_intra, make_frame_state,
    plane_block_geometry, tx_blocks_of, walk_partition_fixed,
)
from tpu_vp9_torch.ops import hme as hme_ops
from tpu_vp9_torch.ops import inter as inter_ops
from tpu_vp9_torch.ops import me as me_ops
from tpu_vp9_torch.ops import txfm
from tpu_vp9_torch.ops.inter import BORDER
from tpu_vp9_torch.pipeline.tpu_me import tpu_block_motion


def intra_inter_ctx(mig: MI.ModeInfoGrid, mi_row: int, mi_col: int) -> int:
    a = mig.above(mi_row, mi_col)
    l = mig.left(mi_row, mi_col)
    if a is not None and l is not None:
        ai, li = not a.is_inter, not l.is_inter
        return 3 if (ai and li) else int(ai or li)
    if a is not None or l is not None:
        e = a if a is not None else l
        return 2 * int(not e.is_inter)
    return 0


def _has2(mi) -> bool:
    return mi.is_inter and mi.ref_frame[1] > 0


def compound_refs(sign_bias) -> tuple:
    """(fixed_ref, (var_ref0, var_ref1)) from the header sign biases
    (eb_vp9_setup_compound_reference_mode, vp9_pred_common.c:25)."""
    LAST, GOLDEN, ALT = (int(RefFrame.LAST), int(RefFrame.GOLDEN),
                         int(RefFrame.ALTREF))
    if sign_bias[LAST] == sign_bias[GOLDEN]:
        return ALT, (LAST, GOLDEN)
    if sign_bias[LAST] == sign_bias[ALT]:
        return GOLDEN, (LAST, ALT)
    return LAST, (GOLDEN, ALT)


def comp_inter_ctx(mig: MI.ModeInfoGrid, mi_row: int, mi_col: int,
                   fixed_ref: int) -> int:
    """Reference-mode (single vs compound) bit context
    (eb_vp9_get_reference_mode_context, vp9_pred_common.c:41)."""
    a = mig.above(mi_row, mi_col)
    l = mig.left(mi_row, mi_col)
    if a is not None and l is not None:
        if not _has2(a) and not _has2(l):
            return (int(a.ref_frame[0] == fixed_ref)
                    ^ int(l.ref_frame[0] == fixed_ref))
        if not _has2(a):
            return 2 + int(a.ref_frame[0] == fixed_ref or not a.is_inter)
        if not _has2(l):
            return 2 + int(l.ref_frame[0] == fixed_ref or not l.is_inter)
        return 4
    if a is not None or l is not None:
        edge = a if a is not None else l
        if not _has2(edge):
            return int(edge.ref_frame[0] == fixed_ref)
        return 3
    return 1


def comp_ref_ctx(mig: MI.ModeInfoGrid, mi_row: int, mi_col: int,
                 sign_bias) -> int:
    """Compound variable-ref bit context
    (eb_vp9_get_pred_context_comp_ref_p, vp9_pred_common.c:81)."""
    fixed_ref, var_refs = compound_refs(sign_bias)
    var_idx = 0 if sign_bias[fixed_ref] else 1  # !fix_ref_idx
    a = mig.above(mi_row, mi_col)
    l = mig.left(mi_row, mi_col)
    v1 = var_refs[1]
    if a is not None and l is not None:
        ai, li = not a.is_inter, not l.is_inter
        if ai and li:
            return 2
        if ai or li:
            edge = l if ai else a
            if not _has2(edge):
                return 1 + 2 * int(edge.ref_frame[0] != v1)
            return 1 + 2 * int(edge.ref_frame[var_idx] != v1)
        a_sg, l_sg = not _has2(a), not _has2(l)
        vrfa = a.ref_frame[0] if a_sg else a.ref_frame[var_idx]
        vrfl = l.ref_frame[0] if l_sg else l.ref_frame[var_idx]
        if vrfa == vrfl and v1 == vrfa:
            return 0
        if l_sg and a_sg:
            if ((vrfa == fixed_ref and vrfl == var_refs[0])
                    or (vrfl == fixed_ref and vrfa == var_refs[0])):
                return 4
            return 3 if vrfa == vrfl else 1
        if l_sg or a_sg:
            vrfc = vrfa if l_sg else vrfl
            rfs = vrfa if a_sg else vrfl
            if vrfc == v1 and rfs != v1:
                return 1
            if rfs == v1 and vrfc != v1:
                return 2
            return 4
        return 4 if vrfa == vrfl else 2
    if a is not None or l is not None:
        edge = a if a is not None else l
        if not edge.is_inter:
            return 2
        if _has2(edge):
            return 4 * int(edge.ref_frame[var_idx] != v1)
        return 3 * int(edge.ref_frame[0] != v1)
    return 2


def single_ref_p2_ctx(mig: MI.ModeInfoGrid, mi_row: int, mi_col: int) -> int:
    """GOLDEN vs ALTREF bit context, compound-aware
    (eb_vp9_get_pred_context_single_ref_p2, vp9_pred_common.c:224)."""
    a = mig.above(mi_row, mi_col)
    l = mig.left(mi_row, mi_col)
    LAST, GOLDEN, ALT = (int(RefFrame.LAST), int(RefFrame.GOLDEN),
                         int(RefFrame.ALTREF))
    if a is not None and l is not None:
        ai, li = not a.is_inter, not l.is_inter
        if ai and li:
            return 2
        if ai or li:
            edge = l if ai else a
            if not _has2(edge):
                if edge.ref_frame[0] == LAST:
                    return 3
                return 4 * int(edge.ref_frame[0] == GOLDEN)
            return 1 + 2 * int(edge.ref_frame[0] == GOLDEN
                               or edge.ref_frame[1] == GOLDEN)
        a2, l2 = _has2(a), _has2(l)
        a0, a1 = a.ref_frame
        l0, l1 = l.ref_frame
        if a2 and l2:
            if a0 == l0 and a1 == l1:
                return 3 * int(a0 == GOLDEN or a1 == GOLDEN
                               or l0 == GOLDEN or l1 == GOLDEN)
            return 2
        if a2 or l2:
            rfs = a0 if not a2 else l0
            crf1 = a0 if a2 else l0
            crf2 = a1 if a2 else l1
            if rfs == GOLDEN:
                return 3 + int(crf1 == GOLDEN or crf2 == GOLDEN)
            if rfs == ALT:
                return int(crf1 == GOLDEN or crf2 == GOLDEN)
            return 1 + 2 * int(crf1 == GOLDEN or crf2 == GOLDEN)
        if a0 == LAST and l0 == LAST:
            return 3
        if a0 == LAST or l0 == LAST:
            edge0 = l0 if a0 == LAST else a0
            return 4 * int(edge0 == GOLDEN)
        return 2 * int(a0 == GOLDEN) + 2 * int(l0 == GOLDEN)
    if a is not None or l is not None:
        edge = a if a is not None else l
        if (not edge.is_inter
                or (edge.ref_frame[0] == LAST and not _has2(edge))):
            return 2
        if not _has2(edge):
            return 4 * int(edge.ref_frame[0] == GOLDEN)
        return 3 * int(edge.ref_frame[0] == GOLDEN
                       or edge.ref_frame[1] == GOLDEN)
    return 2


def single_ref_p1_ctx(mig: MI.ModeInfoGrid, mi_row: int, mi_col: int) -> int:
    """not-LAST bit context, compound-aware
    (eb_vp9_get_pred_context_single_ref_p1, vp9_pred_common.c:158)."""
    a = mig.above(mi_row, mi_col)
    l = mig.left(mi_row, mi_col)
    LAST = int(RefFrame.LAST)
    if a is not None and l is not None:
        ai, li = not a.is_inter, not l.is_inter
        if ai and li:
            return 2
        if ai or li:
            edge = l if ai else a
            if not _has2(edge):
                return 4 * int(edge.ref_frame[0] == LAST)
            return 1 + int(edge.ref_frame[0] == LAST
                           or edge.ref_frame[1] == LAST)
        a2, l2 = _has2(a), _has2(l)
        a0, a1 = a.ref_frame
        l0, l1 = l.ref_frame
        if a2 and l2:
            return 1 + int(a0 == LAST or a1 == LAST
                           or l0 == LAST or l1 == LAST)
        if a2 or l2:
            rfs = a0 if not a2 else l0
            crf1 = a0 if a2 else l0
            crf2 = a1 if a2 else l1
            if rfs == LAST:
                return 3 + int(crf1 == LAST or crf2 == LAST)
            return int(crf1 == LAST or crf2 == LAST)
        return 2 * int(a0 == LAST) + 2 * int(l0 == LAST)
    if a is not None or l is not None:
        edge = a if a is not None else l
        if not edge.is_inter:
            return 2
        if not _has2(edge):
            return 4 * int(edge.ref_frame[0] == LAST)
        return 1 + int(edge.ref_frame[0] == LAST
                       or edge.ref_frame[1] == LAST)
    return 2


def predict_inter_planes(st: FrameState, refs, mi_row: int, mi_col: int,
                         bsize: BlockSize, mv_q3, refs2=None, mv2_q3=None):
    """MC prediction for Y/U/V; returns list of (pred, px, py).

    refs2/mv2_q3: second (compound) reference — predictions averaged
    with spec rounding (vp9_reconinter convolve_avg semantics)."""
    out = []
    for pidx in range(3):
        ss = st.planes[pidx].subsampling
        w, h = T.BLOCK_WH[bsize]
        bw, bh = w >> ss, h >> ss
        pred = inter_ops.predict_inter_block(
            refs[pidx], mi_row, mi_col, 0, 0, bw, bh, mv_q3, ss,
            st.mi_rows, st.mi_cols)
        if refs2 is not None:
            pred2 = inter_ops.predict_inter_block(
                refs2[pidx], mi_row, mi_col, 0, 0, bw, bh, mv2_q3, ss,
                st.mi_rows, st.mi_cols)
            pred = ((pred.astype(np.uint16) + pred2.astype(np.uint16) + 1)
                    >> 1).astype(np.uint8)
        px = (mi_col * 8) >> ss
        py = (mi_row * 8) >> ss
        out.append((pred, px, py))
    return out


def encode_tx_block_inter(st: FrameState, plane_idx: int, pred_full,
                          mi_row: int, mi_col: int, x4: int, y4: int,
                          tx: TxSize, dc_q: int, ac_q: int,
                          qbias: float = 0.38):
    """Transform/quant/recon one tx block given the MC prediction."""
    pl = st.planes[plane_idx]
    n = TX_PX[tx]
    ss = pl.subsampling
    px = ((mi_col * 8) >> ss) + x4 * 4
    py = ((mi_row * 8) >> ss) + y4 * 4
    pred = pred_full[y4 * 4 : y4 * 4 + n, x4 * 4 : x4 * 4 + n].astype(np.int32)
    src = pl.source[py : py + n, px : px + n].astype(np.int32)
    resid = src - pred
    coeffs = txfm.fwd_txfm2d(resid[None], tx, TxType.DCT_DCT)
    levels = txfm.quantize_block(coeffs, dc_q, ac_q, tx, bias=qbias)[0]
    deq = txfm.dequant_block(levels[None], dc_q, ac_q, tx)
    recon = txfm.inv_txfm_add(deq.astype(np.int64), pred[None], tx,
                              TxType.DCT_DCT)[0]
    pl.recon[py : py + n, px : px + n] = recon
    nz = np.nonzero(levels.reshape(-1)[T.scan_order(tx, TxType.DCT_DCT)[0]])[0]
    eob = int(nz[-1]) + 1 if nz.size else 0
    return levels, eob


def probe_inter_cost(st: FrameState, refs, mi_row: int, mi_col: int,
                     bsize: BlockSize, search_range: int = 16,
                     center=(0, 0)):
    """Cheap open-loop cost probe: full-pel ME best SAD (no commit).

    Returns (sad, (dy, dx)) and caches the result for reuse by the full
    decision (the ADP budget probe of SURVEY.md §2.3 kernel 9, re-expressed
    as cost probes instead of depth budgets).
    """
    key = (mi_row, mi_col, int(bsize))
    cache = getattr(st, "_probe_cache", None)
    if cache is None:
        cache = st._probe_cache = {}
    if key in cache:
        return cache[key]
    pl = st.planes[0]
    w, h = T.BLOCK_WH[bsize]
    px, py = mi_col * 8, mi_row * 8
    src = pl.source[py : py + h, px : px + w]
    dy, dx, sad = me_ops.full_pel_search(
        src, refs[0], px, py, BORDER, search_range, center)
    # ZERO-mv guard: motion fields prefer consistency
    zsad = int(np.abs(
        refs[0][BORDER + py : BORDER + py + h,
                BORDER + px : BORDER + px + w].astype(np.int32)
        - src.astype(np.int32)).sum())
    if zsad <= sad:
        dy = dx = 0
        sad = zsad
    out = (sad, (dy, dx))
    cache[key] = out
    return out


def derive_sb_probe_budget(costs: dict, budget_frac: float):
    """Per-SB compute-budget derivation (the ADP budget of
    ``eb_vp9_derive_optimal_budget_per_sb``,
    EbModeDecisionConfigurationProcess.c:1199, re-expressed as a mask):
    rank the parent-block probe costs and grant the expensive split
    probes only to the costliest ``budget_frac`` of blocks — cheap
    (well-predicted) blocks keep the parent size without paying child
    searches.  Returns the set of granted (mi_row, mi_col)."""
    if budget_frac >= 1.0 or not costs:
        return set(costs)
    vals = np.asarray(sorted(costs.values()))
    k = max(1, int(round(len(vals) * budget_frac)))
    thr = vals[len(vals) - k]
    return {key for key, v in costs.items() if v >= thr}


def decide_partition_map(st: FrameState, refs, events, qindex: int,
                         search_range: int = 16, budget_frac: float = 1.0):
    """Refine the fixed-size event list: split 32x32 nodes into 16x16
    where the children's total SAD (plus an overhead penalty) wins.

    Open-loop: probes use full-pel ME only.  budget_frac < 1 engages the
    per-SB ADP budget: only the costliest fraction of parents pay the
    child probes.  Returns a new event list.
    """
    # ~40 bits of extra syntax per split, at sad-per-bit ~ ac_q/16
    # (libvpx sad_per_bit16lut scale)
    split_bias = max(8, (40 * T.ac_quant(qindex)) >> 4)
    granted = None
    if budget_frac < 1.0:
        parent_costs = {}
        for ev in events:
            if (ev[0] == "part" and ev[3] == BlockSize.BLOCK_32X32
                    and ev[4] == Partition.NONE):
                _, r, c, bs, _ = ev
                s, _ = probe_inter_cost(st, refs, r, c, bs, search_range)
                parent_costs[(r, c)] = s
        granted = derive_sb_probe_budget(parent_costs, budget_frac)
    out = []
    i = 0
    while i < len(events):
        ev = events[i]
        if (ev[0] == "part" and ev[3] == BlockSize.BLOCK_32X32
                and ev[4] == Partition.NONE
                and i + 1 < len(events) and events[i + 1][0] == "leaf"
                and (granted is None or (ev[1], ev[2]) in granted)):
            _, mi_row, mi_col, bsize, _ = ev
            sad32, mv32 = probe_inter_cost(st, refs, mi_row, mi_col, bsize,
                                           search_range)
            child_sum = 0
            children = []
            for dr, dc in ((0, 0), (0, 2), (2, 0), (2, 2)):
                r, c = mi_row + dr, mi_col + dc
                if r >= st.mi_rows or c >= st.mi_cols:
                    continue
                # children refine around the parent's motion (cheap)
                s16, _ = probe_inter_cost(st, refs, r, c,
                                          BlockSize.BLOCK_16X16,
                                          8, mv32)
                child_sum += s16
                children.append((r, c))
            if child_sum + split_bias < sad32:
                out.append(("part", mi_row, mi_col, bsize, Partition.SPLIT))
                for r, c in children:
                    out.append(("part", r, c, BlockSize.BLOCK_16X16,
                                Partition.NONE))
                    out.append(("leaf", r, c, BlockSize.BLOCK_16X16, None))
                i += 2
                continue
        out.append(ev)
        i += 1
    return out


def _batch_probe_tree(st: FrameState, refs, search_range: int,
                      min_bs: BlockSize, max_bs: BlockSize,
                      mi_rows: int, mi_cols: int):
    """Pre-fill the probe caches for the whole partition quadtree with
    ONE native batched-search call per tree level (plus one for the
    rect/sub-8x8 probes of each level) — the per-probe ctypes round
    trips were the top wall-time of the M0-M4 descent (~17k calls per
    CIF frame).  Centers replicate decide_partition_tree's recursion
    (children and rect halves search around the parent's winner), so
    the descent below consumes identical results; any cache miss just
    falls back to the per-call path."""
    from tpu_vp9_torch.native import native_sad_search_batch

    cache = getattr(st, "_probe_cache", None)
    if cache is None:
        cache = st._probe_cache = {}
    sub_cache = st._sub8_cache = {}
    pl = st.planes[0]
    src_plane = pl.source
    ref = refs[0]
    if native_sad_search_batch(src_plane[:8, :8], ref, BORDER,
                               np.zeros((0, 8), np.int32)) is None:
        return  # native library unavailable: per-call fallback

    def run(jobs, metas, target):
        if not jobs:
            return
        out = native_sad_search_batch(src_plane, ref, BORDER,
                                      np.asarray(jobs, np.int32))
        if out is None:
            return
        for (key, px, py), (dy, dx, sad) in zip(metas, out):
            target[key] = (int(sad), (int(dy), int(dx)))

    import os as _os

    no_sub8 = (_os.environ.get("TPU_VP9_NO_SUB8X8") == "1"
               or (int(min_bs) >= int(BlockSize.BLOCK_8X8))
               or (getattr(st, "_restrict_mv", False)
                   and getattr(st, "_prev_mvs", None) is None))
    level_bs = [BlockSize.BLOCK_64X64, BlockSize.BLOCK_32X32,
                BlockSize.BLOCK_16X16, BlockSize.BLOCK_8X8]
    nodes = [(r0, c0) for r0 in range(0, mi_rows, 8)
             for c0 in range(0, mi_cols, 8)]
    centers = {n: (0, 0) for n in nodes}
    for li, bs in enumerate(level_bs):
        w, h = T.BLOCK_WH[bs]
        bw = 1 << MI.MI_WIDTH_LOG2[bs]
        jobs, metas = [], []
        for (r0, c0) in nodes:
            if r0 >= mi_rows or c0 >= mi_cols:
                continue
            has_rows, has_cols = MI.partition_rule(
                bs, r0, c0, mi_rows, mi_cols)
            can_none = (has_rows and has_cols) and int(bs) <= int(max_bs)
            key = (r0, c0, int(bs))
            if can_none and key not in cache:
                cy, cx = centers[(r0, c0)]
                rr = search_range if int(bs) >= int(max_bs) else 8
                jobs.append((c0 * 8, r0 * 8, w, h, cy, cx, rr, 1))
                metas.append((key, c0 * 8, r0 * 8))
        run(jobs, metas, cache)
        can_split_lvl = int(bs) > int(min_bs) and not (
            bs == BlockSize.BLOCK_8X8 and no_sub8)
        if bs == BlockSize.BLOCK_8X8:
            if not can_split_lvl:
                break
            # sub-8x8 probes: 4x4 quarters + 4x8/8x4 halves, centered
            # on the 8x8 winner, range 4, NO zero guard
            jobs, metas = [], []
            for (r0, c0) in nodes:
                if r0 >= mi_rows or c0 >= mi_cols:
                    continue
                got = cache.get((r0, c0, int(bs)))
                ctr = got[1] if got is not None else centers[(r0, c0)]
                px, py = c0 * 8, r0 * 8
                for j in range(4):
                    xo, yo = (j % 2) * 4, (j // 2) * 4
                    jobs.append((px + xo, py + yo, 4, 4, ctr[0], ctr[1],
                                 4, 0))
                    metas.append(((r0, c0, "s4", j), px + xo, py + yo))
                for i, xo in enumerate((0, 4)):
                    jobs.append((px + xo, py, 4, 8, ctr[0], ctr[1], 4, 0))
                    metas.append(((r0, c0, "v", i), px + xo, py))
                for i, yo in enumerate((0, 4)):
                    jobs.append((px, py + yo, 8, 4, ctr[0], ctr[1], 4, 0))
                    metas.append(((r0, c0, "h", i), px, py + yo))
            run(jobs, metas, sub_cache)
            break
        # next level: children inherit the parent winner as centre;
        # rect halves of THIS level probe at the same centre (range 8)
        half = bw >> 1
        sub = T.SUBSIZE[(Partition.SPLIT, bs)]
        next_nodes = []
        next_centers = {}
        jobs, metas = [], []
        for (r0, c0) in nodes:
            if r0 >= mi_rows or c0 >= mi_cols:
                continue
            got = cache.get((r0, c0, int(bs)))
            ctr = got[1] if got is not None else centers[(r0, c0)]
            has_rows, has_cols = MI.partition_rule(
                bs, r0, c0, mi_rows, mi_cols)
            can_none = (has_rows and has_cols) and int(bs) <= int(max_bs)
            can_split = int(bs) > int(min_bs)
            if can_none and can_split:
                for part in (Partition.HORZ, Partition.VERT):
                    rsub = T.SUBSIZE[(part, bs)]
                    rw, rh = T.BLOCK_WH[rsub]
                    offs = (((0, 0), (half, 0))
                            if part == Partition.HORZ
                            else ((0, 0), (0, half)))
                    for dr, dc in offs:
                        rr, cc = r0 + dr, c0 + dc
                        if rr >= mi_rows or cc >= mi_cols:
                            continue
                        key = (rr, cc, int(rsub))
                        if key not in cache:
                            jobs.append((cc * 8, rr * 8, rw, rh, ctr[0],
                                         ctr[1], 8, 1))
                            metas.append((key, cc * 8, rr * 8))
            for dr, dc in ((0, 0), (0, half), (half, 0), (half, half)):
                nn = (r0 + dr, c0 + dc)
                if nn not in next_centers:
                    next_centers[nn] = ctr
                    next_nodes.append(nn)
        run(jobs, metas, cache)
        nodes = next_nodes
        centers = next_centers


def decide_partition_tree(st: FrameState, refs, qindex: int,
                          search_range: int, min_bs: BlockSize,
                          max_bs: BlockSize, log2_tile_cols: int = 0):
    """Full quadtree partition decision (64..min_bs) by open-loop cost
    probes — the EP-block geometry of the reference's mode decision
    (EbModeDecisionConfigurationProcess ADP depths), re-expressed as
    recursive SAD probes instead of per-depth budgets.

    Each node compares NONE (one probe at this size, centered on the
    parent's best vector) against SPLIT (children's total + a syntax
    bias); forced splits at frame edges follow partition_rule.  Returns
    a decode-order event list compatible with walk_partition_fixed's.
    """
    from tpu_vp9_torch.codec.intra_frame import tile_mi_offsets

    ac_q = T.ac_quant(qindex)
    split_bias = max(8, (40 * ac_q) >> 4)
    # sub-8x8 descent needs stable bmi candidate lists: gate it off under
    # the non-ER restriction machinery (no temporal-MV model)
    if (int(min_bs) < int(BlockSize.BLOCK_8X8)
            and getattr(st, "_restrict_mv", False)
            and getattr(st, "_prev_mvs", None) is None):
        min_bs = BlockSize.BLOCK_8X8
    mi_rows, mi_cols = st.mi_rows, st.mi_cols
    _batch_probe_tree(st, refs, search_range, min_bs, max_bs,
                      mi_rows, mi_cols)

    def node(mi_row, mi_col, bsize, center):
        if mi_row >= mi_rows or mi_col >= mi_cols:
            return 0, []
        has_rows, has_cols = MI.partition_rule(
            bsize, mi_row, mi_col, mi_rows, mi_cols)
        forced_split = not (has_rows and has_cols)
        can_none = not forced_split and int(bsize) <= int(max_bs)
        can_split = int(bsize) > int(min_bs)
        if bsize == BlockSize.BLOCK_8X8 and can_split:
            import os as _os

            if _os.environ.get("TPU_VP9_NO_SUB8X8") == "1":
                can_split = False
        if bsize == BlockSize.BLOCK_8X8 and can_split:
            # 8x8 -> ONE sub-8x8 mi (4X4 / 4X8 / 8X4) with bmi MVs:
            # compare the 8x8 probe against per-sub-block searches
            # (sub-8x8 candidate injection, EbModeDecision.c:569)
            cost8, mv8 = probe_inter_cost(st, refs, mi_row, mi_col, bsize,
                                          8, center)
            pl = st.planes[0]
            px, py = mi_col * 8, mi_row * 8
            sub_cache = getattr(st, "_sub8_cache", None) or {}

            def sub_sad(kind, j, src_view, sx, sy):
                got = sub_cache.get((mi_row, mi_col, kind, j))
                if got is not None:
                    return got[0]
                _, _, s = me_ops.full_pel_search(
                    src_view, refs[0], sx, sy, BORDER, 4, mv8)
                return s

            s4 = []
            for j in range(4):
                xo, yo = (j % 2) * 4, (j // 2) * 4
                src4 = pl.source[py + yo : py + yo + 4,
                                 px + xo : px + xo + 4]
                s4.append(sub_sad("s4", j, src4, px + xo, py + yo))
            rect_bias = max(4, split_bias >> 1)
            sv = sh_ = 0
            for i, xo in enumerate((0, 4)):  # VERT: two 4-wide halves
                src48 = pl.source[py : py + 8, px + xo : px + xo + 4]
                sv += sub_sad("v", i, src48, px + xo, py)
            for i, yo in enumerate((0, 4)):  # HORZ: two 4-tall halves
                src84 = pl.source[py + yo : py + yo + 4, px : px + 8]
                sh_ += sub_sad("h", i, src84, px, py + yo)
            cands = [(cost8 if can_none else 1 << 60, Partition.NONE,
                      bsize),
                     (split_bias + sum(s4), Partition.SPLIT,
                      BlockSize.BLOCK_4X4),
                     (rect_bias + sv, Partition.VERT,
                      BlockSize.BLOCK_4X8),
                     (rect_bias + sh_, Partition.HORZ,
                      BlockSize.BLOCK_8X4)]
            cost, part, leaf_bs = min(cands, key=lambda x: x[0])
            if part == Partition.NONE:
                return cost, [("part", mi_row, mi_col, bsize,
                               Partition.NONE),
                              ("leaf", mi_row, mi_col, bsize, None)]
            return cost, [("part", mi_row, mi_col, bsize, part),
                          ("leaf", mi_row, mi_col, leaf_bs, None)]
        cost_none = mv = None
        if can_none:
            r = search_range if bsize >= max_bs else 8
            cost_none, mv = probe_inter_cost(st, refs, mi_row, mi_col,
                                             bsize, r, center)
        if not can_split and can_none:
            return cost_none, [("part", mi_row, mi_col, bsize,
                                Partition.NONE),
                               ("leaf", mi_row, mi_col, bsize, None)]
        sub = T.SUBSIZE[(Partition.SPLIT, bsize)]
        half = (1 << MI.MI_WIDTH_LOG2[bsize]) >> 1
        ccenter = mv if mv is not None else center
        cost_split = split_bias
        sub_events = []
        for dr, dc in ((0, 0), (0, half), (half, 0), (half, half)):
            c, ev = node(mi_row + dr, mi_col + dc, sub, ccenter)
            cost_split += c
            sub_events.extend(ev)
        # rectangular candidates (the reference's H/V partitions in its
        # 681-entry EP-block geometry): two w x h/2 or w/2 x h halves,
        # probed around the parent's vector.  Only interior nodes — edge
        # nodes keep their forced-split handling above.
        best_rect = None
        if can_none and can_split:
            rect_bias = max(4, split_bias >> 1)
            for part, offs in ((Partition.HORZ, ((0, 0), (half, 0))),
                               (Partition.VERT, ((0, 0), (0, half)))):
                rsub = T.SUBSIZE[(part, bsize)]
                cost_r = rect_bias
                evs = [("part", mi_row, mi_col, bsize, part)]
                for dr, dc in offs:
                    r, c = mi_row + dr, mi_col + dc
                    if r >= mi_rows or c >= mi_cols:
                        continue
                    s, _ = probe_inter_cost(st, refs, r, c, rsub, 8, ccenter)
                    cost_r += s
                    evs.append(("leaf", r, c, rsub, None))
                if best_rect is None or cost_r < best_rect[0]:
                    best_rect = (cost_r, evs)
        # preference order on ties: NONE, then rect, then SPLIT (min()
        # keeps the first minimal entry)
        cands = []
        if can_none:
            cands.append((cost_none,
                          [("part", mi_row, mi_col, bsize, Partition.NONE),
                           ("leaf", mi_row, mi_col, bsize, None)]))
        if best_rect is not None:
            cands.append(best_rect)
        cands.append((cost_split,
                      [("part", mi_row, mi_col, bsize, Partition.SPLIT)]
                      + sub_events))
        return min(cands, key=lambda x: x[0])

    events = []
    offs = tile_mi_offsets(mi_cols, log2_tile_cols)
    for t in range(len(offs) - 1):
        events.append(("tile", offs[t], offs[t + 1], None, None))
        for sb_r in range(0, mi_rows, 8):
            for sb_c in range(offs[t], offs[t + 1], 8):
                _, ev = node(sb_r, sb_c, BlockSize.BLOCK_64X64, (0, 0))
                events.extend(ev)
    return events


def decide_leaf_sub8x8_inter(st: FrameState, refs, mi_row: int, mi_col: int,
                             bsize: BlockSize, qindex: int,
                             do_subpel: bool = True):
    """Sub-8x8 inter leaf (bmi MVs): per-sub-block decision among
    {NEAREST, NEAR, ZERO, NEW} with the normative sub-block candidate
    rules (vp9_append_sub8x8_mvs_for_idx); LAST reference only.
    Prediction mirrors the decoder exactly: per-4x4 luma MC with each
    bmi MV, one 4x4 chroma MC at the q4-averaged MV.
    Reference: EbModeDecision.c:569 sub-8x8 candidate injection.
    """
    from tpu_vp9_torch.codec.intra_frame import _sub8x8_rc_steps

    LAST = int(RefFrame.LAST)
    ac_q = T.ac_quant(qindex)
    lam = max(1, (ac_q * ac_q) >> 6)
    pl = st.planes[0]
    px, py = mi_col * 8, mi_row * 8
    prev_mvs = getattr(st, "_prev_mvs", None)
    sign_bias = getattr(st, "_sign_bias", None) or (0, 0, 0, 0)
    mv_list, mode_context = MV.find_mv_refs(
        st.mig, mi_row, mi_col, bsize, LAST, st.mig.tile_mi_start,
        st.mig.tile_mi_end, prev_mvs=prev_mvs, sign_bias=sign_bias)
    nearest_blk, _ = MV.find_best_ref_mvs(
        mv_list, False, mi_row, mi_col, bsize, st.mi_rows, st.mi_cols)
    filters = T.subpel_filters(T.InterpFilter.EIGHTTAP)
    fcst = getattr(st, "_rd_costs", None)
    bmi = [(0, 0)] * 4
    sub_modes = [0] * 4
    for j, num4w, num4h in _sub8x8_rc_steps(bsize):
        x_off, y_off = (j % 2) * 4, (j // 2) * 4
        sw = 4 if num4w == 1 else 8
        sh = 4 if num4h == 1 else 8
        src = pl.source[py + y_off : py + y_off + sh,
                        px + x_off : px + x_off + sw]

        def sse_of(mv):
            pred = inter_ops.predict_inter_block(
                refs[0], mi_row, mi_col, x_off, y_off, sw, sh, mv, 0,
                st.mi_rows, st.mi_cols)
            d = pred.astype(np.int64) - src.astype(np.int64)
            return int((d * d).sum())

        nearest_s, near_s = MV.append_sub8x8_mvs(
            st.mig, mi_row, mi_col, bsize, LAST, j, bmi,
            st.mig.tile_mi_start, st.mig.tile_mi_end, prev_mvs=prev_mvs,
            sign_bias=sign_bias)
        best = None
        for mode, mvv, rate in ((0, nearest_s, 2), (1, near_s, 3),
                                (2, (0, 0), 1)):
            cost = sse_of(mvv) + rate * lam
            if best is None or cost < best[0]:
                best = (cost, mode, mvv)
        # NEW: small full-pel search around the sub nearest + subpel
        center = (int(np.clip(nearest_s[0] >> 3, -32, 32)),
                  int(np.clip(nearest_s[1] >> 3, -32, 32)))
        dy, dx, _ = me_ops.full_pel_search(src, refs[0], px + x_off,
                                           py + y_off, BORDER, 8, center)
        if do_subpel:
            new_mv, _ = me_ops.subpel_refine(
                src, refs[0], px + x_off, py + y_off, BORDER, (dy, dx),
                filters)
        else:
            new_mv = (dy * 8, dx * 8)
        if fcst is not None:
            mv_bits = 10 + fcst.mv_rate(new_mv, nearest_blk) // 256
        else:
            mv_bits = 12
        cost = sse_of(new_mv) + mv_bits * lam
        if cost < best[0]:
            best = (cost, 3, new_mv)
        _, mode, mvv = best
        bmi[j] = tuple(mvv)
        sub_modes[j] = mode
        if num4h == 2:
            bmi[j + 2] = bmi[j]
            sub_modes[j + 2] = mode
        if num4w == 2:
            bmi[j + 1] = bmi[j]
            sub_modes[j + 1] = mode
    mi = MI.ModeInfo(bsize=bsize, tx_size=T.MAX_TX_SIZE[bsize], skip=False,
                     is_inter=True, ref_frame=(LAST, -1),
                     mv=(bmi[3], (0, 0)), inter_mode=sub_modes[3],
                     sub_mvs=tuple((b, (0, 0)) for b in bmi),
                     sub_modes=tuple(sub_modes))
    mi.mode_context = mode_context
    mi.best_ref_mv = nearest_blk
    st.mig.set_block(mi_row, mi_col, bsize, mi)
    # decoder-exact prediction: per-4x4 luma, q4-averaged-MV 4x4 chroma
    pred_y = np.zeros((8, 8), np.uint8)
    for j in range(4):
        x_off, y_off = (j % 2) * 4, (j // 2) * 4
        pred_y[y_off : y_off + 4, x_off : x_off + 4] = \
            inter_ops.predict_inter_block(
                refs[0], mi_row, mi_col, x_off, y_off, 4, 4, bmi[j], 0,
                st.mi_rows, st.mi_cols)
    mv_avg = MV.mi_mv_pred_q4(bmi)
    preds = [(pred_y, px, py)]
    for pidx in (1, 2):
        p = inter_ops.predict_inter_block(
            refs[pidx], mi_row, mi_col, 0, 0, 4, 4, mv_avg, 1,
            st.mi_rows, st.mi_cols)
        preds.append((p, px >> 1, py >> 1))
    return (mi, mi_row, mi_col, bsize, preds)


def decide_leaf_inter(st: FrameState, refs, mi_row: int, mi_col: int,
                      bsize: BlockSize, qindex: int, search_range: int = 16,
                      do_subpel: bool = True):
    """Phase 1: mode/MV decision for one leaf (no reconstruction yet).

    Returns a pending-work entry for the batched transform phase, or None
    for leaves that chose intra (reconstructed in decode-order phase 3).
    """
    ac_q = T.ac_quant(qindex)
    pl = st.planes[0]
    w, h = T.BLOCK_WH[bsize]
    px, py = mi_col * 8, mi_row * 8
    src = pl.source[py : py + h, px : px + w]

    lam = max(1, (ac_q * ac_q) >> 6)
    lmap = getattr(st, "_lambda_map", None)
    if lmap is not None:
        # QPM/BEA analogue: per-SB RDMULT modulation
        # (EbEncDecProcess.c:5515 rdmult-from-qindex, seg-less variant)
        sr = min(mi_row >> 3, lmap.shape[0] - 1)
        sc = min(mi_col >> 3, lmap.shape[1] - 1)
        lam = max(1, int(lam * float(lmap[sr, sc])))
    filters = T.subpel_filters(T.InterpFilter.EIGHTTAP)

    from tpu_vp9_torch import native as nat

    use_native = nat.get_lib() is not None

    def mc_sad(ref_planes, mv_q3):
        # squared-error metric: dimensionally matched to the q^2 lambda
        # and sensitive to compound noise-averaging (SAD is not)
        if use_native:
            return nat.native_mc_sse(ref_planes[0], BORDER, mi_row, mi_col,
                                     w, h, mv_q3, st.mi_rows, st.mi_cols,
                                     src)
        pred = inter_ops.predict_inter_block(
            ref_planes[0], mi_row, mi_col, 0, 0, w, h, mv_q3, 0,
            st.mi_rows, st.mi_cols)
        d = pred.astype(np.int64) - src.astype(np.int64)
        return int((d * d).sum())

    prev_mvs = getattr(st, "_prev_mvs", None)
    # with temporal MVs modeled, the candidate list is fully known and no
    # restriction is needed
    restrict = getattr(st, "_restrict_mv", False) and prev_mvs is None

    sign_bias = getattr(st, "_sign_bias", None) or (0, 0, 0, 0)

    def eval_ref(ref_id, ref_planes, extra_rate, me_range):
        mv_list, mode_context, stable = MV.find_mv_refs(
            st.mig, mi_row, mi_col, bsize, ref_id,
            st.mig.tile_mi_start, st.mig.tile_mi_end, return_stable=True,
            prev_mvs=prev_mvs, sign_bias=sign_bias)
        nearest, near = MV.find_best_ref_mvs(
            mv_list, False, mi_row, mi_col, bsize, st.mi_rows, st.mi_cols)
        sad_cache = {}

        def c_sad(mvv):
            k = (int(mvv[0]), int(mvv[1]))
            if k not in sad_cache:
                sad_cache[k] = mc_sad(ref_planes, k)
            return sad_cache[k]

        # predictor-only candidate list (respecting the non-ER restriction)
        pred_cands = [(0, nearest, 2), (1, near, 3), (2, (0, 0), 1)]
        newmv_ok = True
        if restrict:
            if stable == 0:
                pred_cands = [(2, (0, 0), 1)]
                newmv_ok = False
            elif stable == 1:
                pred_cands = [(0, nearest, 2), (2, (0, 0), 1)]
        best = None
        for offset, mvv, rate in pred_cands:
            cost = c_sad(mvv) + (rate + extra_rate) * lam
            if best is None or cost < best[0]:
                best = (cost, offset, mvv)
        # lossless NEWMV skip: if a predictor candidate already costs less
        # than NEWMV's minimum possible rate cost, the motion search cannot
        # change the decision (SAD >= 0), so skip it entirely
        if not newmv_ok or best[0] <= (10 + extra_rate) * lam:
            return (best[0], ref_id, best[1], best[2], nearest,
                    mode_context, ref_planes, near, c_sad)
        tpu_mv = None
        if ref_id == int(RefFrame.LAST):
            tmv = getattr(st, "_tpu_mv", None)
            if tmv is not None:
                bn = T.BLOCK_WH[bsize][0]
                br, bc = (mi_row * 8) // tmv[1], (mi_col * 8) // tmv[1]
                if (bn == tmv[1] and br < tmv[0].shape[0]
                        and bc < tmv[0].shape[1]):
                    tpu_mv = (int(tmv[0][br, bc, 0]), int(tmv[0][br, bc, 1]))
        if tpu_mv is not None:
            # device search already covered +-r around zero; just compare
            # against the nearest-predictor position
            cand_n = (nearest[0] // 8, nearest[1] // 8)
            s_t = mc_sad(ref_planes, (tpu_mv[0] * 8, tpu_mv[1] * 8))
            s_n = mc_sad(ref_planes, (cand_n[0] * 8, cand_n[1] * 8))
            dy, dx = tpu_mv if s_t <= s_n else cand_n
        else:
            center = (int(np.clip(nearest[0] // 8, -64, 64)),
                      int(np.clip(nearest[1] // 8, -64, 64)))
            if me_range >= 32:
                # large search areas go hierarchical (the reference's HME;
                # EbMotionEstimationProcess.c level0-2 over decimated refs)
                cache = getattr(st, "_hme_cache", None)
                if cache is None:
                    cache = st._hme_cache = {}
                key = id(ref_planes[0])
                pyr = cache.get(key)
                if pyr is None:
                    pyr = cache[key] = hme_ops.build_pyramid(ref_planes[0])
                dy, dx, fsad = hme_ops.hme_search(
                    src, pyr, px, py, BORDER, me_range, center)
            else:
                dy, dx, fsad = me_ops.full_pel_search(
                    src, ref_planes[0], px, py, BORDER, me_range, center)
            if ref_id == int(RefFrame.LAST):
                probe = getattr(st, "_probe_cache", {}).get(
                    (mi_row, mi_col, int(bsize)))
                if probe is not None and probe[0] < fsad:
                    dy, dx = probe[1]
        if do_subpel:
            new_mv, _ = me_ops.subpel_refine(
                src, ref_planes[0], px, py, BORDER, (dy, dx), filters)
        else:
            new_mv = (dy * 8, dx * 8)
        cost = c_sad(new_mv) + (10 + extra_rate) * lam
        if cost < best[0]:
            best = (cost, 3, new_mv)
        return (best[0], ref_id, best[1], best[2], nearest, mode_context,
                ref_planes, near, c_sad)

    ranges = getattr(st, "_ref_ranges", None) or {}
    results = [eval_ref(int(RefFrame.LAST), refs, 0,
                        ranges.get(int(RefFrame.LAST), search_range))]
    golden_refs = getattr(st, "_golden_refs", None)
    # cheap-LAST no longer skips the other references outright: compound
    # averaging of two anchors' quantization noise is a ~1-2 dB win on
    # low-motion leaves (the reference injects bi-pred candidates at all
    # presets, EbModeDecision.c:421), and eval_ref's internal NEWMV skip
    # already makes the extra evaluations predictor-only when cheap
    if golden_refs is not None:
        results.append(eval_ref(
            int(RefFrame.GOLDEN), golden_refs, 2,
            ranges.get(int(RefFrame.GOLDEN), max(search_range // 2, 8))))
    altref_refs = getattr(st, "_altref_refs", None)
    if altref_refs is not None:
        results.append(eval_ref(
            int(RefFrame.ALTREF), altref_refs, 2,
            ranges.get(int(RefFrame.ALTREF), search_range)))
    best_all = min(results, key=lambda x: x[0])
    best = (best_all[0], best_all[2], best_all[3])
    ref_id = best_all[1]
    nearest = best_all[4]
    mode_context = best_all[5]
    chosen_refs = best_all[6]

    # compound candidate: average the fixed ref (opposite sign bias) with
    # a variable ref (EbModeDecision.c bi-pred injection analogue; spec
    # ordering: ref_frame[sign_bias[fixed]] = fixed)
    comp_choice = None
    if len(set(sign_bias[1:4])) > 1 and len(results) > 1:
        fixed_ref, var_refs = compound_refs(sign_bias)
        by_ref = {r[1]: r for r in results}
        fx = by_ref.get(fixed_ref)
        if fx is not None:
            idx = sign_bias[fixed_ref]

            def comp_sad(p0_planes, p1_planes, mv0, mv1):
                if use_native:
                    return nat.native_mc_sse_avg(
                        p0_planes[0], p1_planes[0], BORDER, mi_row, mi_col,
                        w, h, mv0, mv1, st.mi_rows, st.mi_cols, src)
                p0 = inter_ops.predict_inter_block(
                    p0_planes[0], mi_row, mi_col, 0, 0, w, h, mv0, 0,
                    st.mi_rows, st.mi_cols)
                p1 = inter_ops.predict_inter_block(
                    p1_planes[0], mi_row, mi_col, 0, 0, w, h, mv1, 0,
                    st.mi_rows, st.mi_cols)
                avg = (p0.astype(np.int64) + p1.astype(np.int64) + 1) >> 1
                d = avg - src.astype(np.int64)
                return int((d * d).sum())

            for var in var_refs:
                vr = by_ref.get(var)
                if vr is None:
                    continue
                pair = [None, None]
                pair[idx], pair[1 - idx] = fx, vr
                cands = [(0, pair[0][4], pair[1][4], 4),
                         (1, pair[0][7], pair[1][7], 5),
                         (2, (0, 0), (0, 0), 3),
                         (3, pair[0][3], pair[1][3], 22)]
                seen = set()
                for mode, mv0, mv1, rate in cands:
                    k = (mode >= 3, mv0, mv1)
                    if k in seen:
                        continue
                    seen.add(k)
                    cost = comp_sad(pair[0][6], pair[1][6], mv0, mv1) \
                        + rate * lam
                    if cost < best[0] and (comp_choice is None
                                           or cost < comp_choice[0]):
                        comp_choice = (cost, mode, mv0, mv1, pair)

    # intra DC fallback — decided open-loop (source-based references);
    # exact recon happens in decode-order phase 3
    from tpu_vp9_torch.ops import intra as intra_ops

    n = min(w, h, 32)
    ha, hl = py > 0, px > st.tile_mi_start * 8
    above, al, left = intra_ops.build_ref_samples(
        pl.source, px, py, n, pl.width, pl.height, ha, hl, False)
    dc_pred = intra_ops.predict_block_full(IntraMode.DC_PRED, above, al,
                                           left, ha, hl, n)
    _di = dc_pred.astype(np.int64) - src[:n, :n].astype(np.int64)
    intra_cost = int((_di * _di).sum()) + 15 * lam

    fcst = getattr(st, "_rd_costs", None)
    if fcst is not None:
        # ---- full loop (EbEncDecProcess.c:766): re-rank the fast-loop
        # winners with true transform-domain distortion and exact
        # entropy-table rates (coeff tokens, nmv mv bits, mode syntax) ----
        base_lam = max(1, (ac_q * ac_q) >> 6)
        lam_factor = lam / base_lam  # QPM/BEA modulation carried over
        fc = fcst.fc

        def _bitp(p, bit):
            from tpu_vp9_torch.codec.rd_cost import PROB_COST

            return int(PROB_COST[256 - int(p)] if bit else
                       PROB_COST[int(p)])

        def single_ref_rate(rid):
            rctx = single_ref_p1_ctx(st.mig, mi_row, mi_col)
            not_last = rid != int(RefFrame.LAST)
            r = _bitp(fc.single_ref_probs[rctx, 0], not_last)
            if not_last:
                rctx2 = single_ref_p2_ctx(st.mig, mi_row, mi_col)
                r += _bitp(fc.single_ref_probs[rctx2, 1],
                           rid == int(RefFrame.ALTREF))
            return r

        cands = []
        for res in results:
            cands.append(dict(
                kind="inter", refs=res[6], mv=res[3], mode=res[2],
                mode_context=res[5], nearest=res[4], ref_id=res[1],
                ref_rate=single_ref_rate(res[1])))
        if comp_choice is not None:
            _, mode, mv0, mv1, pair = comp_choice
            cctx = comp_inter_ctx(st.mig, mi_row, mi_col,
                                  compound_refs(sign_bias)[0])
            cands.append(dict(
                kind="comp", refs=pair[0][6], refs2=pair[1],
                mv=mv0, mv2=mv1, mode=mode, mode_context=pair[0][5],
                nearest=pair[0][4], nearest2=pair[1][4],
                ref_rate=_bitp(fc.comp_inter_probs[cctx], 1), pair=pair))
        cands.append(dict(kind="intra", pred=dc_pred))
        win = _full_loop_choose(st, fcst, cands, mi_row, mi_col, bsize,
                                qindex, getattr(st, "_qbias", 0.38),
                                lam_factor)
        if win["kind"] == "intra":
            mi = MI.ModeInfo(bsize=bsize, y_mode=IntraMode.DC_PRED,
                             uv_mode=IntraMode.DC_PRED,
                             tx_size=T.MAX_TX_SIZE[bsize], skip=False,
                             is_inter=False)
            mi.tile_mi_start = st.tile_mi_start
            st.mig.set_block(mi_row, mi_col, bsize, mi)
            return None
        if win["kind"] == "comp":
            pair = win["pair"]
            mi = MI.ModeInfo(bsize=bsize, tx_size=T.MAX_TX_SIZE[bsize],
                             skip=False, is_inter=True,
                             ref_frame=(pair[0][1], pair[1][1]),
                             mv=(tuple(win["mv"]), tuple(win["mv2"])),
                             inter_mode=win["mode"])
            mi.mode_context = pair[0][5]
            mi.best_ref_mv = pair[0][4]
            mi.best_ref_mv2 = pair[1][4]
            st.mig.set_block(mi_row, mi_col, bsize, mi)
            return (mi, mi_row, mi_col, bsize, win["preds"])
        mi = MI.ModeInfo(bsize=bsize, tx_size=T.MAX_TX_SIZE[bsize],
                         skip=False, is_inter=True,
                         ref_frame=(win["ref_id"], -1),
                         mv=(tuple(win["mv"]), (0, 0)),
                         inter_mode=win["mode"])
        mi.mode_context = win["mode_context"]
        mi.best_ref_mv = win["nearest"]
        st.mig.set_block(mi_row, mi_col, bsize, mi)
        return (mi, mi_row, mi_col, bsize, win["preds"])

    inter_best = comp_choice[0] if comp_choice is not None else best[0]
    if intra_cost < inter_best:
        mi = MI.ModeInfo(bsize=bsize, y_mode=IntraMode.DC_PRED,
                         uv_mode=IntraMode.DC_PRED,
                         tx_size=T.MAX_TX_SIZE[bsize], skip=False,
                         is_inter=False)
        mi.tile_mi_start = st.tile_mi_start
        st.mig.set_block(mi_row, mi_col, bsize, mi)
        return None

    if comp_choice is not None:
        _, mode, mv0, mv1, pair = comp_choice
        mi = MI.ModeInfo(bsize=bsize, tx_size=T.MAX_TX_SIZE[bsize],
                         skip=False, is_inter=True,
                         ref_frame=(pair[0][1], pair[1][1]),
                         mv=(tuple(mv0), tuple(mv1)), inter_mode=mode)
        mi.mode_context = pair[0][5]
        mi.best_ref_mv = pair[0][4]
        mi.best_ref_mv2 = pair[1][4]
        st.mig.set_block(mi_row, mi_col, bsize, mi)
        preds = predict_inter_planes(st, pair[0][6], mi_row, mi_col, bsize,
                                     mv0, refs2=pair[1][6], mv2_q3=mv1)
        return (mi, mi_row, mi_col, bsize, preds)

    _, offset, mvv = best
    mi = MI.ModeInfo(bsize=bsize, tx_size=T.MAX_TX_SIZE[bsize], skip=False,
                     is_inter=True, ref_frame=(ref_id, -1),
                     mv=(tuple(mvv), (0, 0)), inter_mode=offset)
    mi.mode_context = mode_context
    mi.best_ref_mv = nearest
    st.mig.set_block(mi_row, mi_col, bsize, mi)
    preds = predict_inter_planes(st, chosen_refs, mi_row, mi_col, bsize, mvv)
    return (mi, mi_row, mi_col, bsize, preds)


def _rd_probe_planes(st: FrameState, fcst, preds, mi_row: int, mi_col: int,
                     bsize: BlockSize, qindex: int, qbias: float,
                     is_inter: bool = True):
    """Full-loop price of a prediction: transform/quant/recon all three
    planes at the max tx size and return (dist_sse, coeff_rate_256,
    all_zero).  The coefficient rate is the exact token-walk price under
    this frame's entropy tables (EbEncDecProcess.c:766 full-loop stage;
    EbRateDistortionCost.c coeff rates)."""
    dc_q, ac_q = T.dc_quant(qindex), T.ac_quant(qindex)
    tx = T.MAX_TX_SIZE[bsize]
    dist = 0
    rate = 0
    all_zero = True
    for pidx, (pred, px, py) in enumerate(preds):
        pl = st.planes[pidx]
        ss = pl.subsampling
        w, h = T.BLOCK_WH[bsize]
        bw, bh = w >> ss, h >> ss
        src = pl.source[py : py + bh, px : px + bw].astype(np.int32)
        txs = tx if pidx == 0 else MI.uv_tx_size(bsize, tx)
        n = TX_PX[txs]
        ky, kx = bh // n, bw // n
        resid = (src - pred.astype(np.int32)).reshape(
            ky, n, kx, n).transpose(0, 2, 1, 3).reshape(-1, n, n)
        co = txfm.fwd_txfm2d(resid, txs, TxType.DCT_DCT)
        lv = txfm.quantize_block(co, dc_q, ac_q, txs, bias=qbias)
        dq = txfm.dequant_block(lv, dc_q, ac_q, txs)
        ptiles = pred.reshape(ky, n, kx, n).transpose(0, 2, 1, 3) \
            .reshape(-1, n, n)
        rec = txfm.inv_txfm_add(dq.astype(np.int64), ptiles, txs,
                                TxType.DCT_DCT)
        stiles = src.reshape(ky, n, kx, n).transpose(0, 2, 1, 3) \
            .reshape(-1, n, n)
        d = rec.astype(np.int64) - stiles
        wgt = 1 if pidx == 0 else 1  # planes weighted equally (PSNR-YUV)
        dist += wgt * int((d * d).sum())
        if lv.any():
            all_zero = False
            rate += int(fcst.coeff_rate(lv, txs, pidx > 0, is_inter,
                                        1).sum())
    return dist, rate, all_zero


def _full_loop_choose(st: FrameState, fcst, cands, mi_row: int, mi_col: int,
                      bsize: BlockSize, qindex: int, qbias: float,
                      lam_factor: float = 1.0):
    """RD-compare mode candidates with real distortions and rates.

    cands: list of dicts with keys kind ('inter'|'comp'|'intra'),
    and per-kind fields.  Returns the winning candidate dict with
    'preds' attached (None for intra: phase 3 reconstructs those).
    """
    sctx = MI.skip_ctx(st.mig, mi_row, mi_col)
    ictx = intra_inter_ctx(st.mig, mi_row, mi_col)
    lam = fcst.lambda_bits * lam_factor
    best = None
    for cand in cands:
        if cand["kind"] == "intra":
            # open-loop probe: DC prediction from source refs (exact
            # recon happens decode-ordered in phase 3)
            pred = cand["pred"]
            n = pred.shape[0]
            pl = st.planes[0]
            px, py = mi_col * 8, mi_row * 8
            src = pl.source[py : py + n, px : px + n].astype(np.int32)
            dc_q, ac_q = T.dc_quant(qindex), T.ac_quant(qindex)
            txs = {4: TxSize.TX_4X4, 8: TxSize.TX_8X8, 16: TxSize.TX_16X16,
                   32: TxSize.TX_32X32}[n]
            resid = (src - pred)[None]
            co = txfm.fwd_txfm2d(resid, txs, TxType.DCT_DCT)
            lv = txfm.quantize_block(co, dc_q, ac_q, txs, bias=qbias)
            dq = txfm.dequant_block(lv, dc_q, ac_q, txs)
            rec = txfm.inv_txfm_add(dq.astype(np.int64),
                                    pred[None].astype(np.int32), txs,
                                    TxType.DCT_DCT)
            d = rec[0].astype(np.int64) - src
            dist = int((d * d).sum())
            # the probe covers n x n of the block; scale to full area
            bw = T.BLOCK_WH[bsize][0]
            dist = dist * (bw * bw) // (n * n)
            rate = int(fcst.intra_inter_cost[ictx][0])
            rate += 2 * 256  # y/uv mode signaling approximation (DC)
            if lv.any():
                rate += int(fcst.skip_cost[sctx][0])
                rate += int(fcst.coeff_rate(lv, txs, False, False, 1).sum())
            else:
                rate += int(fcst.skip_cost[sctx][1])
            cost = dist + lam * rate / 256.0
        else:
            refs2 = cand.get("refs2")
            preds = predict_inter_planes(
                st, cand["refs"], mi_row, mi_col, bsize, cand["mv"],
                refs2=refs2[6] if refs2 is not None else None,
                mv2_q3=cand.get("mv2"))
            dist, crate, zero = _rd_probe_planes(
                st, fcst, preds, mi_row, mi_col, bsize, qindex, qbias)
            rate = int(fcst.intra_inter_cost[ictx][1])
            rate += int(fcst.inter_mode_cost[cand["mode_context"],
                                             cand["mode"]])
            rate += cand.get("ref_rate", 0)
            if cand["mode"] == 3:
                rate += fcst.mv_rate(cand["mv"], cand["nearest"])
                if cand.get("mv2") is not None:
                    rate += fcst.mv_rate(cand["mv2"], cand["nearest2"])
            if zero:
                rate += int(fcst.skip_cost[sctx][1])
            else:
                rate += int(fcst.skip_cost[sctx][0]) + crate
            cost = dist + lam * rate / 256.0
            cand = dict(cand, preds=preds)
        if best is None or cost < best[0]:
            best = (cost, cand)
    return best[1]


def decide_tx_sizes(st: FrameState, pending, qindex: int,
                    qbias: float = 0.38) -> None:
    """Choose per-block Y tx size (max vs one-below) by RD estimate.

    Batched over blocks of equal size; sets mi.tx_size in place.
    """
    dc_q = T.dc_quant(qindex)
    ac_q = T.ac_quant(qindex)
    lam = max(1, (ac_q * ac_q) >> 8)
    groups = {}
    for entry in pending:
        mi, mi_row, mi_col, bsize, preds = entry
        groups.setdefault(bsize, []).append(entry)
    for bsize, entries in groups.items():
        max_tx = T.MAX_TX_SIZE[bsize]
        if int(max_tx) == 0:
            continue
        w, h = T.BLOCK_WH[bsize]
        resid = np.stack([
            st.planes[0].source[mi_row * 8 : mi_row * 8 + h,
                                mi_col * 8 : mi_col * 8 + w].astype(np.int32)
            - preds[0][0].astype(np.int32)
            for _, mi_row, mi_col, _, preds in entries])
        costs = []
        for tx in (max_tx, TxSize(int(max_tx) - 1)):
            n = TX_PX[tx]
            b = resid.shape[0]
            blocks = resid.reshape(b, h // n, n, w // n, n) \
                          .transpose(0, 1, 3, 2, 4).reshape(-1, n, n)
            coeffs = txfm.fwd_txfm2d(blocks, tx, TxType.DCT_DCT)
            levels = txfm.quantize_block(coeffs, dc_q, ac_q, tx, bias=qbias)
            q_eff = np.full((n, n), float(ac_q), np.float32)
            q_eff[0, 0] = float(dc_q)
            if n == 32:
                q_eff *= 0.5
            qerr = coeffs - levels * q_eff
            gain = 16.0 if n == 32 else 64.0
            dist = (qerr**2).sum(axis=(1, 2)) / gain
            mags = np.abs(levels)
            rate = (np.where(mags > 0, 1.5 + np.log2(1.0 + mags), 0.0)
                    .sum(axis=(1, 2)) + 1.5)
            per_blk = (dist + lam * rate).reshape(b, -1).sum(axis=1)
            costs.append(per_blk)
        pick_small = costs[1] < costs[0]
        for i, (mi, _, _, _, _) in enumerate(entries):
            mi.tx_size = TxSize(int(max_tx) - 1) if pick_small[i] else max_tx


# Calibrated on the BD-rate harness (pan_text M4 sweep): the DP prices
# context changes against the original cache, so the break-even lambda
# sits far below the mode-decision lambda; larger scales over-zero.
TRELLIS_LAMBDA_SCALE = 0.1
# High-q frames lose more PSNR than the bits they save (few, large
# coefficients — truncation is all-or-nothing); the reference's
# speed features likewise disable trellis first at high q.
TRELLIS_MAX_QINDEX = 170


def _optimize_levels(fcst, levels, coeffs, txs, items, dc_q, ac_q):
    """Trellis-optimize a batch of quantized tx blocks with the frame's
    exact token-cost tables.  items carry the plane index (chroma and
    luma price against their own probability sets).  Falls back to the
    unoptimized levels when the native library is unavailable."""
    import os

    from tpu_vp9_torch import native as nat

    if os.environ.get("TPU_VP9_NO_TRELLIS") == "1":
        return levels
    n = TX_PX[txs]
    gain = 16.0 if n == 32 else 64.0
    # TRELLIS_LAMBDA_SCALE < 1: the token-cost model prices each change
    # against the CURRENT contexts, but zeroing a coefficient also
    # cheapens every later context (un-modeled savings), so the
    # break-even lambda for the DP sits below the mode-decision lambda
    # (calibrated on the BD-rate harness)
    lam = (fcst.lambda_bits * gain / 256.0 * TRELLIS_LAMBDA_SCALE
           * float(os.environ.get("TPU_VP9_TRELLIS_SCALE", "1.0")))
    q_shift = 1 if n == 32 else 0
    out = np.ascontiguousarray(levels, np.int32)
    by_plane = {}
    for i, it in enumerate(items):
        by_plane.setdefault(it[2] > 0, []).append(i)
    for is_uv, idxs in by_plane.items():
        sel = np.asarray(idxs)
        probs = fcst._coef_full[(int(txs), is_uv, True)]
        res = nat.native_optimize_coeffs_batch(
            out[sel], coeffs[sel], int(txs), int(TxType.DCT_DCT), probs,
            1, lam, dc_q, ac_q, q_shift)
        if res is None:
            return levels
        out[sel] = res[0]
    return out


def batch_encode_inter_blocks(st: FrameState, pending, qindex: int,
                              qbias: float = 0.38) -> None:
    """Phase 2: transform/quant/recon ALL inter blocks batched per tx size.

    Inter blocks are mutually independent (prediction comes from the
    reference frame), so this is one batched tensor op per tx size — the
    TPU-native formulation of the reference's EncDec thread pool.
    """
    dc_q = T.dc_quant(qindex)
    ac_q = T.ac_quant(qindex)
    jobs = {}  # tx -> list of (mi, key, pidx, py, px, pred)
    for mi, mi_row, mi_col, bsize, preds in pending:
        eff = bsize if bsize >= T.BlockSize.BLOCK_8X8 \
            else T.BlockSize.BLOCK_8X8
        y_tx = mi.tx_size
        uv_tx = (MI.uv_tx_size(bsize, y_tx)
                 if bsize >= T.BlockSize.BLOCK_8X8 else TxSize.TX_4X4)
        for pidx, txs in ((0, y_tx), (1, uv_tx), (2, uv_tx)):
            ss = st.planes[pidx].subsampling
            pred_full = preds[pidx][0]
            for x4, y4 in tx_blocks_of(eff, txs, ss):
                if not _visible(st, pidx, mi_row, mi_col, x4, y4):
                    continue
                n = TX_PX[txs]
                px = ((mi_col * 8) >> ss) + x4 * 4
                py = ((mi_row * 8) >> ss) + y4 * 4
                if pidx == 0:
                    key = (0, mi_row * 2 + y4, mi_col * 2 + x4)
                else:
                    key = (pidx, mi_row + y4, mi_col + x4)
                pred = pred_full[y4 * 4 : y4 * 4 + n, x4 * 4 : x4 * 4 + n]
                jobs.setdefault(txs, []).append((mi, key, pidx, py, px, pred))
    fcst = getattr(st, "_rd_costs", None)
    for txs, items in jobs.items():
        n = TX_PX[txs]
        preds = np.stack([it[5] for it in items]).astype(np.int32)
        srcs = np.stack([
            st.planes[it[2]].source[it[3] : it[3] + n, it[4] : it[4] + n]
            for it in items]).astype(np.int32)
        resid = srcs - preds
        coeffs = txfm.fwd_txfm2d(resid, txs, TxType.DCT_DCT)
        levels = txfm.quantize_block(coeffs, dc_q, ac_q, txs, bias=qbias)
        if fcst is not None and qindex <= TRELLIS_MAX_QINDEX:
            # trellis RDOQ on the final coded levels (vp9_optimize_b
            # analogue, EbEncDecProcess.c:426; M0-M4 full-loop presets)
            levels = _optimize_levels(fcst, levels, coeffs, txs, items,
                                      dc_q, ac_q)
        deq = txfm.dequant_block(levels, dc_q, ac_q, txs)
        recon = txfm.inv_txfm_add(deq.astype(np.int64), preds, txs,
                                  TxType.DCT_DCT)
        scan = T.scan_order(txs, TxType.DCT_DCT)[0]
        lv_scan = levels.reshape(levels.shape[0], -1)[:, scan]
        nz = lv_scan != 0
        eobs = np.where(nz.any(axis=1),
                        n * n - np.argmax(nz[:, ::-1], axis=1), 0)
        for i, (mi, key, pidx, py, px, _) in enumerate(items):
            st.planes[pidx].recon[py : py + n, px : px + n] = recon[i]
            st.levels[key] = levels[i]
            st.eobs[key] = int(eobs[i])
    # skip determination: a block skips iff all its tx blocks are empty
    for mi, mi_row, mi_col, bsize, _ in pending:
        eff = bsize if bsize >= T.BlockSize.BLOCK_8X8 \
            else T.BlockSize.BLOCK_8X8
        y_tx = mi.tx_size
        uv_tx = (MI.uv_tx_size(bsize, y_tx)
                 if bsize >= T.BlockSize.BLOCK_8X8 else TxSize.TX_4X4)
        all_zero = True
        for pidx, txs in ((0, y_tx), (1, uv_tx), (2, uv_tx)):
            ss = st.planes[pidx].subsampling
            for x4, y4 in tx_blocks_of(eff, txs, ss):
                if not _visible(st, pidx, mi_row, mi_col, x4, y4):
                    continue
                if pidx == 0:
                    key = (0, mi_row * 2 + y4, mi_col * 2 + x4)
                else:
                    key = (pidx, mi_row + y4, mi_col + x4)
                all_zero &= st.eobs[key] == 0
        mi.skip = all_zero
        if mi.skip:
            # skip+inter under TX_MODE_SELECT implies the max tx size
            mi.tx_size = T.MAX_TX_SIZE[bsize]
            st.mig.set_block(mi_row, mi_col, bsize, mi)


def _encode_intra_in_inter(st, mi, mi_row, mi_col, bsize, qindex, qbias):
    dc_q = T.dc_quant(qindex)
    ac_q = T.ac_quant(qindex)
    all_zero = True
    y_tx = mi.tx_size
    tx_type = MI.y_tx_type(mi.y_mode, False, False, y_tx)
    w4y, _ = plane_block_geometry(bsize, 0)
    for x4, y4 in tx_blocks_of(bsize, y_tx, 0):
        if not _visible(st, 0, mi_row, mi_col, x4, y4):
            continue
        levels, eob, _ = encode_tx_block_intra(
            st, 0, mi.y_mode, mi_row, mi_col, x4, y4, y_tx, tx_type,
            dc_q, ac_q, w4y, qbias)
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
                st, pidx, mi.uv_mode, mi_row, mi_col, x4, y4, uv_tx,
                TxType.DCT_DCT, dc_q, ac_q, w4uv, qbias)
            st.levels[(pidx, mi_row + y4, mi_col + x4)] = levels
            st.eobs[(pidx, mi_row + y4, mi_col + x4)] = eob
            all_zero &= eob == 0
    mi.skip = all_zero


def serialize_pframe(st: FrameState, events, qindex: int, fc=None,
                     counts_sink=None,
                     tx_mode=T.TxMode.ALLOW_32X32,
                     reference_mode: int = 0,
                     sign_bias=(0, 0, 0, 0)) -> bytes:
    """Pass B for a P frame (single tile)."""
    if fc is None:
        fc = T.default_frame_context()
    from tpu_vp9_torch.codec.intra_frame import pack_tiles
    from tpu_vp9_torch.native import make_bool_encoder

    tiles = []
    enc = None
    pctx = MI.PartitionContext(st.mi_rows, st.mi_cols)
    planes_ctx = None
    full_probs = {
        (ts, uv, ref): tok.full_probs_for(fc, ts, uv, is_inter=ref)
        for ts in TxSize for uv in (False, True) for ref in (False, True)
    }
    dc_q, ac_q = T.dc_quant(qindex), T.ac_quant(qindex)

    for ev, mi_row, mi_col, bsize, part in events:
        if ev == "tile":
            if enc is not None:
                tiles.append(enc.finalize())
            enc = make_bool_encoder()
            st.mig.tile_mi_start, st.mig.tile_mi_end = mi_row, mi_col
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
            MI.write_partition(enc, fc.partition_probs[ctx], part,
                               has_rows, has_cols)
            if counts_sink is not None:
                # decoder counts every partition symbol incl. forced ones
                # (vp9 decodeframe read_partition)
                counts_sink["partition"][ctx, int(part)] += 1
            if part != Partition.SPLIT or bsize == BlockSize.BLOCK_8X8:
                sub = T.SUBSIZE[(part, bsize)]
                pctx.update(mi_row, mi_col, sub, bsize)
            continue
        mi = st.mig.get(mi_row, mi_col)
        sctx = MI.skip_ctx(st.mig, mi_row, mi_col)
        enc.put_bit(1 if mi.skip else 0, int(fc.skip_probs[sctx]))
        if counts_sink is not None:
            counts_sink["skip"][sctx, 1 if mi.skip else 0] += 1
        # is_inter
        iictx = intra_inter_ctx(st.mig, mi_row, mi_col)
        enc.put_bit(1 if mi.is_inter else 0,
                    int(fc.intra_inter_probs[iictx]))
        if counts_sink is not None:
            counts_sink["intra_inter"][iictx, 1 if mi.is_inter else 0] += 1
        if (tx_mode == T.TxMode.TX_MODE_SELECT
                and bsize >= BlockSize.BLOCK_8X8
                and (not mi.skip or not mi.is_inter)):
            MI.write_tx_size(enc, fc, st.mig, mi_row, mi_col, bsize,
                             mi.tx_size)
            if counts_sink is not None:
                txctx = MI.tx_size_ctx(st.mig, mi_row, mi_col, bsize)
                max_tx = T.MAX_TX_SIZE[bsize]
                key = {3: "tx_p32", 2: "tx_p16", 1: "tx_p8"}[int(max_tx)]
                counts_sink[key][txctx, int(mi.tx_size)] += 1
        if not mi.is_inter:
            if bsize < BlockSize.BLOCK_8X8:
                # per-sub-block modes (bmi), inter-frame intra trees
                from tpu_vp9_torch.codec.intra_frame import _sub8x8_rc_steps

                for j, _, _ in _sub8x8_rc_steps(bsize):
                    m = int(mi.sub_modes[j])
                    T.write_token(enc, "intra_mode_tree", fc.if_y_probs[0],
                                  m)
                    if counts_sink is not None:
                        counts_sink["y_mode"][0, m] += 1
            else:
                grp = T.SIZE_GROUP[bsize]
                T.write_token(enc, "intra_mode_tree", fc.if_y_probs[grp],
                              int(mi.y_mode))
                if counts_sink is not None:
                    counts_sink["y_mode"][grp, int(mi.y_mode)] += 1
            T.write_token(enc, "intra_mode_tree",
                          fc.if_uv_probs[int(mi.y_mode)], int(mi.uv_mode))
            if counts_sink is not None:
                counts_sink["uv_mode"][int(mi.y_mode), int(mi.uv_mode)] += 1
        else:
            compound = mi.ref_frame[1] > 0
            if reference_mode == 2:
                fixed_ref, _ = compound_refs(sign_bias)
                cctx = comp_inter_ctx(st.mig, mi_row, mi_col, fixed_ref)
                enc.put_bit(1 if compound else 0,
                            int(fc.comp_inter_probs[cctx]))
                if counts_sink is not None:
                    counts_sink["comp_inter"][cctx,
                                              1 if compound else 0] += 1
            if compound:
                fixed_ref, var_refs = compound_refs(sign_bias)
                idx = sign_bias[fixed_ref]
                var = mi.ref_frame[1 - idx]
                rctx = comp_ref_ctx(st.mig, mi_row, mi_col, sign_bias)
                bit = 1 if var == var_refs[1] else 0
                enc.put_bit(bit, int(fc.comp_ref_probs[rctx]))
                if counts_sink is not None:
                    counts_sink["comp_ref"][rctx, bit] += 1
            else:
                # single reference selection
                rctx = single_ref_p1_ctx(st.mig, mi_row, mi_col)
                not_last = mi.ref_frame[0] != int(RefFrame.LAST)
                enc.put_bit(1 if not_last else 0,
                            int(fc.single_ref_probs[rctx, 0]))
                if counts_sink is not None:
                    counts_sink["single_ref"][rctx, 0,
                                              1 if not_last else 0] += 1
                if not_last:
                    rctx2 = single_ref_p2_ctx(st.mig, mi_row, mi_col)
                    is_alt = mi.ref_frame[0] == int(RefFrame.ALTREF)
                    enc.put_bit(1 if is_alt else 0,
                                int(fc.single_ref_probs[rctx2, 1]))
                    if counts_sink is not None:
                        counts_sink["single_ref"][rctx2, 1,
                                                  1 if is_alt else 0] += 1
            best_refs = (mi.best_ref_mv,
                         getattr(mi, "best_ref_mv2", (0, 0)))
            if bsize < BlockSize.BLOCK_8X8:
                # bmi loop: per-sub-block inter mode + NEWMV mvds
                # (vp9_bitstream.c:360 write_modes_b sub-8x8 branch)
                from tpu_vp9_torch.codec.intra_frame import _sub8x8_rc_steps

                for j, _, _ in _sub8x8_rc_steps(bsize):
                    bm = int(mi.sub_modes[j])
                    T.write_token(enc, "inter_mode_tree",
                                  fc.inter_mode_probs[mi.mode_context], bm)
                    if counts_sink is not None:
                        counts_sink["inter_mode"][mi.mode_context, bm] += 1
                    if bm == 3:
                        for i in range(2 if compound else 1):
                            MV.write_mv(enc, mi.sub_mvs[j][i],
                                        best_refs[i], fc.nmv, False)
                            if counts_sink is not None:
                                from tpu_vp9_torch.codec.adapt import inc_mv

                                inc_mv(counts_sink,
                                       (mi.sub_mvs[j][i][0]
                                        - best_refs[i][0],
                                        mi.sub_mvs[j][i][1]
                                        - best_refs[i][1]))
            else:
                # inter mode
                T.write_token(enc, "inter_mode_tree",
                              fc.inter_mode_probs[mi.mode_context],
                              int(mi.inter_mode))
                if counts_sink is not None:
                    counts_sink["inter_mode"][mi.mode_context,
                                              int(mi.inter_mode)] += 1
                if mi.inter_mode == 3:  # NEWMV
                    for i in range(2 if compound else 1):
                        MV.write_mv(enc, mi.mv[i], best_refs[i], fc.nmv,
                                    False)
                        if counts_sink is not None:
                            from tpu_vp9_torch.codec.adapt import inc_mv

                            inc_mv(counts_sink,
                                   (mi.mv[i][0] - best_refs[i][0],
                                    mi.mv[i][1] - best_refs[i][1]))
        # tokens (sub-8x8 blocks code the enclosing 8x8 geometry at TX_4X4)
        eff = bsize if bsize >= BlockSize.BLOCK_8X8 else BlockSize.BLOCK_8X8
        y_tx = mi.tx_size
        uv_tx = (MI.uv_tx_size(bsize, y_tx)
                 if bsize >= BlockSize.BLOCK_8X8 else T.TxSize.TX_4X4)
        if mi.skip:
            for pidx in (0, 1, 2):
                ss = st.planes[pidx].subsampling
                pc = planes_ctx[pidx]
                w4, h4 = plane_block_geometry(eff, ss)
                bx4 = (mi_col * 2) >> ss
                by4 = (mi_row * 2) >> ss
                pc.above[bx4 : bx4 + w4] = 0
                pc.left[by4 : by4 + h4] = 0
            continue
        if mi.is_inter:
            tx_type = TxType.DCT_DCT
        else:
            tx_type = MI.y_tx_type(mi.y_mode, False, False, y_tx)
        for pidx, txs, tt in ((0, y_tx, tx_type), (1, uv_tx, TxType.DCT_DCT),
                              (2, uv_tx, TxType.DCT_DCT)):
            ss = st.planes[pidx].subsampling
            pc = planes_ctx[pidx]
            probs = full_probs[(txs, pidx > 0, mi.is_inter)]
            for x4, y4 in tx_blocks_of(eff, txs, ss):
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
                    pt_i = 1 if pidx else 0
                    ref_i = 1 if mi.is_inter else 0
                    cnt = counts_sink[("coef", txs)][pt_i, ref_i]
                    ecnt = counts_sink[("eob", txs)][pt_i, ref_i]
                tt_blk = tt
                if (pidx == 0 and not mi.is_inter
                        and bsize < BlockSize.BLOCK_8X8):
                    # sub-8x8 intra: per-sub-block tx type from its mode
                    tt_blk = MI.y_tx_type(
                        IntraMode(int(mi.sub_modes[y4 * 2 + x4])), False,
                        False, txs)
                eob = tok.write_coeffs_any(enc, levels, txs, tt_blk, probs,
                                           ctx0, cnt, ecnt)
                pc.set_ctx(gx4, gy4, txs, eob > 0,
                           (st.mi_cols * 2) >> ss, (st.mi_rows * 2) >> ss)
    tiles.append(enc.finalize())
    return pack_tiles(tiles)


def _native_phase1(st: FrameState, refs, events, qindex: int,
                   search_range: int, do_subpel: bool, pending: list,
                   intra_leaves: list) -> bool:
    """Run phase-1 mode decision through the native fast loop when the
    active toolset is covered by it (the M5-M9 fast-loop configuration:
    no full loop, no QPM lambda map, no device-ME hints, no partition
    probes).  Appends to pending/intra_leaves exactly like the Python
    loop; returns False to request the Python fallback.

    Bit-identical to decide_leaf_inter (tests/test_native_fastloop.py);
    the per-leaf Python overhead — the round-3 host regression — is gone.
    """
    import os

    from tpu_vp9_torch import native as nat

    if os.environ.get("TPU_VP9_NO_NATIVE_FASTLOOP") == "1":
        return False
    if (getattr(st, "_rd_costs", None) is not None
            or getattr(st, "_lambda_map", None) is not None
            or getattr(st, "_tpu_mv", None) is not None
            or getattr(st, "_probe_cache", None)):
        return False
    lib = nat.get_lib()
    if lib is None or not hasattr(lib, "fast_loop_decide"):
        return False
    ac_q = T.ac_quant(qindex)
    lam = max(1, (ac_q * ac_q) >> 6)
    LAST, GOLD, ALT = (int(RefFrame.LAST), int(RefFrame.GOLDEN),
                       int(RefFrame.ALTREF))
    ranges_in = getattr(st, "_ref_ranges", None) or {}
    ref_sets = {LAST: refs,
                GOLD: getattr(st, "_golden_refs", None),
                ALT: getattr(st, "_altref_refs", None)}
    defaults = {LAST: search_range,
                GOLD: max(search_range // 2, 8),
                ALT: search_range}
    ranges3 = []
    triples = []
    for rid in (LAST, GOLD, ALT):
        planes = ref_sets[rid]
        if planes is None:
            ranges3.append(0)
            triples.append(None)
            continue
        rng = int(ranges_in.get(rid, defaults[rid]))
        ranges3.append(rng)
        full = planes[0]
        if full.dtype != np.uint8 or not full.flags["C_CONTIGUOUS"]:
            return False
        half = quarter = None
        if rng >= 32:
            cache = getattr(st, "_hme_cache", None)
            if cache is None:
                cache = st._hme_cache = {}
            pyr = cache.get(id(full))
            if pyr is None:
                pyr = cache[id(full)] = hme_ops.build_pyramid(full)
            half = np.ascontiguousarray(pyr[1])
            quarter = np.ascontiguousarray(pyr[2])
        triples.append((full, half, quarter))
    prev_mvs = getattr(st, "_prev_mvs", None)
    if prev_mvs is not None:
        p0, p1, m0, m1 = prev_mvs
        prev_mvs = (np.ascontiguousarray(p0, np.int8),
                    np.ascontiguousarray(p1, np.int8),
                    np.ascontiguousarray(m0, np.int32),
                    np.ascontiguousarray(m1, np.int32))
    restrict = getattr(st, "_restrict_mv", False)
    sign_bias = getattr(st, "_sign_bias", None) or (0, 0, 0, 0)
    mig = st.mig
    fields = (mig.f_inter.view(np.uint8), mig.f_ref0, mig.f_ref1,
              mig.f_mode, mig.f_mv, mig.f_mv1)
    pl = st.planes[0]
    src = pl.source
    if src.dtype != np.uint8 or not src.flags["C_CONTIGUOUS"]:
        return False

    # group decode-order leaves by tile segment
    segments = []  # (tile_start, tile_end, [(mi_row, mi_col, bsize)...])
    cur = None
    for ev, mi_row, mi_col, bsize, _ in events:
        if ev == "tile":
            cur = (mi_row, mi_col, [])
            segments.append(cur)
        elif ev == "leaf":
            cur[2].append((mi_row, mi_col, int(bsize)))
    jobs = []  # winner-MC jobs: (mi_row, mi_col, bsize, ref0, ref1, mvs)
    for tile_start, tile_end, leaves in segments:
        st.tile_mi_start = tile_start
        mig.tile_mi_start, mig.tile_mi_end = tile_start, tile_end
        if not leaves:
            continue
        out = nat.native_fast_loop_decide(
            st.mi_rows, st.mi_cols, tile_start, tile_end, BORDER,
            pl.width, pl.height, src, triples, ranges3, lam, do_subpel,
            restrict, (sign_bias[0], sign_bias[1], sign_bias[2],
                       sign_bias[3]), prev_mvs, fields,
            np.asarray(leaves, np.int32))
        if out is None:
            return False
        for (mi_row, mi_col, bsize), o in zip(leaves, out):
            bsize = BlockSize(bsize)
            kind = int(o[0])
            if kind == 0:
                mi = MI.ModeInfo(bsize=bsize, y_mode=IntraMode.DC_PRED,
                                 uv_mode=IntraMode.DC_PRED,
                                 tx_size=T.MAX_TX_SIZE[bsize], skip=False,
                                 is_inter=False)
                mi.tile_mi_start = tile_start
                st.mig.set_block(mi_row, mi_col, bsize, mi)
                intra_leaves.append((mi_row, mi_col, bsize))
                continue
            ref0 = int(o[1])
            mv0 = (int(o[5]), int(o[6]))
            if kind == 2:
                ref1 = int(o[2])
                mv1 = (int(o[7]), int(o[8]))
                mi = MI.ModeInfo(bsize=bsize, tx_size=T.MAX_TX_SIZE[bsize],
                                 skip=False, is_inter=True,
                                 ref_frame=(ref0, ref1), mv=(mv0, mv1),
                                 inter_mode=int(o[3]))
                mi.best_ref_mv2 = (int(o[11]), int(o[12]))
            else:
                ref1 = -1
                mv1 = (0, 0)
                mi = MI.ModeInfo(bsize=bsize, tx_size=T.MAX_TX_SIZE[bsize],
                                 skip=False, is_inter=True,
                                 ref_frame=(ref0, -1), mv=(mv0, (0, 0)),
                                 inter_mode=int(o[3]))
            mi.mode_context = int(o[4])
            mi.best_ref_mv = (int(o[9]), int(o[10]))
            st.mig.set_block(mi_row, mi_col, bsize, mi)
            pending.append((mi, mi_row, mi_col, bsize, None))
            jobs.append((mi_row, mi_col, int(bsize), ref0, ref1,
                         mv0[0], mv0[1], mv1[0], mv1[1]))
    if jobs:
        # all winner predictions in one native pass (MC is tile-agnostic)
        mc = nat.native_mc_predict_winners(
            {rid: ref_sets[rid] for rid in ref_sets}, BORDER, st.mi_rows,
            st.mi_cols, np.asarray(jobs, np.int32))
        if mc is None:
            return False
        for i, (mi, mi_row, mi_col, bsize, _) in enumerate(pending):
            y, u, v = mc[i]
            px, py = mi_col * 8, mi_row * 8
            pending[i] = (mi, mi_row, mi_col, bsize,
                          [(y, px, py), (u, px >> 1, py >> 1),
                           (v, px >> 1, py >> 1)])
    return True


# the device search runs at a fixed range (one kernel shape per (B, n))
DEVICE_ME_RANGE = 16


def encode_pframe(frame, refs, qindex: int,
                  block_size=BlockSize.BLOCK_32X32, search_range: int = 16,
                  qbias: float = 0.38, do_subpel: bool = True,
                  prob_update: bool = True, log2_tile_cols: int = 0,
                  adaptive_partition: bool = False, golden_refs=None,
                  tx_select: bool = False, use_tpu_me: bool = False,
                  fc_base=None, restrict_mv_modes: bool = False,
                  prev_mvs=None, part_depths=None, altref_refs=None,
                  ref_ranges=None, sign_bias=(0, 0, 0), lambda_map=None,
                  full_loop: bool = False, adp_budget: float = 1.0,
                  device="cuda"):
    """Encode one P frame against border-extended refs [y, u, v].

    golden_refs: optional second (long-term) reference planes; blocks then
    choose LAST vs GOLDEN per-block.  altref_refs: optional third
    reference (hierarchical-GOP future anchor).  ref_ranges: optional
    {ref_id: full-pel search range} derived from temporal distance.
    device: where the full-pel search runs when use_tpu_me is set and the
    frame has at least 1280x720 pixels; a failure there propagates (the
    JAX package falls back to the host search instead).
    Returns (tile_bytes, FrameState).
    """
    h, w = frame.y.shape
    mi_rows, mi_cols = (h + 7) >> 3, (w + 7) >> 3
    st = make_frame_state(frame, mi_rows, mi_cols)
    st._golden_refs = golden_refs
    st._altref_refs = altref_refs
    st._ref_ranges = ref_ranges
    st._restrict_mv = restrict_mv_modes
    st._prev_mvs = prev_mvs
    st._sign_bias = (0,) + tuple(sign_bias)
    st._lambda_map = lambda_map
    st._qbias = qbias
    st._rd_costs = None
    if full_loop:
        from tpu_vp9_torch.bitstream.tables import default_frame_context
        from tpu_vp9_torch.codec.rd_cost import FrameCosts

        st._rd_costs = FrameCosts(
            fc_base if fc_base is not None else default_frame_context(),
            qindex)
    # Device ME pays off when the per-frame block count is large enough to
    # amortize the host<->device round-trip (and its one-time compile).
    if use_tpu_me and w * h >= 1280 * 720:
        from tpu_vp9_torch.utils.trace import span as _span

        n = T.BLOCK_WH[block_size][0]
        hh = (h // n) * n
        ww = (w // n) * n
        if hh and ww:
            # fixed range: one kernel shape per (B, n)
            with _span("device_me"):
                mvs = tpu_block_motion(
                    st.planes[0].source[:hh, :ww], refs[0], BORDER, n,
                    DEVICE_ME_RANGE, device)
            st._tpu_mv = (mvs, n)
    from tpu_vp9_torch.utils.trace import span

    with span("partition"):
        if part_depths is not None:
            events = decide_partition_tree(st, refs, qindex, search_range,
                                           part_depths[0], part_depths[1],
                                           log2_tile_cols)
        else:
            events = walk_partition_fixed(mi_rows, mi_cols, block_size,
                                          log2_tile_cols)
            if adaptive_partition and block_size == BlockSize.BLOCK_32X32:
                events = decide_partition_map(st, refs, events, qindex,
                                              search_range,
                                              budget_frac=adp_budget)
    # phase 1: decisions (decode order; mvrefs see final neighbor choices)
    pending = []
    intra_leaves = []
    with span("mode_decision"):
        native_done = _native_phase1(st, refs, events, qindex, search_range,
                                     do_subpel, pending, intra_leaves)
        if not native_done:
            for ev, mi_row, mi_col, bsize, _ in events:
                if ev == "tile":
                    st.tile_mi_start = mi_row
                    st.mig.tile_mi_start, st.mig.tile_mi_end = mi_row, mi_col
                    continue
                if ev != "leaf":
                    continue
                if bsize < BlockSize.BLOCK_8X8:
                    entry = decide_leaf_sub8x8_inter(
                        st, refs, mi_row, mi_col, bsize, qindex, do_subpel)
                else:
                    entry = decide_leaf_inter(st, refs, mi_row, mi_col,
                                              bsize, qindex, search_range,
                                              do_subpel)
                if entry is None:
                    intra_leaves.append((mi_row, mi_col, bsize))
                else:
                    pending.append(entry)
    # phase 2: all inter blocks batched (independent of each other)
    with span("batch_txfm"):
        if tx_select:
            decide_tx_sizes(st, pending, qindex, qbias)
            for mi, mi_row, mi_col, bsize, _ in pending:
                st.mig.set_block(mi_row, mi_col, bsize, mi)  # refresh tx
        batch_encode_inter_blocks(st, pending, qindex, qbias)
    # phase 3: intra-fallback leaves, exact recon in decode order
    with span("intra_fallback"):
        for mi_row, mi_col, bsize in intra_leaves:
            mi = st.mig.get(mi_row, mi_col)
            st.tile_mi_start = getattr(mi, "tile_mi_start", 0)
            _encode_intra_in_inter(st, mi, mi_row, mi_col, bsize, qindex,
                                   qbias)
    tx_mode = T.TxMode.TX_MODE_SELECT if tx_select else T.TxMode.ALLOW_32X32
    # frame-level reference mode from the per-block outcomes (libvpx
    # vp9_encodeframe: SINGLE if no compound blocks, COMPOUND if all,
    # SELECT otherwise)
    reference_mode = 0
    if len(set(sign_bias)) > 1:
        n_comp = n_single = 0
        for ev, mi_row, mi_col, bsize, _ in events:
            if ev != "leaf":
                continue
            mi = st.mig.get(mi_row, mi_col)
            if mi is None or not mi.is_inter:
                continue
            if mi.ref_frame[1] > 0:
                n_comp += 1
            else:
                n_single += 1
        if n_comp and n_single:
            reference_mode = 2
        elif n_comp:
            reference_mode = 1
    st.reference_mode = reference_mode
    import functools

    ser = functools.partial(serialize_pframe, tx_mode=tx_mode,
                            reference_mode=reference_mode,
                            sign_bias=st._sign_bias)
    with span("serialize"):
        if prob_update:
            from tpu_vp9_torch.codec.fwd_update import serialize_with_updates

            tile, st.header_updates, st.fc_final, st.counts = \
                serialize_with_updates(
                st, events, qindex, ser, fc_base)
        else:
            tile = ser(st, events, qindex, fc=fc_base)
            st.fc_final = fc_base
    return tile, st
