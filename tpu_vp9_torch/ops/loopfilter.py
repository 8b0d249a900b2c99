"""VP9 in-loop deblocking filter — exact, vectorized along edges.

Parity reference: vendored libvpx ``loopfilter.c`` (filter4/8/16 kernels,
masks) and ``vp9_loopfilter.c`` (level LUT, sharpness limits, per-edge
width selection, ordering) in SVT-VP9.  Ordering contract (bit-exact with
libvpx): superblocks in raster order; per SB all vertical edges (top
band to bottom, left position to right, main edge then internal 4x4
edge), then all horizontal edges likewise; frame left/top boundaries
unfiltered.

Filters are vectorized along the edge (8/16-pixel segments at once as
numpy rows), which is also the layout the Pallas TPU kernel uses.
"""

from __future__ import annotations

import functools

import numpy as np

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream.tables import BlockSize, TxSize
from tpu_vp9_torch.codec import modeinfo as MI

MAX_LOOP_FILTER = 63

# mode_lf_lut: intra modes 0; NEARESTMV,NEARMV,NEWMV -> 1; ZEROMV -> 0
MODE_LF_LUT = [0] * 10 + [1, 1, 0, 1]


@functools.cache
def sharpness_limits(sharpness: int):
    """(lim[64], mblim[64]) per filter level."""
    lim = np.zeros(64, np.int32)
    mblim = np.zeros(64, np.int32)
    for lvl in range(64):
        block_inside = lvl >> ((sharpness > 0) + (sharpness > 4))
        if sharpness > 0:
            block_inside = min(block_inside, 9 - sharpness)
        block_inside = max(block_inside, 1)
        lim[lvl] = block_inside
        mblim[lvl] = 2 * (lvl + 2) + block_inside
    return lim, mblim


def hev_thresh(lvl: int) -> int:
    return lvl >> 4


def build_level_lut(filter_level: int, ref_deltas, mode_deltas,
                    delta_enabled: bool):
    """lvl[ref 0..3][mode 0..1] (ref 0 = intra, uses mode index 0)."""
    lut = np.zeros((4, 2), np.int32)
    if not delta_enabled:
        lut[:] = filter_level
        return lut
    scale = 1 << (filter_level >> 5)
    lut[0, :] = np.clip(filter_level + ref_deltas[0] * scale, 0,
                        MAX_LOOP_FILTER)
    for ref in range(1, 4):
        for mode in range(2):
            lut[ref, mode] = np.clip(
                filter_level + ref_deltas[ref] * scale
                + mode_deltas[mode] * scale, 0, MAX_LOOP_FILTER)
    return lut


def mi_filter_level(lut, mi: MI.ModeInfo) -> int:
    if not mi.is_inter:
        return int(lut[0, 0])
    mode = MODE_LF_LUT[10 + int(mi.inter_mode)]
    return int(lut[mi.ref_frame[0], mode])


def _c8(x):
    """signed char clamp on int32 arrays."""
    return np.clip(x, -128, 127)


def _filter_mask(limit, blimit, p, q):
    """p/q: lists of arrays p[0..3], q[0..3] (p[0] adjacent)."""
    m = (np.abs(p[3] - p[2]) > limit)
    m |= np.abs(p[2] - p[1]) > limit
    m |= np.abs(p[1] - p[0]) > limit
    m |= np.abs(q[1] - q[0]) > limit
    m |= np.abs(q[2] - q[1]) > limit
    m |= np.abs(q[3] - q[2]) > limit
    m |= (np.abs(p[0] - q[0]) * 2 + np.abs(p[1] - q[1]) // 2) > blimit
    return ~m


def _flat_mask4(thresh, p, q):
    m = np.abs(p[1] - p[0]) > thresh
    m |= np.abs(q[1] - q[0]) > thresh
    m |= np.abs(p[2] - p[0]) > thresh
    m |= np.abs(q[2] - q[0]) > thresh
    m |= np.abs(p[3] - p[0]) > thresh
    m |= np.abs(q[3] - q[0]) > thresh
    return ~m


def _flat_mask5(thresh, p, q):
    """flat2: outer pixels p4..p7/q4..q7 vs p0/q0 only (spec flat_mask5
    invoked with (p7,p6,p5,p4,p0,q0,q4,q5,q6,q7))."""
    m = np.zeros(p[0].shape, bool)
    for k in range(4, 8):
        m |= np.abs(p[k] - p[0]) > thresh
        m |= np.abs(q[k] - q[0]) > thresh
    return ~m


def _filter4_core(mask, thresh, p1, p0, q0, q1):
    """Returns new (p1, p0, q0, q1) int32 arrays."""
    hev = (np.abs(p1 - p0) > thresh) | (np.abs(q1 - q0) > thresh)
    ps1, ps0 = p1 - 128, p0 - 128
    qs0, qs1 = q0 - 128, q1 - 128
    f = np.where(hev, _c8(ps1 - qs1), 0)
    f = np.where(mask, _c8(f + 3 * (qs0 - ps0)), 0)
    f1 = _c8(f + 4) >> 3
    f2 = _c8(f + 3) >> 3
    nq0 = _c8(qs0 - f1) + 128
    np0 = _c8(ps0 + f2) + 128
    fa = np.where(hev, 0, (f1 + 1) >> 1)
    nq1 = _c8(qs1 - fa) + 128
    np1 = _c8(ps1 + fa) + 128
    return np1, np0, nq0, nq1


def _rp2(x, n):
    return (x + (1 << (n - 1))) >> n


def filter_edge(p, q, width, lvl, lim, mblim):
    """Filter one edge; p[k]/q[k] int32 arrays (k pixels from the edge).

    width: 4, 8, or 16 — scalar or per-row array (0 = unfiltered rows).
    lvl: scalar or per-row array of filter levels.
    Returns (new_p list, new_q list) of modified arrays (p[0..n], q[0..n]).
    """
    lvl = np.asarray(lvl)
    width = np.asarray(width)
    thresh = hev_thresh(lvl)
    limit = lim[lvl]
    blimit = mblim[lvl]
    if width.ndim or lvl.ndim:
        return _filter_edge_mixed(p, q, width, thresh, limit, blimit)
    width = int(width)
    mask = _filter_mask(limit, blimit, p[:4], q[:4])
    np1, np0, nq0, nq1 = _filter4_core(mask, thresh, p[1], p[0], q[0], q[1])
    if width == 4:
        return [np0, np1], [nq0, nq1]
    flat = _flat_mask4(1, p[:4], q[:4]) & mask
    # 7-tap
    s = [None] * 3
    o = [None] * 3
    s[2] = _rp2(p[3] + p[3] + p[3] + 2 * p[2] + p[1] + p[0] + q[0], 3)
    s[1] = _rp2(p[3] + p[3] + p[2] + 2 * p[1] + p[0] + q[0] + q[1], 3)
    s[0] = _rp2(p[3] + p[2] + p[1] + 2 * p[0] + q[0] + q[1] + q[2], 3)
    o[0] = _rp2(p[2] + p[1] + p[0] + 2 * q[0] + q[1] + q[2] + q[3], 3)
    o[1] = _rp2(p[1] + p[0] + q[0] + 2 * q[1] + q[2] + q[3] + q[3], 3)
    o[2] = _rp2(p[0] + q[0] + q[1] + 2 * q[2] + q[3] + q[3] + q[3], 3)
    p8 = [np.where(flat, s[0], np0), np.where(flat, s[1], np1),
          np.where(flat, s[2], p[2])]
    q8 = [np.where(flat, o[0], nq0), np.where(flat, o[1], nq1),
          np.where(flat, o[2], q[2])]
    if width == 8:
        return p8, q8
    flat2 = _flat_mask5(1, p, q) & flat
    # 15-tap
    ps = [None] * 7
    qs = [None] * 7
    for k in range(7):
        # output p[k]: p7*(k+1) + 2*p[k] + singles p[k+1..6], p[0..k-1],
        # q[0..6-k]  (15-tap [1,..,1,2,1,..,1] with edge replication)
        acc = p[7] * (k + 1) + 2 * p[k]
        for j in range(k + 1, 7):
            acc += p[j]
        for j in range(k):
            acc += p[j]
        for j in range(0, 7 - k):
            acc += q[j]
        ps[k] = _rp2(acc, 4)
        acc = q[7] * (k + 1) + 2 * q[k]
        for j in range(k + 1, 7):
            acc += q[j]
        for j in range(k):
            acc += q[j]
        for j in range(0, 7 - k):
            acc += p[j]
        qs[k] = _rp2(acc, 4)
    pout = [np.where(flat2, ps[k], p8[k] if k < 3 else p[k])
            for k in range(7)]
    qout = [np.where(flat2, qs[k], q8[k] if k < 3 else q[k])
            for k in range(7)]
    return pout, qout


def _filter_edge_mixed(p, q, width, thresh, limit, blimit):
    """Vectorized edge filter with per-row width (0/4/8/16) and level."""
    mask = _filter_mask(limit, blimit, p[:4], q[:4]) & (width > 0)
    np1, np0, nq0, nq1 = _filter4_core(mask, thresh, p[1], p[0], q[0], q[1])
    w8 = width >= 8
    flat = _flat_mask4(1, p[:4], q[:4]) & mask & w8
    s2 = _rp2(p[3] + p[3] + p[3] + 2 * p[2] + p[1] + p[0] + q[0], 3)
    s1 = _rp2(p[3] + p[3] + p[2] + 2 * p[1] + p[0] + q[0] + q[1], 3)
    s0 = _rp2(p[3] + p[2] + p[1] + 2 * p[0] + q[0] + q[1] + q[2], 3)
    o0 = _rp2(p[2] + p[1] + p[0] + 2 * q[0] + q[1] + q[2] + q[3], 3)
    o1 = _rp2(p[1] + p[0] + q[0] + 2 * q[1] + q[2] + q[3] + q[3], 3)
    o2 = _rp2(p[0] + q[0] + q[1] + 2 * q[2] + q[3] + q[3] + q[3], 3)
    p8 = [np.where(flat, s0, np0), np.where(flat, s1, np1),
          np.where(flat, s2, p[2])]
    q8 = [np.where(flat, o0, nq0), np.where(flat, o1, nq1),
          np.where(flat, o2, q[2])]
    if len(p) < 8:
        return p8, q8
    w16 = width >= 16
    flat2 = _flat_mask5(1, p, q) & flat & w16
    ps = [None] * 7
    qs = [None] * 7
    for k in range(7):
        acc = p[7] * (k + 1) + 2 * p[k]
        for j in range(k + 1, 7):
            acc += p[j]
        for j in range(k):
            acc += p[j]
        for j in range(0, 7 - k):
            acc += q[j]
        ps[k] = _rp2(acc, 4)
        acc = q[7] * (k + 1) + 2 * q[k]
        for j in range(k + 1, 7):
            acc += q[j]
        for j in range(k):
            acc += q[j]
        for j in range(0, 7 - k):
            acc += p[j]
        qs[k] = _rp2(acc, 4)
    pout = [np.where(flat2, ps[k], p8[k] if k < 3 else p[k])
            for k in range(7)]
    qout = [np.where(flat2, qs[k], q8[k] if k < 3 else q[k])
            for k in range(7)]
    return pout, qout


def _apply_vert(plane, x: int, y0: int, nrows: int, width: int, lvl: int,
                lim, mblim) -> None:
    taps = 8 if width == 16 else 4
    p = [plane[y0 : y0 + nrows, x - 1 - k].astype(np.int32)
         for k in range(taps)]
    q = [plane[y0 : y0 + nrows, x + k].astype(np.int32) for k in range(taps)]
    np_, nq_ = filter_edge(p, q, width, lvl, lim, mblim)
    for k, arr in enumerate(np_):
        plane[y0 : y0 + nrows, x - 1 - k] = arr.astype(np.uint8)
    for k, arr in enumerate(nq_):
        plane[y0 : y0 + nrows, x + k] = arr.astype(np.uint8)


def _apply_horz(plane, y: int, x0: int, ncols: int, width: int, lvl: int,
                lim, mblim) -> None:
    taps = 8 if width == 16 else 4
    p = [plane[y - 1 - k, x0 : x0 + ncols].astype(np.int32)
         for k in range(taps)]
    q = [plane[y + k, x0 : x0 + ncols].astype(np.int32) for k in range(taps)]
    np_, nq_ = filter_edge(p, q, width, lvl, lim, mblim)
    for k, arr in enumerate(np_):
        plane[y - 1 - k, x0 : x0 + ncols] = arr.astype(np.uint8)
    for k, arr in enumerate(nq_):
        plane[y + k, x0 : x0 + ncols] = arr.astype(np.uint8)


@functools.cache
def _bsize_luts():
    """Per-bsize lookup arrays: w4, h4, w8, h8 and uv_tx[bsize][ytx]."""
    n = 13
    w4 = np.zeros(n, np.int32)
    h4 = np.zeros(n, np.int32)
    uv_tx = np.zeros((n, 4), np.int32)
    for bs in BlockSize:
        w, h = T.BLOCK_WH[bs]
        w4[int(bs)] = w // 4
        h4[int(bs)] = h // 4
        for tx in TxSize:
            if bs >= BlockSize.BLOCK_8X8:
                uv_tx[int(bs), int(tx)] = int(MI.uv_tx_size(bs, tx))
            else:
                uv_tx[int(bs), int(tx)] = 0
    w8 = np.maximum(w4 // 2, 1)
    h8 = np.maximum(h4 // 2, 1)
    return w4, h4, w8, h8, uv_tx


def _decisions_vectorized(mig, lut, ss: int):
    """(n_row_steps, n_col_steps, 5) int32 decisions, == _edges_for_mi."""
    step = 1 << ss
    bs = mig.f_bsize[::step, ::step].astype(np.int32)
    skip = mig.f_skip[::step, ::step]
    inter = mig.f_inter[::step, ::step]
    ref0 = mig.f_ref0[::step, ::step].astype(np.int32)
    mode = mig.f_mode[::step, ::step].astype(np.int32)
    ytx = mig.f_tx[::step, ::step].astype(np.int32)
    w4l, h4l, w8l, h8l, uvtxl = _bsize_luts()
    mlut = np.asarray(MODE_LF_LUT, np.int32)
    lvl = np.where(inter, lut[ref0, mlut[mode]], lut[0, 0])
    tx = ytx if ss == 0 else uvtxl[bs, ytx]
    rows = np.arange(0, mig.mi_rows, step)[:, None]
    cols = np.arange(0, mig.mi_cols, step)[None, :]
    w4b, h4b = w4l[bs], h4l[bs]
    w8b, h8b = w8l[bs], h8l[bs]
    skip_this = skip & inter
    bel = np.where(w4b > 1, (cols & (w8b - 1)) == 0, True)
    bea = np.where(h4b > 1, (rows & (h8b - 1)) == 0, True)
    skip_c = skip_this & ~bel
    skip_r = skip_this & ~bea
    cpos = cols >> ss
    rpos = rows >> ss
    sb_c = (ss != 0) & (cols == mig.mi_cols - 1)
    sb_r = (ss != 0) & (rows == mig.mi_rows - 1)
    vw = np.zeros_like(lvl)
    hw = np.zeros_like(lvl)
    vint = np.zeros_like(lvl)
    hint = np.zeros_like(lvl)
    for tval, align in ((3, 3), (2, 1)):  # TX_32X32, TX_16X16
        m = tx == tval
        cm = m & ~skip_c & ((cpos & align) == 0)
        vw = np.where(cm, np.where(sb_c, 8, 16), vw)
        rm = m & ~skip_r & ((rpos & align) == 0)
        hw = np.where(rm, np.where(sb_r, 8, 16), hw)
    small = tx <= 1
    cm = small & ~skip_c
    vw = np.where(cm, np.where((tx == 1) | ((cpos & 3) == 0), 8, 4), vw)
    rm = small & ~skip_r
    hw = np.where(rm, np.where((tx == 1) | ((rpos & 3) == 0), 8, 4), hw)
    tiny = (tx < 1) & ~skip_this
    vint = np.where(tiny & ~sb_c, 4, 0)
    hint = np.where(tiny & ~sb_r, 4, 0)
    zero = lvl == 0
    dec = np.stack([lvl, np.where(zero, 0, vw),
                    np.where(zero, 0, np.minimum(vint, 1)),
                    np.where(zero, 0, hw),
                    np.where(zero, 0, np.minimum(hint, 1))], axis=-1)
    return dec.astype(np.int32)


def _edges_for_mi(mig, lut, mi_r: int, mi_c: int, ss: int):
    """Edge decisions for one mi step (non420-equivalent logic).

    Returns (lvl, vmain_width|0, vint, hmain_width|0, hint) where widths
    are 4/8/16 and vint/hint flag internal tx4 edges."""
    mi = mig.grid[mi_r, mi_c]
    lvl = mi_filter_level(lut, mi)
    if lvl == 0:
        return 0, 0, False, 0, False
    bs = BlockSize(mi.bsize)
    w4b, h4b = T.BLOCK_WH[bs][0] // 4, T.BLOCK_WH[bs][1] // 4
    w8b, h8b = max(w4b // 2, 1), max(h4b // 2, 1)
    skip_this = mi.skip and mi.is_inter
    block_edge_left = (mi_c & (w8b - 1)) == 0 if w4b > 1 else True
    block_edge_above = (mi_r & (h8b - 1)) == 0 if h4b > 1 else True
    skip_c = skip_this and not block_edge_left
    skip_r = skip_this and not block_edge_above
    tx = mi.tx_size if ss == 0 else MI.uv_tx_size(bs, mi.tx_size)
    cpos = (mi_c >> ss)  # position in plane 8px units
    rpos = (mi_r >> ss)
    skip_border_c = ss and mi_c == mig.mi_cols - 1
    skip_border_r = ss and mi_r == mig.mi_rows - 1
    vw = hw = 0
    vint = hint = False
    if tx == TxSize.TX_32X32:
        if not skip_c and (cpos & 3) == 0:
            vw = 8 if skip_border_c else 16
        if not skip_r and (rpos & 3) == 0:
            hw = 8 if skip_border_r else 16
    elif tx == TxSize.TX_16X16:
        if not skip_c and (cpos & 1) == 0:
            vw = 8 if skip_border_c else 16
        if not skip_r and (rpos & 1) == 0:
            hw = 8 if skip_border_r else 16
    else:
        if not skip_c:
            vw = 8 if (tx == TxSize.TX_8X8 or (cpos & 3) == 0) else 4
        if not skip_r:
            hw = 8 if (tx == TxSize.TX_8X8 or (rpos & 3) == 0) else 4
        if not skip_this and tx < TxSize.TX_8X8:
            vint = not skip_border_c
            hint = not skip_border_r
    return lvl, vw, vint, hw, hint


def loop_filter_frame(planes, mig, filter_level: int, sharpness: int = 0,
                      ref_deltas=(1, 0, -1, -1), mode_deltas=(0, 0),
                      delta_enabled: bool = True) -> None:
    """Filter [y, u, v] planes in place (mi-aligned views)."""
    if filter_level == 0:
        return
    lim, mblim = sharpness_limits(sharpness)
    lut = build_level_lut(filter_level, ref_deltas, mode_deltas,
                          delta_enabled)
    mi_rows, mi_cols = mig.mi_rows, mig.mi_cols

    # native fast path (bit-identical; validated by tests)
    from tpu_vp9_torch.native import get_lib, native_lf_plane

    if get_lib() is not None:
        mig.refresh_fields()
        for pidx, plane in enumerate(planes):
            ss = 0 if pidx == 0 else 1
            dec = _decisions_vectorized(mig, lut, ss)
            native_lf_plane(plane, dec, 8 >> ss, 8, lim, mblim)
        return

    for sb_r in range(0, mi_rows, 8):
        for sb_c in range(0, mi_cols, 8):
            for pidx, plane in enumerate(planes):
                ss = 0 if pidx == 0 else 1
                step = 1 << ss
                mi_rs = list(range(sb_r, min(sb_r + 8, mi_rows), step))
                mi_cs = list(range(sb_c, min(sb_c + 8, mi_cols), step))
                dec = [[_edges_for_mi(mig, lut, r, c, ss) for c in mi_cs]
                       for r in mi_rs]
                nb = len(mi_rs)
                y0 = (sb_r * 8) >> ss
                # vertical edges: one mixed call per column position
                for ci, c in enumerate(mi_cs):
                    x = (c * 8) >> ss
                    wrow = np.zeros(nb * 8, np.int32)
                    irow = np.zeros(nb * 8, np.int32)
                    lrow = np.zeros(nb * 8, np.int32)
                    for ri in range(nb):
                        lvl, vw, vint, _, _ = dec[ri][ci]
                        lrow[ri * 8 : ri * 8 + 8] = lvl
                        if lvl:
                            wrow[ri * 8 : ri * 8 + 8] = vw
                            irow[ri * 8 : ri * 8 + 8] = 4 if vint else 0
                    if x > 0 and wrow.any():
                        _apply_vert_mixed(plane, x, y0, wrow, lrow, lim,
                                          mblim)
                    if irow.any():
                        _apply_vert_mixed(plane, x + 4, y0, irow, lrow, lim,
                                          mblim)
                # horizontal edges: one mixed call per band
                for ri, r in enumerate(mi_rs):
                    y = (r * 8) >> ss
                    ncols = len(mi_cs) * 8
                    x0 = (sb_c * 8) >> ss
                    wcol = np.zeros(ncols, np.int32)
                    icol = np.zeros(ncols, np.int32)
                    lcol = np.zeros(ncols, np.int32)
                    for ci in range(len(mi_cs)):
                        lvl, _, _, hw, hint = dec[ri][ci]
                        lcol[ci * 8 : ci * 8 + 8] = lvl
                        if lvl:
                            wcol[ci * 8 : ci * 8 + 8] = hw
                            icol[ci * 8 : ci * 8 + 8] = 4 if hint else 0
                    if y > 0 and wcol.any():
                        _apply_horz_mixed(plane, y, x0, wcol, lcol, lim,
                                          mblim)
                    if icol.any():
                        _apply_horz_mixed(plane, y + 4, x0, icol, lcol, lim,
                                          mblim)


def _apply_vert_mixed(plane, x: int, y0: int, widths, lvls, lim, mblim):
    # odd mi dims: the last step row holds a single mi (half a step)
    n = min(widths.size, plane.shape[0] - y0)
    widths, lvls = widths[:n], lvls[:n]
    taps = 8 if (widths >= 16).any() else 4
    p = [plane[y0 : y0 + n, x - 1 - k].astype(np.int32) for k in range(taps)]
    q = [plane[y0 : y0 + n, x + k].astype(np.int32) for k in range(taps)]
    np_, nq_ = filter_edge(p, q, widths, lvls, lim, mblim)
    for k, arr in enumerate(np_):
        plane[y0 : y0 + n, x - 1 - k] = arr.astype(np.uint8)
    for k, arr in enumerate(nq_):
        plane[y0 : y0 + n, x + k] = arr.astype(np.uint8)


def _apply_horz_mixed(plane, y: int, x0: int, widths, lvls, lim, mblim):
    n = min(widths.size, plane.shape[1] - x0)
    widths, lvls = widths[:n], lvls[:n]
    taps = 8 if (widths >= 16).any() else 4
    p = [plane[y - 1 - k, x0 : x0 + n].astype(np.int32) for k in range(taps)]
    q = [plane[y + k, x0 : x0 + n].astype(np.int32) for k in range(taps)]
    np_, nq_ = filter_edge(p, q, widths, lvls, lim, mblim)
    for k, arr in enumerate(np_):
        plane[y - 1 - k, x0 : x0 + n] = arr.astype(np.uint8)
    for k, arr in enumerate(nq_):
        plane[y + k, x0 : x0 + n] = arr.astype(np.uint8)


def pick_filter_level(qindex: int, is_keyframe: bool) -> int:
    """LPF_PICK_FROM_Q (vp9_picklpf.c:37)."""
    q = T.ac_quant(qindex)
    guess = (q * 20723 + 1015158 + (1 << 17)) >> 18
    if is_keyframe:
        guess -= 4
    return int(np.clip(guess, 0, MAX_LOOP_FILTER))
