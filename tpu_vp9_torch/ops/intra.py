"""VP9 intra prediction — all 10 modes, exact, batched.

Directional modes are expressed as constant per-(mode, block-size) gather
index maps into a per-block reference vector
``ref = [left[0..bs-1], above_left, above[0..2bs-1]]`` with weight triples
(w0,w1,w2)/4 — this turns the spec's sequential copy recurrences into pure
vectorized gathers that run identically under numpy and jax.numpy (and map
to one-hot matmuls on TPU).

Closed forms were derived from the spec predictors (parity reference:
``intrapred.c`` in SVT-VP9's vendored libvpx); availability/extension rules
follow ``vp9_reconintra.c:106`` ``build_intra_predictors``:
  * left unavailable  -> 129,  above unavailable -> 127 (incl. corner)
  * above_left = actual if above&left else 129 (above avail) / 127
  * above-right half: real pixels only for bs==4 with right available,
    else replicate above[bs-1]; beyond frame width replicate.
"""

from __future__ import annotations

import functools

import numpy as np

from tpu_vp9_torch.bitstream.tables import IntraMode

BLOCK_SIZES = (4, 8, 16, 32)


def _ref_idx(bs: int):
    def L(i):
        return int(np.clip(i, 0, bs - 1))

    def A(i):
        # A(-1) is the corner
        return bs + 1 + int(np.clip(i, -1, 2 * bs - 1))

    AL = bs
    return L, A, AL


@functools.cache
def dir_maps(bs: int):
    """Index/weight maps: dict mode -> (idx (3,bs,bs) int32, w (3,bs,bs))."""
    L, A, AL = _ref_idx(bs)
    maps = {}

    def alloc():
        return np.zeros((3, bs, bs), np.int32), np.zeros((3, bs, bs), np.int32)

    def setpx(idx, w, r, c, entries):
        # entries: list of (ref_index, weight); pad to 3
        for k in range(3):
            if k < len(entries):
                idx[k, r, c], w[k, r, c] = entries[k]
            else:
                idx[k, r, c], w[k, r, c] = entries[0][0], 0

    def avg3(a, b, c):
        return [(a, 1), (b, 2), (c, 1)]

    def avg2(a, b):
        return [(a, 2), (b, 2)]

    def copy(a):
        return [(a, 4)]

    # V / H
    idx, w = alloc()
    for r in range(bs):
        for c in range(bs):
            setpx(idx, w, r, c, copy(A(c)))
    maps[IntraMode.V_PRED] = (idx, w)
    idx, w = alloc()
    for r in range(bs):
        for c in range(bs):
            setpx(idx, w, r, c, copy(L(r)))
    maps[IntraMode.H_PRED] = (idx, w)

    # D45
    idx, w = alloc()
    for r in range(bs):
        for c in range(bs):
            i = r + c
            e = avg3(A(i), A(i + 1), A(i + 2)) if i < bs - 1 else copy(A(bs - 1))
            setpx(idx, w, r, c, e)
    maps[IntraMode.D45_PRED] = (idx, w)

    # D63
    idx, w = alloc()
    for r in range(bs):
        for c in range(bs):
            i = c + (r >> 1)
            if r >= 2 and i >= bs - 1:
                e = copy(A(bs - 1))
            elif r % 2 == 0:
                e = avg2(A(i), A(i + 1))
            else:
                e = avg3(A(i), A(i + 1), A(i + 2))
            setpx(idx, w, r, c, e)
    maps[IntraMode.D63_PRED] = (idx, w)

    # D207
    idx, w = alloc()
    for r in range(bs):
        for c in range(bs):
            k = r + (c >> 1)
            if c % 2 == 0:
                e = avg2(L(k), L(k + 1)) if k < bs - 1 else copy(L(bs - 1))
            else:
                if k < bs - 2:
                    e = avg3(L(k), L(k + 1), L(k + 2))
                elif k == bs - 2:
                    e = avg3(L(bs - 2), L(bs - 1), L(bs - 1))
                else:
                    e = copy(L(bs - 1))
            setpx(idx, w, r, c, e)
    maps[IntraMode.D207_PRED] = (idx, w)

    # D117
    idx, w = alloc()
    for r in range(bs):
        for c in range(bs):
            s = min(c, r >> 1)
            rp, cp = r - 2 * s, c - s
            if rp == 0:
                e = avg2(A(cp - 1), A(cp))
            elif rp == 1:
                if cp == 0:
                    e = avg3(L(0), AL, A(0))
                else:
                    e = avg3(A(cp - 2), A(cp - 1), A(cp))
            elif rp == 2:
                e = avg3(AL, L(0), L(1))
            else:
                e = avg3(L(rp - 3), L(rp - 2), L(rp - 1))
            setpx(idx, w, r, c, e)
    maps[IntraMode.D117_PRED] = (idx, w)

    # D135 via border array j = bs-1-r+c
    idx, w = alloc()
    for r in range(bs):
        for c in range(bs):
            j = bs - 1 - r + c
            if j <= bs - 3:
                e = avg3(L(bs - 3 - j), L(bs - 2 - j), L(bs - 1 - j))
            elif j == bs - 2:
                e = avg3(AL, L(0), L(1))
            elif j == bs - 1:
                e = avg3(L(0), AL, A(0))
            elif j == bs:
                e = avg3(AL, A(0), A(1))
            else:
                e = avg3(A(j - bs - 1), A(j - bs), A(j - bs + 1))
            setpx(idx, w, r, c, e)
    maps[IntraMode.D135_PRED] = (idx, w)

    # D153
    idx, w = alloc()
    for r in range(bs):
        for c in range(bs):
            s = min(r, c >> 1)
            rp, cp = r - s, c - 2 * s
            if cp == 0:
                e = avg2(AL, L(0)) if rp == 0 else avg2(L(rp - 1), L(rp))
            elif cp == 1:
                if rp == 0:
                    e = avg3(L(0), AL, A(0))
                elif rp == 1:
                    e = avg3(AL, L(0), L(1))
                else:
                    e = avg3(L(rp - 2), L(rp - 1), L(rp))
            else:
                e = avg3(A(cp - 3), A(cp - 2), A(cp - 1))
            setpx(idx, w, r, c, e)
    maps[IntraMode.D153_PRED] = (idx, w)

    return maps


DIR_MODES = (IntraMode.V_PRED, IntraMode.H_PRED, IntraMode.D45_PRED,
             IntraMode.D135_PRED, IntraMode.D117_PRED, IntraMode.D153_PRED,
             IntraMode.D207_PRED, IntraMode.D63_PRED)


@functools.cache
def stacked_dir_maps(bs: int):
    """(8, 3, bs, bs) idx and weights for DIR_MODES order."""
    maps = dir_maps(bs)
    idx = np.stack([maps[m][0] for m in DIR_MODES])
    w = np.stack([maps[m][1] for m in DIR_MODES])
    return idx, w


def build_ref_vector(above_ext, above_left, left, xp=np):
    """ref = [left(bs), above_left(1), above(2bs)] along last axis.

    above_ext: (..., 2*bs), above_left: (...,), left: (..., bs)
    """
    al = above_left[..., None]
    return xp.concatenate([left, al, above_ext], axis=-1).astype(xp.int32)


def predict_directional(ref, bs: int, xp=np):
    """All 8 directional modes at once: ref (..., 3bs+1) -> (..., 8, bs, bs)."""
    idx, w = stacked_dir_maps(bs)
    if xp is not np:
        idx = xp.asarray(idx)
        w = xp.asarray(w)
    gathered = xp.take_along_axis(
        xp.broadcast_to(ref[..., None, None, None, :],
                        ref.shape[:-1] + (8, 3, bs, ref.shape[-1])),
        xp.broadcast_to(idx, ref.shape[:-1] + (8, 3, bs, bs)),
        axis=-1,
    )
    pred = (gathered * w).sum(axis=-3)
    return (pred + 2) >> 2


def predict_dc(above, left, have_above, have_left, bs: int, xp=np):
    """DC prediction value per block: (...,) int32.

    above/left: (..., bs); have_*: (...,) bool arrays.
    """
    sum_a = above[..., :bs].astype(xp.int32).sum(axis=-1)
    sum_l = left.astype(xp.int32).sum(axis=-1)
    both = (sum_a + sum_l + bs) >> int(np.log2(bs) + 1)
    only_a = (sum_a + (bs >> 1)) >> int(np.log2(bs))
    only_l = (sum_l + (bs >> 1)) >> int(np.log2(bs))
    dc = xp.where(
        have_above & have_left, both,
        xp.where(have_above, only_a, xp.where(have_left, only_l, 128)),
    )
    return dc


def predict_tm(above, above_left, left, bs: int, xp=np):
    """TM: clip(left[r] + above[c] - above_left)."""
    p = (left[..., :, None].astype(xp.int32)
         + above[..., None, :bs].astype(xp.int32)
         - above_left[..., None, None].astype(xp.int32))
    return xp.clip(p, 0, 255)


def predict_all_modes(above_ext, above_left, left, have_above, have_left,
                      bs: int, xp=np):
    """(..., 10, bs, bs) int32 predictions in IntraMode order."""
    ref = build_ref_vector(above_ext, above_left, left, xp)
    d = predict_directional(ref, bs, xp)  # (..., 8, bs, bs) in DIR order
    dc = predict_dc(above_ext, left, have_above, have_left, bs, xp)
    dc_blk = xp.broadcast_to(dc[..., None, None, None],
                             dc.shape + (1, bs, bs))
    tm = predict_tm(above_ext, above_left, left, bs, xp)[..., None, :, :]
    # Assemble in IntraMode order: DC,V,H,D45,D135,D117,D153,D207,D63,TM
    order = [None, 0, 1, 2, 3, 4, 5, 6, 7, None]
    parts = [dc_blk[..., 0, :, :][..., None, :, :]]
    for m_i, d_i in zip(range(1, 9), order[1:9]):
        parts.append(d[..., d_i, :, :][..., None, :, :])
    parts.append(tm)
    return xp.concatenate(parts, axis=-3)


def predict_mode_batch(mode: IntraMode, above_ext, above_left, left,
                       have_above, have_left, bs: int):
    """(B, bs, bs) int32 predictions of ONE mode for a lane batch —
    the wavefront recon path knows each block's mode, so computing all
    10 (predict_all_modes) wastes 9/10ths of the gathers."""
    mode = IntraMode(mode)
    if mode == IntraMode.DC_PRED:
        dc = predict_dc(above_ext, left, have_above, have_left, bs)
        return np.broadcast_to(dc[:, None, None],
                               (dc.shape[0], bs, bs)).copy()
    if mode == IntraMode.TM_PRED:
        return predict_tm(above_ext, above_left, left, bs)
    ref = build_ref_vector(above_ext, above_left, left)  # (B, 3bs+1)
    idx, w = dir_maps(bs)[mode]  # (3, bs, bs) each
    g = ref[:, idx]  # (B, 3, bs, bs)
    return (g * w[None]).sum(axis=1) + 2 >> 2


@functools.cache
def all_modes_matrix_int(bs: int):
    """(10, bs*bs, 3*bs+1) f32 with INTEGER weights: directional rows
    produce the pre-rounded 3-tap sum (pred = (x + 2) >> 2), the TM
    row produces left + above - al (pred = clip(x, 0, 255)), and the
    DC row is zero (DC comes from predict_dc).  Used by the exact
    matmul predictor below."""
    L = 3 * bs + 1
    M = np.zeros((10, bs * bs, L), np.float32)
    idx, w = stacked_dir_maps(bs)
    flat_pix = np.arange(bs * bs)
    for d_i, mode in enumerate(DIR_MODES):
        m = int(mode)
        for k in range(3):
            np.add.at(M[m], (flat_pix, idx[d_i, k].reshape(-1)),
                      w[d_i, k].reshape(-1).astype(np.float32))
    ys, xs = np.divmod(flat_pix, bs)
    M[9, flat_pix, ys] = 1.0
    M[9, flat_pix, bs + 1 + xs] += 1.0
    M[9, flat_pix, bs] = -1.0
    return M


def predict_modes_matmul(above_ext, above_left, left, have_above,
                         have_left, bs: int, xp=np):
    """Exact all-10-mode predictions as one matmul + cheap rounding.

    Bit-identical to predict_all_modes but gather-free: every VP9
    intra mode is (rounded/clipped) linear in the reference vector, so
    the whole mode bank is a (10*bs^2, 3bs+1) matrix product that
    rides the MXU — the advanced-index gathers of the stacked
    directional maps were ~95%% of the device keyframe wavefront's
    step time.  Weight sums have <= 3 integer terms <= 4*255, so f32
    is exact.  Returns (..., 10, bs, bs) int32 in IntraMode order."""
    ref = build_ref_vector(above_ext, above_left, left, xp) \
        .astype(xp.float32)
    M = all_modes_matrix_int(bs)
    if xp is not np:
        M = xp.asarray(M)
    lin = xp.einsum("mql,bl->bmq", M, ref)
    dirp = xp.floor((lin + 2.0) * 0.25)
    tmp = xp.clip(lin, 0.0, 255.0)
    dc = predict_dc(above_ext, left, have_above, have_left, bs, xp)
    b = ref.shape[0]
    q = bs * bs
    parts = [
        xp.broadcast_to(dc[:, None, None].astype(xp.float32), (b, 1, q)),
        dirp[:, 1:9],
        tmp[:, 9:10],
    ]
    out = xp.concatenate(parts, axis=1).astype(xp.int32)
    return out.reshape(b, 10, bs, bs)


@functools.cache
def all_modes_matrix(bs: int):
    """(10, bs*bs, 3*bs+1) float32 M with pred[m] ~= M[m] @ ref.

    Every VP9 intra mode is linear in the reference vector up to
    rounding/clipping, so open-loop mode *selection* (non-normative)
    can run as one matmul instead of the exact gather path.  Ref
    layout matches build_ref_vector: [left(bs), al(1), above(2bs)].
    """
    L = 3 * bs + 1
    M = np.zeros((10, bs * bs, L), np.float32)
    # DC (both-available case): mean of left + above
    M[0, :, :bs] = 1.0 / (2 * bs)
    M[0, :, bs + 1 : 2 * bs + 1] = 1.0 / (2 * bs)
    # directional modes: expand idx/weight maps
    idx, w = stacked_dir_maps(bs)  # (8, 3, bs, bs)
    flat_pix = np.arange(bs * bs)
    for d_i, mode in enumerate(DIR_MODES):
        m = int(mode)
        for k in range(3):
            np.add.at(M[m], (flat_pix, idx[d_i, k].reshape(-1)),
                      w[d_i, k].reshape(-1).astype(np.float32) / 4.0)
    # TM: left[y] + above[x] - al
    ys, xs = np.divmod(flat_pix, bs)
    M[9, flat_pix, ys] = 1.0
    M[9, flat_pix, bs + 1 + xs] += 1.0
    M[9, flat_pix, bs] = -1.0
    return M


def build_ref_samples(plane, x0: int, y0: int, bs: int,
                      frame_w: int, frame_h: int,
                      have_above: bool, have_left: bool, have_right: bool):
    """Host-side (numpy) construction of (above_ext[2bs], above_left, left[bs])
    for one block from a recon plane, following build_intra_predictors."""
    plane = np.asarray(plane)
    above = np.full(2 * bs, 127, np.int32)
    left = np.full(bs, 129, np.int32)
    above_left = 127
    if have_left:
        # blocks fully inside the alignment overhang (sub-8x8 columns of
        # an edge mi when crop is not an 8px multiple) clamp to the last
        # in-crop sample
        n_avail = min(bs, max(frame_h - y0, 0))
        if n_avail:
            rows = plane[y0 : y0 + n_avail, x0 - 1].astype(np.int32)
            left[:n_avail] = rows
            if n_avail < bs:
                left[n_avail:] = rows[-1]
        else:
            left[:] = int(plane[frame_h - 1, x0 - 1])
    if have_above:
        arow = plane[y0 - 1]
        n_avail = min(bs, max(frame_w - x0, 0))
        if n_avail:
            above[:n_avail] = arow[x0 : x0 + n_avail]
            if n_avail < bs:
                above[n_avail:bs] = above[n_avail - 1]
        else:
            above[:bs] = int(arow[frame_w - 1])
        # above-right half
        if bs == 4 and have_right:
            n2 = min(2 * bs, max(frame_w - x0, bs))
            above[bs:n2] = arow[x0 + bs : x0 + n2]
            if n2 < 2 * bs:
                above[n2:] = above[n2 - 1]
        else:
            above[bs:] = above[bs - 1]
        above_left = int(arow[x0 - 1]) if have_left else 129
    return above, above_left, left


def predict_block_full(mode: IntraMode, above_ext, above_left, left,
                       have_above: bool, have_left: bool, bs: int):
    """Single-block prediction for any mode incl. DC (host oracle path)."""
    mode = IntraMode(mode)
    above_ext = np.asarray(above_ext, np.int32)
    left = np.asarray(left, np.int32)
    if mode == IntraMode.DC_PRED:
        dc = predict_dc(above_ext[None], left[None],
                        np.array([have_above]), np.array([have_left]), bs)
        return np.full((bs, bs), int(dc[0]), np.int32)
    if mode == IntraMode.TM_PRED:
        return predict_tm(above_ext[None], np.asarray([above_left]),
                          left[None], bs)[0]
    ref = build_ref_vector(above_ext[None], np.asarray([above_left]),
                           left[None])
    d = predict_directional(ref, bs)
    return d[0, DIR_MODES.index(mode)]
