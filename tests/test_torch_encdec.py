"""The port's realtime P-frame step, stage by stage, against the TPU
package's ``tpu_vp9/pipeline/tpu_encdec.py``.

Each stage gets the JAX stage's own inputs, made from a seed with numpy;
JAX runs on the CPU (the Pallas ``block_energy`` in interpret mode) and the
port runs its plain versions, which is what CPU tensors run. Tolerance 0
for every integer stage. Two stages are float in the TPU package and are
held to stated bounds instead: the forward transform into the quantizer
(levels may flip only where JAX's float32 ``|c|/q + 0.38`` lies within
1e-3 of an integer) and the candidate costs (a different choice only at a
near-tie, costs within 1e-5 relative, on at most 1% of blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vp9.bitstream import tables as T
from tpu_vp9.bitstream.tables import TxSize, TxType
from tpu_vp9.ops import txfm as jtxfm
from tpu_vp9.ops.pallas_kernels import block_energy as jax_block_energy
from tpu_vp9.pipeline import tpu_encdec as J

from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.pipeline import tpu_encdec as P

torch.set_num_threads(1)

FILTERS = T.subpel_filters(T.InterpFilter.EIGHTTAP)
M9_DIMS = [(128, 96), (160, 120), (96, 64)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(port, ref):
    np.testing.assert_array_equal(
        port.numpy() if isinstance(port, torch.Tensor) else port,
        np.asarray(ref))


# ---------------------------------------------------------------------------
# block_energy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 16, 32])
def test_block_energy_matches_pallas(n):
    rng = np.random.default_rng(n)
    src = rng.integers(0, 256, (7, n, n), dtype=np.uint8)
    pred = rng.integers(0, 256, (7, n, n), dtype=np.uint8)
    pred[0] = src[0]
    src[1], pred[1] = 0, 255
    want = jax_block_energy(jnp.asarray(src), jnp.asarray(pred), n,
                            interpret=True)
    got = K.block_energy(_t(src), _t(pred), n)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        _eq(g, w)


def test_block_energy_refuses_other_sizes():
    with pytest.raises(ValueError, match="n=4"):
        K.block_energy(torch.zeros((1, 4, 4), dtype=torch.uint8),
                       torch.zeros((1, 4, 4), dtype=torch.uint8), 4)


# ---------------------------------------------------------------------------
# sse_map_search
# ---------------------------------------------------------------------------


def _search_inputs(n, r, half, seed, b=6):
    """Windows of n+2r+8 (2x2 sums at the half-res level). Block 0 has an
    exact match (its minimum relative SSE is -sum(src^2) < 0); block 1 is
    constant (every candidate ties, (-r, -r) wins); block 2 repeats one
    row in every window row at a fixed dx (every dy ties); block 3 is
    constant but for one bright pixel."""
    rng = np.random.default_rng(seed)
    sw = n + 2 * r + 8
    k = 2 if half else 1
    wins = rng.integers(0, 256, (b, sw * k, sw * k)).astype(np.int32)
    src = rng.integers(0, 256, (b, n * k, n * k)).astype(np.int32)
    if half:
        wins = wins.reshape(b, sw, 2, sw, 2).sum(axis=(2, 4))
        src = src.reshape(b, n, 2, n, 2).sum(axis=(2, 4))
    wins[0, 4 + 3:4 + 3 + n, 4 + 2 * r - 1:4 + 2 * r - 1 + n] = src[0]
    src[1], wins[1] = 90, 90
    wins[2] = wins[2, :1]
    src[2] = wins[2, 0, 4 + 5:4 + 5 + n]
    src[3], wins[3] = 10, 10
    wins[3, 4 + r, 4 + r] = 200
    return src, wins


@pytest.mark.parametrize("n,r,half", [(16, 18, True), (32, 4, False)],
                         ids=["half_res", "refine"])
def test_sse_map_search_matches_full_search_sse_mxu(n, r, half):
    src, wins = _search_inputs(n, r, half, seed=n + r)
    dt = np.int16 if half else np.uint8
    want = J._full_search_sse_mxu(jnp.asarray(src), jnp.asarray(wins), n,
                                  r=r)
    got = K.sse_map_search(_t(src.astype(dt)), _t(wins.astype(dt)), n, r)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        _eq(g, w)
    rel = got[2].reshape(src.shape[0], -1)
    assert int(rel[0].min()) < 0  # the negative minimum case
    assert (int(got[0][0]), int(got[1][0])) == (3 - r, r - 1)
    assert (int(got[0][1]), int(got[1][1])) == (-r, -r)  # all tie
    assert (int(got[0][2]), int(got[1][2])) == (-r, 5 - r)  # dy ties
    no_map = K.sse_map_search(_t(src.astype(dt)), _t(wins.astype(dt)), n, r,
                              want_map=False)
    assert no_map[2] is None
    _eq(no_map[0], want[0])
    _eq(no_map[1], want[1])


def test_sse_map_search_refuses_bad_inputs():
    src = torch.zeros((2, 16, 16), dtype=torch.int16)
    with pytest.raises(ValueError, match="wins shape"):
        K.sse_map_search(src, torch.zeros((2, 59, 59), dtype=torch.int16),
                         16, 18)
    with pytest.raises(TypeError, match="uint8 or both int16"):
        K.sse_map_search(src, torch.zeros((2, 60, 60), dtype=torch.uint8),
                         16, 18)
    with pytest.raises(ValueError, match="shared memory"):
        K.sse_map_search(torch.zeros((1, 32, 32), dtype=torch.uint8),
                         torch.zeros((1, 120, 120), dtype=torch.uint8), 32,
                         40)


# ---------------------------------------------------------------------------
# search windows, hierarchical search, quarter-pel search
# ---------------------------------------------------------------------------


def _ref_plane(g, rng, planted=None):
    """A smooth border-extended luma reference of geometry g."""
    h, w = g.pad_h, g.pad_w
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(float)
    up = np.kron(base, np.ones((8, 8)))[:h, :w]
    y = np.clip(up + rng.normal(0, 6, (h, w)), 0, 255).astype(np.uint8)
    return y


def _blocks_and_windows(g, seed):
    """Source blocks that are shifted reference blocks (plus noise), and
    the luma search windows of the 32-grid."""
    rng = np.random.default_rng(seed)
    y = _ref_plane(g, rng)
    ref = np.asarray(J.extend_borders_device(jnp.asarray(y), g.width,
                                             g.height))
    rows, cols = g.rows32, g.cols32
    src = np.empty((rows * cols, 32, 32), np.uint8)
    for i in range(rows * cols):
        dy, dx = rng.integers(-30, 31, 2)
        oy = J.BORDER + (i // cols) * 32 + dy
        ox = J.BORDER + (i % cols) * 32 + dx
        src[i] = np.clip(ref[oy:oy + 32, ox:ox + 32].astype(int)
                         + rng.integers(-3, 4, (32, 32)), 0, 255)
    wins = np.asarray(J._extract_search_windows(
        jnp.asarray(ref), 32, rows, cols, 0,
        np.arange(cols, dtype=np.int64) * 32))
    return ref, src, wins


@pytest.mark.parametrize("dims", M9_DIMS)
def test_geometry_matches_jax(dims):
    for wh in dims, (1920, 1080):
        assert P.make_geom(*wh).__dict__ == J.make_geom(*wh).__dict__


def test_geometry_refusals_match_jax():
    for wh in ((100, 64), (128, 104)):
        with pytest.raises(ValueError):
            J.make_geom(*wh)
        with pytest.raises(ValueError):
            P.make_geom(*wh)
    assert P.make_geom(128, 112).strip  # refused later, by the session


def test_1080p_is_the_overhang_geometry_and_windows_stay_inside():
    """At 1080p and at the test sizes no window start leaves the plane:
    the luma and chroma windows of the 32-grid fit the border-extended
    planes (torch slicing does not clamp as lax.dynamic_slice does)."""
    g = P.make_geom(1920, 1080)
    assert (g.mi_rows % 4, g.rows32, g.n_blocks32) == (3, 34, 2040)
    assert (g.pad_h, g.pad_w, g.strip) == (1088, 1920, False)
    for wh in [(1920, 1080)] + M9_DIMS:
        g = P.make_geom(*wh)
        bd = 2 * P.BORDER
        P.window_bounds((g.pad_h + bd, g.pad_w + bd), 32, g.rows32,
                        g.cols32, 0)
        P.window_bounds((g.pad_h // 2 + bd, g.pad_w // 2 + bd), 16,
                        g.rows32, g.cols32, 0, r=P.CHROMA_WIN_R)
    with pytest.raises(ValueError, match="leave"):
        P.window_bounds((100, 100), 32, 4, 4, 0)


@pytest.mark.parametrize("dims", M9_DIMS)
def test_extend_borders_and_search_windows_match_jax(dims):
    g = J.make_geom(*dims)
    rng = np.random.default_rng(sum(dims))
    y = rng.integers(0, 256, (g.pad_h, g.pad_w), dtype=np.uint8)
    u = rng.integers(0, 256, (g.pad_h // 2, g.pad_w // 2), dtype=np.uint8)
    cw, ch = (g.width + 1) >> 1, (g.height + 1) >> 1
    for plane, crop, n, r in ((y, (g.width, g.height), 32, J.WIN_R),
                              (u, (cw, ch), 16, J.CHROMA_WIN_R)):
        ref_j = J.extend_borders_device(jnp.asarray(plane), *crop)
        ref_p = P.extend_borders_device(_t(plane), *crop)
        _eq(ref_p, ref_j)
        want = J._extract_search_windows(
            ref_j, n, g.rows32, g.cols32, 0,
            np.arange(g.cols32, dtype=np.int64) * n, r=r)
        got = P._extract_search_windows(ref_p, n, g.rows32, g.cols32, 0, r=r)
        _eq(got, want)


def test_hier_search_matches_jax():
    g = J.make_geom(160, 120)
    _, src, wins = _blocks_and_windows(g, seed=5)
    want = J.hier_search(jnp.asarray(src), jnp.asarray(wins), 32)
    got = P.hier_search(_t(src), _t(wins), 32)
    assert len(got) == len(want) == 7
    for gp, w in zip(got, want):
        _eq(gp.to(torch.int32), np.asarray(w).astype(np.int32))
    assert np.any(np.asarray(want[0]) != 0)  # the search found motion


def test_subpel_search_matches_jax():
    g = J.make_geom(128, 96)
    _, src, wins = _blocks_and_windows(g, seed=6)
    c_y, c_x, dyr, dxr, loc, _, _ = P.hier_search(_t(src), _t(wins), 32)
    want = J._subpel_exhaustive(jnp.asarray(loc.numpy()), jnp.asarray(src),
                                jnp.asarray(dyr.numpy()),
                                jnp.asarray(dxr.numpy()), 32, FILTERS,
                                r=J.REFINE_R)
    got = P.subpel_search_ref(loc, _t(src), dyr, dxr, 32, P.REFINE_R)
    for gp, w in zip(got, want):
        _eq(gp, w)
    # the flat +-40 form of the same stage, on the full windows
    dy = torch.from_numpy(np.random.default_rng(1).integers(
        -40, 41, src.shape[0]).astype(np.int32))
    dx = -dy
    want = J._subpel_exhaustive(jnp.asarray(wins), jnp.asarray(src),
                                jnp.asarray(dy.numpy()),
                                jnp.asarray(dx.numpy()), 32, FILTERS)
    for gp, w in zip(P.subpel_search_ref(_t(wins), _t(src), dy, dx, 32,
                                         P.WIN_R), want):
        _eq(gp, w)


# ---------------------------------------------------------------------------
# motion compensation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [(160, 120), (96, 64)])
def test_mc_predict_from_wins_matches_jax_at_the_umv_clamp(dims):
    g = J.make_geom(*dims)
    rng = np.random.default_rng(7)
    ref_y, _, wins = _blocks_and_windows(g, seed=7)
    b = g.n_blocks32
    pos_y = (np.arange(b) // g.cols32 * 32).astype(np.int32)
    pos_x = (np.arange(b) % g.cols32 * 32).astype(np.int32)
    # q3 MVs up to +-(8 * 40 + 6): past the UMV border at every frame edge
    mv_r = rng.integers(-326, 327, b).astype(np.int32)
    mv_c = rng.integers(-326, 327, b).astype(np.int32)
    mv_r[:4], mv_c[:4] = (-326, 326, -326, 326), (-326, -326, 326, 326)
    filt_p = torch.as_tensor(np.asarray(FILTERS, np.int32))
    chroma = rng.integers(0, 256, (g.pad_h // 2, g.pad_w // 2),
                          dtype=np.uint8)
    ref_c = np.asarray(J.extend_borders_device(
        jnp.asarray(chroma), (g.width + 1) >> 1, (g.height + 1) >> 1))
    wins_c = np.asarray(J._extract_search_windows(
        jnp.asarray(ref_c), 16, g.rows32, g.cols32, 0,
        np.arange(g.cols32, dtype=np.int64) * 16, r=J.CHROMA_WIN_R))
    for w, n, ss, wr, py, px in (
            (wins, 32, 0, J.WIN_R, pos_y, pos_x),
            (wins_c, 16, 1, J.CHROMA_WIN_R, pos_y // 2, pos_x // 2)):
        want = J.mc_predict_from_wins(
            jnp.asarray(w), jnp.asarray(py), jnp.asarray(px),
            jnp.asarray(mv_r), jnp.asarray(mv_c), n, ss, g.mi_rows,
            g.mi_cols, FILTERS, wr)
        got = P.mc_predict_from_wins(_t(w), _t(py), _t(px), _t(mv_r),
                                     _t(mv_c), n, ss, g.mi_rows, g.mi_cols,
                                     filt_p, wr)
        assert got.dtype == torch.uint8
        _eq(got, want)
    # and the windows give what MC on the whole plane gives
    whole = J.mc_predict_batch(jnp.asarray(ref_y), jnp.asarray(pos_y),
                               jnp.asarray(pos_x), jnp.asarray(mv_r),
                               jnp.asarray(mv_c), 32, 0, g.mi_rows,
                               g.mi_cols, FILTERS)
    _eq(P.mc_predict_from_wins(_t(wins), _t(pos_y), _t(pos_x), _t(mv_r),
                               _t(mv_c), 32, 0, g.mi_rows, g.mi_cols,
                               filt_p, P.WIN_R), whole)


# ---------------------------------------------------------------------------
# transform, quantizer and recon
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qindex", [20, 120])
def test_transform_recon_matches_jax_but_for_boundary_flips(qindex):
    rng = np.random.default_rng(qindex)
    dc_q, ac_q = T.dc_quant(qindex), T.ac_quant(qindex)
    for n in (32, 16):
        src = rng.integers(0, 256, (48, n, n), dtype=np.uint8)
        pred = np.clip(src.astype(int) + rng.integers(-60, 61, src.shape),
                       0, 255).astype(np.uint8)
        lv_j, eob_j, rec_j = J.transform_recon(
            jnp.asarray(src), jnp.asarray(pred), jnp.int32(dc_q),
            jnp.int32(ac_q), n)
        lv_p, eob_p, rec_p = P.transform_recon(_t(src), _t(pred), dc_q,
                                               ac_q, n)
        lv_j = np.asarray(lv_j)
        flips = np.argwhere(lv_p.numpy() != lv_j)
        # JAX's own float32 quantizer input at every flip
        resid = (src.astype(np.int32) - pred).astype(np.float32)
        coeffs = np.asarray(jtxfm.fwd_txfm2d(
            jnp.asarray(resid), J._TS[n], TxType.DCT_DCT, jnp))
        q = np.full((n, n), ac_q, np.float32)
        q[0, 0] = dc_q
        if n == 32:
            q = q * np.float32(0.5)
        mag = np.abs(coeffs) / q + np.float32(0.38)
        print(f"n={n} qindex={qindex}: {len(flips)} level flips of "
              f"{lv_j.size}")
        for b, i, j in flips:
            assert abs(int(lv_p[b, i, j]) - int(lv_j[b, i, j])) == 1
            assert abs(mag[b, i, j] - np.round(mag[b, i, j])) < 1e-3
        # given the same levels, eob and recon are bit-exact
        eob_p2, rec_p2 = P.recon_from_levels(_t(lv_j.astype(np.int32)),
                                             _t(pred), dc_q, ac_q, n)
        _eq(eob_p2, eob_j)
        _eq(rec_p2, rec_j)
        if not len(flips):
            _eq(eob_p, eob_j)
            _eq(rec_p, rec_j)


def test_quantizer_runs_in_float64_with_the_float32_bias():
    """The level of a coefficient sitting on a float32 boundary follows
    the float64 value, with JAX's float32 0.38 as the bias."""
    q = 10.0
    c = torch.tensor([[[(2 - P.txfm.QBIAS) * q]]], dtype=torch.float64)
    c = c.expand(1, 4, 4).clone()
    lv = P.txfm.quantize_f64(c, 10, 10, 4)
    assert int(lv[0, 0, 0]) == 2
    assert P.txfm.QBIAS == float(np.float32(0.38))
    assert P.txfm.fwd_txfm2d_f64(torch.zeros((1, 8, 8), dtype=torch.int32)) \
        .dtype == torch.float64


# ---------------------------------------------------------------------------
# mode decision
# ---------------------------------------------------------------------------


def test_candidate_decide_matches_jax_but_for_near_ties():
    rng = np.random.default_rng(11)
    rows, cols = 24, 30
    b = rows * cols
    d = 2 * J.HALF_R + 1
    ssem = rng.integers(-400_000, 400_000, (b, d, d)).astype(np.int32)
    src2m = rng.integers(200_000, 800_000, b).astype(np.int32)
    sse_zero = rng.integers(0, 4_000_000, b).astype(np.int32)
    sse_new = rng.integers(0, 4_000_000, b).astype(np.int32)
    new_r = rng.integers(-326, 327, b).astype(np.int32)
    new_c = rng.integers(-326, 327, b).astype(np.int32)
    # a coherent field in half the blocks makes LEFT/ABOVE competitive
    new_r[::2], new_c[::2] = 24, -16
    sse_new[::3] = sse_zero[::3]  # exact ties between ZERO and NEW
    prev = rng.integers(-326, 327, (b, 2)).astype(np.int32)
    lam = 1800
    args = (rows, cols, J.HALF_R, 4, 4)
    jr, jc, jcost = J._candidate_decide(
        jnp.asarray(ssem), jnp.asarray(src2m), jnp.asarray(sse_zero),
        jnp.asarray(sse_new), jnp.asarray(new_r), jnp.asarray(new_c),
        jnp.asarray(prev), *args, jnp.int32(lam))
    pr, pc, pcost = P._candidate_decide(
        _t(ssem), _t(src2m), _t(sse_zero), _t(sse_new), _t(new_r),
        _t(new_c), _t(prev), *args, lam, P.new_bits_table("cpu"))
    diff = (pr.numpy() != np.asarray(jr)) | (pc.numpy() != np.asarray(jc))
    print(f"candidate choices differing from JAX: {int(diff.sum())} of {b}")
    assert diff.sum() <= 0.01 * b
    jcost, pcost = np.asarray(jcost), pcost.numpy()
    near = np.abs(jcost - pcost) <= 1e-5 * np.abs(jcost)
    assert np.all(near[diff])
    np.testing.assert_array_equal(pcost[~diff], jcost[~diff])


def test_new_bits_table_is_the_rate_proxy():
    tab = P.new_bits_table("cpu").numpy()
    assert tab.dtype == np.float32 and tab.shape == (P.MVD_MAX + 1,)
    k = np.arange(P.MVD_MAX + 1)
    np.testing.assert_allclose(tab, 10.0 + 2.0 * np.log2(1.0 + k),
                               rtol=1e-6)
    assert tab[0] == 10.0 and tab[1] == 12.0 and tab[3] == 14.0


# ---------------------------------------------------------------------------
# loop filter
# ---------------------------------------------------------------------------


def _lf_planes(g, rng):
    def smooth(hh, ww):
        base = rng.integers(0, 256, (hh // 8 + 2, ww // 8 + 2)).astype(float)
        up = np.kron(base, np.ones((8, 8)))[:hh, :ww]
        return np.ascontiguousarray(
            np.clip(up + rng.normal(0, 2, (hh, ww)), 0, 255), np.uint8)

    return [smooth(g.h_mi, g.w_mi), smooth(g.h_mi // 2, g.w_mi // 2),
            smooth(g.h_mi // 2, g.w_mi // 2)]


def _pad(planes, g):
    return [np.pad(p, ((0, s[0] - p.shape[0]), (0, s[1] - p.shape[1])),
                   mode="edge")
            for p, s in zip(planes, ((g.pad_h, g.pad_w),
                                     (g.pad_h // 2, g.pad_w // 2),
                                     (g.pad_h // 2, g.pad_w // 2)))]


@pytest.mark.parametrize("dims", M9_DIMS)
def test_loop_filter_matches_jax_and_host_oracle(dims):
    """Port LF == JAX device LF == host loop_filter_frame, bit-exact, on
    smooth content (noise planes never trigger the filter masks)."""
    from tpu_vp9.bitstream.tables import BlockSize
    from tpu_vp9.codec import modeinfo as MI
    from tpu_vp9.codec.intra_frame import walk_partition_fixed
    from tpu_vp9.ops.loopfilter import loop_filter_frame, sharpness_limits

    g = J.make_geom(*dims)
    rng = np.random.default_rng(sum(dims))
    mig = MI.ModeInfoGrid(g.mi_rows, g.mi_cols)
    for ev, r, c, bs, _ in walk_partition_fixed(
            g.mi_rows, g.mi_cols, BlockSize.BLOCK_32X32, 0):
        if ev != "leaf":
            continue
        assert bs == BlockSize.BLOCK_32X32
        mig.set_block(r, c, bs, MI.ModeInfo(
            bsize=bs, tx_size=TxSize.TX_32X32,
            skip=bool(rng.integers(0, 2)), is_inter=True, ref_frame=(1, -1),
            mv=((0, 0), (0, 0)), inter_mode=int(rng.integers(0, 4))))
    planes = _lf_planes(g, rng)
    lim_t, mblim_t = sharpness_limits(0)
    fn = jax.jit(lambda a, b, c, l, li, mb: J.loop_filter_device(
        a, b, c, g, l, li, mb))
    for lvl in (0, 11, 34):
        host = [p.copy() for p in planes]
        loop_filter_frame(host, mig, lvl, 0, (1, 0, -1, -1), (0, 0), True)
        dev = _pad(planes, g)
        want = fn(*[jnp.asarray(p) for p in dev], jnp.int32(lvl),
                  jnp.int32(int(lim_t[lvl])), jnp.int32(int(mblim_t[lvl])))
        ins = [_t(p) for p in dev]
        got = P.loop_filter_device(*ins, P.make_geom(*dims), lvl,
                                   int(lim_t[lvl]), int(mblim_t[lvl]))
        for gp, w, i, d, h in zip(got, want, ins, dev, host):
            _eq(gp, w)
            _eq(i, d)  # the inputs are left as they were
            hh, ww = h.shape
            _eq(gp[:hh, :ww], h)
        if lvl:
            assert not np.array_equal(got[0].numpy(), dev[0])


def test_loop_filter_refuses_strip_geometry():
    g = P.make_geom(128, 112)
    y = torch.zeros((g.pad_h, g.pad_w), dtype=torch.uint8)
    c = torch.zeros((g.pad_h // 2, g.pad_w // 2), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        P.loop_filter_device(y, c, c, g, 10, 5, 20)


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------


def test_pframe_step_matches_jax_step():
    """One whole step on the same padded source and reference: the zone
    outputs and the new references."""
    w, h = 160, 120
    gj, gp = J.make_geom(w, h), P.make_geom(w, h)
    rng = np.random.default_rng(13)
    _, src_blocks, _ = _blocks_and_windows(gj, seed=13)
    src_y = np.ascontiguousarray(P._scatter_blocks(
        _t(src_blocks), gj.rows32, gj.cols32, 32).numpy())
    planes = _lf_planes(gj, rng)
    src = [src_y] + _pad(planes, gj)[1:]
    ref_planes = _pad(_lf_planes(gj, rng), gj)
    cw, ch = (w + 1) >> 1, (h + 1) >> 1
    crops = ((w, h), (cw, ch), (cw, ch))
    refs_j = [J.extend_borders_device(jnp.asarray(p), *c)
              for p, c in zip(ref_planes, crops)]
    refs_p = [P.extend_borders_device(_t(p), *c)
              for p, c in zip(ref_planes, crops)]
    prev = rng.integers(-40, 41, (gj.n_blocks32, 2)).astype(np.int32)
    qidx = 120
    q = (T.dc_quant(qidx), T.ac_quant(qidx), max(1, T.ac_quant(qidx) ** 2
                                                  >> 6), 20, 7, 50)
    step_j = J.make_pframe_step(gj)
    outs_j, new_j = step_j(*[jnp.asarray(p) for p in src], *refs_j,
                           jnp.asarray(prev), jnp.zeros((1, 2), jnp.int32),
                           *[jnp.int32(v) for v in q])
    outs_p, new_p = P.make_pframe_step(gp, "cpu")(
        *[_t(p) for p in src], *refs_p, _t(prev), *q)
    zj, zp = outs_j["m32"], outs_p["m32"]
    for k in ("mv", "skip", "eob_y", "eob_u", "eob_v", "lv_y", "lv_u",
              "lv_v", "dist_b", "rate_b"):
        _eq(zp[k], zj[k])
    for k in ("rec_y", "rec_u", "rec_v"):
        _eq(outs_p[k], outs_j[k])
    for a, b in zip(new_p, new_j):
        _eq(a, b)
    assert np.any(np.asarray(zj["mv"]) != 0)
