"""The M8 additions of the port's P-frame step, stage by stage, against
the JAX package's ``tpu_vp9/pipeline/tpu_encdec.py``.

Each stage gets the JAX stage's own inputs, made from a seed with numpy;
JAX runs on the CPU and the port runs its plain versions, which is what
CPU tensors run. Tolerance 0 for every integer stage. The candidate costs
are float32 (``sse + lam_bits * rate / 256``): a choice may differ from
JAX's only at a near-tie (the two best costs within 1e-5 relative), such
blocks are counted, and they must stay under 1% of the blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vp9.bitstream import tables as JT
from tpu_vp9.pipeline import tpu_encdec as J

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream.tables import BlockSize, TxSize
from tpu_vp9_torch.codec import modeinfo as MI
from tpu_vp9_torch.ops.loopfilter import loop_filter_frame, sharpness_limits
from tpu_vp9_torch.pipeline import tpu_encdec as P

torch.set_num_threads(1)

FILTERS = T.subpel_filters(T.InterpFilter.EIGHTTAP)


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(port, ref, msg=""):
    np.testing.assert_array_equal(
        port.numpy() if isinstance(port, torch.Tensor) else port,
        np.asarray(ref), err_msg=msg)


def _adapted_fc(seed):
    """A frame context away from the defaults, as after some frames."""
    rng = np.random.default_rng(seed)
    pfc, jfc = T.default_frame_context(), JT.default_frame_context()
    for fc in (pfc, jfc):
        r = np.random.default_rng(seed)
        fc.inter_mode_probs = r.integers(
            1, 256, fc.inter_mode_probs.shape).astype(
                fc.inter_mode_probs.dtype)
        fc.single_ref_probs = r.integers(
            1, 256, fc.single_ref_probs.shape).astype(
                fc.single_ref_probs.dtype)
        fc.nmv.joints = r.integers(1, 256, np.shape(fc.nmv.joints)).astype(
            np.asarray(fc.nmv.joints).dtype)
    del rng
    return pfc, jfc


# ---------------------------------------------------------------------------
# rate tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("qindex", [40, 120, 200])
@pytest.mark.parametrize("adapted", [False, True], ids=["default", "adapted"])
def test_make_rate_tabs_matches_jax(qindex, adapted):
    pfc, jfc = (_adapted_fc(qindex) if adapted
                else (T.default_frame_context(), JT.default_frame_context()))
    want = J.make_rate_tabs(jfc, qindex)
    got = P.make_rate_tabs(pfc, qindex)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    assert got["mv_cost_max"] == 1023
    up = P.upload_rate_tabs(got, "cpu")
    assert up["lam_bits"] == float(want["lam_bits"])
    assert up["mode_cost"] == [int(v) for v in want["mode_cost"]]
    _eq(up["nmv_row"], want["nmv_row"])
    assert tuple(up["nmv_row"].shape) == (2 * 1023 + 1,)


def _jax_rates(tabs):
    return {k: (jnp.asarray(v) if k != "mv_cost_max" else v)
            for k, v in tabs.items()}


# ---------------------------------------------------------------------------
# candidate decision with entropy-table rates
# ---------------------------------------------------------------------------


def _near_ties(costs_sorted):
    """Blocks whose two best costs lie within 1e-5 relative."""
    a, b = costs_sorted[0], costs_sorted[1]
    return np.abs(b - a) <= 1e-5 * np.maximum(np.abs(a), 1.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_candidate_decide_with_rates_matches_jax(seed):
    rng = np.random.default_rng(seed)
    rows, cols, r_map = 6, 10, P.HALF_R
    b = rows * cols
    d = 2 * r_map + 1
    ssem = rng.integers(-200000, 200000, (b, d, d)).astype(np.int32)
    src2m = rng.integers(200000, 400000, b).astype(np.int32)
    sse_zero = rng.integers(0, 1 << 20, b).astype(np.int32)
    sse_new = rng.integers(0, 1 << 20, b).astype(np.int32)
    # some exact ties between ZERO and NEW at equal rate are impossible
    # (rates differ), but equal SSEs exercise the float path all the same
    sse_new[::7] = sse_zero[::7]
    new_r = rng.integers(-326, 327, b).astype(np.int32)
    new_c = rng.integers(-326, 327, b).astype(np.int32)
    new_r[::5], new_c[::5] = 0, 0
    prev = rng.integers(-326, 327, (b, 2)).astype(np.int32)
    # far MVs: mvd components past the LUTs' reach are clipped
    new_c[3], prev[4, 0] = 326, -326
    tabs = P.make_rate_tabs(_adapted_fc(seed)[0], 120)
    lam = 90
    want = J._candidate_decide(
        jnp.asarray(ssem), jnp.asarray(src2m), jnp.asarray(sse_zero),
        jnp.asarray(sse_new), jnp.asarray(new_r), jnp.asarray(new_c),
        jnp.asarray(prev), rows, cols, r_map, 4, 4, jnp.asarray(lam),
        rates=_jax_rates(tabs))
    got = P._candidate_decide(
        _t(ssem), _t(src2m), _t(sse_zero), _t(sse_new), _t(new_r),
        _t(new_c), _t(prev), rows, cols, r_map, 4, 4, lam,
        P.new_bits_table("cpu"), rates=P.upload_rate_tabs(tabs, "cpu"))
    mv_same = (got[0].numpy() == np.asarray(want[0])) \
        & (got[1].numpy() == np.asarray(want[1]))
    differ = int((~mv_same).sum())
    print(f"seed {seed}: {differ} of {b} choices differ from JAX's")
    assert differ <= 0.01 * b
    np.testing.assert_allclose(got[2].numpy()[mv_same],
                               np.asarray(want[2])[mv_same], rtol=1e-6)
    assert got[2].dtype == torch.float32


def test_table_costs_keep_jax_s_operation_order():
    """sse + (lam_bits * rate) / 256 in float32, not a fused
    multiply-add and not lam_bits * (rate / 256)."""
    sads = torch.tensor([[16777217, 3]], dtype=torch.int32)
    rate = torch.tensor([[1001, 7]], dtype=torch.int32)
    lam = float(np.float32(1234.567))
    got = P._table_costs(sads, rate, lam).numpy()
    want = (np.float32(sads.numpy())
            + np.float32(lam) * np.float32(rate.numpy()) / np.float32(256))
    np.testing.assert_array_equal(got, want.astype(np.float32))


# ---------------------------------------------------------------------------
# top-K on tie-ridden scores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 3, 5, 12, 19])
def test_descent_parents_breaks_ties_like_lax_top_k(k):
    """Sentinels and equal distortions make ties routine; K cuts through
    runs of equals."""
    score = np.array([7, -1, 7, 7, 0, 0, -1, 7, 3, 3, 3, -1, 0, 7, -1, 3,
                      0, -1, 7, 7], np.int32)
    want = jax.lax.top_k(jnp.asarray(score), k)[1]
    _eq(P.descent_parents(_t(score), k), want)
    rng = np.random.default_rng(k)
    score = rng.integers(-1, 3, 200).astype(np.int32)
    _eq(P.descent_parents(_t(score), 50),
        jax.lax.top_k(jnp.asarray(score), 50)[1])
    flat = np.full(40, -1, np.int32)
    _eq(P.descent_parents(_t(flat), 10), np.arange(10))


# ---------------------------------------------------------------------------
# SSE at a full-pel MV that leaves the plane (dynamic_slice clamps)
# ---------------------------------------------------------------------------


def test_fullpel_sse_clamps_like_dynamic_slice():
    rng = np.random.default_rng(3)
    g = P.make_geom(128, 96)
    n = 32
    ref = rng.integers(0, 256, (g.pad_h + 2 * P.BORDER,
                                g.pad_w + 2 * P.BORDER), dtype=np.uint8)
    pos_y, pos_x, rows, cols = P._zone_positions(g, "cpu")
    b = rows * cols
    src = rng.integers(0, 256, (b, n, n), dtype=np.uint8)
    mv = rng.integers(-326, 327, (b, 2)).astype(np.int32)
    # MVs of a previous frame that push the block out of the plane
    mv[0] = (-4000, -4000)
    mv[1] = (4000, 4000)
    mv[2] = (-2000, 3000)
    mv[b - 1] = (3000, 100)
    want = J._fullpel_sse(jnp.asarray(ref), jnp.asarray(src),
                          jnp.asarray(pos_y.numpy()),
                          jnp.asarray(pos_x.numpy()), jnp.asarray(mv[:, 0]),
                          jnp.asarray(mv[:, 1]), n)
    got = P._fullpel_sse(_t(ref), _t(src), pos_y, pos_x, _t(mv[:, 0]),
                         _t(mv[:, 1]), n)
    assert got.dtype == torch.int32
    _eq(got, want)


def test_block_sq_sum_matches_jax():
    rng = np.random.default_rng(5)
    src = rng.integers(0, 256, (9, 16, 16), dtype=np.uint8)
    src[0] = 255
    _eq(P._block_sq_sum(_t(src)), J._block_sq_sum(jnp.asarray(src)))


# ---------------------------------------------------------------------------
# MC out of a parent's window (org_off)
# ---------------------------------------------------------------------------


def test_mc_from_parent_windows_matches_mc_on_the_plane():
    """A 16x16 child compensated from its parent's 32-block window with
    its origin offset equals MC on the full border-extended plane."""
    rng = np.random.default_rng(11)
    g = P.make_geom(128, 96)
    ref = rng.integers(0, 256, (g.pad_h + 2 * P.BORDER,
                                g.pad_w + 2 * P.BORDER), dtype=np.uint8)
    wins = P._extract_search_windows(_t(ref), 32, g.rows32, g.cols32, 0)
    k = g.n_blocks32
    pr, pc = np.arange(k) // g.cols32, np.arange(k) % g.cols32
    ii, jj = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
    pos_y = ((2 * pr[:, None] + ii) * 16).reshape(-1).astype(np.int32)
    pos_x = ((2 * pc[:, None] + jj) * 16).reshape(-1).astype(np.int32)
    off_y, off_x = np.tile(ii * 16, k), np.tile(jj * 16, k)
    mv = rng.integers(-8 * P.WIN_R, 8 * P.WIN_R + 1,
                      (4 * k, 2)).astype(np.int32)
    filt = torch.as_tensor(np.asarray(FILTERS, np.int32))
    got = P.mc_predict_from_wins(
        wins.repeat_interleave(4, dim=0), _t(pos_y), _t(pos_x),
        _t(mv[:, 0]), _t(mv[:, 1]), 16, 0, g.mi_rows, g.mi_cols, filt,
        P.WIN_R, org_off_y=_t(off_y.astype(np.int32)),
        org_off_x=_t(off_x.astype(np.int32)))
    want = J.mc_predict_batch(
        jnp.asarray(ref), jnp.asarray(pos_y), jnp.asarray(pos_x),
        jnp.asarray(mv[:, 0]), jnp.asarray(mv[:, 1]), 16, 0, g.mi_rows,
        g.mi_cols, FILTERS)
    _eq(got, want)


# ---------------------------------------------------------------------------
# loop filter with a split mask, against the host oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [(128, 128), (192, 120), (160, 96)])
def test_device_lf_split_matches_host_oracle(dims):
    """Mixed 32/16 grids: the step's loop filter with a split32 mask
    equals the host loop filter on the same mode-info grid."""
    w, h = dims
    g = P.make_geom(w, h)
    assert not g.strip
    rng = np.random.default_rng(w * 1000 + h)
    split = rng.integers(0, 2, (g.rows32, g.cols32)).astype(np.int32)
    mig = MI.ModeInfoGrid(g.mi_rows, g.mi_cols)
    for br in range(g.rows32):
        for bc in range(g.cols32):
            r0, c0 = br * 4, bc * 4
            kinds = ([(BlockSize.BLOCK_16X16, TxSize.TX_16X16, dr, dc)
                      for dr in (0, 2) for dc in (0, 2)]
                     if split[br, bc] else
                     [(BlockSize.BLOCK_32X32, TxSize.TX_32X32, 0, 0)])
            for bsize, ts, dr, dc in kinds:
                if r0 + dr >= g.mi_rows or c0 + dc >= g.mi_cols:
                    continue
                mi = MI.ModeInfo(
                    bsize=bsize, tx_size=ts, skip=bool(rng.integers(0, 2)),
                    is_inter=True, ref_frame=(1, -1), mv=((0, 0), (0, 0)),
                    inter_mode=int(rng.integers(0, 4)))
                mig.set_block(r0 + dr, c0 + dc, bsize, mi)

    def smooth(hh, ww):
        base = rng.integers(0, 256, (hh // 8 + 2, ww // 8 + 2)).astype(float)
        up = np.kron(base, np.ones((8, 8)))[:hh, :ww]
        return np.ascontiguousarray(
            np.clip(up + rng.normal(0, 2, (hh, ww)), 0, 255), np.uint8)

    planes = [smooth(g.h_mi, g.w_mi), smooth(g.h_mi // 2, g.w_mi // 2),
              smooth(g.h_mi // 2, g.w_mi // 2)]
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))
    lim_t, mblim_t = sharpness_limits(0)
    for lvl in (13, 37, 0):
        host = [p.copy() for p in planes]
        if lvl:
            loop_filter_frame(host, mig, lvl, 0, (1, 0, -1, -1), (0, 0),
                              True)
        dev = [_t(P.pad_plane(p, *shp)) for p, shp in zip(planes, shapes)]
        before = [d.clone() for d in dev]
        out = P.loop_filter_device(*dev, g, lvl, int(lim_t[lvl]),
                                   int(mblim_t[lvl]), split32=_t(split))
        for d, b in zip(dev, before):  # the inputs are not modified
            assert torch.equal(d, b)
        for k, (o, hst) in enumerate(zip(out, host)):
            _eq(o[:hst.shape[0], :hst.shape[1]], hst,
                f"plane {k} lvl={lvl}")


def test_device_lf_all_zero_split_equals_no_split():
    g = P.make_geom(128, 96)
    rng = np.random.default_rng(2)
    dev = [_t(rng.integers(100, 110, s, dtype=np.uint8)) for s in
           ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
            (g.pad_h // 2, g.pad_w // 2))]
    zero = torch.zeros((g.rows32, g.cols32), dtype=torch.int32)
    a = P.loop_filter_device(*dev, g, 20, 5, 30)
    b = P.loop_filter_device(*dev, g, 20, 5, 30, split32=zero)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], dev[0])  # the filter did something


# ---------------------------------------------------------------------------
# the step's argument forms
# ---------------------------------------------------------------------------


def test_step_argument_forms():
    """golden adds the three GOLDEN planes; golden or with_rates adds the
    rate tables as the last argument; anything else is refused. On the
    uniform grid the tables change the costs, not the outputs' shapes."""
    g = P.make_geom(128, 96)
    rng = np.random.default_rng(1)
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))
    src = [_t(rng.integers(0, 256, s, dtype=np.uint8)) for s in shapes]
    refs = [P.extend_borders_device(p, g.width >> (k > 0),
                                    g.height >> (k > 0))
            for k, p in enumerate(src)]
    prev = torch.zeros((g.n_blocks32, 2), dtype=torch.int32)
    scalars = (40, 50, 39, 10, 5, 20)
    rates = P.upload_rate_tabs(
        P.make_rate_tabs(T.default_frame_context(), 100), "cpu")
    plain = P.make_pframe_step(g, "cpu")
    outs, new_refs = plain(*src, *refs, prev, *scalars)
    assert set(outs) == {"m32", "rec_y", "rec_u", "rec_v"}
    assert tuple(new_refs[0].shape) == tuple(refs[0].shape)
    with pytest.raises(TypeError, match="13 arguments"):
        plain(*src, *refs, prev, *scalars, rates)
    tabled = P.make_pframe_step(g, "cpu", with_rates=True)
    outs_t, _ = tabled(*src, *refs, prev, *scalars, rates)
    assert outs_t["m32"]["mv"].shape == outs["m32"]["mv"].shape
    with pytest.raises(TypeError, match="14 arguments"):
        tabled(*src, *refs, prev, *scalars)
    golden = P.make_pframe_step(g, "cpu", split16=True, golden=True)
    with pytest.raises(TypeError, match="17 arguments"):
        golden(*src, *refs, prev, *scalars, rates)
    outs_g, _ = golden(*src, *refs, *refs, prev, *scalars, rates)
    assert {"m16f", "split32"} <= set(outs_g)
    assert tuple(outs_g["split32"].shape) == (g.rows32, g.cols32)
    assert len(outs_g["m16f"]["sel_idx"]) == g.n_blocks32 // P.DESCEND_FRAC
