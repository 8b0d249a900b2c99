"""The zone's mode decision: ``mode_decide_ref`` against the JAX package,
and ``tpu_vp9_torch/csrc/mode_decide.cu`` on the CPU against it.

1. ``pipeline/tpu_encdec.py:mode_decide_ref`` (LAST's five candidates,
   GOLDEN's two, ALTREF's two, the reference choice) against the JAX
   package's ``_candidate_decide`` itself, followed by ``encode_zone``'s
   GOLDEN and ALTREF lines (``tpu_vp9/pipeline/tpu_encdec.py:1661-1756``)
   run op by op in eager jnp on the same SSEs, bit for bit on the MVs and
   ``ref_sel``: the rate tables and the proxies, GOLDEN, ALTREF, tune SQ's
   per-block ``lam_bits``, a column shard's ``left_edge``, the 32 zone's
   half-res map and the strip's full-res one. With the proxies NEW's
   rate is the port's float32 table, ``new_bits_table``, where the JAX
   package takes XLA's log2; the two differ at 240 of the 1305 mvds
   (``tests/test_torch_encdec.py`` bounds that), so these cases draw
   every NEW MV at an mvd against its LEFT where they agree.
2. The kernel's device code built by g++ behind
   ``tests/cuda_standin/cuda_runtime.h`` (a host thread per CUDA thread,
   every CTA of the grid at once through ``standin_launch_all``, the
   float32 intrinsics as single IEEE operations, built with
   -ffp-contract=off and -fwrapv, ``__trap`` a failed launch) and
   launched by the wrapper ``ops/cuda_kernels.py:mode_decide`` on CPU
   tensors (its device check answers "cuda"), bit for bit against
   ``mode_decide_ref``: the cases above, all-tie inputs (every candidate
   and every reference equal), SSEs past 2^24 one apart, map scores that
   wrap int32, MVs past the map and past the LUTs' reach, an mvd past the
   proxy table (the plain version raises, the kernel's launch fails), and
   the wrapper's refusals.

What this cannot show: that nvcc accepts the source and the card's own
float32 rounding (the intrinsics promise it); ``chip_smoke.py`` checks
the kernel on the card.
"""

import ctypes
import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vp9.pipeline import tpu_encdec as J

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.pipeline import tpu_encdec as P

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "tpu_vp9_torch", "csrc")
STANDIN = os.path.join(REPO, "tests", "cuda_standin")
# (r_map, q3_shift, sse_scale) of the 32 zone's half-res map and the
# strip's full-res one (zone_search)
MAPS = {"n32": (P.HALF_R, 4, 4), "strip": (P.WIN_R, 3, 1)}
LAM = 90

_STANDIN_LAUNCH = """
cudaError_t launch_md(const MdArgs& a, cudaStream_t) {
  standin_launch_all((a.b + kWarps - 1) / kWarps, kThreads,
                     [&] { mode_decide_kernel(a); });
  return standin_take_trap();
}

"""


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _agreeing_mvds():
    """The mvds at which the port's proxy table equals the JAX package's
    rn0 + rnb * log2(1 + mvd) in float32."""
    k = np.arange(P.MVD_MAX + 1, dtype=np.float32)
    _, rn0, rnb, _, _ = P.CAND_RATE_PROXY
    jax_bits = np.asarray(rn0 + rnb * jnp.log2(1.0 + jnp.asarray(k)))
    return np.nonzero(jax_bits == P.new_bits_table("cpu").numpy())[0]


def rate_tabs(seed, qindex=120):
    """The frame's rate tables from a frame context away from the
    defaults."""
    rng = np.random.default_rng(seed)
    fc = T.default_frame_context()
    fc.inter_mode_probs = rng.integers(
        1, 256, fc.inter_mode_probs.shape).astype(fc.inter_mode_probs.dtype)
    fc.single_ref_probs = rng.integers(
        1, 256, fc.single_ref_probs.shape).astype(fc.single_ref_probs.dtype)
    fc.nmv.joints = rng.integers(1, 256, np.shape(fc.nmv.joints)).astype(
        np.asarray(fc.nmv.joints).dtype)
    return P.make_rate_tabs(fc, qindex)


def zone_case(seed, rows, cols, zone="n32", left_edge=False, mvds=None):
    """A zone's decision inputs as numpy arrays: maps, sums, SSEs, LAST's
    NEW MVs (each, with ``mvds``, at an mvd of that set against its LEFT),
    previous MVs, GOLDEN's (2, B) SSEs, ALTREF's SSEs and NEW MVs, and
    LEFT's edge column (or None). SSEs overlap the map scores so that
    every candidate and reference wins somewhere; some tie exactly."""
    rng = np.random.default_rng(seed)
    r_map, _, scale = MAPS[zone]
    b, d = rows * cols, 2 * r_map + 1
    top = 600_000 * scale
    src2m = rng.integers(200_000, 400_000, b)
    ssem = rng.integers(-200_000, 200_000, (b, d, d))
    edge = rng.integers(-326, 327, (rows, 2)) if left_edge else None
    new = np.zeros((rows, cols, 2), np.int64)
    for r in range(rows):
        left = edge[r] if left_edge else np.zeros(2, np.int64)
        for c in range(cols):
            if mvds is None:
                new[r, c] = rng.integers(-326, 327, 2)
            else:
                k = int(rng.choice(mvds[mvds <= 300]))
                dr = int(rng.integers(0, k + 1))
                step = np.array([dr, k - dr]) * rng.choice([-1, 1], 2)
                new[r, c] = left + step
            left = new[r, c]
    new = new.reshape(b, 2)
    sse_zero = rng.integers(0, top, b)
    sse_new = rng.integers(0, top, b)
    prev = rng.integers(-326, 327, (b, 2))
    prev[::6] = new[::6]
    gold = rng.integers(0, top, (2, b))
    alt = [rng.integers(0, top, b), rng.integers(0, top, b),
           *rng.integers(-326, 327, (2, b))]
    alt[3][::4] = 0  # NEW's row or column zero: the joints

    def near(x, sl, reach):
        """x[sl] moved by up to ``reach``: near-ties, where the rates and
        the signalling costs decide."""
        return np.maximum(x[sl] + rng.integers(-reach, reach, x[sl].shape),
                          0)

    # every third block from the second on: ZERO (almost surely LAST's
    # best: its SSE far below the rest) against NEW a few rates away;
    # from the third on: GOLDEN's and ALTREF's candidates a few
    # signalling costs from it
    for sl in (np.s_[1::3], np.s_[2::3]):
        sse_zero[sl] = rng.integers(0, 20_000, sse_zero[sl].shape)
    sse_new[1::3] = near(sse_zero, np.s_[1::3], 3000)
    sse_new[::7] = sse_zero[::7]
    gold[0, 2::3] = near(sse_zero, np.s_[2::3], 300)
    gold[1, 2::3] = near(gold[0], np.s_[2::3], 600)
    gold[0, ::5] = sse_zero[::5]
    alt[0][2::3] = near(sse_zero, np.s_[2::3], 300)
    alt[1][2::3] = near(alt[0], np.s_[2::3], 3000)
    i32 = np.int32
    return {"ssem": ssem.astype(i32), "src2m": src2m.astype(i32),
            "sse_zero": sse_zero.astype(i32), "sse_new": sse_new.astype(i32),
            "new_r": new[:, 0].astype(i32), "new_c": new[:, 1].astype(i32),
            "prev": prev.astype(i32), "gold": gold.astype(i32),
            "alt": [a.astype(i32) for a in alt],
            "edge": None if edge is None else edge.astype(i32)}


def aq_lam(tabs, b, seed):
    """A per-block lam_bits as tune SQ makes it: the frame's value times
    a float32 scale in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 2.0, b).astype(np.float32)
    return (scale * np.float32(tabs["lam_bits"])).astype(np.float32)


def port_args(cs, rows, cols, zone, rates, golden, altref, lam=LAM):
    """``mode_decide``'s positional and keyword arguments on CPU tensors."""
    r_map, q3s, scale = MAPS[zone]
    args = (_t(cs["ssem"]), _t(cs["src2m"]), _t(cs["sse_zero"]),
            _t(cs["sse_new"]), _t(cs["new_r"]), _t(cs["new_c"]),
            _t(cs["prev"]), rows, cols, r_map, q3s, scale, lam,
            P.new_bits_table("cpu"))
    kw = {"rates": rates,
          "left_edge": None if cs["edge"] is None else _t(cs["edge"]),
          "gold_sse": _t(cs["gold"]) if golden else None,
          "alt": tuple(_t(a) for a in cs["alt"]) if altref else None}
    return args, kw


def jax_altref_costs(rates, a_sse0, a_sse1, a_new_r, a_new_c):
    """encode_zone's ALTREF costs and first minimum, as written there (its
    lam_f the rate tables' lam_bits). Returns (mv_r, mv_c, cost without
    ALTREF's signalling cost)."""
    b = a_new_r.shape[0]
    zero = jnp.zeros_like(a_new_r)
    lam_f = rates["lam_bits"]
    a_sses = jnp.stack([a_sse0, a_sse1])
    mc = rates["mode_cost"]
    m = int(rates["mv_cost_max"])
    jt = (2 * (a_new_r != 0).astype(jnp.int32)
          + (a_new_c != 0).astype(jnp.int32))
    mvd_bits = (rates["joint_cost"][jt]
                + rates["nmv_row"][jnp.clip(a_new_r, -m, m) + m]
                + rates["nmv_col"][jnp.clip(a_new_c, -m, m) + m])
    a_rate = jnp.stack([mc[2] * jnp.ones_like(mvd_bits), mc[3] + mvd_bits])
    a_costs = (a_sses.astype(jnp.float32)
               + lam_f * a_rate.astype(jnp.float32) / 256.0)
    a_best = jnp.argmin(a_costs, axis=0)
    a_bidx = (a_best, jnp.arange(b))
    return (jnp.where(a_best == 0, zero, a_new_r),
            jnp.where(a_best == 0, zero, a_new_c), a_costs[a_bidx])


def jax_decide(cs, rows, cols, zone, tabs, lam_vec, golden, altref):
    """The JAX package's decision on the same inputs: its
    ``_candidate_decide``, then ``encode_zone``'s GOLDEN and ALTREF lines
    (tpu_vp9/pipeline/tpu_encdec.py:1661-1756) as written there, the SSEs
    given. Returns (mv_r, mv_c, ref_sel) as numpy."""
    r_map, q3s, scale = MAPS[zone]
    a = jnp.asarray
    lam = a(np.int32(LAM))
    rates = None
    if tabs is not None:
        rates = {k: (a(v) if k != "mv_cost_max" else v)
                 for k, v in tabs.items()}
        if lam_vec is not None:
            rates["lam_bits"] = a(lam_vec)
    mv_r, mv_c, cost_last = J._candidate_decide(
        a(cs["ssem"]), a(cs["src2m"]), a(cs["sse_zero"]), a(cs["sse_new"]),
        a(cs["new_r"]), a(cs["new_c"]), a(cs["prev"]), rows, cols, r_map,
        q3s, scale, lam, left_edge=None if cs["edge"] is None
        else a(cs["edge"]), rates=rates)
    b = rows * cols
    ref_sel = jnp.zeros((b,), jnp.int8)
    prev_mv = a(cs["prev"])
    if golden or altref:
        if rates is not None:
            lam_f = rates["lam_bits"]
            ref_extra = rates["ref_cost"].astype(jnp.float32)[:, None] \
                * lam_f / 256.0
        else:
            lam_f = lam.astype(jnp.float32)
            ref_extra = jnp.array([0.0, 2.0, 2.0],
                                  jnp.float32)[:, None] * lam_f
        best_cost = cost_last + ref_extra[0]
        zero = jnp.zeros_like(mv_r)
    if golden:
        g_cands_r = jnp.stack([zero, prev_mv[:, 0]])
        g_cands_c = jnp.stack([zero, prev_mv[:, 1]])
        g_sses = a(cs["gold"])
        if rates is not None:
            mc = rates["mode_cost"]
            g_rate = jnp.stack([mc[2], mc[0]])[:, None]
            g_costs = (g_sses.astype(jnp.float32)
                       + lam_f * g_rate.astype(jnp.float32) / 256.0)
        else:
            rz, _, _, rp, _ = J.CAND_RATE_PROXY
            g_costs = (g_sses.astype(jnp.float32)
                       + lam_f * jnp.array([[rz], [rp]], jnp.float32))
        g_best = jnp.argmin(g_costs, axis=0)
        g_bidx = (g_best, jnp.arange(b))
        g_cost = g_costs[g_bidx] + ref_extra[1]
        g_mv_r = g_cands_r[g_bidx]
        g_mv_c = g_cands_c[g_bidx]
        use_gold = g_cost < best_cost
        best_cost = jnp.where(use_gold, g_cost, best_cost)
        ref_sel = use_gold.astype(jnp.int8)
        mv_r = jnp.where(use_gold, g_mv_r, mv_r)
        mv_c = jnp.where(use_gold, g_mv_c, mv_c)
    if altref:
        a_mv_r, a_mv_c, a_cost = jax_altref_costs(
            rates, *(a(v) for v in cs["alt"]))
        a_cost = a_cost + ref_extra[2]
        use_alt = a_cost < best_cost
        ref_sel = jnp.where(use_alt, jnp.int8(2), ref_sel)
        mv_r = jnp.where(use_alt, a_mv_r, mv_r)
        mv_c = jnp.where(use_alt, a_mv_c, mv_c)
    return np.asarray(mv_r), np.asarray(mv_c), np.asarray(ref_sel)


# (zone, rate form, GOLDEN, ALTREF, left edge): every branch
CASES = {
    "n32-proxies": ("n32", "proxies", False, False, False),
    "n32-proxies-golden": ("n32", "proxies", True, False, False),
    "n32-tables": ("n32", "tables", False, False, False),
    "n32-tables-golden": ("n32", "tables", True, False, False),
    "n32-tables-golden-altref": ("n32", "tables", True, True, False),
    "n32-tables-altref": ("n32", "tables", False, True, False),
    "n32-aq-golden-altref": ("n32", "aq", True, True, False),
    "n32-tables-golden-left-edge": ("n32", "tables", True, False, True),
    "n32-proxies-left-edge": ("n32", "proxies", False, False, True),
    "strip-proxies-golden": ("strip", "proxies", True, False, False),
    "strip-tables-golden-altref": ("strip", "tables", True, True, False),
    "strip-aq-golden": ("strip", "aq", True, False, False),
}


def case_inputs(name, seed):
    """(mode_decide's args and kwargs, the JAX decision) of a case."""
    zone, form, golden, altref, edge = CASES[name]
    rows, cols = (4, 6) if zone == "n32" else (1, 20)
    cs = zone_case(seed, rows, cols, zone, left_edge=edge,
                   mvds=_agreeing_mvds() if form == "proxies" else None)
    tabs = rates = lam_vec = None
    if form != "proxies":
        tabs = rate_tabs(seed)
        rates = P.upload_rate_tabs(tabs, "cpu")
        if form == "aq":
            lam_vec = aq_lam(tabs, rows * cols, seed)
            rates = dict(rates, lam_bits=_t(lam_vec))
    args, kw = port_args(cs, rows, cols, zone, rates, golden, altref)
    return args, kw, (cs, rows, cols, zone, tabs, lam_vec, golden, altref)


# ---------------------------------------------------------------------------
# 1. the plain version against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_mode_decide_ref_matches_jax(name):
    args, kw, jax_in = case_inputs(name, seed=len(name))
    mv_r, mv_c, ref_sel = P.mode_decide_ref(*args, **kw)
    want = jax_decide(*jax_in)
    assert mv_r.dtype == mv_c.dtype == torch.int32
    assert ref_sel.dtype == torch.int8
    np.testing.assert_array_equal(mv_r.numpy(), want[0])
    np.testing.assert_array_equal(mv_c.numpy(), want[1])
    np.testing.assert_array_equal(ref_sel.numpy(), want[2])
    # every reference the case offers won somewhere
    _, _, golden, altref, _ = CASES[name]
    assert {0, *((1,) if golden else ()), *((2,) if altref else ())} \
        <= set(ref_sel.tolist())


@pytest.mark.parametrize("dims,n", [((96, 64), 32), ((128, 112), 16)],
                         ids=["n32", "strip"])
def test_altref_decide_matches_jax(dims, n):
    """``_altref_decide`` (``_altref_search``, then ``_altref_costs``)
    against encode_zone's ALTREF block on the same planes: the windows,
    the ZERO SSE, the 32 grid's two-level search or the strip's flat one,
    the quarter-pel refinement and the costs, bit for bit."""
    from tpu_vp9_torch.utils.yuv import panning_frames

    g = P.make_geom(*dims)
    frames = list(panning_frames(*dims, 3, seed=n))
    src = P.pad_plane(np.asarray(frames[1].y), g.pad_h, g.pad_w)
    alt = P.pad_plane(np.asarray(frames[2].y), g.pad_h, g.pad_w)
    alt_y = P.extend_borders_device(_t(alt), g.width, g.height)
    y0, rows, cols = P._zone(g, n)
    src_blocks = P._extract_blocks(_t(src), y0, rows, cols, n)
    tabs = rate_tabs(n)
    got = P._altref_decide(alt_y, src_blocks, rows, cols, n,
                           P.upload_rate_tabs(tabs, "cpu"), y0)
    a = jnp.asarray
    ja, js = a(alt_y.numpy()), a(src_blocks.numpy())
    filters = a(np.asarray(P.FILTERS, np.int32))
    wins = J._extract_search_windows(ja, n, rows, cols, y0,
                                     np.arange(cols, dtype=np.int64) * n)
    sse0 = J._zero_sse(ja, js, y0, 0, rows, cols, n)
    if n == 32:
        cy, cx, dyr, dxr, loc, _, _ = J.hier_search(js, wins, n)
        sr, sc, sse1 = J._subpel_exhaustive(loc, js, dyr, dxr, n, filters,
                                            r=J.REFINE_R)
        new_r, new_c = cy * 8 + sr, cx * 8 + sc
    else:
        dy, dx, _ = J._full_search_sse_mxu(js, wins, n)
        new_r, new_c, sse1 = J._subpel_exhaustive(wins, js, dy, dx, n,
                                                  filters)
    rates = {k: (a(v) if k != "mv_cost_max" else v) for k, v in tabs.items()}
    want = jax_altref_costs(rates, sse0, sse1, new_r, new_c)
    for x, y in zip(got[:3], want):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(wins))
    assert bool((got[0] != 0).any())  # NEW won somewhere


def test_mode_decide_dispatch_takes_the_plain_version_on_the_cpu():
    args, kw, _ = case_inputs("n32-tables-golden-altref", seed=3)
    got = P.mode_decide(*_row(args), **kw)
    want = P.mode_decide_ref(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="rate tables"):
        P.mode_decide(*_row(args), **dict(kw, rates=None))


def test_rate_scalars_row_holds_the_host_numbers():
    tabs = rate_tabs(5)
    up = P.upload_rate_tabs(tabs, "cpu")
    row = up["scalars"].numpy()
    assert row.dtype == np.int32 and row.shape == (len(K.RATE_SCALARS),)
    assert row[:4].tolist() == up["mode_cost"]
    assert row[4:7].tolist() == up["ref_cost"]
    assert row[7] == up["mv_cost_max"]
    assert row[8:9].view(np.float32)[0] == np.float32(up["lam_bits"])


# ---------------------------------------------------------------------------
# 2. the kernel under the g++ stand-in
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """``mode_decide.cu`` built with g++ behind the stand-ins: the source
    up to its launch helper, the stand-in's helper, the source's
    launcher. Returns the launcher with ``_LAUNCHERS``' argument types."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the stand-in of the CUDA source")
    with open(os.path.join(CSRC, "mode_decide.cu")) as fh:
        src = fh.read()
    cut = src.index("cudaError_t launch_md(")
    tail = src[src.index("}  // namespace"):]
    out = tmp_path_factory.mktemp("standin")
    cpp, lib = out / "mode_decide_standin.cpp", out / "libmode_decide.so"
    cpp.write_text(src[:cut] + _STANDIN_LAUNCH + tail)
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fwrapv", "-ffp-contract=off", "-shared",
         "-fPIC", "-I", STANDIN, "-I", CSRC, "-o", str(lib), str(cpp),
         "-lpthread"], check=True, capture_output=True, text=True)
    _, sym, n_ptr, n_float, n_int = K._LAUNCHERS["mode_decide"]
    fn = getattr(ctypes.CDLL(str(lib)), sym)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_float] * n_float
                   + [ctypes.c_int] * n_int + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture
def on_standin(standin, monkeypatch):
    """``mode_decide``'s wrapper on CPU tensors launching the stand-in
    build; a launch that fails raises as ``_launch`` does."""
    real_kind = K._device_kind

    def kind(name, *tensors):
        return "cuda" if name == "mode_decide" else real_kind(name, *tensors)

    def launch(name, dev, *args, words=None):
        err = standin(*args, None)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {err}")

    monkeypatch.setattr(K, "_device_kind", kind)
    monkeypatch.setattr(K, "_launch", launch)
    return K


def _row(args):
    """The plain version's arguments with its lam (at 12) as the step's
    row of scalars, which the dispatch and the wrapper take."""
    return (*args[:12], P.step_scalars(40, 48, args[12], 0, 0, 0),
            *args[13:])


def kernel(args, kw):
    """The wrapper's call on the dispatch's arguments."""
    return K.mode_decide(*_row(args), kw["rates"], kw["left_edge"],
                         kw["gold_sse"], kw["alt"], P.CAND_RATE_PROXY)


def _same(got, want, msg=""):
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape, msg
        assert torch.equal(g, w), msg


@pytest.mark.parametrize("name", CASES)
def test_kernel_on_standin_matches_plain(on_standin, name):
    args, kw, _ = case_inputs(name, seed=len(name) + 1)
    before = K.mode_decide.launches
    _same(kernel(args, kw), P.mode_decide_ref(*args, **kw), name)
    assert K.mode_decide.launches == before + 1


def _tie_tabs(lam_bits):
    """Rate tables under which every candidate of every reference costs
    its SSE plus the same rate: equal mode costs, mvd bits 0, equal
    signalling costs."""
    m = 60
    return {"mode_cost": np.full(4, 300, np.int32),
            "joint_cost": np.zeros(4, np.int32),
            "nmv_row": np.zeros(2 * m + 1, np.int32),
            "nmv_col": np.zeros(2 * m + 1, np.int32),
            "ref_cost": np.full(3, 150, np.int32),
            "lam_bits": np.float32(lam_bits), "mv_cost_max": m}


@pytest.mark.parametrize("form", ["proxies-lam0", "tables", "tables-lam0",
                                  "aq"])
def test_kernel_on_standin_all_ties_take_last_zero(on_standin, form):
    """Every candidate's SSE and rate equal, GOLDEN and ALTREF tying LAST
    exactly: ZERO of LAST wins in both versions."""
    rows, cols = 4, 6
    b = rows * cols
    r_map, q3s, scale = MAPS["n32"]
    d = 2 * r_map + 1
    x = 4 * 1_000_003
    src2m = np.full(b, 300_000, np.int32)
    cs = {"ssem": np.full((b, d, d), x // 4 - 300_000, np.int32),
          "src2m": src2m, "sse_zero": np.full(b, x, np.int32),
          "sse_new": np.full(b, x, np.int32),
          "new_r": np.arange(b, dtype=np.int32) * 8 - 80,
          "new_c": np.arange(b, dtype=np.int32) % 5 - 2,
          "prev": np.stack([np.arange(b), -np.arange(b)], 1).astype(np.int32),
          "gold": np.full((2, b), x, np.int32),
          "alt": [np.full(b, x, np.int32), np.full(b, x, np.int32),
                  np.arange(b, dtype=np.int32) - 7,
                  np.arange(b, dtype=np.int32)],
          "edge": None}
    if form == "proxies-lam0":
        args, kw = port_args(cs, rows, cols, "n32", None, True, False, lam=0)
    else:
        tabs = _tie_tabs(0.0 if form == "tables-lam0" else 1234.5)
        rates = P.upload_rate_tabs(tabs, "cpu")
        if form == "aq":
            rates = dict(rates, lam_bits=_t(aq_lam(tabs, b, 9)))
        args, kw = port_args(cs, rows, cols, "n32", rates, True, True)
    got = kernel(args, kw)
    _same(got, P.mode_decide_ref(*args, **kw), form)
    assert not got[0].any() and not got[1].any() and not got[2].any()


def test_kernel_on_standin_sses_past_2_24_round_to_nearest(on_standin):
    """SSEs above 2^24 one apart (a 32x32 SSE reaches 66.3e6): both
    versions round them alike to float32, so ties stay ties."""
    args, kw, _ = case_inputs("n32-tables-golden-altref", seed=11)
    rng = np.random.default_rng(11)
    b = args[4].shape[0]
    base = rng.integers(1 << 24, 66_300_000, b)
    for i, t in enumerate((args[2], args[3])):
        t.copy_(_t((base + i).astype(np.int32)))
    kw["gold_sse"].copy_(_t(np.stack([base + 1, base + 2]).astype(np.int32)))
    kw["alt"][0].copy_(_t((base + 3).astype(np.int32)))
    kw["alt"][1].copy_(_t((base - 1).astype(np.int32)))
    _same(kernel(args, kw), P.mode_decide_ref(*args, **kw))


def test_kernel_on_standin_wraps_map_scores_and_clamps(on_standin):
    """Map entries near 2^30 whose (entry + src2m) * 4 wraps int32; PREV,
    LEFT and ABOVE far past the map (clamped to its edge); NEW and ALTREF
    MVs past the LUTs' reach (clipped): both versions alike."""
    args, kw, _ = case_inputs("n32-tables-golden-altref", seed=12)
    tabs = rate_tabs(12)
    m = tabs["mv_cost_max"]
    tabs = dict(tabs, mv_cost_max=40, nmv_row=tabs["nmv_row"][m - 40:m + 41],
                nmv_col=tabs["nmv_col"][m - 40:m + 41])
    kw["rates"] = P.upload_rate_tabs(tabs, "cpu")
    rng = np.random.default_rng(12)
    ssem = args[0]
    ssem[::3].copy_(_t(rng.integers((1 << 29) - 500_000, 1 << 29,
                                    ssem[::3].shape).astype(np.int32)))
    args[6][::2] = torch.tensor([900, -900], dtype=torch.int32)
    args[4][1::4] = 640
    kw["alt"][2][::3] = -700
    got = kernel(args, kw)
    _same(got, P.mode_decide_ref(*args, **kw))
    m = kw["rates"]["mv_cost_max"]
    assert int((args[4][1:] - args[4][:-1]).abs().max()) > m


def test_kernel_on_standin_past_the_proxy_table_fails(on_standin):
    """Without rate tables an mvd past the NEW table has no rate: the
    plain version's indexing raises, the kernel traps and its launch
    fails; at the table's last entry both agree."""
    args, kw, _ = case_inputs("n32-proxies", seed=13)
    args = list(args)
    new_r, new_c = args[4], args[5]
    # the first row's blocks from column 1 on moved down together: block
    # 1's mvd against block 0 becomes MVD_MAX + 1, the others' stay
    cols = args[8]
    dr = int(new_r[1] - new_r[0])
    new_r[1:cols] += P.MVD_MAX + 1 - abs(int(new_c[1] - new_c[0])) - dr
    with pytest.raises(IndexError):
        P.mode_decide_ref(*args, **kw)
    with pytest.raises(RuntimeError, match="launch failed"):
        kernel(args, kw)
    new_r[1:cols] -= 1
    _same(kernel(args, kw), P.mode_decide_ref(*args, **kw))


def test_wrapper_refusals(on_standin):
    args, kw, _ = case_inputs("n32-tables-golden-altref", seed=14)
    with pytest.raises(TypeError, match="int32"):
        kernel((args[0].long(), *args[1:]), kw)
    with pytest.raises(ValueError, match="contiguous"):
        kernel((args[0], args[1], args[2], args[3], args[4],
                args[5], args[6].t().contiguous().t(), *args[7:]), kw)
    with pytest.raises(TypeError, match="gold_sse"):
        kernel(args, dict(kw, gold_sse=kw["gold_sse"][:1].contiguous()))
    with pytest.raises(ValueError, match="rate tables"):
        kernel(args, dict(kw, rates=None))
    with pytest.raises(TypeError, match="lam_bits"):
        kernel(args, dict(kw, rates=dict(kw["rates"],
                                         lam_bits=torch.ones(3))))
    short = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError, match="scalars"):
        kernel(args, dict(kw, rates=dict(kw["rates"], scalars=short)))
    with pytest.raises(ValueError, match="blocks in a"):
        kernel((*args[:7], 5, *args[8:]), kw)


def test_wrapper_takes_cuda_tensors_only():
    args, kw, _ = case_inputs("n32-tables", seed=15)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel(args, kw)
