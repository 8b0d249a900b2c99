"""The decisions folded into motion compensation: the step's dispatches
``mode_decide_mc`` (the zone's decision, LAST, GOLDEN, ALTREF and the
reference choice, then its MC) and ``descent_decide_mc`` (the split16
children's decision, then their MC), each one launch of
``tpu_vp9_torch/csrc/mc_predict.cu``'s decided instances on the card.

1. Their plain compositions (``pipeline/tpu_encdec.py:
   mode_decide_mc_ref`` and ``descent_decide_mc_ref``: the decision's
   plain version, then ``mc_predict_planes_ref``) against the JAX
   package, bit for bit: its ``_candidate_decide`` with ``encode_zone``'s
   GOLDEN and ALTREF lines (``tests/test_torch_mode_decide.py:
   jax_decide``) or ``encode_children_masked``'s candidate decision
   (``tests/test_torch_descent.py:jax_decide``), then its
   ``mc_predict_from_wins`` on the windows its ``_extract_search_windows``
   cuts from the same planes, merged by ``jnp.where`` over the reference
   (the zones) or the parents' taken and repeated (the children).
2. The decided instances built by g++ behind
   ``tests/cuda_standin/cuda_runtime.h`` (every CTA of a plane at once
   through ``standin_launch_all``, the float32 intrinsics single IEEE
   operations, -ffp-contract=off, ``__trap`` a failed launch) and launched
   by the wrappers ``ops/cuda_kernels.py:mode_decide_mc`` and
   ``descent_decide_mc`` on CPU tensors, bit for bit against the plain
   compositions: GOLDEN and ALTREF with the rate tables, the proxies,
   ``left_edge``, tune SQ's ``lam_vec``, the strip zone at n=16, all-tie
   inputs (the first candidate wins), an mvd past ``new_bits`` (a trap),
   ragged batches (only the batch's blocks written), the int16 and int32
   MV layouts, the children's rate scalars read from the device row; the
   launch counted as mc_predict's, with the launcher's arguments; the
   wrappers' refusals.
3. The decision's device code is one copy: ``csrc/decide.cuh``, which
   ``mode_decide.cu``, ``descent.cu`` and ``mc_predict.cu`` include.

What this cannot show: that nvcc accepts the source, timing, and the
card's own float32 rounding (the intrinsics promise it);
``chip_smoke.py`` checks the decided launches on the card.
"""

import ctypes
import os
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vp9.pipeline import tpu_encdec as J

from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.pipeline import tpu_encdec as P

import test_torch_descent as DS
import test_torch_mode_decide as MD

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "tpu_vp9_torch", "csrc")
STANDIN = os.path.join(REPO, "tests", "cuda_standin")
FILTERS = torch.as_tensor(np.asarray(P.FILTERS, np.int32))
DECIDED = ("mode_decide_mc", "descent_decide_mc")
CHILD_PROXY = (P.CAND_RATE_PROXY[0], P.CAND_RATE_PROXY[4])
# the zones of test_torch_mode_decide's cases: (n, width, height) of a
# geometry whose 32 grid is the n32 case's 4 x 6 zone, or whose strip is
# the strip case's 20 blocks; and a ragged 3 x 5 zone (15 blocks: no
# multiple of four warps)
ZONES = {"n32": (32, 192, 128), "strip": (16, 320, 112),
         "ragged": (32, 160, 96)}

# the stand-in's launch helpers: each plane's CTAs sixteen at once (a
# CTA's warps side by side); a trapped kernel fails its launch
_STANDIN_LAUNCH = """
template <int N, int D>
cudaError_t launch(const McArgs& a, cudaStream_t) {
  const int ctas = (a.nblk + kWarps - 1) / kWarps;
  for (int p = 0; p < kPlanes; ++p) {
    for (int c0 = 0; c0 < ctas; c0 += 16) {
      standin_launch_all(ctas - c0 < 16 ? ctas - c0 : 16, kThreads, [&] {
        blockIdx.x += c0;
        blockIdx.y = p;
        mc_predict_kernel<N, D>(a);
      });
    }
  }
  return standin_take_trap();
}

template <int N, int D>
int occupancy(int* ctas_per_sm, int* smem_bytes) {
  *ctas_per_sm = 1;
  *smem_bytes = kSmem<N>;
  return 0;
}

"""


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """``mc_predict.cu`` built with g++ behind the stand-ins: the source up
    to its launch helpers (its dynamic shared memory the stand-in's
    buffer), the stand-in's helpers, the source's launchers. Returns
    {wrapper name: launcher} with ``_LAUNCHERS``' argument types."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the stand-in of the CUDA source")
    with open(os.path.join(CSRC, "mc_predict.cu")) as fh:
        src = fh.read()
    cut = src.index("template <int N, int D>\ncudaError_t launch(")
    tail = src[src.index("}  // namespace"):]
    body = src[:cut].replace(
        "extern __shared__ __align__(16) unsigned char smem[];",
        "unsigned char* smem = standin_smem;")
    out = tmp_path_factory.mktemp("standin")
    cpp, lib = out / "mc_predict_standin.cpp", out / "libmc_predict.so"
    cpp.write_text(body + _STANDIN_LAUNCH + tail)
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fwrapv", "-ffp-contract=off", "-shared",
         "-fPIC", "-I", STANDIN, "-I", CSRC, "-o", str(lib), str(cpp),
         "-lpthread"], check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    fns = {}
    for name in (*DECIDED, "mc_predict"):
        _, sym, n_ptr, n_float, n_int = K._LAUNCHERS[name]
        fn = getattr(dll, sym)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_float] * n_float
                       + [ctypes.c_int] * n_int + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@pytest.fixture
def on_standin(standin, monkeypatch):
    """The decided wrappers on CPU tensors launching the stand-in build; a
    launch that fails raises as ``_launch`` does."""
    real_kind = K._device_kind

    def kind(name, *tensors):
        return "cuda" if name in DECIDED else real_kind(name, *tensors)

    def launch(name, dev, *args, words=None):
        err = standin[name](*args, None)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {err}")

    monkeypatch.setattr(K, "_device_kind", kind)
    monkeypatch.setattr(K, "_launch", launch)
    return K


def _bordered(g, rng):
    """Random border-extended-sized (y, u, v) planes of geometry ``g``."""
    return tuple(_t(rng.integers(0, 256, (h + 2 * P.BORDER, w + 2 * P.BORDER),
                                 np.uint8))
                 for h, w in ((g.pad_h, g.pad_w),
                              (g.pad_h // 2, g.pad_w // 2),
                              (g.pad_h // 2, g.pad_w // 2)))


def _kernel_grid(planes, grid):
    return P.mc_window_grid(tuple(tuple(t.shape) for t in planes[0]),
                            tuple(grid))


# ---------------------------------------------------------------------------
# the zone: cases and the JAX package's decision and MC
# ---------------------------------------------------------------------------


def zone_args(name, seed, zone=None):
    """``mode_decide_mc``'s arguments (CPU tensors) for test_torch_mode_
    decide's case ``name`` (its decision inputs) with random planes of
    each reference the case takes, at the geometry of its zone
    (``ZONES``), and the JAX decision's inputs."""
    d_args, kw, jax_in = MD.case_inputs(name, seed)
    zone = zone or MD.CASES[name][0]
    n, w, h = ZONES[zone]
    g = P.make_geom(w, h)
    rows, cols = d_args[7], d_args[8]
    rng = np.random.default_rng(seed)
    planes = [_bordered(g, rng),
              None if kw["gold_sse"] is None else _bordered(g, rng),
              None if kw["alt"] is None else _bordered(g, rng)]
    y0 = g.strip_y if n == 16 else 0
    pos_y = np.repeat(y0 + np.arange(rows) * n, cols).astype(np.int32)
    pos_x = np.tile(np.arange(cols) * n, rows).astype(np.int32)
    args = (*d_args, kw["rates"], kw["left_edge"], kw["gold_sse"],
            kw["alt"], planes, _t(pos_y), _t(pos_x), n, g.mi_rows,
            g.mi_cols, FILTERS, (n, y0, rows, cols))
    return args, jax_in


def jax_zone_mc(args, mv_r, mv_c, ref_sel):
    """The JAX package's MC of a zone at its decision: per plane each
    reference's windows of the zone's grid (``_extract_search_windows``),
    merged by ``jnp.where`` over ref_sel, then ``mc_predict_from_wins``."""
    planes, pos_y, pos_x, n, mi_rows, mi_cols, _, grid = args[18:]
    _, y0, rows, cols = grid
    out = []
    for p in range(3):
        ss = min(p, 1)
        m, r = n >> ss, (P.WIN_R, P.CHROMA_WIN_R)[ss]
        wins = [None if ref is None else J._extract_search_windows(
            jnp.asarray(ref[p].numpy()), m, rows, cols, y0 >> ss,
            np.arange(cols, dtype=np.int64) * m, r=r) for ref in planes]
        w = wins[0]
        for ref_id in (1, 2):
            if wins[ref_id] is not None:
                w = jnp.where(jnp.asarray(ref_sel == ref_id)[:, None, None],
                              wins[ref_id], w)
        out.append(np.asarray(J.mc_predict_from_wins(
            w, jnp.asarray(pos_y.numpy() >> ss),
            jnp.asarray(pos_x.numpy() >> ss), jnp.asarray(mv_r),
            jnp.asarray(mv_c), m, ss, mi_rows, mi_cols,
            np.asarray(P.FILTERS, np.int32), r)))
    return out


def _row(args, i, sc=None):
    """``args`` with the plain version's lam at ``i`` replaced by the
    step's row of scalars the wrappers take (``sc``, or a new one)."""
    if sc is None:
        sc = P.step_scalars(40, 48, args[i], 0, 0, 0)
    return (*args[:i], sc, *args[i + 1:])


def zone_kernel(args, sc=None):
    """The wrapper's call on the dispatch's arguments (the lam as the
    step's row ``sc``)."""
    return K.mode_decide_mc(*_row(args[:18], 12, sc), P.CAND_RATE_PROXY,
                            *args[18:24], _kernel_grid(args[18], args[25]))


def _same(got, want, msg=""):
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape, msg
        assert torch.equal(g, w), msg


# ---------------------------------------------------------------------------
# the children: cases and the JAX package's decision and MC
# ---------------------------------------------------------------------------


def children_args(seed, with_rates, k=6, kind="random"):
    """``descent_decide_mc``'s arguments (CPU tensors) for 4K children of
    K parents of a 128 x 96 frame's 32 zone (test_torch_descent's decision
    inputs, the parents' windows by index in LAST's planes), the JAX
    decision's inputs, the parents."""
    n = 4 * k
    a = DS.decide_case(n, seed, kind)
    tabs = DS.rate_tabs(seed) if with_rates else None
    rates = None if tabs is None else P.upload_rate_tabs(tabs, "cpu")
    g = P.make_geom(128, 96)
    rng = np.random.default_rng(seed)
    sel = np.sort(rng.choice(g.n_blocks32, k, replace=False))
    ii, jj = np.tile([0, 0, 1, 1], k), np.tile([0, 1, 0, 1], k)
    pos_y = (np.repeat(sel // g.cols32 * 32, 4) + 16 * ii).astype(np.int32)
    pos_x = (np.repeat(sel % g.cols32 * 32, 4) + 16 * jj).astype(np.int32)
    args = (*(_t(a[key]) for key in DS.DECIDE_KEYS), 300,
            P.new_bits_table("cpu"), rates, [_bordered(g, rng)], _t(pos_y),
            _t(pos_x), 16, g.mi_rows, g.mi_cols, FILTERS,
            (32, 0, g.rows32, g.cols32),
            _t(np.repeat(sel, 4).astype(np.int32)),
            _t((16 * ii).astype(np.int32)), _t((16 * jj).astype(np.int32)))
    return args, (a, tabs), sel


def jax_children_mc(args, sel, mv_r, mv_c):
    """The JAX package's MC of the children at their decision: the
    parents' windows of LAST taken and repeated, the children's offsets
    inside them, ``mc_predict_from_wins``."""
    (planes, pos_y, pos_x, n, mi_rows, mi_cols, _, grid, _, off_y,
     off_x) = args[13:]
    _, _, rows, cols = grid
    out = []
    for p in range(3):
        ss = min(p, 1)
        m, r = 32 >> ss, (P.WIN_R, P.CHROMA_WIN_R)[ss]
        w = J._extract_search_windows(
            jnp.asarray(planes[0][p].numpy()), m, rows, cols, 0,
            np.arange(cols, dtype=np.int64) * m, r=r)
        w = jnp.repeat(jnp.take(w, jnp.asarray(sel), axis=0), 4, axis=0)
        out.append(np.asarray(J.mc_predict_from_wins(
            w, jnp.asarray(pos_y.numpy() >> ss),
            jnp.asarray(pos_x.numpy() >> ss), jnp.asarray(mv_r),
            jnp.asarray(mv_c), n >> ss, ss, mi_rows, mi_cols,
            np.asarray(P.FILTERS, np.int32), r,
            org_off_y=jnp.asarray(off_y.numpy() >> ss),
            org_off_x=jnp.asarray(off_x.numpy() >> ss))))
    return out


def children_kernel(args, sc=None):
    """The wrapper's call on the dispatch's arguments (the lam as the
    step's row ``sc``)."""
    return K.descent_decide_mc(*_row(args[:13], 10, sc), CHILD_PROXY,
                               *args[13:19], _kernel_grid(args[13], args[20]),
                               *args[21:])


# ---------------------------------------------------------------------------
# 1. the plain compositions against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MD.CASES)
def test_mode_decide_mc_ref_matches_jax(name):
    args, jax_in = zone_args(name, seed=len(name) + 40)
    mv_r, mv_c, ref_sel, mv, *preds = P.mode_decide_mc_ref(*args)
    jr, jc, jref = MD.jax_decide(*jax_in)
    np.testing.assert_array_equal(mv_r.numpy(), jr)
    np.testing.assert_array_equal(mv_c.numpy(), jc)
    np.testing.assert_array_equal(ref_sel.numpy(), jref)
    assert mv.dtype == torch.int16 and tuple(mv.shape) == (jr.size, 2)
    np.testing.assert_array_equal(
        mv.numpy(), np.stack([jr, jc], -1).astype(np.int16))
    for got, want in zip(preds, jax_zone_mc(args, jr, jc, jref),
                         strict=True):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("with_rates", [True, False],
                         ids=["tables", "proxies"])
def test_descent_decide_mc_ref_matches_jax(with_rates):
    args, (a, tabs), sel = children_args(5 + with_rates, with_rates)
    mv_r, mv_c, mv, *preds = P.descent_decide_mc_ref(*args)
    jr, jc, _ = DS.jax_decide(a, 300, tabs,
                              nb=P.new_bits_table("cpu").numpy())
    np.testing.assert_array_equal(mv_r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(mv_c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(
        mv.numpy(), np.stack([jr, jc], -1).astype(np.int16))
    for got, want in zip(preds, jax_children_mc(args, sel, jr, jc),
                         strict=True):
        np.testing.assert_array_equal(got.numpy(), want)


def test_dispatches_take_the_plain_compositions_on_the_cpu():
    """The dispatches (the step's row of scalars for the plain versions'
    lam) on CPU tensors give the plain compositions."""
    args, _ = zone_args("n32-tables-golden-altref", seed=3)
    _same(P.mode_decide_mc(*_row(args, 12)), P.mode_decide_mc_ref(*args))
    cargs, _, _ = children_args(4, True)
    _same(P.descent_decide_mc(*_row(cargs, 10)),
          P.descent_decide_mc_ref(*cargs))


# ---------------------------------------------------------------------------
# 2. the decided instances under the g++ stand-in
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", MD.CASES)
def test_zone_on_standin_matches_plain(on_standin, name):
    """Every branch of the zone's decision (test_torch_mode_decide's
    cases: the rate tables and the proxies, GOLDEN, ALTREF, tune SQ's
    lam_vec, a shard's left_edge, the 32 zone and the strip at n=16),
    then its MC: one launch, counted as mc_predict's."""
    args, _ = zone_args(name, seed=len(name) + 60)
    before = K.mc_predict.launches
    got = zone_kernel(args)
    assert K.mc_predict.launches == before + 1
    _same(got, P.mode_decide_mc_ref(*args), name)
    mv_r, mv_c, _, mv = got[:4]
    assert torch.equal(mv, torch.stack([mv_r, mv_c], -1).to(torch.int16))


@pytest.mark.parametrize("form", ["tables", "proxies"])
def test_zone_on_standin_ragged_batch(on_standin, form):
    """A 3 x 5 zone (15 blocks, the last CTA's fourth warp idle) with
    GOLDEN, and ALTREF with the tables."""
    b = 15
    cs = MD.zone_case(71, 3, 5, "n32")
    rates = (P.upload_rate_tabs(MD.rate_tabs(71), "cpu") if form == "tables"
             else None)
    d_args, kw = MD.port_args(cs, 3, 5, "n32", rates, True,
                              form == "tables")
    _, w, h = ZONES["ragged"]
    g = P.make_geom(w, h)
    rng = np.random.default_rng(72)
    planes = [_bordered(g, rng), _bordered(g, rng),
              _bordered(g, rng) if form == "tables" else None]
    args = (*d_args, kw["rates"], kw["left_edge"], kw["gold_sse"],
            kw["alt"], planes,
            _t(np.repeat(np.arange(3) * 32, 5).astype(np.int32)),
            _t(np.tile(np.arange(5) * 32, 3).astype(np.int32)), 32,
            g.mi_rows, g.mi_cols, FILTERS, (32, 0, 3, 5))
    got = zone_kernel(args)
    assert got[0].shape == (b,)
    _same(got, P.mode_decide_mc_ref(*args), form)


def _raw_zone_outputs(standin, monkeypatch, args, b_buf):
    """The zone launcher called with the wrapper's words but outputs of
    ``b_buf`` blocks filled with 0x5A: (mv (2, b_buf) int32, ref_sel
    (b_buf,) int8, mv16 (b_buf, 2) int16, pred_y, pred_u, pred_v)."""
    n = args[21]
    nc = n // 2
    outs = [torch.full((2, b_buf), 0x5A5A5A5A, dtype=torch.int32),
            torch.full((b_buf,), 0x5A, dtype=torch.int8),
            torch.full((b_buf, 2), 0x5A5A, dtype=torch.int16),
            torch.full((b_buf, n, n), 0x5A, dtype=torch.uint8),
            torch.full((b_buf, nc, nc), 0x5A, dtype=torch.uint8),
            torch.full((b_buf, nc, nc), 0x5A, dtype=torch.uint8)]
    sent = []

    def launch(name, dev, address, *floats, words=None):
        words = list((ctypes.c_int64 * 66).from_address(address))
        # the predictions' words, then mv, ref_sel and mv16's
        for at, t in zip((12, 13, 14, 35, 36, 37),
                         (*outs[3:], *outs[:3])):
            words[at] = t.data_ptr()
        sent.append(standin[name]((ctypes.c_int64 * 66)(*words), *floats,
                                  None))

    monkeypatch.setattr(K, "_device_kind", lambda name, *t: "cuda")
    monkeypatch.setattr(K, "_launch", launch)
    zone_kernel(args)
    assert sent == [0]
    return outs


def test_zone_on_standin_writes_only_its_blocks(standin, monkeypatch):
    """The launcher with outputs longer than its batch: the batch's blocks
    get the decision and the predictions, in the int32 (2, B) and the
    int16 (B, 2) layouts, and nothing past them is written."""
    args, _ = zone_args("n32-tables-golden-altref", seed=80)
    b = args[4].shape[0]
    want = P.mode_decide_mc_ref(*args)
    # the int32 rows are (2, b) at the buffer's start: lay them out so
    outs = _raw_zone_outputs(standin, monkeypatch, args, b + 5)
    flat = outs[0].reshape(-1)
    assert torch.equal(flat[:b], want[0]) and torch.equal(flat[b:2 * b],
                                                           want[1])
    assert (flat[2 * b:] == 0x5A5A5A5A).all()
    assert torch.equal(outs[1][:b], want[2]) and (outs[1][b:] == 0x5A).all()
    assert torch.equal(outs[2][:b], want[3])
    assert (outs[2][b:] == 0x5A5A).all()
    for got, w in zip(outs[3:], want[4:]):
        assert torch.equal(got[:b], w) and (got[b:] == 0x5A).all()


@pytest.mark.parametrize("form", ["proxies-lam0", "tables", "aq"])
def test_zone_on_standin_all_ties_take_last_zero(on_standin, form):
    """Every candidate and every reference of equal cost: LAST's ZERO
    wins, in both versions, and every block reads LAST at MV 0."""
    rows, cols = 4, 6
    b = rows * cols
    r_map, _, _ = MD.MAPS["n32"]
    d = 2 * r_map + 1
    x = 4 * 1_000_003
    cs = {"ssem": np.full((b, d, d), x // 4 - 300_000, np.int32),
          "src2m": np.full(b, 300_000, np.int32),
          "sse_zero": np.full(b, x, np.int32),
          "sse_new": np.full(b, x, np.int32),
          "new_r": np.arange(b, dtype=np.int32) * 8 - 80,
          "new_c": np.arange(b, dtype=np.int32) % 5 - 2,
          "prev": np.stack([np.arange(b), -np.arange(b)], 1).astype(np.int32),
          "gold": np.full((2, b), x, np.int32),
          "alt": [np.full(b, x, np.int32), np.full(b, x, np.int32),
                  np.arange(b, dtype=np.int32) - 7,
                  np.arange(b, dtype=np.int32)], "edge": None}
    if form == "proxies-lam0":
        d_args, kw = MD.port_args(cs, rows, cols, "n32", None, True, False,
                                  lam=0)
    else:
        tabs = MD._tie_tabs(1234.5)
        rates = P.upload_rate_tabs(tabs, "cpu")
        if form == "aq":
            rates = dict(rates, lam_bits=_t(MD.aq_lam(tabs, b, 9)))
        d_args, kw = MD.port_args(cs, rows, cols, "n32", rates, True, True)
    _, w, h = ZONES["n32"]
    g = P.make_geom(w, h)
    rng = np.random.default_rng(90)
    planes = [_bordered(g, rng), _bordered(g, rng),
              None if kw["alt"] is None else _bordered(g, rng)]
    args = (*d_args, kw["rates"], kw["left_edge"], kw["gold_sse"],
            kw["alt"], planes,
            _t(np.repeat(np.arange(rows) * 32, cols).astype(np.int32)),
            _t(np.tile(np.arange(cols) * 32, rows).astype(np.int32)), 32,
            g.mi_rows, g.mi_cols, FILTERS, (32, 0, rows, cols))
    got = zone_kernel(args)
    _same(got, P.mode_decide_mc_ref(*args), form)
    assert not any(t.any() for t in got[:4])


def test_zone_on_standin_past_the_proxy_table_traps(on_standin):
    """Without rate tables an mvd past NEW's table has no rate: the plain
    composition's indexing raises, the decided launch traps and fails."""
    args, _ = zone_args("n32-proxies", seed=100)
    new_r, new_c, cols = args[4], args[5], args[8]
    dr = int(new_r[1] - new_r[0])
    new_r[1:cols] += P.MVD_MAX + 1 - abs(int(new_c[1] - new_c[0])) - dr
    with pytest.raises(IndexError):
        P.mode_decide_mc_ref(*args)
    with pytest.raises(RuntimeError, match="launch failed"):
        zone_kernel(args)
    new_r[1:cols] -= 1
    _same(zone_kernel(args), P.mode_decide_mc_ref(*args))


@pytest.mark.parametrize("with_rates,kind", [(True, "random"),
                                             (True, "parent_new"),
                                             (False, "random")],
                         ids=["tables", "tables-parent-new", "proxies"])
def test_children_on_standin_matches_plain(on_standin, with_rates, kind):
    """The children's decision (PARENT MVs anywhere in the parents'
    reach; NEW at PARENT's MV, mvd 0), then their MC in their parents'
    windows by index: one launch, counted as mc_predict's."""
    args, _, _ = children_args(110 + with_rates, with_rates, k=10,
                               kind=kind)
    before = K.mc_predict.launches
    got = children_kernel(args)
    assert K.mc_predict.launches == before + 1
    _same(got, P.descent_decide_mc_ref(*args), kind)
    assert torch.equal(got[2], torch.stack(got[:2], -1).to(torch.int16))


def test_children_on_standin_read_the_rate_scalars_from_the_device(
        on_standin):
    """With the rate tables the decided launch reads the mode costs and
    lam_bits from the tables' device row, not from the host numbers: a
    row uploaded from other host numbers decides as those numbers do."""
    args, _, _ = children_args(120, True, k=10)
    rates = args[12]
    # a lam_bits that lets the rates rule, ZERO's mode the cheapest
    other = dict(rates, lam_bits=float(np.float32(rates["lam_bits"] * 1000)),
                 mode_cost=[5000, 5000, 0, 5000])
    row = torch.from_numpy(K.rate_scalars(other))
    got = children_kernel((*args[:12], dict(rates, scalars=row), *args[13:]))
    want = P.descent_decide_mc_ref(*args[:12], other, *args[13:])
    _same(got, want)
    assert not all(torch.equal(a, b) for a, b in zip(
        got[:2], P.descent_decide_mc_ref(*args)[:2]))


@pytest.mark.parametrize("with_rates", [True, False],
                         ids=["tables", "proxies"])
def test_children_on_standin_all_ties_take_zero(on_standin, with_rates):
    """ZERO, NEW and PARENT of equal cost (NEW at PARENT's MV, the rates
    equal): ZERO wins in both versions."""
    args, _, _ = children_args(130, with_rates, k=10, kind="parent_new")
    args = list(args)
    n = args[1].shape[0]
    top = 3_000_000
    if with_rates:
        rates = dict(args[12], mode_cost=[300, 300, 300, 300])
        for key in ("joint_cost", "nmv_row", "nmv_col"):
            rates[key] = torch.zeros_like(rates[key])
        rates["scalars"] = torch.from_numpy(K.rate_scalars(rates))
        args[12] = rates
    else:
        args[10] = 0  # lam 0: the rates gone
    args[1] = torch.full((n,), top, dtype=torch.int32)
    args[2] = torch.full((n,), top, dtype=torch.int32)
    d = 2 * P.CHILD_R + 1
    args[5] = torch.full((n,), 1000, dtype=torch.int32)
    args[0] = torch.full((n, d, d), top - 1000, dtype=torch.int32)
    got = children_kernel(args)
    _same(got, P.descent_decide_mc_ref(*args))
    assert not got[0].any() and not got[1].any()


def test_children_on_standin_past_the_proxy_table_traps(on_standin):
    args, _, _ = children_args(140, False, k=4)
    args = list(args)
    args[8] = args[8].clone()
    args[8][3] = 32_000  # PARENT far away: NEW's mvd past the table
    with pytest.raises(IndexError):
        P.descent_decide_mc_ref(*args)
    with pytest.raises(RuntimeError, match="launch failed"):
        children_kernel(args)


def test_decided_launch_arguments_and_counter(monkeypatch):
    """The wrappers' launcher words (the planes plane by plane, MC's and
    the decision's pointers, the outputs', then MC's ints as mc_predict's
    and the decision's) and floats on tensors off the CPU, one launch
    each counted as mc_predict's; a launch that fails raises."""
    calls = []

    def launch(name, dev, address, *floats, words=None):
        size = {"mode_decide_mc": 66, "descent_decide_mc": 55}[name]
        calls.append((name, list((ctypes.c_int64 * size).from_address(
            address)), floats))

    monkeypatch.setattr(K, "_device_kind", lambda name, *t: "cuda")
    monkeypatch.setattr(K, "_launch", launch)
    args, _ = zone_args("n32-tables-golden-altref", seed=150)
    cargs, _, _ = children_args(151, True)
    before = K.mc_predict.launches
    sc = P.step_scalars(40, 48, 300, 0, 0, 0)
    zone_kernel(args, sc)
    children_kernel(cargs, sc)
    assert [c[0] for c in calls] == list(DECIDED)
    assert K.mc_predict.launches == before + 2
    grid = _kernel_grid(args[18], args[25])
    mc_ints = [24, 32, 4, 6, *(v for spec in grid[2:] for v in spec),
               P.WIN_R, P.CHROMA_WIN_R,
               *(t.shape[1] for t in args[18][0]), args[22], args[23]]
    _, zone_w, zone_f = calls[0]
    planes = args[18]
    assert zone_w[:9] == [planes[r][p].data_ptr() for p in range(3)
                          for r in range(3)]
    assert zone_w[9:11] == [args[19].data_ptr(), args[20].data_ptr()]
    rates = args[14]
    left = 0 if args[15] is None else args[15].data_ptr()
    assert zone_w[15:34] == [
        *(t.data_ptr() for t in args[:7]), left, args[16].data_ptr(),
        *(t.data_ptr() for t in args[17]), rates["scalars"].data_ptr(),
        rates["joint_cost"].data_ptr(), rates["nmv_row"].data_ptr(),
        rates["nmv_col"].data_ptr(), 0, args[13].data_ptr()]
    # the step's row after the decision's inputs; no lam among the ints
    assert zone_w[34] == sc.data_ptr()
    assert zone_w[38:] == mc_ints + [args[9], args[10], args[11], 1,
                                     P.MVD_MAX + 1]
    assert zone_f == tuple(float(P.CAND_RATE_PROXY[i]) for i in (0, 3, 4))
    cgrid = _kernel_grid(cargs[13], cargs[20])
    _, child_w, child_f = calls[1]
    nch = cargs[1].shape[0]
    assert child_w[:8] == [t.data_ptr() for t in (
        *cargs[13][0], cargs[21], cargs[14], cargs[15], cargs[22],
        cargs[23])]
    crates = cargs[12]
    assert child_w[12:27] == [t.data_ptr() for t in (
        *cargs[:10], cargs[11], crates["scalars"], crates["joint_cost"],
        crates["nmv_row"], crates["nmv_col"])]
    assert child_w[27] == sc.data_ptr()
    assert child_w[30:] == [nch, 16, *cgrid[:2],
                            *(v for spec in cgrid[2:] for v in spec),
                            P.WIN_R, P.CHROMA_WIN_R,
                            *(t.shape[1] for t in cargs[13][0]),
                            cargs[17], cargs[18], 1, P.MVD_MAX + 1]
    assert child_f == CHILD_PROXY

    def refused(name, dev, *a, words=None):
        raise RuntimeError(f"{name}: CUDA launch failed with error 9")

    monkeypatch.setattr(K, "_launch", refused)
    with pytest.raises(RuntimeError, match="launch failed"):
        zone_kernel(args)
    with pytest.raises(RuntimeError, match="launch failed"):
        children_kernel(cargs)


def test_wrapper_refusals(on_standin):
    """Every refusal of the wrappers each decided launch merges: dtypes,
    a strided input, GOLDEN's and the rate tables' shapes, ALTREF without
    the tables, a zone of other blocks, the children's per-block lam_bits,
    planes of another dtype or shape, a grid past the planes, a block
    size the kernel is not built for."""
    args, _ = zone_args("n32-tables-golden-altref", seed=160)
    a = list(args)
    with pytest.raises(TypeError, match="int32"):
        zone_kernel((a[0].long(), *a[1:]))
    with pytest.raises(ValueError, match="contiguous"):
        zone_kernel((*a[:6], a[6].t().contiguous().t(), *a[7:]))
    with pytest.raises(TypeError, match="gold_sse"):
        zone_kernel((*a[:16], a[16][:1].contiguous(), *a[17:]))
    with pytest.raises(ValueError, match="rate tables"):
        zone_kernel((*a[:14], None, *a[15:]))
    short = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError, match="scalars"):
        zone_kernel((*a[:14], dict(a[14], scalars=short), *a[15:]))
    with pytest.raises(ValueError, match="blocks in a"):
        zone_kernel((*a[:7], 5, *a[8:]))
    planes = a[18]
    with pytest.raises(TypeError, match="uint8"):
        zone_kernel((*a[:18], [tuple(p.to(torch.int16) for p in planes[0]),
                               *planes[1:]], *a[19:]))
    with pytest.raises(ValueError, match="every reference"):
        zone_kernel((*a[:18], [planes[0], tuple(
            p[1:].contiguous() for p in planes[1]), planes[2]], *a[19:]))
    with pytest.raises(ValueError, match="leave"):
        K.mode_decide_mc(*_row(a[:18], 12), P.CAND_RATE_PROXY, *a[18:24],
                         (4, 6, (32, 120, 200, 52), *_kernel_grid(
                             planes, a[25])[3:]))
    with pytest.raises(ValueError, match="n=8"):
        K.mode_decide_mc(*_row(a[:18], 12), P.CAND_RATE_PROXY, *a[18:21], 8,
                         *a[22:24], _kernel_grid(planes, a[25]))
    cargs, _, _ = children_args(161, True)
    c = list(cargs)
    with pytest.raises(TypeError, match="lam_bits"):
        children_kernel((*c[:12], dict(c[12], lam_bits=torch.ones(
            c[1].shape[0])), *c[13:]))
    with pytest.raises(TypeError, match="nmv_row"):
        children_kernel((*c[:12], dict(c[12], nmv_row=c[12]["nmv_row"][
            :-1]), *c[13:]))
    with pytest.raises(TypeError, match="int32"):
        children_kernel((*c[:21], c[21].long(), *c[22:]))
    with pytest.raises(ValueError, match="LAST's"):
        children_kernel((*c[:13], [*c[13], c[13][0]], *c[14:]))


def test_wrappers_take_cuda_tensors_only():
    args, _ = zone_args("n32-tables", seed=170)
    with pytest.raises(ValueError, match="CUDA tensors"):
        zone_kernel(args)
    cargs, _, _ = children_args(171, False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        children_kernel(cargs)


# ---------------------------------------------------------------------------
# 3. one copy of the decision
# ---------------------------------------------------------------------------


def test_the_decision_is_one_copy_in_decide_cuh():
    """``mode_decide.cu``, ``descent.cu`` and ``mc_predict.cu`` include
    ``decide.cuh`` and take their decisions from it; no other source
    defines the decision's cost helpers or rounds its float32 costs (the
    split's own 32-against-16 costs aside)."""
    def read(name):
        with open(os.path.join(CSRC, name)) as fh:
            return fh.read()

    header = read("decide.cuh")
    for fn in ("zone", "child", "table_cost", "proxy_cost", "mvd_bits",
               "map_score", "child_rates"):
        assert re.search(rf"\b{fn}\(", header), fn
    uses = {"mode_decide.cu": ("decide::zone(",),
            "descent.cu": ("decide::child(",),
            "mc_predict.cu": ("decide::zone(", "decide::child(",
                              "decide::child_rates(")}
    for name, calls in uses.items():
        src = read(name)
        assert '#include "decide.cuh"' in src, name
        for call in calls:
            assert call in src, (name, call)
    for path in os.listdir(CSRC):
        if path == "decide.cuh":
            continue
        src = read(path)
        for fn in ("table_cost", "proxy_cost", "mvd_bits", "map_score"):
            assert not re.search(rf"\b{fn}\(", src), (path, fn)
        # the decision's cost by the tables divides by 256
        assert "256.0f" not in src, path
