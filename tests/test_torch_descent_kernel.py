"""The device code of ``tpu_vp9_torch/csrc/descent.cu`` run on the CPU:
g++ builds its four kernels behind the stand-ins of
``tests/cuda_standin/cuda_runtime.h`` (a host thread per CUDA thread, the
warp shuffles through an exchange area, the float32 intrinsics as single
IEEE operations, built with -ffp-contract=off, ``__trap`` a failed
launch), and the wrappers ``ops/cuda_kernels.py:descent_gather``,
``descent_decide``, ``descent_pack`` and ``descent_split`` launch them
there: their device check answers "cuda" and their launch calls the
stand-in build with the launchers' own arguments (the source's
``descent_*_launch``, whose launch helpers the stand-in's replace). Every
call is held against its plain version in ``pipeline/tpu_encdec.py``
(``descent_*_ref``), bit for bit.

The cases: the geometries 128x96 and 128x88 (the overhang row), parents
out of raster order and at every frame edge, full-pel winners that clamp
the union at 0 and at SW - 64, PARENT MVs beyond +-8 of the map centre,
both cost forms, all-tie costs, a lam that flips the split, overhang
parents whose children would win; then the whole P-frame step with the
four dispatches taking the stand-in; and the wrappers' refusals (a
strided plane, wrong dtypes, an mvd past MVD_MAX, a parent index past the
zone, CPU tensors).

What this cannot show: that nvcc accepts the source, timing, and the
card's own float32 rounding (the intrinsics promise it). ``chip_smoke.py``
checks the kernels on the card.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.pipeline import realtime as port_realtime
from tpu_vp9_torch.pipeline import tpu_encdec as P
from tpu_vp9_torch.utils.yuv import panning_frames

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "tpu_vp9_torch", "csrc")
STANDIN = os.path.join(REPO, "tests", "cuda_standin")
NAMES = ("descent_gather", "descent_decide", "descent_pack", "descent_split")
GEOMS = {"128x96": (128, 96), "128x88": (128, 88)}
SW = 32 + 2 * P.WIN_R + 8  # the parents' windows
EDGE = 8 * P.WIN_R + 6  # the largest parent MV, q3
PROXY = (P.CAND_RATE_PROXY[0], P.CAND_RATE_PROXY[4])


def _sc(lam):
    """The step's row of scalars with ``lam``, as the wrappers take it
    (the plain versions take ``lam`` itself)."""
    return P.step_scalars(40, 48, lam, 0, 0, 0)

# the stand-in's launch helpers: every CTA of the grid (the gather's a CTA
# per parent, the split's a warp per selected parent), one after another,
# but the pack's, kPackAtOnce CTAs at once (each with its own shared
# words); a trapped kernel fails its launch
_STANDIN_LAUNCH = """
constexpr int kPackAtOnce = 64;

cudaError_t launch_gather(const GatherArgs& a, cudaStream_t) {
  standin_launch(a.k, kGatherThreads, [&] { descent_gather_kernel(a); });
  return standin_take_trap();
}

cudaError_t launch_decide(const DecideArgs& a, cudaStream_t) {
  standin_launch((a.nch + kDecideThreads - 1) / kDecideThreads,
                 kDecideThreads, [&] { descent_decide_kernel(a); });
  return standin_take_trap();
}

cudaError_t launch_pack(const PackArgs& a, cudaStream_t) {
  for (int c0 = 0; c0 < a.k; c0 += kPackAtOnce) {
    standin_launch_all(a.k - c0 < kPackAtOnce ? a.k - c0 : kPackAtOnce,
                       kPackThreads, [&] {
                         blockIdx.x += c0;
                         descent_pack_kernel(a);
                       });
  }
  return standin_take_trap();
}

cudaError_t launch_split(const SplitArgs& a, cudaStream_t) {
  standin_launch((a.k + kSplitWarps - 1) / kSplitWarps, kSplitThreads,
                 [&] { descent_split_kernel(a); });
  return standin_take_trap();
}

"""


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """The four kernels and the launchers' argument packing built with g++
    behind the stand-ins: the source up to its launch helpers (the
    kernels' shared words the stand-in's buffer), the stand-in's helpers,
    then the source's launchers. Returns {wrapper name: ctypes function}
    with ``_LAUNCHERS``' argument types."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the stand-in of the CUDA source")
    with open(os.path.join(CSRC, "descent.cu")) as fh:
        src = fh.read()
    cut = src.index("cudaError_t launch_gather(")
    shared = "extern __shared__ __align__(16) int smem[];"
    assert src.count(shared) == 2
    body = src[:cut].replace(
        shared, "int* smem = reinterpret_cast<int*>(standin_smem);")
    tail = src[src.index("}  // namespace"):]
    out = tmp_path_factory.mktemp("standin")
    cpp, lib = out / "descent_standin.cpp", out / "libdescent.so"
    cpp.write_text(body + _STANDIN_LAUNCH + tail)
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fwrapv", "-ffp-contract=off", "-shared",
         "-fPIC", "-I", STANDIN, "-I", CSRC, "-o", str(lib), str(cpp),
         "-lpthread"], check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    fns = {}
    for name in NAMES:
        _, sym, n_ptr, n_float, n_int = K._LAUNCHERS[name]
        fn = getattr(dll, sym)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_float] * n_float
                       + [ctypes.c_int] * n_int + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@pytest.fixture
def on_standin(standin, monkeypatch):
    """The descent's wrappers on CPU tensors launching the stand-in build
    (the other wrappers keep their CPU path); a launch that fails raises as
    ``_launch`` does."""
    real_kind = K._device_kind

    def kind(name, *tensors):
        return "cuda" if name in NAMES else real_kind(name, *tensors)

    def launch(name, dev, *args):
        err = standin[name](*args, None)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {err}")

    monkeypatch.setattr(K, "_device_kind", kind)
    monkeypatch.setattr(K, "_launch", launch)
    return K


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want, msg=""):
    """Equal values, dtypes and shapes, tensor by tensor (dicts by key)."""
    if isinstance(want, dict):
        assert set(got) == set(want), msg
        for key in want:
            _same(got[key], want[key], f"{msg} {key}")
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), msg
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{msg} [{i}]")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (msg, got.dtype, want.dtype, got.shape, want.shape)
    assert torch.equal(got, want), msg


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------


def _edge_sel(g, rng):
    """Every parent of the frame's edges, then two inner ones, shuffled."""
    idx = np.arange(g.n_blocks32).reshape(g.rows32, g.cols32)
    edges = np.unique(np.concatenate([idx[0], idx[-1], idx[:, 0],
                                      idx[:, -1]]))
    sel = np.concatenate([edges, np.setdiff1d(idx, edges)[:2]])
    rng.shuffle(sel)
    return sel.astype(np.int32)


def gather_args(w, h, seed, winners="random"):
    """descent_gather's arguments (CPU tensors) and the geometry: random
    windows and planes (LAST's bordered luma with them), winners at
    -WIN_R and WIN_R and inside; ``winners="every shift"`` puts the union's
    start at every column of an 8-byte word (0-7), at SW - 64 and inside,
    in rows and columns."""
    rng = np.random.default_rng(seed)
    g = P.make_geom(w, h)
    b32 = g.n_blocks32
    dy = rng.integers(-P.WIN_R, P.WIN_R + 1, b32).astype(np.int32)
    dx = rng.integers(-P.WIN_R, P.WIN_R + 1, b32).astype(np.int32)
    dy[::3], dx[1::3] = -P.WIN_R, P.WIN_R
    dx[::4], dy[2::4] = -P.WIN_R, P.WIN_R
    if winners == "every shift":
        starts = np.resize([0, 1, 2, 3, 4, 5, 6, 7, SW - 64, 41, 19, 30],
                           b32)
        dx = (starts - 36).astype(np.int32)
        dy = (np.roll(starts, 5) - 36).astype(np.int32)
    border = 2 * P.BORDER
    return g, [
        _t(_edge_sel(g, rng)), _t(rng.integers(0, 256, (b32, SW, SW),
                                               np.uint8)),
        _t(dy), _t(dx),
        _t(rng.integers(-EDGE, EDGE + 1, (b32, 2)).astype(np.int32)),
        _t(rng.integers(0, 256, (g.pad_h, g.pad_w), np.uint8)),
        _t(rng.integers(0, 256, (g.pad_h // 2, g.pad_w // 2), np.uint8)),
        _t(rng.integers(0, 256, (g.pad_h // 2, g.pad_w // 2), np.uint8)),
        _t(rng.integers(0, 256, (g.pad_h + border, g.pad_w + border),
                        np.uint8))]


def decide_args(n, seed, kind="random"):
    """descent_decide's tensors: (ssem, sse_zero, sse_new, sub_r, sub_c,
    src2, base_y, base_x, par_r, par_c); PARENT MVs anywhere in the
    parents' reach, or (``parent_new``) NEW's own."""
    rng = np.random.default_rng(seed)
    d = 2 * P.CHILD_R + 1
    src2 = rng.integers(0, 4_000_000, n).astype(np.int32)
    ssem = (rng.integers(0, 4_000_000, (n, d, d))
            - src2[:, None, None]).astype(np.int32)
    zero = rng.integers(0, 4_000_000, n).astype(np.int32)
    new = rng.integers(0, 4_000_000, n).astype(np.int32)
    new[::5] = zero[::5]
    sub = rng.integers(-70, 71, (2, n)).astype(np.int32)
    base = rng.integers(-32, 25, (2, n)).astype(np.int32)
    par = rng.integers(-EDGE, EDGE + 1, (2, n)).astype(np.int32)
    if kind == "parent_new":
        par = base * 8 + sub
    return [_t(v) for v in (ssem, zero, new, sub[0], sub[1], src2, base[0],
                            base[1], par[0], par[1])]


def rate_tabs(seed):
    rng = np.random.default_rng(seed)
    fc = T.default_frame_context()
    fc.inter_mode_probs = rng.integers(
        1, 256, fc.inter_mode_probs.shape).astype(fc.inter_mode_probs.dtype)
    fc.nmv.joints = rng.integers(1, 256, np.shape(fc.nmv.joints)).astype(
        np.asarray(fc.nmv.joints).dtype)
    return P.make_rate_tabs(fc, 120)


def pack_args(k, seed, case="random"):
    """descent_pack's tensors for K parents: levels mostly zero (every
    third child's all zero), eobs half zero, random recon and luma source;
    ``case`` "extremes": the first parents' children every level zero,
    then every level nonzero, and recon against source all 255 against 0
    and 0 against 255 (the SSE at its most, 256 * 255^2 a child) and
    equal."""
    rng = np.random.default_rng(seed)
    n = 4 * k

    def levels(m):
        lv = rng.integers(-40, 41, (n, m, m))
        lv[rng.random((n, m, m)) < 0.8] = 0
        lv[::3] = 0
        if case == "extremes":
            lv[:4] = 0
            lv[4:8] = rng.choice([-1, 1, 7, -300], (4, m, m))
        return lv.astype(np.int16)

    eobs = []
    for _ in range(3):
        e = rng.integers(0, 3, n).astype(np.int32)
        e[::2] = 0
        eobs.append(_t(e))
    rec = rng.integers(0, 256, (n, 16, 16), np.uint8)
    src = rng.integers(0, 256, (n, 16, 16), np.uint8)
    if case == "extremes":
        rec[:4], src[:4] = 255, 0
        rec[4:8], src[4:8] = 0, 255
        src[8:12] = rec[8:12]
    return [*eobs, _t(levels(16)), _t(levels(8)), _t(levels(8)), _t(rec),
            _t(rng.integers(0, 256, (n, 8, 8), np.uint8)),
            _t(rng.integers(0, 256, (n, 8, 8), np.uint8)), _t(src)]


def split_args(w, h, seed, overhang_wins=False):
    """descent_split's tensors and the geometry: the children beat their
    parent on distortion by a little and pay in rate; ``overhang_wins``
    selects every parent of the overhang row with children far better."""
    rng = np.random.default_rng(seed)
    g = P.make_geom(w, h)
    b32 = g.n_blocks32
    sel = rng.permutation(b32)[:max(1, (2 * b32) // 3)]
    if overhang_wins:
        last = np.arange(b32 - g.cols32, b32)
        sel = np.concatenate([last, np.setdiff1d(sel, last)[:4]])
        rng.shuffle(sel)
    k = sel.size
    dist_b = rng.integers(10_000, 200_000, b32).astype(np.int32)
    rate_b = rng.integers(0, 40, b32).astype(np.int64)
    dist4 = (dist_b[sel] - rng.integers(-5_000, 20_000, k)).astype(np.int64)
    rate4 = (rate_b[sel] + rng.integers(0, 30, k)).astype(np.int64)
    if overhang_wins:
        over = sel >= b32 - g.cols32
        dist4[over], rate4[over] = dist_b[sel[over]] // 10, 0
    r32, c32 = g.rows32, g.cols32
    return g, [_t(sel.astype(np.int32)), _t(dist_b), _t(rate_b), _t(dist4),
               _t(rate4),
               _t(rng.integers(0, 256, (r32 * 32, c32 * 32), np.uint8)),
               _t(rng.integers(0, 256, (r32 * 16, c32 * 16), np.uint8)),
               _t(rng.integers(0, 256, (r32 * 16, c32 * 16), np.uint8)),
               _t(rng.integers(0, 256, (k, 32, 32), np.uint8)),
               _t(rng.integers(0, 256, (k, 16, 16), np.uint8)),
               _t(rng.integers(0, 256, (k, 16, 16), np.uint8))]


# ---------------------------------------------------------------------------
# each kernel against its plain version
# ---------------------------------------------------------------------------


def test_kernel_constants_are_the_steps():
    assert K.DESCENT_R == P.CHILD_R
    g, args = gather_args(128, 96, 0)
    keys = set(P.descent_gather_ref(*args, g))
    assert keys == {"cw", "csrc", "csrc_u", "csrc_v", *K.GATHER_INTS}


@pytest.mark.parametrize("winners", ["random", "every shift"])
@pytest.mark.parametrize("geom", GEOMS)
def test_gather_on_standin_matches_plain(on_standin, geom, winners):
    """A CTA per parent, the parents in a shuffled order and at every edge
    of the frame: the union clamped at 0 and at SW - 64, or its start at
    every byte of a word; the ZERO SSE read against LAST's bordered luma
    as block_energy_at's plain version reads it."""
    g, args = gather_args(*GEOMS[geom], seed=1, winners=winners)
    got = on_standin.descent_gather(*args, g, P.BORDER)
    _same(got, P.descent_gather_ref(*args, g), geom)
    base = got["base_x"]
    assert int(base.min()) == -32 and int(base.max()) == SW - 96
    if winners == "every shift":
        assert set(((base + 32) % 8).tolist()) == set(range(8))
    pos = (got["pos_y"] + P.BORDER, got["pos_x"] + P.BORDER)
    _same(got["sse_zero"], K.block_energy_at_ref(
        got["csrc"], args[8], pos[0][None], pos[1][None], 16)[0][0])


@pytest.mark.parametrize("kind", ["random", "parent_new"])
@pytest.mark.parametrize("with_rates", [True, False],
                         ids=["rates", "proxies"])
def test_decide_on_standin_matches_plain(on_standin, kind, with_rates):
    args = decide_args(300, seed=3, kind=kind)
    rates = P.upload_rate_tabs(rate_tabs(4), "cpu") if with_rates else None
    nb = P.new_bits_table("cpu")
    for lam in (300, 40_000):
        got = on_standin.descent_decide(*args, _sc(lam), nb, rates, PROXY)
        want = P.descent_decide_ref(*args, lam, nb, rates)
        _same(got, want, f"lam {lam}")
    if kind == "random":  # PARENT won from beyond the map's reach
        par_won = (got[0] == args[8]) & (got[1] == args[9])
        far = ((((args[8] + 4) >> 3) - args[6]).abs() > P.CHILD_R)
        assert bool((par_won & far).any())


@pytest.mark.parametrize("with_rates", [True, False],
                         ids=["rates", "proxies"])
def test_decide_on_standin_ties_take_the_first(on_standin, with_rates):
    """All three costs equal: ZERO; ZERO one worse: NEW over PARENT."""
    n = 64
    args = decide_args(n, seed=7, kind="parent_new")
    ssem, zero, new, sub_r, sub_c, src2, base_y, base_x, par_r, par_c = args
    if with_rates:
        tabs = rate_tabs(8)
        tabs["lam_bits"] = np.float32(256.0)  # cost = sse + rate
        rates = P.upload_rate_tabs(tabs, "cpu")
        m = rates["mv_cost_max"]
        bits = int(rates["joint_cost"][0] + rates["nmv_row"][m]
                   + rates["nmv_col"][m])
        mc = rates["mode_cost"]
        rate = (mc[2], mc[3] + bits, mc[0])
    else:
        rates, rate = None, (2, 10, 4)  # lam 1: ZERO's, NEW's, PARENT's
    top = 3_000_000
    zero[:], new[:] = top - rate[0], top - rate[1]
    fy = (((par_r + 4) >> 3) - base_y).clamp(-8, 8) + 8
    fx = (((par_c + 4) >> 3) - base_x).clamp(-8, 8) + 8
    ssem[torch.arange(n), fy, fx] = top - rate[2] - src2
    nb = P.new_bits_table("cpu")
    got = on_standin.descent_decide(*args, _sc(1), nb, rates, PROXY)
    _same(got, P.descent_decide_ref(*args, 1, nb, rates))
    assert not got[0].any() and not got[1].any()
    zero += 1
    got = on_standin.descent_decide(*args, _sc(1), nb, rates, PROXY)
    _same(got, P.descent_decide_ref(*args, 1, nb, rates))
    assert torch.equal(got[0], base_y * 8 + sub_r)


@pytest.mark.parametrize("k,case", [(9, "random"), (9, "extremes"),
                                    (510, "random"), (2040, "random")],
                         ids=["k9", "extremes", "1080p-m8-k510",
                              "ra-k2040"])
def test_pack_on_standin_matches_plain(on_standin, k, case):
    """The pack with the children's recon SSE at a few parents, at the
    1080p M8 call's K = 510 and the RA shape's K = 2,040; the extremes:
    the SSE at 256 * 255^2 a child, both ways, and 0; every level zero and
    every level nonzero."""
    args = pack_args(k, seed=11, case=case)
    got = on_standin.descent_pack(*args)
    _same(got, P.descent_pack_ref(*args))
    assert got["skip"].any() and not got["skip"].all()
    if case == "extremes":
        assert got["dist4"][:2].tolist() == [4 * 256 * 255 ** 2] * 2
        assert int(got["dist4"][2]) == 0
        assert int(got["rate4"][0]) == 0
        assert int(got["rate4"][1]) == 4 * (256 + 2 * 64)


def _split_in_place(k_mod, args, lam, g):
    """descent_split on the stand-in on copies of the zone's planes: the
    result, the plain version's on the planes as they were, and the
    blocks of the 32 grid (Y, U, V) that must have stayed as they were
    (not selected, or selected and not split) held byte for byte."""
    planes = [t.clone() for t in args[5:8]]
    got = k_mod.descent_split(*args[:5], *planes, *args[8:], _sc(lam), g,
                              P.SPLIT_RATE_EXTRA)
    assert all(a is b for a, b in zip(got[1:], planes))  # in place
    want = P.descent_split_ref(*args, lam, g)
    kept = ~got[0].bool()
    for plane, before, n in zip(got[1:], args[5:8], (32, 16, 16)):
        mask = kept.repeat_interleave(n, 0).repeat_interleave(n, 1)
        assert torch.equal(plane[mask], before[mask])
    return got, want


@pytest.mark.parametrize("geom", GEOMS)
def test_split_on_standin_matches_plain(on_standin, geom):
    g, args = split_args(*GEOMS[geom], seed=13)
    counts = []
    for lam in (1, 500, 100_000):
        got, want = _split_in_place(on_standin, args, lam, g)
        _same(got, want, f"lam {lam}")
        counts.append(int(got[0].sum()))
    assert counts[0] > counts[1] > 0 == counts[2]


def test_split_on_standin_keeps_the_overhang_row(on_standin):
    g, args = split_args(*GEOMS["128x88"], seed=17, overhang_wins=True)
    got, want = _split_in_place(on_standin, args, 5, g)
    _same(got, want)
    assert not got[0][-1].any() and got[0][:-1].any()


@pytest.mark.parametrize("gap", [0, 1], ids=["all-ties", "one-better"])
def test_split_on_standin_ties_keep_the_32(on_standin, gap):
    """lam 0: the costs are the distortions alone. The children's equal to
    their parent's in every selected parent: none splits (a strict <);
    one less: every one splits but the overhang row's (128x88)."""
    g, args = split_args(*GEOMS["128x88"], seed=18, overhang_wins=True)
    args[3] = (args[1][args[0].long()] - gap).to(torch.int64)
    got, want = _split_in_place(on_standin, args, 0, g)
    _same(got, want)
    split = got[0].reshape(-1)[args[0].long()].bool()
    over = args[0] >= g.n_blocks32 - g.cols32
    assert torch.equal(split, ~over if gap else torch.zeros_like(over))


# ---------------------------------------------------------------------------
# the whole step on the stand-in
# ---------------------------------------------------------------------------


def _step_args(w, h, seed, golden):
    """A P-frame step's arguments (CPU tensors) on a panning clip, a
    quadrant of two parents moving its own way."""
    rng = np.random.default_rng(seed)
    g = P.make_geom(w, h)
    frames = list(panning_frames(w, h, 3, seed=seed))
    cur = [np.asarray(p).copy() for p in (frames[2].y, frames[2].u,
                                          frames[2].v)]
    before = [np.asarray(p) for p in (frames[1].y, frames[1].u, frames[1].v)]
    for y0, x0 in ((16, 32), (48, 80)):
        cur[0][y0:y0 + 16, x0:x0 + 16] = before[0][y0 + 5:y0 + 21,
                                                   x0 - 6:x0 + 10]
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))
    src = [_t(P.pad_plane(p, *s)) for p, s in zip(cur, shapes)]
    refs = list(port_realtime.upload_refs(before, g, "cpu"))
    if golden:
        old = [np.asarray(p) for p in (frames[0].y, frames[0].u,
                                       frames[0].v)]
        refs += list(port_realtime.upload_refs(old, g, "cpu"))
    qidx = 120
    ac_q = T.ac_quant(qidx)
    return g, [*src, *refs,
               _t(rng.integers(-64, 65, (g.n_blocks32, 2)).astype(np.int32)),
               torch.zeros((1, 2), dtype=torch.int32),
               P.step_scalars(T.dc_quant(qidx), ac_q,
                              max(1, (ac_q ** 2) >> 6), 20, 3, 40),
               P.upload_rate_tabs(rate_tabs(seed), "cpu")]


def _flat(outs):
    """The step's outputs as (name, tensor) pairs."""
    for key, v in sorted(outs.items()):
        if isinstance(v, dict):
            for k2, t in sorted(v.items()):
                yield f"{key} {k2}", t
        else:
            yield key, v


@pytest.mark.parametrize("geom,golden,frac", [("128x96", True, 4),
                                              ("128x88", False, 1)],
                         ids=["128x96-m8", "128x88-every-parent"])
def test_step_with_the_standin_kernels_matches_plain(on_standin, monkeypatch,
                                                     geom, golden, frac):
    """The P-frame step with the descent, once on the plain versions and
    once with the four dispatches reaching the stand-in kernels: every
    output and the new references equal, but the zone's recon planes,
    into which the split writes in place (they held the plain step's
    before it and hold the plain split's result after); each kernel
    launched once. At 128x88 every parent descends, the overhang row's
    included."""
    g, args = _step_args(*GEOMS[geom], seed=19, golden=golden)
    step = P.make_pframe_step(g, "cpu", split16=True, golden=golden,
                              with_rates=True, descend_frac=frac)
    want_outs, want_refs = step(*args)
    before = {name: getattr(K, name).launches for name in NAMES}
    # the wrappers take the constants that the dispatches hand them; the
    # split's zone planes are recorded as they were before its call
    extra = {"descent_gather": (P.BORDER,), "descent_decide": (PROXY,),
             "descent_split": (P.SPLIT_RATE_EXTRA,)}
    split_ref, split_in = P.descent_split_ref, []
    # the plain versions take lam where the wrappers take the step's row
    lam_at = {"descent_decide": 10, "descent_split": 11}

    def as_row(name, a):
        i = lam_at.get(name)
        return a if i is None else (*a[:i], _sc(a[i]), *a[i + 1:])

    for name in NAMES:
        monkeypatch.setattr(P, f"{name}_ref",
                            lambda *a, w=getattr(K, name), nm=name,
                            e=extra.get(name, ()): w(*as_row(nm, a), *e))

    def split(*a):
        split_in.append((*a[:5], *(t.clone() for t in a[5:8]), *a[8:]))
        return K.descent_split(*as_row("descent_split", a),
                               P.SPLIT_RATE_EXTRA)

    monkeypatch.setattr(P, "descent_split_ref", split)
    got_outs, got_refs = step(*args)
    assert {name: getattr(K, name).launches - before[name]
            for name in NAMES} == dict.fromkeys(NAMES, 1)
    got, want = dict(_flat(got_outs)), dict(_flat(want_outs))
    assert set(got) == set(want)
    # the zone's recon planes: the plain step's before the split; the
    # split wrote its blocks into them in place
    zone = ("m32 rec_y", "m32 rec_u", "m32 rec_v")
    split_in, = split_in
    _same(list(split_in[5:8]), [want[key] for key in zone], "zone recon")
    _same([got[key] for key in zone], list(split_ref(*split_in)[1:]),
          "zone recon, split in place")
    for key in set(want) - set(zone):
        _same(got[key], want[key], key)
    _same(got_refs, want_refs, "references")
    assert int(got_outs["split32"].sum()) > 0
    if geom == "128x88":
        assert g.n_blocks32 == got_outs["m16f"]["sel_idx"].shape[0]
        assert not got_outs["split32"][-1].any()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_wrappers_refuse_a_strided_plane_and_wrong_dtypes(on_standin):
    g, args = gather_args(128, 96, 21)
    wide = torch.zeros((g.pad_h, g.pad_w + 32), dtype=torch.uint8)
    strided = wide[:, :g.pad_w]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        on_standin.descent_gather(*args[:5], strided, *args[6:], g,
                                  P.BORDER)
    with pytest.raises(TypeError, match="int32"):
        on_standin.descent_gather(*args[:2], args[2].long(), *args[3:], g,
                                  P.BORDER)
    with pytest.raises(TypeError, match="uint8"):
        on_standin.descent_gather(*args[:5], args[5].to(torch.int16),
                                  *args[6:], g, P.BORDER)
    with pytest.raises(ValueError, match="grid"):
        on_standin.descent_gather(*args[:5], args[5][:64].contiguous(),
                                  *args[6:], g, P.BORDER)
    d = decide_args(16, seed=22)
    nb = P.new_bits_table("cpu")
    with pytest.raises(TypeError, match="int32"):
        on_standin.descent_decide(d[0], d[1].long(), *d[2:], _sc(9), nb, None,
                                  PROXY)
    with pytest.raises(TypeError, match="float32"):
        on_standin.descent_decide(*d, _sc(9), nb.double(), None, PROXY)
    rates = P.upload_rate_tabs(rate_tabs(1), "cpu")
    with pytest.raises(TypeError, match="nmv_row"):
        on_standin.descent_decide(*d, _sc(9), nb, dict(
            rates, nmv_row=rates["nmv_row"][:-1]), PROXY)
    with pytest.raises(TypeError, match="lam_bits"):
        on_standin.descent_decide(*d, _sc(9), nb, dict(
            rates, lam_bits=torch.ones(16)), PROXY)
    p = pack_args(2, seed=23)
    with pytest.raises(TypeError, match="int16"):
        on_standin.descent_pack(*p[:3], p[3].to(torch.int32), *p[4:])
    with pytest.raises(ValueError, match="four a parent"):
        on_standin.descent_pack(*(t[:7] for t in p))
    g, s = split_args(128, 96, seed=24)
    with pytest.raises(TypeError, match="int64"):
        on_standin.descent_split(*s[:2], s[2].to(torch.int32), *s[3:], _sc(9), g,
                                 P.SPLIT_RATE_EXTRA)
    with pytest.raises(ValueError, match="contiguous"):
        on_standin.descent_split(*s[:5], s[5].t().contiguous().t(), *s[6:],
                                 _sc(9), g, P.SPLIT_RATE_EXTRA)


def _shifted(t, by):
    """A contiguous copy of ``t`` that starts ``by`` bytes (a multiple of
    its element's size) past a 64-byte boundary of its storage."""
    flat = torch.zeros(t.numel() + 64, dtype=t.dtype)
    start = ((-flat.data_ptr()) % 64 + by) // t.element_size()
    out = flat[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 64 == by
    return out


def test_wrappers_refuse_unaligned_words(on_standin):
    """The word loads and stores need aligned rows: the gather refuses a
    plane, a window set or LAST's luma that starts off its word (or a
    window side that is not a multiple of 8), the split a plane or a
    merged block off its 16 bytes, the pack a level, luma recon or source
    tensor off its 16 bytes and a chroma recon off its 8; an aligned copy
    of each runs."""
    g, args = gather_args(128, 96, 32)
    for i, by in ((1, 4), (5, 8), (6, 4), (7, 2), (8, 8)):
        bad = list(args)
        bad[i] = _shifted(args[i], by)
        with pytest.raises(ValueError, match="byte boundary"):
            on_standin.descent_gather(*bad, g, P.BORDER)
    wide = args[1][:, :116, :116].contiguous()
    with pytest.raises(ValueError, match="multiple of 8"):
        on_standin.descent_gather(args[0], wide, *args[2:], g, P.BORDER)
    with pytest.raises(ValueError, match="multiple of 16"):
        on_standin.descent_gather(*args, g, P.BORDER + 8)
    ok = [_shifted(a, 16) if a.dtype == torch.uint8 else a for a in args]
    _same(on_standin.descent_gather(*ok, g, P.BORDER),
          P.descent_gather_ref(*args, g))
    g, s = split_args(128, 96, seed=33)
    for i in (5, 6, 7, 8, 9, 10):
        bad = list(s)
        bad[i] = _shifted(s[i], 8)
        with pytest.raises(ValueError, match="16-byte boundary"):
            on_standin.descent_split(*bad, _sc(9), g, P.SPLIT_RATE_EXTRA)
    # the pack: the levels, rec_y and csrc on 16 bytes, rec_u and rec_v on 8
    p = pack_args(3, seed=36)
    for i, by, to in ((3, 8, 16), (4, 2, 16), (5, 8, 16), (6, 8, 16),
                      (7, 4, 8), (8, 1, 8), (9, 8, 16)):
        bad = list(p)
        bad[i] = _shifted(p[i], by)
        with pytest.raises(ValueError, match=f"{to}-byte boundary"):
            on_standin.descent_pack(*bad)
    ok = [_shifted(a, 16) if a.dim() > 1 else a for a in p]
    _same(on_standin.descent_pack(*ok), P.descent_pack_ref(*p))


def test_no_parent_selected_on_standin(on_standin):
    """K = 0: the gather launches nothing and returns empty outputs; the
    split launches no kernel, zeroes split32 and leaves the planes."""
    g, args = gather_args(128, 96, 34)
    args[0] = args[0][:0]
    before = on_standin.descent_gather.launches
    got = on_standin.descent_gather(*args, g, P.BORDER)
    assert on_standin.descent_gather.launches == before
    assert all(t.shape[0] == 0 for t in got.values())
    assert set(got) == set(P.descent_gather_ref(*args, g))
    g, s = split_args(128, 96, seed=35)
    s[0], s[3], s[4] = s[0][:0], s[3][:0], s[4][:0]
    s[8], s[9], s[10] = s[8][:0], s[9][:0], s[10][:0]
    before = on_standin.descent_split.launches
    got, want = _split_in_place(on_standin, s, 9, g)
    assert on_standin.descent_split.launches == before
    _same(got, want)
    assert not got[0].any()


def test_mvd_past_the_table_fails_the_launch(on_standin):
    """Without rate tables an mvd past MVD_MAX has no NEW rate: the plain
    version's indexing raises, the kernel traps and its launch fails; at
    MVD_MAX both give the same answer."""
    d = decide_args(8, seed=25)
    nb = P.new_bits_table("cpu")
    base_y, sub_r, par_r, par_c = d[6], d[3], d[8], d[9]
    par_r[3] = base_y[3] * 8 + sub_r[3] - P.MVD_MAX - 1
    par_c[3] = d[7][3] * 8 + d[4][3]
    with pytest.raises(IndexError):
        P.descent_decide_ref(*d, 100, nb)
    with pytest.raises(RuntimeError, match="launch failed"):
        on_standin.descent_decide(*d, _sc(100), nb, None, PROXY)
    par_r[3] += 1
    _same(on_standin.descent_decide(*d, _sc(100), nb, None, PROXY),
          P.descent_decide_ref(*d, 100, nb))


def test_parent_index_past_the_zone_fails_the_launch(on_standin):
    """A parent index past B32: the plain versions' indexing raises, the
    gather and the split trap."""
    g, args = gather_args(128, 96, 26)
    args[0][2] = g.n_blocks32
    with pytest.raises(IndexError):
        P.descent_gather_ref(*args, g)
    with pytest.raises(RuntimeError, match="launch failed"):
        on_standin.descent_gather(*args, g, P.BORDER)
    g, s = split_args(128, 96, seed=27)
    s[0][1] = g.n_blocks32
    with pytest.raises(IndexError):
        P.descent_split_ref(*s, 9, g)
    with pytest.raises(RuntimeError, match="launch failed"):
        on_standin.descent_split(*s, _sc(9), g, P.SPLIT_RATE_EXTRA)


def test_wrappers_take_cuda_tensors_only():
    g, args = gather_args(128, 96, 28)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.descent_gather(*args, g, P.BORDER)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.descent_pack(*pack_args(2, seed=29))
    d = decide_args(8, seed=30)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.descent_decide(*d, _sc(9), P.new_bits_table("cpu"), None, PROXY)
    g, s = split_args(128, 96, seed=31)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.descent_split(*s, _sc(9), g, P.SPLIT_RATE_EXTRA)
