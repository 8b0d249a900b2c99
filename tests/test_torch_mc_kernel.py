"""The device code of ``tpu_vp9_torch/csrc/mc_predict.cu`` run on the CPU:
g++ builds the kernel behind the stand-ins of
``tests/cuda_standin/cuda_runtime.h`` (a host thread per CUDA thread, dp4a
and the byte intrinsics written out from their definitions), and the
wrapper ``ops/cuda_kernels.py:mc_predict`` launches it there: its device
check answers "cuda" and its launch calls the stand-in build with the
launcher's own arguments (the source's ``mc_predict_launch`` up to its
launch; every CTA of a plane at once, sixteen at a time, each CTA's four
warps on their own blocks). Every call is held against the plain version
``pipeline/tpu_encdec.py:mc_predict_planes_ref`` (the windows cut from the
planes, then ``mc_predict_ref``), bit for bit.

The cases: the 32 zone (LAST, GOLDEN and ALTREF per block, a reference
without planes), the strip zone (n = 16 at a strip geometry, its y_base),
the children (their parents' windows by a window index, origin offsets),
every q4 phase pair of the chroma planes (the luma even ones) with MVs of
either sign, MVs of +-(WIN_R + 0.75) pel at every edge of a geometry with
the overhang row, MVs past the windows' reach (the window clamp), a column
shard's planes, ragged batches, planes that start 1 and 3 bytes into their
storage with odd pitches, a window index past the grid (a trap), and the
wrapper's refusals.

What this cannot show: that nvcc accepts the source, timing, and bank
conflicts. ``chip_smoke.py`` checks the kernel on the card.
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
from tpu_vp9_torch.pipeline import tpu_encdec as P

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "tpu_vp9_torch", "csrc")
STANDIN = os.path.join(REPO, "tests", "cuda_standin")
FILTERS = torch.as_tensor(np.asarray(P.FILTERS, np.int32))
EDGE = P.WIN_R * 8 + 6  # +-(WIN_R + 0.75) pel in q3

# the stand-in's launch: each plane's CTAs, sixteen at once (a CTA's warps
# run side by side); a trapped kernel fails its launch
_STANDIN_LAUNCH = """
    const int ctas = (nblk + kWarps - 1) / kWarps;
    for (int p = 0; p < kPlanes; ++p) {
      for (int c0 = 0; c0 < ctas; c0 += 16) {
        const int m = ctas - c0 < 16 ? ctas - c0 : 16;
        switch (n) {
          case 32:
            standin_launch_all(m, kThreads, [&] {
              blockIdx.x += c0;
              blockIdx.y = p;
              mc_predict_kernel<32, kPlain>(a);
            });
            break;
          case 16:
            standin_launch_all(m, kThreads, [&] {
              blockIdx.x += c0;
              blockIdx.y = p;
              mc_predict_kernel<16, kPlain>(a);
            });
            break;
          default:
            return 1;
        }
      }
    }
    (void)s;
    return standin_take_trap();
}
"""
N_INTS = 23


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """The kernel's device code and the launcher's argument packing built
    with g++ behind the stand-ins: the source up to its host launch code,
    its dynamic shared memory the stand-ins' buffer, then the source's
    ``mc_predict_launch`` up to its switch, renamed, with the stand-in's
    launch."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the stand-in of the CUDA source")
    with open(os.path.join(CSRC, "mc_predict.cu")) as fh:
        src = fh.read()
    cut = src.index("template <int N, int D>\ncudaError_t launch(")
    shared = "extern __shared__ __align__(16) unsigned char smem[];"
    assert src.count(shared) == 1
    body = src[:cut].replace(shared, "unsigned char* smem = standin_smem;")
    head = src[src.index('extern "C" int mc_predict_launch('):]
    head = head[:head.index("  switch (n) {")].replace(
        "mc_predict_launch", "standin_mc_predict_launch")
    out = tmp_path_factory.mktemp("standin")
    cpp, lib = out / "mc_predict_standin.cpp", out / "libmc.so"
    cpp.write_text(body + "}  // namespace\n" + head + _STANDIN_LAUNCH)
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fwrapv", "-shared", "-fPIC", "-I",
         STANDIN, "-I", CSRC, "-o", str(lib), str(cpp), "-lpthread"],
        check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    fn = dll.standin_mc_predict_launch
    fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * N_INTS + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture
def on_standin(standin, monkeypatch):
    """``K.mc_predict`` on CPU tensors launching the stand-in build."""
    def launch(name, dev, *args):
        assert name == "mc_predict"
        err = standin(*args, None)
        if err != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {err}")

    monkeypatch.setattr(K, "_device_kind", lambda name, *t: "cuda")
    monkeypatch.setattr(K, "_launch", launch)
    return K.mc_predict


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(kind, seed):
    """Keyword arguments of the step's ``mc_predict`` /
    ``mc_predict_planes_ref`` (CPU tensors, the zone's grid as (step,
    y_base, rows, cols)) for one kind of call: random bordered planes of
    each reference, the zone's window grid, and its blocks."""
    rng = np.random.default_rng(seed)
    w, h = {"strip": (128, 112), "edges": (128, 88), "clamp": (512, 288),
            "phases": (512, 192), "shard": (256, 96)}.get(kind, (128, 96))
    g = P.make_geom(w, h)
    n = 16 if kind == "strip" else 32
    grid = (32, 0, g.rows32, g.cols32)
    extra = {}
    if kind == "strip":
        grid = (16, g.strip_y, 1, g.cols16)
        pos_y = np.full(g.cols16, g.strip_y)
        pos_x = np.arange(g.cols16) * 16
    elif kind == "phases":
        # 256 blocks inside a wider frame, where no MV of the case clamps,
        # each reading its own window of the grid
        pos_y = np.tile([64, 96], 128)
        pos_x = np.repeat(64 + np.arange(8) * 32, 32)
        extra["win_idx"] = _t((pos_y // 32 * g.cols32 + pos_x // 32)
                              .astype(np.int32))
    elif kind == "shard":
        # columns 4-7: the shard's planes hold its columns and a border
        # either side, its positions stay global
        grid = (32, 0, g.rows32, 4)
        pos_y = np.repeat(np.arange(g.rows32) * 32, 4)
        pos_x = np.tile((4 + np.arange(4)) * 32, g.rows32)
    else:
        pos_y = np.repeat(np.arange(g.rows32) * 32, g.cols32)
        pos_x = np.tile(np.arange(g.cols32) * 32, g.rows32)
    b = pos_y.size
    n_refs = 1 if kind in ("children", "edges") else 3
    pw = {"shard": 4 * 32}.get(kind, g.pad_w)
    planes = [tuple(_t(rng.integers(0, 256, (hh + 2 * P.BORDER,
                                             ww + 2 * P.BORDER), np.uint8))
                    for hh, ww in ((g.pad_h, pw), (g.pad_h // 2, pw // 2),
                                   (g.pad_h // 2, pw // 2)))
              for _ in range(n_refs)]
    if kind == "children":
        # K = 3 parents descend, 4 children each, in their windows
        sel = np.sort(rng.choice(b, 3, replace=False)).astype(np.int32)
        ii, jj = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
        pos_y = (pos_y[sel][:, None] + 16 * ii).reshape(-1)
        pos_x = (pos_x[sel][:, None] + 16 * jj).reshape(-1)
        b, n = pos_y.size, 16
        mv = rng.integers(-EDGE + 16 * 8, EDGE - 16 * 8 + 1, (2, b))
        extra = {"win_idx": _t(np.repeat(sel, 4)),
                 "org_off_y": _t(np.tile(16 * ii, 3).astype(np.int32)),
                 "org_off_x": _t(np.tile(16 * jj, 3).astype(np.int32))}
    elif kind == "phases":
        # chroma phase pairs (pr, pc) = (mv_r & 15, mv_c & 15), all 256
        pr, pc = np.repeat(np.arange(16), 16), np.tile(np.arange(16), 16)
        sign = rng.choice([-1, 1], (2, b))
        mv = np.stack([pr, pc]) + 16 * rng.integers(0, 13, (2, b)) * sign
    elif kind in ("edges", "shard"):
        # +-(WIN_R + 0.75) pel and 0 in each axis, every block of the
        # geometry (its edges and overhang row among them)
        combos = np.array([(r, c) for r in (-EDGE, 0, EDGE)
                           for c in (-EDGE, 0, EDGE)])
        mv = combos[np.arange(b) % 9].T
    elif kind == "clamp":
        # past the windows' reach: the read start clamps into them
        mv = rng.choice([-1, 1], (2, b)) * rng.integers(
            EDGE + 8, EDGE + 400, (2, b))
    else:
        mv = rng.integers(-EDGE, EDGE + 1, (2, b))
    if n_refs == 3:
        extra["ref_sel"] = _t(rng.integers(0, 3, b).astype(np.int8))
    return dict(planes=planes, pos_y=_t(pos_y.astype(np.int32)),
                pos_x=_t(pos_x.astype(np.int32)),
                mv_r=_t(mv[0].astype(np.int32)),
                mv_c=_t(mv[1].astype(np.int32)), n=n, mi_rows=g.mi_rows,
                mi_cols=g.mi_cols, grid=grid, **extra)


def _ref(case):
    return P.mc_predict_planes_ref(filters=FILTERS, **case)


def _kernel_grid(case):
    """The case's window grid as the wrapper takes it (the dispatch's
    ``mc_window_grid``)."""
    return P.mc_window_grid(tuple(tuple(t.shape) for t in case["planes"][0]),
                            case["grid"])


def _kernel(fn, case):
    return fn(**dict(case, grid=_kernel_grid(case)))


def _assert_equal(got, want):
    for gp, wp in zip(got, want):
        assert gp.dtype == torch.uint8 and gp.shape == wp.shape
        assert torch.equal(gp, wp)


KINDS = ("zone", "strip", "children", "phases", "edges", "clamp", "shard")


@pytest.mark.parametrize("kind", KINDS)
def test_standin_matches_plain_version(on_standin, kind):
    case = _case(kind, seed=KINDS.index(kind))
    before = K.mc_predict.launches
    _assert_equal(_kernel(on_standin, case), _ref(case))
    assert K.mc_predict.launches == before + 1


def test_standin_takes_every_phase_pair_and_both_phase0_paths(on_standin):
    """The phases case reaches all 256 chroma phase pairs and, in luma, the
    even ones: phase 0 in neither axis, in one and in both."""
    case = _case("phases", seed=11)
    got = _kernel(on_standin, case)
    _assert_equal(got, _ref(case))
    ph = {(int(r) & 15, int(c) & 15) for r, c in zip(case["mv_r"],
                                                     case["mv_c"])}
    assert len(ph) == 256
    luma = {((2 * r) & 15, (2 * c) & 15) for r, c in ph}
    assert {(0, 0), (0, 2), (2, 0), (2, 2)} <= luma


def test_clamp_case_reaches_past_the_windows():
    """The clamp case's reads start outside their windows before the
    clamp, on both sides, in luma and chroma; the edge case's stay inside
    at +-(WIN_R + 0.75) pel."""
    for kind, outside in (("clamp", True), ("edges", False)):
        case = _case(kind, seed=KINDS.index(kind))
        step = case["grid"][0]
        for ss, r in ((0, P.WIN_R), (1, P.CHROMA_WIN_R)):
            sw = (step >> ss) + 2 * r + 8
            m = case["n"] >> ss
            py, px = case["pos_y"] >> ss, case["pos_x"] >> ss
            row, col = P._clamp_mv_umv(
                case["mv_r"], case["mv_c"], (py << ss) // 8, (px << ss) // 8,
                m, m, ss, case["mi_rows"], case["mi_cols"])
            starts = torch.cat([((py << 4) + row >> 4) - py + r + 1,
                                ((px << 4) + col >> 4) - px + r + 1])
            lo, hi = bool((starts < 0).any()), bool((starts > sw - m - 7)
                                                    .any())
            assert (lo and hi) if outside else not (lo or hi), (kind, ss)
            if not outside and ss == 0:
                # luma reaches both ends (chroma's reach, 21 pel, is more
                # than half of 40.75)
                assert int(starts.min()) == 0 and int(starts.max()) == \
                    sw - m - 7


@pytest.mark.parametrize("present", [(True, False), (False, True)],
                         ids=["no_altref", "no_golden"])
def test_standin_reads_last_where_the_reference_has_no_windows(on_standin,
                                                               present):
    """A ref_sel naming a reference without planes reads LAST's, in both
    versions."""
    case = _case("zone", seed=21)
    last, gold, alt = case["planes"]
    case["planes"] = [last, gold if present[0] else None,
                      alt if present[1] else None]
    got = _kernel(on_standin, case)
    _assert_equal(got, _ref(case))
    only_last = dict(case, planes=[last], ref_sel=None)
    absent = 2 if present[0] else 1
    rows = case["ref_sel"] == absent
    assert bool(rows.any())
    for gp, wp in zip(got, _ref(only_last)):
        assert torch.equal(gp[rows], wp[rows])


@pytest.mark.parametrize("b", [1, 5, 7])
def test_standin_ragged_batch_writes_only_its_blocks(standin, b):
    """B blocks (no multiple of a CTA's four warps) write their B
    predictions and nothing past them."""
    case = _case("zone", seed=30 + b)
    for key in ("pos_y", "pos_x", "mv_r", "mv_c", "ref_sel"):
        case[key] = case[key][:b].contiguous()
    case["win_idx"] = torch.arange(b, dtype=torch.int32)
    outs = [torch.full((b + 2, m, m), 77, dtype=torch.uint8)
            for m in (32, 16, 16)]
    planes = case["planes"]
    rows, cols, *specs = _kernel_grid(case)
    args = (*(planes[r][p].data_ptr() for p in range(3) for r in range(3)),
            case["ref_sel"].data_ptr(), case["win_idx"].data_ptr(),
            *(case[k].data_ptr() for k in ("pos_y", "pos_x", "mv_r",
                                           "mv_c")),
            None, None, torch.from_numpy(K._mc_taps()).data_ptr(),
            *(o.data_ptr() for o in outs), b, 32, rows, cols,
            *(v for spec in specs for v in spec), P.WIN_R, P.CHROMA_WIN_R,
            *(planes[0][p].shape[1] for p in range(3)), case["mi_rows"],
            case["mi_cols"], None)
    assert standin(*args) == 0
    for o, w in zip(outs, _ref(case)):
        assert torch.equal(o[:b], w)
        assert bool((o[b:] == 77).all())


@pytest.mark.parametrize("kind", ["children", "shard"])
def test_standin_reads_unaligned_views(on_standin, kind):
    """Planes that start 1 and 3 bytes into their storage and have odd
    pitches (a column added on their right): the kernel reads each row
    from the aligned words that hold it."""
    case = _case(kind, seed=41)

    def shifted(t, k):
        wide = torch.cat([t, t[:, :1]], dim=1)  # an odd pitch
        buf = torch.zeros(wide.numel() + k, dtype=torch.uint8)
        buf[k:] = wide.reshape(-1)
        return buf[k:].view(wide.shape)

    case["planes"] = [tuple(shifted(pl, 1 + 2 * ((p + r) % 2))
                            for p, pl in enumerate(ref))
                      for r, ref in enumerate(case["planes"])]
    y, u = case["planes"][0][:2]
    assert y.data_ptr() % 4 == 1 and u.data_ptr() % 4 == 3
    assert y.shape[1] % 2 == 1 and u.shape[1] % 2 == 1
    _assert_equal(_kernel(on_standin, case), _ref(case))


def test_standin_traps_a_window_index_past_the_grid(on_standin):
    """A child's window index past the grid traps the kernel (the plain
    version's indexing raises), and the launch fails."""
    case = _case("children", seed=43)
    nwin = case["grid"][2] * case["grid"][3]
    case["win_idx"] = case["win_idx"].clone()
    case["win_idx"][5] = nwin
    with pytest.raises(RuntimeError, match="launch failed"):
        _kernel(on_standin, case)
    with pytest.raises(IndexError):
        _ref(case)


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """Wrong dtypes, a non-contiguous input, mixed devices, a missing
    window index, references of other shapes, a grid whose windows leave
    the planes or hold no region of the block size (the dispatch's grid
    refuses windows past the planes too), and a tap table outside signed
    bytes at a phase the kernel filters."""
    case = _case("zone", seed=51)
    step, y_base, rows, cols = case["grid"]
    case["grid"] = _kernel_grid(case)
    with pytest.raises(TypeError, match="int32"):
        K.mc_predict(**dict(case, mv_r=case["mv_r"].long()))
    with pytest.raises(TypeError, match="uint8"):
        K.mc_predict(**dict(case, planes=[tuple(p.to(torch.int16) for p in
                                                case["planes"][0])]))
    with pytest.raises(TypeError, match="int8"):
        K.mc_predict(**dict(case, ref_sel=case["ref_sel"].to(torch.int32)))
    wide = case["mv_c"].repeat_interleave(2)[::2]
    assert not wide.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        K.mc_predict(**dict(case, mv_c=wide))
    with pytest.raises(ValueError, match="contiguous"):
        K.mc_predict(**dict(case, planes=[tuple(
            p[:, :-1] for p in case["planes"][0])]))
    with pytest.raises(ValueError, match="different devices"):
        K.mc_predict(**dict(case, pos_x=case["pos_x"].to("meta")))
    with pytest.raises(ValueError, match="window index"):
        K.mc_predict(**dict(case, pos_y=case["pos_y"][:3], pos_x=case[
            "pos_x"][:3], mv_r=case["mv_r"][:3], mv_c=case["mv_c"][:3],
            ref_sel=case["ref_sel"][:3]))
    last, gold, alt = case["planes"]
    with pytest.raises(ValueError, match="every reference"):
        K.mc_predict(**dict(case, planes=[last, tuple(
            p[1:].contiguous() for p in gold), alt]))
    spec_y, spec_u, spec_v = case["grid"][2:]
    with pytest.raises(ValueError, match="leave"):
        K.mc_predict(**dict(case, grid=(rows, cols + 2, *case["grid"][2:])))
    for far in ((step, 120, 200, 52), (step, 120, 52, -1)):
        with pytest.raises(ValueError, match="leave"):
            K.mc_predict(**dict(case, grid=(rows, cols, far, spec_u,
                                            spec_v)))
    with pytest.raises(ValueError, match="no region"):
        K.mc_predict(**dict(case, grid=(rows, cols, spec_y, spec_u,
                                        (16, 22, *spec_v[2:]))))
    shapes = tuple(tuple(t.shape) for t in last)
    for grid in ((step, 0, rows, cols + 2), (step, 128, rows, cols)):
        with pytest.raises(ValueError, match="leave"):
            P.mc_window_grid(shapes, grid)
    with pytest.raises(ValueError, match="n=8"):
        K.mc_predict(**dict(case, n=8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.mc_predict(**case)
    real = T.subpel_filters

    def wide_taps(kind):
        out = np.array(real(kind))
        out[5, 2] = -130  # phase 5: subpel_search never filters it
        return out

    monkeypatch.setattr(T, "subpel_filters", wide_taps)
    K._mc_taps_on.cache_clear()
    try:
        with pytest.raises(ValueError, match="signed byte"):
            K.mc_predict(**case)
        K._subpel_taps()  # the phases 4, 8 and 12 are unchanged
    finally:
        monkeypatch.setattr(T, "subpel_filters", real)
        K._mc_taps_on.cache_clear()


def test_mc_table_premise():
    """The table the kernel takes: the identity at phase 0, every tap of
    the phases 1-15 a signed byte, each phase summing to 128."""
    taps = K._mc_taps()
    assert taps.dtype == np.int32 and taps.shape == (16, 8)
    assert taps[0].tolist() == [0, 0, 0, 128, 0, 0, 0, 0]
    assert taps[1:].min() >= -128 and taps[1:].max() <= 127
    assert (taps.sum(axis=1) == 128).all()
    np.testing.assert_array_equal(taps, np.asarray(P.FILTERS, np.int32))
