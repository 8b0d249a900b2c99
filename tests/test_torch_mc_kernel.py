"""The device code of ``tpu_vp9_torch/csrc/mc_predict.cu`` run on the CPU:
g++ builds the kernel behind the stand-ins of
``tests/cuda_standin/cuda_runtime.h`` (a host thread per CUDA thread, dp4a
and the byte intrinsics written out from their definitions), and the
wrapper ``ops/cuda_kernels.py:mc_predict`` launches it there: its device
check answers "cuda" and its launch calls the stand-in build with the
launcher's own arguments (the source's ``mc_predict_launch`` up to its
launch). Every call is held against the plain version
``pipeline/tpu_encdec.py:mc_predict_ref``, bit for bit.

The cases: the 32 zone (LAST, GOLDEN and ALTREF per block, a reference
without windows), the strip zone (n = 16 at a strip geometry), the
children (their parents' windows by a window index, origin offsets), every
q4 phase pair of the chroma planes (the luma planes' even ones) with MVs
of either sign, MVs of +-(WIN_R + 0.75) pel at every edge of a geometry
with the overhang row, MVs past the windows' reach (the window clamp),
ragged batches, windows that start 1 and 3 bytes into their storage, and
the wrapper's refusals.

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

# the stand-in's launch: each plane's CTAs one after another
_STANDIN_LAUNCH = """
    for (int p = 0; p < kPlanes; ++p) {
      switch (n) {
        case 32:
          standin_launch(nblk, kThreads, [&] {
            blockIdx.y = p;
            mc_predict_kernel<32>(a);
          });
          break;
        case 16:
          standin_launch(nblk, kThreads, [&] {
            blockIdx.y = p;
            mc_predict_kernel<16>(a);
          });
          break;
        default:
          return 1;
      }
    }
    (void)s;
    return 0;
}
"""


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
    cut = src.index("template <int N>\ncudaError_t launch(")
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
    fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture
def on_standin(standin, monkeypatch):
    """``K.mc_predict`` on CPU tensors launching the stand-in build."""
    def launch(name, dev, *args):
        assert name == "mc_predict"
        assert standin(*args, None) == 0

    monkeypatch.setattr(K, "_device_kind", lambda name, *t: "cuda")
    monkeypatch.setattr(K, "_launch", launch)
    return K.mc_predict


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _windows(plane, pos_y, pos_x, sw, r):
    """(B, sw, sw) windows of a (bordered) plane whose origin is each
    position minus (r + 4), as ``_extract_search_windows`` cuts them."""
    return np.stack([plane[P.BORDER + y - r - 4:P.BORDER + y - r - 4 + sw,
                           P.BORDER + x - r - 4:P.BORDER + x - r - 4 + sw]
                     for y, x in zip(pos_y, pos_x)])


def _case(kind, seed):
    """Keyword arguments of ``mc_predict`` / ``mc_predict_ref`` (CPU
    tensors) for one kind of call."""
    rng = np.random.default_rng(seed)
    w, h = {"strip": (128, 112), "edges": (128, 88),
            "clamp": (512, 288)}.get(kind, (128, 96))
    g = P.make_geom(w, h)
    n = 16 if kind == "strip" else 32
    nc = n // 2
    if kind == "strip":
        pos_y = np.full(g.cols16, g.strip_y)
        pos_x = np.arange(g.cols16) * 16
    elif kind == "phases":
        # 256 blocks inside a wider frame, where no MV of the case clamps
        g = P.make_geom(512, 192)
        pos_y = np.tile([64, 96], 128)
        pos_x = np.repeat(64 + np.arange(8) * 32, 32)
    else:
        pos_y = np.repeat(np.arange(g.rows32) * 32, g.cols32)
        pos_x = np.tile(np.arange(g.cols32) * 32, g.rows32)
    b = pos_y.size
    n_refs = 1 if kind in ("children", "edges") else 3
    planes = [(rng.integers(0, 256, (g.pad_h + 2 * P.BORDER,
                                     g.pad_w + 2 * P.BORDER), np.uint8),
               rng.integers(0, 256, (g.pad_h // 2 + 2 * P.BORDER,
                                     g.pad_w // 2 + 2 * P.BORDER), np.uint8),
               rng.integers(0, 256, (g.pad_h // 2 + 2 * P.BORDER,
                                     g.pad_w // 2 + 2 * P.BORDER), np.uint8))
              for _ in range(n_refs)]
    sw_y, sw_c = n + 2 * P.WIN_R + 8, nc + 2 * P.CHROMA_WIN_R + 8
    if kind == "children":
        # every parent's windows; K = 3 parents descend, 4 children each
        wins = [tuple(_t(_windows(pl, pos_y >> s, pos_x >> s, sw, r))
                      for pl, s, sw, r in zip(
                          planes[0], (0, 1, 1), (sw_y, sw_c, sw_c),
                          (P.WIN_R, P.CHROMA_WIN_R, P.CHROMA_WIN_R)))]
        sel = np.sort(rng.choice(b, 3, replace=False)).astype(np.int32)
        ii, jj = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
        pos_y = (pos_y[sel][:, None] + 16 * ii).reshape(-1)
        pos_x = (pos_x[sel][:, None] + 16 * jj).reshape(-1)
        b, n = pos_y.size, 16
        mv = rng.integers(-EDGE + 16 * 8, EDGE - 16 * 8 + 1, (2, b))
        extra = {"win_idx": _t(np.repeat(sel, 4)),
                 "org_off_y": _t(np.tile(16 * ii, 3).astype(np.int32)),
                 "org_off_x": _t(np.tile(16 * jj, 3).astype(np.int32))}
    else:
        wins = [tuple(_t(_windows(pl, pos_y >> s, pos_x >> s, sw, r))
                      for pl, s, sw, r in zip(
                          ref, (0, 1, 1), (sw_y, sw_c, sw_c),
                          (P.WIN_R, P.CHROMA_WIN_R, P.CHROMA_WIN_R)))
                for ref in planes]
        extra = {}
        if n_refs == 3:
            extra["ref_sel"] = _t(rng.integers(0, 3, b).astype(np.int8))
        if kind == "phases":
            # chroma phase pairs (pr, pc) = (mv_r & 15, mv_c & 15), all 256
            pr, pc = np.repeat(np.arange(16), 16), np.tile(np.arange(16), 16)
            sign = rng.choice([-1, 1], (2, b))
            mv = np.stack([pr, pc]) + 16 * rng.integers(0, 13, (2, b)) * sign
        elif kind == "edges":
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
    return dict(wins=wins, pos_y=_t(pos_y.astype(np.int32)),
                pos_x=_t(pos_x.astype(np.int32)),
                mv_r=_t(mv[0].astype(np.int32)),
                mv_c=_t(mv[1].astype(np.int32)), n=n, mi_rows=g.mi_rows,
                mi_cols=g.mi_cols, **extra)


def _ref(case):
    return P.mc_predict_ref(filters=FILTERS, **case)


def _assert_equal(got, want):
    for gp, wp in zip(got, want):
        assert gp.dtype == torch.uint8 and gp.shape == wp.shape
        assert torch.equal(gp, wp)


KINDS = ("zone", "strip", "children", "phases", "edges", "clamp")


@pytest.mark.parametrize("kind", KINDS)
def test_standin_matches_plain_version(on_standin, kind):
    case = _case(kind, seed=KINDS.index(kind))
    _assert_equal(on_standin(**case), _ref(case))


def test_standin_takes_every_phase_pair_and_both_phase0_paths(on_standin):
    """The phases case reaches all 256 chroma phase pairs and, in luma, the
    even ones: phase 0 in neither axis, in one and in both."""
    case = _case("phases", seed=11)
    got = on_standin(**case)
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
        for ss, r, sw in ((0, P.WIN_R, case["wins"][0][0].shape[-1]),
                          (1, P.CHROMA_WIN_R,
                           case["wins"][0][1].shape[-1])):
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
    """A ref_sel naming a reference without windows reads LAST's, in both
    versions."""
    case = _case("zone", seed=21)
    last, gold, alt = case["wins"]
    case["wins"] = [last, gold if present[0] else None,
                    alt if present[1] else None]
    got = on_standin(**case)
    _assert_equal(got, _ref(case))
    only_last = dict(case, wins=[last], ref_sel=None)
    absent = 2 if present[0] else 1
    rows = case["ref_sel"] == absent
    assert bool(rows.any())
    for gp, wp in zip(got, _ref(only_last)):
        assert torch.equal(gp[rows], wp[rows])


@pytest.mark.parametrize("b", [1, 5, 7])
def test_standin_ragged_batch_writes_only_its_blocks(standin, b):
    """B blocks write their B predictions and nothing past them."""
    case = _case("zone", seed=30 + b)
    for key in ("pos_y", "pos_x", "mv_r", "mv_c", "ref_sel"):
        case[key] = case[key][:b].contiguous()
    case["wins"] = [tuple(w[:b].contiguous() for w in ref)
                    for ref in case["wins"]]
    outs = [torch.full((b + 2, m, m), 77, dtype=torch.uint8)
            for m in (32, 16, 16)]
    ptrs = [w.data_ptr() for p in range(3) for w in
            (case["wins"][0][p], case["wins"][1][p], case["wins"][2][p])]
    args = (*ptrs, case["ref_sel"].data_ptr(), None,
            *(case[k].data_ptr() for k in ("pos_y", "pos_x", "mv_r",
                                           "mv_c")),
            None, None, torch.from_numpy(K._mc_taps()).data_ptr(),
            *(o.data_ptr() for o in outs), b, 32,
            case["wins"][0][0].shape[-1], case["wins"][0][1].shape[-1],
            P.WIN_R, P.CHROMA_WIN_R, case["mi_rows"], case["mi_cols"], None)
    assert standin(*args) == 0
    for o, w in zip(outs, _ref(case)):
        assert torch.equal(o[:b], w)
        assert bool((o[b:] == 77).all())


def test_standin_reads_unaligned_views(on_standin):
    """Windows that start 1 and 3 bytes into their storage: the kernel
    reads them a byte at a time."""
    case = _case("children", seed=41)

    def shifted(t, k):
        buf = torch.zeros(t.numel() + k, dtype=torch.uint8)
        buf[k:] = t.reshape(-1)
        return buf[k:].view(t.shape)

    case["wins"] = [tuple(shifted(w, 1 + 2 * (p % 2))
                          for p, w in enumerate(case["wins"][0]))]
    assert case["wins"][0][0].data_ptr() % 4 == 1
    assert case["wins"][0][1].data_ptr() % 4 == 3
    _assert_equal(on_standin(**case), _ref(case))


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """Wrong dtypes, a non-contiguous input, mixed devices, a missing
    window index, and a tap table outside signed bytes at a phase the
    kernel filters."""
    case = _case("zone", seed=51)
    with pytest.raises(TypeError, match="int32"):
        K.mc_predict(**dict(case, mv_r=case["mv_r"].long()))
    with pytest.raises(TypeError, match="uint8"):
        K.mc_predict(**dict(case, wins=[tuple(w.to(torch.int16) for w in
                                              case["wins"][0])]))
    with pytest.raises(TypeError, match="int8"):
        K.mc_predict(**dict(case, ref_sel=case["ref_sel"].to(torch.int32)))
    wide = case["mv_c"].repeat_interleave(2)[::2]
    assert not wide.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        K.mc_predict(**dict(case, mv_c=wide))
    with pytest.raises(ValueError, match="different devices"):
        K.mc_predict(**dict(case, pos_x=case["pos_x"].to("meta")))
    with pytest.raises(ValueError, match="window index"):
        K.mc_predict(**dict(case, pos_y=case["pos_y"][:3], pos_x=case[
            "pos_x"][:3], mv_r=case["mv_r"][:3], mv_c=case["mv_c"][:3],
            ref_sel=case["ref_sel"][:3]))
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
