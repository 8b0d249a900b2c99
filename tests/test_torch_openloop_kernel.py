"""The device code of ``tpu_vp9_torch/csrc/openloop_modes.cu`` run on the
CPU: g++ builds the kernel and its launcher behind the stand-ins of
``tests/cuda_standin/cuda_runtime.h`` (a host thread per CUDA thread), its
``<<<>>>`` launch replaced by ``standin_launch_all`` (every CTA of the grid
at once), and each launch is held against the plain version
``ops/cuda_kernels.py:openloop_modes_ref``, bit for bit: modes, the 10
SSEs and the least cost of every 32x32 block, on random planes at three
qindex values, a smooth gradient, a constant plane, small grids (one
block, one block row, one block column), a plane built so that DC, V
and TM tie at the least cost (the first mode wins), with a count of the
ties reached, planes of the largest SSE and cost key (every prediction
255 off, a 0/255 checkerboard, all 255, at qindex 0 and 255), and a frame
whose blocks take TM both ways (closed form, pixel by pixel). The
launcher's refusals (an empty grid, a short pitch, an unaligned table, an
unaligned plane or pitch) come back as errors with nothing run. The
kernel's class table (``_ol_slot_tables``) is held against a direct count
of ``_kf_mode_lists``.

What this cannot show: that nvcc accepts the source, timing.
``chip_smoke.py`` checks the kernel on the card.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpu_vp9_torch.ops import cuda_kernels as K

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "tpu_vp9_torch", "csrc")
STANDIN = os.path.join(REPO, "tests", "cuda_standin")

_LAUNCH = """  openloop_modes_kernel<<<grid, kThreads, kSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(plane), pitch, rows, cols, lam,
      static_cast<const uint2*>(tabs), static_cast<int*>(modes),
      static_cast<int*>(sse), static_cast<int*>(best));"""
_STANDIN_LAUNCH = """  standin_launch_all(grid, kThreads, [&] {
    openloop_modes_kernel(
        static_cast<const uint8_t*>(plane), pitch, rows, cols, lam,
        static_cast<const uint2*>(tabs), static_cast<int*>(modes),
        static_cast<int*>(sse), static_cast<int*>(best));
  });"""


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """The kernel and its launcher built with g++ behind the stand-ins:
    its dynamic shared memory the stand-ins' buffer of the running CTA,
    its launch every CTA at once."""
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the stand-in of the CUDA source"
    with open(os.path.join(CSRC, "openloop_modes.cu")) as fh:
        src = fh.read()
    for old, new in (
            ("extern __shared__ __align__(16) unsigned char smem[];",
             "unsigned char* smem = standin_smem;"),
            (_LAUNCH, _STANDIN_LAUNCH)):
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    out = tmp_path_factory.mktemp("standin")
    cpp, lib = out / "openloop_standin.cpp", out / "libopenloop.so"
    cpp.write_text(src)
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fwrapv", "-shared", "-fPIC", "-I",
         STANDIN, "-I", CSRC, "-o", str(lib), str(cpp), "-lpthread"],
        check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).openloop_modes_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _run(fn, plane, qindex, tabs=None, pitch=None):
    """One launch on a CPU plane, as the wrapper makes it: (the launcher's
    error, modes, sse, best); the outputs start as junk so that a place
    not written shows."""
    h, w = plane.shape
    rows, cols = h // 32, w // 32
    b = rows * cols
    out = torch.full((12 * max(b, 1),), -777, dtype=torch.int32)
    if tabs is None:
        tabs = K._ol_tables_on(torch.device("cpu")).reshape(-1)
    ptr = out.data_ptr()
    err = fn(plane.data_ptr(), tabs.data_ptr(), ptr, ptr + 8 * b,
             ptr + 4 * b, w if pitch is None else pitch, rows, cols,
             K.openloop_lam(qindex), None)
    return (err, out[:b].reshape(rows, cols),
            out[2 * b:12 * b].reshape(rows, cols, 10),
            out[b:2 * b].reshape(rows, cols))


def _check(fn, plane, qindex):
    """The launch against the plain version; returns the plain version's
    outputs."""
    t = torch.from_numpy(np.ascontiguousarray(plane))
    err, *got = _run(fn, t, qindex)
    assert err == 0
    want = K.openloop_modes_ref(t, qindex)
    for name, g, w in zip(("modes", "sse", "best"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name
    return want


def _ties(sse, qindex):
    """Blocks whose least cost two or more modes share."""
    cost = sse.reshape(-1, 10).long() + torch.tensor(
        K.KF_MODE_BIAS) * K.openloop_lam(qindex)
    return int(((cost == cost.min(dim=1, keepdim=True).values).sum(dim=1)
                > 1).sum())


def tie_plane():
    """A 96x96 plane of 100 whose block (1, 1) has DC, V and TM tie at the
    least cost at qindex 45 (lam 32): column 63 is 101 from row 31 down,
    so that block's source repeats its above row (V and TM exact, cost
    lam) and DC, 100, misses 32 pixels by one (cost 32)."""
    p = np.full((96, 96), 100, np.uint8)
    p[31:64, 63] = 101
    return p


@pytest.mark.parametrize("qindex", [0, 120, 255])
def test_standin_random_planes(standin, qindex):
    rng = np.random.default_rng(qindex)
    _check(standin, rng.integers(0, 256, (64, 96), dtype=np.uint8), qindex)


@pytest.mark.parametrize("dims", [(32, 32), (32, 128), (128, 32)],
                         ids=["one_block", "one_row", "one_column"])
def test_standin_small_grids(standin, dims):
    """Edges of the frame on every side: a block with neither neighbour,
    a row of blocks with no row above, a column with no column left."""
    rng = np.random.default_rng(sum(dims))
    _check(standin, rng.integers(0, 256, dims, dtype=np.uint8), 100)


def test_standin_gradient_and_constant(standin):
    """A smooth gradient (the directional modes win some blocks) and a
    constant plane (away from the frame's edges every mode predicts the
    constant; DC wins)."""
    y, x = np.mgrid[0:96, 0:64]
    want = _check(standin, ((3 * x + 2 * y) % 256).astype(np.uint8), 60)
    assert len(set(want[0].reshape(-1).tolist())) > 1
    want = _check(standin, np.full((64, 64), 77, np.uint8), 255)
    assert (want[0][1:, 1:] == 0).all()


def test_standin_ties_go_to_the_first_mode(standin):
    """DC, V and TM share block (1, 1)'s least cost and DC, the first,
    wins; small-amplitude planes give ties across many blocks, each
    resolved as the plain version's first minimum."""
    want = _check(standin, tie_plane(), 45)
    costs = want[1][1, 1].long() + torch.tensor(K.KF_MODE_BIAS) * 32
    assert costs[0] == costs[1] == costs[9] == costs.min()
    assert int(want[0][1, 1]) == 0
    rng = np.random.default_rng(5)
    ties = 0
    for q in (0, 30):
        plane = (100 + rng.integers(0, 2, (96, 96))).astype(np.uint8)
        ties += _ties(_check(standin, plane, q)[1], q)
    assert ties > 0


def test_launcher_refusals(standin):
    """An empty grid, a pitch shorter than the grid and an unaligned table
    are refused (cudaErrorInvalidValue) before anything runs."""
    plane = torch.zeros((32, 64), dtype=torch.uint8)
    tabs = K._ol_tables_on(torch.device("cpu")).reshape(-1)
    assert _run(standin, plane, 10, pitch=32)[0] == 1
    assert _run(standin, plane, 10, tabs=tabs[1:])[0] == 1
    assert _run(standin, torch.zeros((0, 64), dtype=torch.uint8), 10)[0] == 1


def test_launcher_refuses_unaligned_rows(standin):
    """The kernel reads each row as two 16-byte vectors: a plane not
    16-byte aligned, or a pitch not a multiple of 16, is refused."""
    buf = torch.zeros(32 * 80 + 16, dtype=torch.uint8)
    assert buf.data_ptr() % 16 == 0
    shifted = buf[1:1 + 32 * 64].view(32, 64)
    assert _run(standin, shifted, 10)[0] == 1
    wide = torch.zeros((32, 80), dtype=torch.uint8)[:, :64]
    assert _run(standin, wide, 10, pitch=72)[0] == 1
    assert _run(standin, wide, 10, pitch=80)[0] == 0


def edge_lines_plane():
    """A 96x96 plane of 255 but row 63 and column 63, which are 0: block
    (2, 2) is all 255 and every one of its 10 predictions is 0 (its above
    row, left column and corner are 0), so each of its SSEs is the largest
    there is, 1024 * 255^2, and all ten tie (DC wins)."""
    p = np.full((96, 96), 255, np.uint8)
    p[63, :] = 0
    p[:, 63] = 0
    return p


@pytest.mark.parametrize("qindex", [0, 255])
@pytest.mark.parametrize("kind", ["edge_lines", "checkerboard", "all_255"])
def test_standin_extreme_planes(standin, kind, qindex):
    """The largest SSEs and, at qindex 255, the largest cost keys: a plane
    whose block (2, 2) misses every prediction by 255 (SSE 66,585,600, the
    expansion's headroom), a 0/255 checkerboard and an all-255 plane."""
    if kind == "edge_lines":
        plane = edge_lines_plane()
    elif kind == "checkerboard":
        y, x = np.mgrid[0:96, 0:64]
        plane = (255 * ((x + y) & 1)).astype(np.uint8)
    else:
        plane = np.full((64, 96), 255, np.uint8)
    want = _check(standin, plane, qindex)
    if kind == "edge_lines":
        assert (want[1][2, 2] == 1024 * 255 * 255).all()
        assert int(want[0][2, 2]) == 0
        assert int(want[2].max()) == 1024 * 255 * 255
    assert int(want[2].max()) + 3 * K.openloop_lam(255) < 1 << 27


def tm_mixed_plane():
    """A 96x128 plane of blocks where TM clamps (random content, full
    range) beside blocks where it does not (a gentle gradient from 100)."""
    rng = np.random.default_rng(11)
    p = rng.integers(0, 256, (96, 128), dtype=np.uint8)
    y, x = np.mgrid[0:96, 0:64]
    p[:, 64:] = (100 + (x + y) // 4 + rng.integers(0, 3, (96, 64))).astype(
        np.uint8)
    return p


@pytest.mark.parametrize("qindex", [40, 200])
def test_standin_both_tm_branches(standin, qindex):
    """One frame whose blocks take TM both ways in the kernel: in closed
    form where no clamp bites, pixel by pixel where one does
    (``openloop_tm_exact``), each bit-equal to the plain version."""
    plane = tm_mixed_plane()
    exact = K.openloop_tm_exact(torch.from_numpy(plane))
    assert bool(exact.any()) and not bool(exact.all())
    _check(standin, plane, qindex)


def test_slot_table_counts_match_the_mode_lists():
    """The kernel's class table against a direct count: for every
    directional mode and distinct word of ``_kf_mode_lists``, the counts of
    the slots that carry that word add up to the pixels whose index is
    that word's; every pixel lies in exactly one class of each mode; each
    slot's four weights on the kernel's reference layout give its word's
    filter on a random reference vector."""
    wts, places, words, modes = K._ol_slot_tables()
    shape = (len(K.OL_SLOTS), 32)
    assert wts.shape == places.shape == words.shape == modes.shape == shape
    counts = places >> 8
    uniq, idx = K._kf_mode_lists(32)
    assert not np.isin(modes, (1, 2)).any()  # V and H: no slot
    for d in range(2, 8):
        m = d + 1
        sel = modes == m
        direct = np.bincount(idx[:, d], minlength=uniq.shape[1])
        from_slots = np.zeros_like(direct)
        for k, lane in zip(*np.nonzero(sel)):
            j = np.flatnonzero(uniq[d] == words[k, lane])
            assert len(j) == 1
            from_slots[j[0]] += counts[k, lane]
        assert (from_slots == direct).all(), m
        assert counts[sel].sum() == 1024
    seen = {}
    for lanes in K._ol_sweep(32):
        for m, px in lanes:
            seen.setdefault(m, []).extend(px)
    assert set(seen) == set(range(3, 9))
    for m, px in seen.items():
        assert sorted(px) == [(y, x) for y in range(32) for x in range(32)]
    ref = np.random.default_rng(2).integers(0, 256, 97)
    kept = np.zeros(100, np.int64)  # the kernel's layout: the left reversed
    for k in range(97):
        kept[K._ol_ref_index(k)] = ref[k]
    for k, lane in zip(*np.nonzero(counts)):
        w = int(words[k, lane])
        want = ((w >> 21 & 7) * ref[w & 127]
                + (w >> 24 & 7) * ref[w >> 7 & 127]
                + (w >> 27 & 7) * ref[w >> 14 & 127] + 2) >> 2
        o, wt = int(places[k, lane]) & 255, int(wts[k, lane])
        got = (sum((wt >> (8 * i) & 255) * int(kept[o + i])
                   for i in range(4)) + 2) >> 2
        assert got == want


def test_wrapper_checks_its_arguments():
    """The wrapper refuses what the kernel does not take, on any device:
    a block size other than 32, a plane not a grid of blocks, another
    dtype, a qindex outside [0, 255]."""
    ok = torch.zeros((64, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="n=16"):
        K.openloop_modes(ok, 10, 16)
    with pytest.raises(ValueError, match="grid"):
        K.openloop_modes(torch.zeros((64, 80), dtype=torch.uint8), 10)
    with pytest.raises(TypeError, match="uint8"):
        K.openloop_modes(ok.to(torch.int16), 10)
    with pytest.raises(ValueError, match="qindex"):
        K.openloop_modes(ok, 256)
