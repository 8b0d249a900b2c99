"""The device code of ``tpu_vp9_torch/csrc/openloop_modes.cu`` run on the
CPU: g++ builds the kernel and its launcher behind the stand-ins of
``tests/cuda_standin/cuda_runtime.h`` (a host thread per CUDA thread), its
``<<<>>>`` launch replaced by ``standin_launch_all`` (every CTA of the grid
at once), and each launch is held against the plain version
``ops/cuda_kernels.py:openloop_modes_ref``, bit for bit: modes, the 10
SSEs and the least cost of every 32x32 block, on random planes at three
qindex values, a smooth gradient, a constant plane, small grids (one
block, one block row, one block column), and a plane built so that DC, V
and TM tie at the least cost (the first mode wins), with a count of the
ties reached. The launcher's refusals (an empty grid, a short pitch, an
unaligned table) come back as errors with nothing run.

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

_LAUNCH = """  openloop_modes_kernel<<<rows * cols, kThreads, kSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(plane), pitch, cols, lam,
      static_cast<const int*>(tabs), static_cast<int*>(modes),
      static_cast<int*>(sse), static_cast<int*>(best));"""
_STANDIN_LAUNCH = """  standin_launch_all(rows * cols, kThreads, [&] {
    openloop_modes_kernel(
        static_cast<const uint8_t*>(plane), pitch, cols, lam,
        static_cast<const int*>(tabs), static_cast<int*>(modes),
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
        tabs = K._kf_tables_on(torch.device("cpu"))[1]
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
    tabs = K._kf_tables_on(torch.device("cpu"))[1]
    assert _run(standin, plane, 10, pitch=32)[0] == 1
    assert _run(standin, plane, 10, tabs=tabs[1:])[0] == 1
    assert _run(standin, torch.zeros((0, 64), dtype=torch.uint8), 10)[0] == 1


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
