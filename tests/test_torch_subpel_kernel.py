"""The device code of ``tpu_vp9_torch/csrc/subpel_search.cu`` run on the
CPU: g++ builds the kernel behind the stand-ins of
``tests/cuda_standin/cuda_runtime.h`` (a host thread per CUDA thread, the
warp's shuffles through an exchange area, dp4a and the byte intrinsics
written out from their definitions), and each launch is held against the
plain version ``pipeline/tpu_encdec.py:subpel_search_ref``, bit for bit:
the three outputs, ties to the first offset (-6, -6) included. The packed
8-tap helpers of ``csrc/convolve8.cuh`` are held against libvpx's convolve
written in numpy.

The shapes: the M8 path's zone (n = 32, r = 4) and children (n = 16,
r = 8), and n = 16 at r = 40 (the reach of the strip zone still to come).
At n = 16 a CTA takes four blocks, so the batches of six leave the last
CTA ragged.

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
THREADS = 128  # the kernel's CTA
SHAPES = [(32, P.REFINE_R), (16, P.CHILD_R), (16, 40)]
SHAPE_IDS = ["zone_n32_r4", "children_n16_r8", "strip_n16_r40"]
KINDS = ("random", "smooth", "corners", "tie", "max_sse", "checker")

# the launcher of the stand-in build, and a driver of the packed 8-tap
# helpers
_DRIVER = """
}  // namespace
extern "C" int standin_run(const uint8_t* wins, const uint8_t* src,
                           const int* dy, const int* dx, const int* filters,
                           int* mv_r, int* mv_c, int* sse, int nblk, int n,
                           int r) {
  switch (n) {
%s
    default:
      return 1;
  }
  return 0;
}
extern "C" void standin_tap8(const uint8_t* px, const int* taps, int count,
                             int* out) {
  for (int i = 0; i < count; ++i) {
    uint32_t t_lo, t_hi, w[3];
    conv8::pack_taps(taps + 8 * i, t_lo, t_hi);
    std::memcpy(w, px + 12 * i, 12);
    uint32_t lo, hi;
    conv8::bytes8(w[0], w[1], w[2], i %% 4, lo, hi);
    out[i] = conv8::tap8_packed(lo, hi, t_lo, t_hi);
  }
}
"""
_CASE = """    case %(n)d:
      standin_launch((nblk + Shape<%(n)d>::kPer - 1) / Shape<%(n)d>::kPer,
                     %(threads)d, [&] {
        subpel_search_kernel<%(n)d>(wins, src, dy, dx, filters, mv_r, mv_c,
                                    sse, nblk, r);
      });
      break;"""


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """The kernel's device code built with g++ behind the stand-ins: the
    source up to its host launch code, its dynamic shared memory the
    stand-ins' buffer."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the stand-in of the CUDA source")
    with open(os.path.join(CSRC, "subpel_search.cu")) as fh:
        src = fh.read()
    cut = src.index("template <int N>\ncudaError_t launch(")
    shared = "extern __shared__ __align__(16) unsigned char smem[];"
    assert src.count(shared) == 1
    body = src[:cut].replace(shared, "unsigned char* smem = standin_smem;")
    assert "namespace {" in body
    cases = "\n".join(_CASE % {"n": n, "threads": THREADS}
                      for n in K.SUBPEL_BLOCK_SIZES)
    out = tmp_path_factory.mktemp("standin")
    cpp, lib = out / "subpel_search_standin.cpp", out / "libsp.so"
    cpp.write_text(body + _DRIVER % cases)
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fwrapv", "-shared", "-fPIC", "-I",
         STANDIN, "-I", CSRC, "-o", str(lib), str(cpp), "-lpthread"],
        check=True, capture_output=True, text=True)
    dll = ctypes.CDLL(str(lib))
    dll.standin_run.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
    dll.standin_run.restype = ctypes.c_int
    dll.standin_tap8.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int, ctypes.c_void_p]
    dll.standin_tap8.restype = None
    return dll


def _run(dll, wins, src, dy, dx, n, r, extra=0):
    """One launch of the stand-in on CPU tensors; the outputs start as junk
    and have ``extra`` places past the batch, so that a place the kernel
    does not write, or writes past the batch, shows."""
    b = src.shape[0]
    filters = torch.from_numpy(K._subpel_taps())
    out = torch.full((3, b + extra), -12345, dtype=torch.int32)
    assert dll.standin_run(wins.data_ptr(), src.data_ptr(), dy.data_ptr(),
                           dx.data_ptr(), filters.data_ptr(),
                           out[0].data_ptr(), out[1].data_ptr(),
                           out[2].data_ptr(), b, n, r) == 0
    return out


def _inputs(kind, n, r, b, seed):
    """(wins, src, dy, dx) CPU tensors: b blocks of one kind."""
    rng = np.random.default_rng(seed)
    sw = n + 2 * r + 8
    dy = rng.integers(-r, r + 1, b).astype(np.int32)
    dx = rng.integers(-r, r + 1, b).astype(np.int32)
    wins = rng.integers(0, 256, (b, sw, sw), dtype=np.uint8)
    src = rng.integers(0, 256, (b, n, n), dtype=np.uint8)
    yy, xx = np.mgrid[0:sw, 0:sw]
    if kind == "smooth":
        # the source cut out of a smooth window near the winner: the
        # minimum lies inside the 7 x 7 offsets
        for i in range(b):
            w = 128 + 100 * np.sin(0.31 * yy + 0.17 * xx + rng.uniform(0, 6))
            wins[i] = np.clip(w + rng.normal(0, 2, w.shape), 0, 255)
            oy, ox = 4 + r + np.array([dy[i], dx[i]]) + rng.integers(-1, 2, 2)
            src[i] = wins[i, oy:oy + n, ox:ox + n]
    elif kind == "corners":
        dy = np.array([(-r, r)[i % 2] for i in range(b)], np.int32)
        dx = np.array([(-r, r)[i // 2 % 2] for i in range(b)], np.int32)
    elif kind == "tie":
        level = rng.integers(0, 256, (b, 1, 1), dtype=np.uint8)
        wins[:] = level
        src[:] = level
    elif kind == "max_sse":
        wins[:], src[:] = 0, 255
    elif kind == "checker":
        cb = ((yy + xx) % 2 * 255).astype(np.uint8)
        wins[:] = cb
        wins[1::2] = 255 - cb
        src[:] = 255 - cb[:n, :n]
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (wins, src, dy, dx))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,r", SHAPES, ids=SHAPE_IDS)
def test_standin_matches_plain_version(standin, n, r, kind):
    """A batch of one kind: three blocks at n = 32 (three CTAs), six at
    n = 16 (a full CTA and a ragged one)."""
    b = 3 if n == 32 else 6
    wins, src, dy, dx = _inputs(kind, n, r, b, seed=n + r + KINDS.index(kind))
    got = _run(standin, wins, src, dy, dx, n, r)
    want = P.subpel_search_ref(wins, src, dy, dx, n, r)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if kind in ("tie", "max_sse"):
        # every offset ties: the first, (-6, -6), wins
        assert torch.equal(got[0], dy * 8 - 6)
        assert torch.equal(got[1], dx * 8 - 6)
        top = 0 if kind == "tie" else n * n * 255 * 255
        assert bool((got[2] == top).all())
    if kind == "smooth":
        assert bool(((got[0] - dy * 8).abs() <= 6).all())


@pytest.mark.parametrize("b", [1, 5, 7])
def test_standin_ragged_batch_writes_only_its_blocks(standin, b):
    """At n = 16 a B that is no multiple of four: the blocks past B in the
    last CTA write nothing, and the outputs past the batch keep their
    junk."""
    n, r = 16, P.CHILD_R
    wins, src, dy, dx = _inputs("random", n, r, b, seed=50 + b)
    got = _run(standin, wins, src, dy, dx, n, r, extra=3)
    want = P.subpel_search_ref(wins, src, dy, dx, n, r)
    for g, w in zip(got, want):
        assert torch.equal(g[:b], w)
        assert bool((g[b:] == -12345).all())


@pytest.mark.parametrize("kind", ["smooth", "corners"])
def test_standin_strip_row_is_every_block_once(standin, kind):
    """The strip zone's shape, n = 16 r = 40, over a ragged row of 10
    blocks (three CTAs, the last with two idle warps) whose winners reach
    all of +-40: each block's window is read at its own winner, and the
    outputs past the batch keep their junk."""
    n, r, b = 16, 40, 10
    wins, src, dy, dx = _inputs(kind, n, r, b, seed=90 + len(kind))
    got = _run(standin, wins, src, dy, dx, n, r, extra=2)
    want = P.subpel_search_ref(wins, src, dy, dx, n, r)
    for g, w in zip(got, want):
        assert torch.equal(g[:b], w)
        assert bool((g[b:] == -12345).all())
    if kind == "corners":
        assert set(dy.tolist()) == set(dx.tolist()) == {-r, r}


@pytest.mark.parametrize("n,r", SHAPES, ids=SHAPE_IDS)
def test_standin_reads_unaligned_views(standin, n, r):
    """wins and src views that start 1 and 3 bytes into their storage: the
    kernel reads them a byte at a time."""
    wins, src, dy, dx = _inputs("smooth", n, r, 2, seed=70 + n)
    w_buf = torch.zeros(wins.numel() + 1, dtype=torch.uint8)
    s_buf = torch.zeros(src.numel() + 3, dtype=torch.uint8)
    w_buf[1:] = wins.reshape(-1)
    s_buf[3:] = src.reshape(-1)
    got = _run(standin, w_buf[1:].view(wins.shape), s_buf[3:].view(src.shape),
               dy, dx, n, r)
    for g, w in zip(got, P.subpel_search_ref(wins, src, dy, dx, n, r)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("interp", [T.InterpFilter.EIGHTTAP,
                                    T.InterpFilter.EIGHTTAP_SMOOTH,
                                    T.InterpFilter.EIGHTTAP_SHARP,
                                    T.InterpFilter.BILINEAR])
def test_packed_tap8_matches_convolve(standin, interp):
    """conv8::tap8_packed (packed taps, dp4a, pixels from an unaligned
    start) against libvpx's convolve, clamp((sum + 64) >> 7, 0, 255), at
    every phase but the identity, on random pixels, all-0 and all-255 runs,
    and runs that drive the sum to either clamp."""
    taps = np.asarray(T.subpel_filters(interp), np.int32)[1:]
    assert taps.min() >= -128 and taps.max() <= 127
    rng = np.random.default_rng(int(interp))
    reps = 40
    px = rng.integers(0, 256, (15 * reps, 12), dtype=np.uint8)
    px[0::reps], px[1::reps] = 0, 255
    # the sign of each tap drives each pixel to an end: both clamps
    px[2::reps, :8] = np.where(taps[:, None, :] > 0, 255, 0)[:, 0]
    px[3::reps, :8] = np.where(taps[:, None, :] > 0, 0, 255)[:, 0]
    count = px.shape[0]
    t = np.ascontiguousarray(np.repeat(taps, reps, axis=0))
    want = np.clip(((px[:, :8].astype(np.int64) * t).sum(axis=1) + 64) >> 7,
                   0, 255)
    # the i % 4 start of each run of eight within its twelve bytes
    for i in range(count):
        px[i] = np.roll(px[i], i % 4)
    got = np.zeros(count, np.int32)
    standin.standin_tap8(px.ctypes.data, t.ctypes.data, count,
                         got.ctypes.data)
    np.testing.assert_array_equal(got, want)
    assert want.min() == 0 and want.max() == 255


def test_wrapper_table_is_what_the_kernel_takes(monkeypatch):
    """The wrapper's EIGHTTAP table has the identity at phase 0 and signed
    bytes at the phases 4, 8, 12, and refuses a table that has not."""
    taps = K._subpel_taps()
    assert taps.dtype == np.int32 and taps.shape == (16, 8)
    assert taps[0].tolist() == [0, 0, 0, 128, 0, 0, 0, 0]
    real = T.subpel_filters

    def shifted(kind):
        out = np.array(real(kind))
        out[0] = [0, 0, 0, 0, 128, 0, 0, 0]
        return out

    monkeypatch.setattr(T, "subpel_filters", shifted)
    with pytest.raises(ValueError, match="identity"):
        K._subpel_taps()

    def wide(kind):
        out = np.array(real(kind))
        out[8, 3] += 100
        return out

    monkeypatch.setattr(T, "subpel_filters", wide)
    with pytest.raises(ValueError, match="signed byte"):
        K._subpel_taps()
