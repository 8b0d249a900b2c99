"""The device code of ``tpu_vp9_torch/csrc/loop_filter.cu`` run on the CPU:
g++ builds the kernel behind the stand-ins of
``tests/cuda_standin/cuda_runtime.h`` (a host thread per CUDA thread, a
barrier per ``__syncthreads``), and every CTA of the grid runs at once
(``standin_launch_all``), each with its own shared buffer, filled with
0xA5 so that a read of a place the CTA did not load shows. Each launch is
held against the plain version ``pipeline/tpu_encdec.py:loop_filter_ref``
bit for bit on all three planes, at geometries without and with the
bottom 16-pixel strip, with no mask, a random one, all ones, a
checkerboard and one split block (strip-free geometries only), at lvl 0
(a copy), 9 and 50.
The outputs start as junk, so that a place the kernel does not write
shows.

What this cannot show: that nvcc accepts the source, the card's timing.
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
from tpu_vp9_torch.ops.loopfilter import sharpness_limits
from tpu_vp9_torch.pipeline import tpu_encdec as P

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "tpu_vp9_torch", "csrc")
STANDIN = os.path.join(REPO, "tests", "cuda_standin")
THREADS = 256  # the kernel's CTA
LEVELS = (0, 9, 50)  # copies; thresh 0; thresh 3
LIM_T, MBLIM_T = sharpness_limits(0)
# strip-free geometries (the last no wider than 64: one tile column) and
# the strip geometries (mi_rows % 4 == 2)
DIMS = [(64, 64), (128, 128), (160, 96), (192, 120)]
STRIP_DIMS = [(128, 112), (96, 80)]
# masks: none, random, all ones, and a checkerboard, which puts at every
# chroma tile boundary the pattern that needs its 20 rows of halo (the
# band's left block split above an unsplit one, the right block split)
# (and the checkerboard on gentle content alone, taller geometries among
# them, where the edges of that chain filter and a flat2 decision at its
# end turns on a row of the halo: one row less fails there)
GENTLE_DIMS = DIMS[1:] + [(192, 256), (256, 256)]
# (and one split block: the tiles away from it take the kernel's path for
# tiles without a split block)
CASES = ([(d, m) for d in DIMS
          for m in ("none", "random", "ones", "checkerboard", "one block")]
         + [(d, "none") for d in STRIP_DIMS]
         + [(d, "checkerboard gentle") for d in GENTLE_DIMS])

# every CTA of the grid at once, on threads the caller waits for
_DRIVER = """
}  // namespace
extern "C" int standin_run(const void* y, const void* u, const void* v,
                           void* out_y, void* out_u, void* out_v,
                           const void* split, int pad_h, int pad_w, int h_mi,
                           int w_mi, int strip_y, int rows32, int cols32,
                           int lvl, int lim, int blim) {
  int sc[step_row::kWords] = {};
  sc[step_row::kLfLvl] = lvl;
  sc[step_row::kLfLim] = lim;
  sc[step_row::kLfMblim] = blim;
  const Params P = make_params(y, u, v, out_y, out_u, out_v, split, sc,
                               pad_h, pad_w, h_mi, w_mi, strip_y, rows32,
                               cols32, 3);
  if (split != nullptr)
    standin_launch_all(2 * P.ncol * P.nrow, %(threads)d,
                       [P] { loop_filter_kernel<1>(P); });
  else
    standin_launch_all(2 * P.ncol * P.nrow, %(threads)d,
                       [P] { loop_filter_kernel<0>(P); });
  return SMEM_BYTES;
}
"""


def _source():
    """The kernel's source up to its host launch code, its dynamic shared
    memory the stand-ins' buffer of the running CTA."""
    with open(os.path.join(CSRC, "loop_filter.cu")) as fh:
        src = fh.read()
    cut = src.rindex("}  // namespace")
    shared = "extern __shared__ __align__(16) uint8_t smem[];"
    assert src.count(shared) == 1
    return src[:cut].replace(shared, "uint8_t* smem = standin_smem;")


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    gxx = shutil.which("g++")
    assert gxx, "g++ builds the stand-in of the CUDA source"
    out = tmp_path_factory.mktemp("standin")
    cpp, lib = out / "loop_filter_standin.cpp", out / "liblf.so"
    cpp.write_text(_source() + _DRIVER % {"threads": THREADS})
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fwrapv", "-shared", "-fPIC", "-I",
         STANDIN, "-I", CSRC, "-o", str(lib), str(cpp), "-lpthread"],
        check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).standin_run
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
    fn.restype = ctypes.c_int
    return fn


def _planes(g, rng, gentle_only=False):
    """Padded planes that reach every class of the edge filter: 32x32
    patches (16x16 in chroma) of 8x8 blocks at any level with a little
    noise (masked-out and filter4 lanes), at levels within 3 of each other
    (flat and flat2: "gentle"), or at 0 and 255 with small steps (the
    clamps)."""
    def plane(h, w, patch):
        kinds = rng.integers(0, 3, (h // patch + 1, w // patch + 1))
        if gentle_only:
            kinds[:] = 1
        kind = np.kron(kinds, np.ones((patch, patch), np.int64))[:h, :w]
        bh, bw = h // 8 + 1, w // 8 + 1

        def blocks(levels):
            return np.kron(levels, np.ones((8, 8)))[:h, :w]

        blocky = blocks(rng.integers(0, 256, (bh, bw))) \
            + rng.normal(0, 2, (h, w))
        gentle = blocks(rng.integers(60, 200) + rng.integers(0, 4, (bh, bw))) \
            + rng.integers(0, 2, (h, w))
        ends = blocks(rng.choice([0, 2, 5, 250, 253, 255], (bh, bw))) \
            + rng.integers(-1, 2, (h, w))
        out = np.where(kind == 0, blocky, np.where(kind == 1, gentle, ends))
        return torch.from_numpy(np.ascontiguousarray(
            np.clip(np.rint(out), 0, 255), np.uint8))

    return [plane(g.pad_h, g.pad_w, 32),
            plane(g.pad_h // 2, g.pad_w // 2, 16),
            plane(g.pad_h // 2, g.pad_w // 2, 16)]


def _run(fn, planes, g, lvl, mask):
    """One launch of the stand-in on CPU tensors; outputs start as junk."""
    outs = [torch.full_like(p, 77) for p in planes]
    lim, mblim = int(LIM_T[lvl]), int(MBLIM_T[lvl])
    smem = fn(*(p.data_ptr() for p in (*planes, *outs)),
              None if mask is None else mask.data_ptr(), g.pad_h, g.pad_w,
              g.h_mi, g.w_mi, g.strip_y if g.strip else g.pad_h, g.rows32,
              g.cols32, lvl, lim, mblim)
    assert 0 < smem <= 48 * 1024  # no plane-sized shared memory
    return outs


@pytest.mark.parametrize("dims,mask_kind", CASES,
                         ids=[f"{w}x{h}-{m}" for (w, h), m in CASES])
def test_kernel_matches_plain_version(standin, dims, mask_kind):
    """The kernel's three output planes equal ``loop_filter_ref``'s bit for
    bit at each level; the inputs and the mask stay as they were."""
    g = P.make_geom(*dims)
    rng = np.random.default_rng(dims[0] * 1000 + dims[1])
    planes = _planes(g, rng, gentle_only=mask_kind.endswith("gentle"))
    before = [p.clone() for p in planes]
    mask = None
    if mask_kind == "ones":
        mask = torch.ones((g.rows32, g.cols32), dtype=torch.int32)
    elif mask_kind == "one block":
        mask = torch.zeros((g.rows32, g.cols32), dtype=torch.int32)
        mask[g.rows32 // 2, g.cols32 // 2] = 1
    elif mask_kind.startswith("checkerboard"):
        mask = torch.from_numpy(np.add.outer(
            np.arange(g.rows32), np.arange(g.cols32)).astype(np.int32) % 2)
    elif mask_kind == "random":
        mask = torch.from_numpy(
            rng.integers(0, 2, (g.rows32, g.cols32)).astype(np.int32))
    for lvl in LEVELS:
        got = _run(standin, planes, g, lvl, mask)
        want = P.loop_filter_ref(*planes, g, lvl, int(LIM_T[lvl]),
                                 int(MBLIM_T[lvl]), split32=mask)
        for k, (a, b) in enumerate(zip(got, want)):
            bad = (a != b).nonzero()
            assert bad.shape[0] == 0, (
                f"plane {k} lvl {lvl}: {bad.shape[0]} pixels differ, the "
                f"first at {bad[0].tolist()}")
        for a, b in zip(planes, before):
            assert torch.equal(a, b)


def test_a_strip_geometry_with_a_mask_is_refused_before_the_kernel():
    """The wrapper refuses what the kernel's widths do not cover: a split
    mask with the strip (its 16x16 blocks split no further)."""
    g = P.make_geom(128, 112)
    y = torch.zeros((g.pad_h, g.pad_w), dtype=torch.uint8)
    c = torch.zeros((g.pad_h // 2, g.pad_w // 2), dtype=torch.uint8)
    mask = torch.zeros((g.rows32, g.cols32), dtype=torch.int32)
    with pytest.raises(ValueError, match="strip"):
        K.loop_filter(y, c, c, g, P.step_scalars(40, 48, 100, 10, 5, 20),
                      mask)
