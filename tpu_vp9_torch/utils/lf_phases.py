"""Where ``loop_filter``'s CTAs spend their cycles, on the card.

    python3 -m tpu_vp9_torch.utils.lf_phases [path/to/loop_filter.cu]

Builds a copy of the kernel's source (``csrc/loop_filter.cu`` unless a path
is given) into ``tpu_vp9_torch/_build/`` with a ``clock64()`` stamp by
thread 0 at the start of each CTA, after each of its barriers and after its
stores are issued, runs it on a 1080p panning frame (as the unfiltered
recon) at level 28 (the real 1080p M8 P-frame's at qp 40, as
``chip_smoke.py`` prints it), with a random split mask and
without one (each output held against the plain version, bit for bit), and
prints, for each kind of CTA (chroma: u and v of a superblock; luma) and
each number of levels its tiles took, the median and largest SM cycles of
each phase between stamps: the load, each level, the store. The stamps
cost a global store each; the kernel's own time comes from
``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import os
import re
import sys

import numpy as np
import torch

from tpu_vp9_torch.ops import _build
from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.ops.loopfilter import sharpness_limits

MAX_CTAS, MAX_STAMPS = 1 << 14, 16
LVL = 28


def _stamped_source(src: str) -> str:
    """The kernel's source with the stamps: slot 0 at a CTA's start, 1
    after its load's barrier, 2 and up after each barrier of its levels,
    the last slot after its stores are issued."""
    src = src.replace(
        "namespace {\n",
        "namespace {\n__device__ long long lf_stamps[%d];\n"
        "#define LF_STAMP(i) if (threadIdx.x == 0) "
        "lf_stamps[blockIdx.x * %d + (i)] = clock64()\n"
        % (MAX_CTAS * MAX_STAMPS, MAX_STAMPS), 1)
    for head in ("void luma_levels(", "void chroma_levels("):
        start = src.index("{", src.index(head)) + 1
        end = src.index("\n}\n", start)
        body = re.sub(r"__syncthreads\(\);",
                      "__syncthreads(); LF_STAMP(lf_ph++);", src[start:end])
        src = src[:start] + "\n  int lf_ph = 2;" + body + src[end:]
    for head in ("void luma_cta(", "void chroma_cta("):
        start = src.index("{", src.index(head)) + 1
        end = src.index("\n}\n", start)
        body = src[start:end].replace("__syncthreads();",
                                      "__syncthreads(); LF_STAMP(1);", 1)
        src = (src[:start] + "\n  LF_STAMP(0);" + body
               + "\n  LF_STAMP(%d);" % (MAX_STAMPS - 1) + src[end:])
    return (src + '\nextern "C" int lf_read_stamps(void* host, int n) {\n'
            '  return (int)cudaMemcpyFromSymbol(host, lf_stamps, n * 8);\n'
            '}\n'
            'extern "C" int lf_clear_stamps() {\n'
            '  void* p;\n'
            '  cudaGetSymbolAddress(&p, lf_stamps);\n'
            '  return (int)cudaMemset(p, 0, sizeof(lf_stamps));\n'
            '}\n')


def _build_stamped(path: str):
    with open(path) as fh:
        src = _stamped_source(fh.read())
    lib, _ = _build.build_source(src, "lf_phases")
    lib.loop_filter_launch.argtypes = ([ctypes.c_void_p] * 8
                                       + [ctypes.c_int] * 8
                                       + [ctypes.c_void_p])
    lib.lf_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return lib


def main(argv) -> int:
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.utils.yuv import panning_frames

    if not torch.cuda.is_available():
        print("lf_phases: no CUDA device", file=sys.stderr)
        return 1
    path = argv[0] if argv else os.path.join(_build.CSRC, "loop_filter.cu")
    lib = _build_stamped(path)
    dev = torch.device("cuda", 0)
    w, h = 1920, 1080
    g = P.make_geom(w, h)
    frame = next(iter(panning_frames(w, h, 1, seed=1)))
    planes = []
    for k, plane in enumerate((frame.y, frame.u, frame.v)):
        ph, pw = (g.pad_h, g.pad_w) if k == 0 else (g.pad_h // 2,
                                                    g.pad_w // 2)
        pad = np.zeros((ph, pw), np.uint8)
        pad[:plane.shape[0], :plane.shape[1]] = plane
        planes.append(torch.from_numpy(pad).to(dev))
    lvl = LVL
    lim_t, mblim_t = sharpness_limits(0)
    lim, mblim = int(lim_t[lvl]), int(mblim_t[lvl])
    sc = P.step_scalars(40, 48, 100, lvl, lim, mblim, dev)
    rng = np.random.default_rng(1)
    mask = torch.from_numpy(rng.integers(0, 2, (g.rows32, g.cols32))
                            .astype(np.int32)).to(dev)
    n = g.pad_w // 64 * (g.pad_h // 64)
    print(f"lf_phases: {w}x{h}, lvl {lvl}, {torch.cuda.get_device_name(0)}")
    for split in (mask, None):
        outs = [torch.empty_like(p) for p in planes]
        for _ in range(3):  # the last launch's stamps are read
            lib.lf_clear_stamps()
            err = lib.loop_filter_launch(
                *(t.data_ptr() for t in planes + outs),
                None if split is None else split.data_ptr(), sc.data_ptr(),
                g.pad_h, g.pad_w, g.h_mi, g.w_mi, g.pad_h, g.rows32,
                g.cols32, K.LF_ALL_PARTS,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        torch.cuda.synchronize()
        want = P.loop_filter_ref(*planes, g, lvl, lim, mblim, split)
        if not all(torch.equal(a, b) for a, b in zip(outs, want)):
            raise AssertionError("the stamped kernel disagrees with "
                                 "loop_filter_ref")
        stamps = np.zeros(2 * n * MAX_STAMPS, np.int64)
        lib.lf_read_stamps(stamps.ctypes.data, stamps.size)
        stamps = stamps.reshape(2 * n, MAX_STAMPS)
        for kind, rows in (("chroma", stamps[:n]), ("luma", stamps[n:])):
            # CTAs grouped by their levels (with or without a band, a split
            # block around them)
            levels = (rows[:, 2:MAX_STAMPS - 1] > 0).sum(1)
            for nl in sorted(set(levels.tolist()), reverse=True):
                grp = rows[levels == nl]
                cols = [0, 1, *range(2, 2 + nl), MAX_STAMPS - 1]
                d = np.diff(grp[:, cols], axis=1)
                names = (["load"] + [f"level {i + 1}" for i in range(nl)]
                         + ["store"])
                shown = ", ".join(f"{nm} {int(np.median(d[:, i]))} "
                                  f"(max {int(d[:, i].max())})"
                                  for i, nm in enumerate(names))
                total = grp[:, -1] - grp[:, 0]
                print(f"{'mask' if split is not None else 'no mask'} {kind} "
                      f"CTAs with {nl} levels ({len(grp)}), SM cycles per "
                      f"phase, median (max): {shown}; a CTA "
                      f"{int(np.median(total))} (max {int(total.max())})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
