"""Where ``openloop_modes`` spends its cycles, on the card.

    python3 -m tpu_vp9_torch.utils.ol_phases [--old PATH]

Builds a copy of the kernel's source (``csrc/openloop_modes.cu``) into
``tpu_vp9_torch/_build/`` with a ``clock64()`` stamp at the start of each
32x32 block's work, after each of its barriers (``__syncthreads`` in a
kernel with a CTA per block, thread 0 stamping; a kernel with a warp per
block stamps by each lane 0) and at its end, runs it on 2560x1440 and
1024x768 panning frames at qindex 120 (held against the plain version,
bit for bit) and prints each phase's median SM cycles over the blocks,
each phase named by the first line of its numbered comment in the source.
A copy without stamps is built too and its device time per launch
(profiler) printed at both sizes.

``--old`` does the same for an older source of the kernel with the
interface of its first form (it reads ``_kf_tables_on``'s words, not
``_ol_tables_on``'s); both are timed in turns in one process (old, the
tree's, the tree's, old). The stamps cost a global store each; the
kernel's own time comes from ``chip_smoke.py``.
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

DIMS = ((2560, 1440), (1024, 768))
QINDEX, MAX_STAMPS, REPS = 120, 8, 20


def _phase_names(src: str):
    return [m.group(1).strip() for m in
            re.finditer(r"^  // \d\. (.*)$", src, flags=re.M)]


def _stamped_source(src: str) -> str:
    """The kernel's source with the stamps: slot 0 once the block's index
    ``b`` is known, slot k after the kernel's k-th barrier, the last slot
    at its end."""
    start = src.index("{", src.index("openloop_modes_kernel(")) + 1
    end = src.index("\n}\n", start)
    body = src[start:end]
    blocks = max((h // 32) * (w // 32) for w, h in DIMS)
    # a CTA per block: thread 0 stamps; a warp per block: each lane 0
    who = ("threadIdx.x == 0" if "const int b = blockIdx.x;" in body
           else "(threadIdx.x & 31) == 0")
    count = [0]

    def stamp(i):
        return (f"if ({who} && b < {blocks}) ol_stamps[b * {MAX_STAMPS} + "
                f"{i}] = clock64();")

    def after(m):
        count[0] += 1
        return f"{m.group(0)}\n  {stamp(count[0])}"

    body = re.sub(r"__sync(threads|warp)\(\);", after, body)
    if not 0 < count[0] < MAX_STAMPS - 1:
        raise AssertionError(f"{count[0]} barriers in the kernel")
    body = re.sub(r"const int b = [^;]*;",
                  lambda m: f"{m.group(0)}\n  {stamp(0)}", body, count=1)
    body += f"\n  {stamp(count[0] + 1)}"
    src = (src[:start] + body + src[end:]
           + '\nextern "C" int ol_read_stamps(void* host, int n) {\n'
             '  return (int)cudaMemcpyFromSymbol(host, ol_stamps, n * 8);\n'
             '}\n')
    return src.replace(
        '#include "intra_pred.cuh"',
        '#include "intra_pred.cuh"\n'
        f'__device__ long long ol_stamps[{blocks * MAX_STAMPS}];', 1)


def _build_lib(src: str, name: str):
    lib, report = _build.build_source(src, name)
    fn = lib.openloop_modes_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn, report


class Source:
    """One source of the kernel: its stamped and plain builds, its table."""

    def __init__(self, label: str, path: str, old: bool, dev, tag: str):
        with open(path) as fh:
            src = fh.read()
        self.label, self.names = label, _phase_names(src)
        barriers = len(re.findall(r"__sync(?:threads|warp)\(\);", src))
        if len(self.names) != barriers + 1:
            raise AssertionError(f"{path}: want a numbered comment a phase, "
                                 f"one more than its {barriers} barriers")
        self.lib, self.fn, self.report = _build_lib(src, f"ol_{tag}")
        self.slib, self.sfn, _ = _build_lib(_stamped_source(src),
                                            f"ol_{tag}_stamped")
        self.tabs = (K._kf_tables_on(dev)[1] if old
                     else K._ol_tables_on(dev))
        ctas, smem = ctypes.c_int(0), ctypes.c_int(0)
        err = self.lib.openloop_modes_occupancy(ctypes.byref(ctas),
                                                ctypes.byref(smem))
        if err != 0:
            raise RuntimeError(f"occupancy query failed with {err}")
        self.ctas, self.smem = ctas.value, smem.value

    def run(self, fn, plane):
        h, w = plane.shape
        rows, cols = h // 32, w // 32
        b = rows * cols
        out = torch.empty(12 * b, dtype=torch.int32, device=plane.device)
        ptr = out.data_ptr()
        err = fn(plane.data_ptr(), self.tabs.data_ptr(), ptr, ptr + 8 * b,
                 ptr + 4 * b, w, rows, cols, K.openloop_lam(QINDEX),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.label}: launch failed with {err}")
        return (out[:b].reshape(rows, cols),
                out[2 * b:].reshape(rows, cols, 10),
                out[b:2 * b].reshape(rows, cols))


def main(argv) -> int:
    from tpu_vp9_torch.utils.device import card_info, device_ms, require_cuda
    from tpu_vp9_torch.utils.yuv import panning_frames

    require_cuda()
    print(card_info())
    dev = torch.device("cuda", 0)
    if argv and (len(argv) != 2 or argv[0] != "--old"):
        raise SystemExit(__doc__)
    sources = [Source(f"old ({argv[1]})", argv[1], True, dev, "old")
               ] if argv else []
    sources.append(Source("this tree's", os.path.join(
        _build.CSRC, "openloop_modes.cu"), False, dev, "tree"))
    planes = {(w, h): torch.from_numpy(np.ascontiguousarray(
        next(panning_frames(w, h, 1, seed=1)).y)).to(dev) for w, h in DIMS}
    for v in sources:
        print(f"{v.label} kernel: {'; '.join(v.report)}; {v.ctas} CTAs per "
              f"SM, {v.smem} B dynamic shared memory")
        for (w, h), plane in planes.items():
            want = K.openloop_modes_ref(plane, QINDEX)
            for fn in (v.fn, v.sfn):
                got = v.run(fn, plane)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{v.label} kernel disagrees with "
                                         f"the plain version at {w}x{h}")
        for w, h in DIMS:
            b = (h // 32) * (w // 32)
            buf = (ctypes.c_longlong * (b * MAX_STAMPS))()
            v.run(v.sfn, planes[(w, h)])
            torch.cuda.synchronize()
            if v.slib.ol_read_stamps(buf, b * MAX_STAMPS) != 0:
                raise RuntimeError("reading the stamps failed")
            a = np.array(buf, dtype=np.int64).reshape(b, MAX_STAMPS)
            k = len(v.names)
            d = np.diff(a[:, :k + 1], axis=1)
            print(f"{v.label} kernel at {w}x{h} qindex {QINDEX}, bit-equal "
                  "to the plain version (both builds, both sizes); SM cycles "
                  f"a block, median over {b} blocks:")
            for i, name in enumerate(v.names):
                print(f"  {i + 1}. {name[:60]:60s} "
                      f"{np.median(d[:, i]):8.0f}")
            print(f"  {'the block, start to end':63s} "
                  f"{np.median(a[:, k] - a[:, 0]):8.0f}")
    order = sources + sources[::-1]
    times = {}
    for v in order:
        for (w, h), plane in planes.items():
            ms = device_ms(lambda v=v, p=plane: v.run(v.fn, p),
                           "openloop_modes_kernel", REPS)
            if ms is None:
                raise RuntimeError("the profiler recorded no launch of the "
                                   "kernel")
            times.setdefault((v.label, w, h), []).append(ms)
    for (label, w, h), ms in times.items():
        print(f"{label} kernel at {w}x{h} (B={(h // 32) * (w // 32)}): "
              f"device {', '.join(f'{t:.4f}' for t in ms)} ms per launch "
              f"(profiler, {REPS} launches each, in turns)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
