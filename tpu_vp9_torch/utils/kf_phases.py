"""Where one block of ``kframe_wave``'s chain spends its cycles, on the card.

    python3 -m tpu_vp9_torch.utils.kf_phases [path/to/kframe_wave.cu]

Builds a copy of the kernel's source (``csrc/kframe_wave.cu`` unless a
path is given) into ``tpu_vp9_torch/_build/`` with a ``clock64()`` stamp by
thread 0 at the top of each block's loop and after each of its CTA
barriers, runs it once on a 1080p panning frame at qp 40's qindex (held
against the plain version, bit for bit), and prints each phase's median
SM cycles over the blocks of rows and columns 1 and up, the time from the
last barrier of a block to the top of the next, and the block-to-block
time (row 0's beside it: no waits there). The stamps cost a global store
each; the kernel's own time comes from ``chip_smoke.py``.
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

# the phases between the loop's CTA barriers, in order
PHASES = ("wait and references", "filtered values", "SSEs", "mode, residual",
          "forward, quantizer", "inverse rows", "inverse columns")


def _stamped_source(src: str) -> str:
    src = src.replace('#include "txfm_common.cuh"',
                      '#include "txfm_common.cuh"\n'
                      '__device__ long long kf_stamps[1 << 18];', 1)
    loop = src.index("for (int c = 0; c < cols; ++c) {")
    end = src.index("Params make_params(")
    body = src[loop:end]
    count = [0]

    def stamp(_):
        count[0] += 1
        return ("__syncthreads();\n    if (tid == 0) kf_stamps[bi * 16 + %d]"
                " = clock64();" % count[0])

    body = re.sub(r"__syncthreads\(\);", stamp, body)
    if count[0] != len(PHASES):
        raise AssertionError(f"{count[0]} barriers in the loop, want "
                             f"{len(PHASES)}")
    body = body.replace(
        "const bool hl = c >= 1;",
        "const bool hl = c >= 1;\n    if (tid == 0) kf_stamps[bi * 16] = "
        "clock64();", 1)
    return (src[:loop] + body + src[end:]
            + '\nextern "C" int kf_read_stamps(void* host, int n) {\n'
              '  return (int)cudaMemcpyFromSymbol(host, kf_stamps, n * 8);\n'
              '}\n')


def main(argv) -> int:
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.pipeline.presets import qp_to_qindex
    from tpu_vp9_torch.utils.device import card_info, require_cuda
    from tpu_vp9_torch.utils.yuv import panning_frames

    require_cuda()
    print(card_info())
    path = argv[0] if argv else os.path.join(_build.CSRC, "kframe_wave.cu")
    with open(path) as fh:
        src = _stamped_source(fh.read())
    lib, report = _build.build_source(src, "kf_phases")
    print("\n".join(report))
    fn = lib.kframe_wave_launch
    fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    dev = torch.device("cuda", 0)
    w, h = 1920, 1080
    g = P.make_geom(w, h)
    fr = next(panning_frames(w, h, 1, seed=1))
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))
    ts = [torch.from_numpy(np.ascontiguousarray(
        P.pad_plane(np.asarray(p), *s))).to(dev)
        for p, s in zip((fr.y, fr.u, fr.v), shapes)]
    q = qp_to_qindex(40)
    dc_q, ac_q = T.dc_quant(q), T.ac_quant(q)
    lam = max(1, (ac_q * ac_q) >> 6)
    sc = P.step_scalars(dc_q, ac_q, lam, 0, 0, 0, dev)
    rows, cols = g.rows32, g.cols32
    mode, lvs, eob, recs = K.kf_outputs(g, dev)
    mats, tabs = K._kf_tables_on(dev)
    scratch = torch.zeros(1 + rows * cols * K.KF_EDGE_WORDS,
                          dtype=torch.int64, device=dev)
    ptrs = [t.data_ptr() for t in (*ts, *recs, mode, *lvs, eob, mats, tabs)]
    err = fn(*ptrs, scratch.data_ptr() + 8, scratch.data_ptr(),
             sc.data_ptr(), g.pad_w, g.height, rows, cols, K.KF_MAX_POLLS,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed with CUDA error {err}")
    torch.cuda.synchronize()
    K.kf_check_status(scratch.view(torch.int32)[1:2])
    got = (mode, *lvs, *eob.unbind(0), *recs)
    want = P.kframe_wave_ref(*ts, g, dc_q, ac_q, lam)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("the stamped kernel disagrees with the plain "
                             "version")
    n = rows * cols * 16
    buf = (ctypes.c_longlong * n)()
    if lib.kf_read_stamps(buf, n) != 0:
        raise RuntimeError("reading the stamps failed")
    a = np.array(buf, dtype=np.int64).reshape(rows, cols, 16)
    k = len(PHASES)
    d = np.diff(a[:, :, :k + 1], axis=2)[1:, 1:]
    print(f"kframe_wave at {w}x{h} qindex {q}, bit-equal to the plain "
          "version; SM cycles a block, median over rows and columns >= 1:")
    for i, name in enumerate(PHASES):
        print(f"  {name:22s} {np.median(d[..., i]):8.0f}")
    tail = a[:, 1:, 0] - a[:, :-1, k]
    step = a[:, 1:, 0] - a[:, :-1, 0]
    print(f"  {'rest of the block':22s} {np.median(tail):8.0f}")
    print(f"  {'block to block':22s} {np.median(step[1:]):8.0f} (row 0, "
          f"no waits: {np.median(step[0]):.0f})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
