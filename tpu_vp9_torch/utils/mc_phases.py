"""Where ``mc_predict`` spends its cycles, on the card.

    python3 -m tpu_vp9_torch.utils.mc_phases [--other PATH]

Builds a copy of the kernel's source (``csrc/mc_predict.cu``) into
``tpu_vp9_torch/_build/`` with a ``clock64()`` stamp at the start of each
block-plane's work, after each of its warp's barriers (``__syncwarp``,
lane 0 stamping) and at its end, runs it at three shapes of the 1080p
step on the planes of panning_frames(1920, 1080, 3, seed=1) (the zone,
B=2040 n=32 with LAST, GOLDEN and ALTREF by ref_sel; the M8 children,
B=2040 n=16 in 510 parents' windows; the RA children, B=8160 n=16 in
every parent's), MVs made up within +-(WIN_R + 0.75) pel, held against the
plain version bit for bit, and prints each phase's median SM cycles over
the luma warps and over the chroma warps, each phase named by the first
line of its numbered comment in the source. A copy without stamps is
built too and its device time per launch (profiler) printed at each
shape.

``--other`` builds another source of the kernel with this tree's
interface the same ways; the two are held against the plain version and
timed in turns in one process (the tree's, the other, the other, the
tree's). The stamps cost a global store each; the kernel's own time
comes from ``chip_smoke.py``.
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

MAX_STAMPS, MAX_BLOCKS, REPS = 8, 8160, 20
N_INTS = K._LAUNCHERS["mc_predict"][4]


def _phase_names(src: str):
    return [m.group(1).strip() for m in
            re.finditer(r"^  // \d\. (.*)$", src, flags=re.M)]


def _stamped_source(src: str) -> str:
    """The source with the stamps in ``predict``: slot 0 at its start,
    slot k after its k-th ``__syncwarp``, the last slot at its end; slot
    (plane, block) by lane 0."""
    head = src.index("__device__ __forceinline__ void predict(")
    start = src.index("{", head) + 1
    end = src.index("\n}\n", start)
    body = src[start:end]
    count = [0]

    def stamp(i):
        return (f"if (lane == 0) mc_stamps[(p * {MAX_BLOCKS} + b) * "
                f"{MAX_STAMPS} + {i}] = clock64();")

    def after(m):
        count[0] += 1
        return f"{m.group(0)}\n  {stamp(count[0])}"

    body = re.sub(r"__syncwarp\(\);", after, body)
    if not 0 < count[0] < MAX_STAMPS - 1:
        raise AssertionError(f"{count[0]} barriers in predict")
    body = f"\n  {stamp(0)}" + body + f"\n  {stamp(count[0] + 1)}"
    src = (src[:start] + body + src[end:]
           + '\nextern "C" int mc_read_stamps(void* host, int n) {\n'
             '  return (int)cudaMemcpyFromSymbol(host, mc_stamps, n * 8);\n'
             '}\n')
    return src.replace(
        '#include "convolve8.cuh"',
        '#include "convolve8.cuh"\n'
        f'__device__ long long mc_stamps[{3 * MAX_BLOCKS * MAX_STAMPS}];', 1)


class Source:
    """One source of the kernel: its stamped and plain builds."""

    def __init__(self, label: str, path: str, tag: str):
        with open(path) as fh:
            src = fh.read()
        self.label, self.names = label, _phase_names(src)
        head = src.index("__device__ __forceinline__ void predict(")
        barriers = src.count("__syncwarp();", head)
        if len(self.names) != barriers + 1:
            raise AssertionError(f"{path}: want a numbered comment a phase, "
                                 f"one more than its {barriers} barriers")
        self.lib, self.fn, self.report = self._build(src, f"mc_{tag}")
        self.slib, self.sfn, _ = self._build(_stamped_source(src),
                                             f"mc_{tag}_stamped")

    @staticmethod
    def _build(src, name):
        lib, report = _build.build_source(src, name)
        fn = lib.mc_predict_launch
        fn.argtypes = ([ctypes.c_void_p] * 21 + [ctypes.c_int] * N_INTS
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        return lib, fn, report

    def run(self, fn, case):
        """The launch of ``case`` (the arguments of the step's dispatch,
        the pipeline's ``mc_predict``) through ``fn``: (pred_y, pred_u,
        pred_v)."""
        from tpu_vp9_torch.pipeline import tpu_encdec as P

        planes, pos_y, pos_x, mv_r, mv_c, n, mi_rows, mi_cols, _, grid, \
            kw = case
        b, nc = pos_y.shape[0], n // 2
        dev = pos_y.device
        rows, cols, *specs = P.mc_window_grid(
            tuple(tuple(t.shape) for t in planes[0]), tuple(grid))
        outs = (torch.empty((b, n, n), dtype=torch.uint8, device=dev),
                torch.empty((b, nc, nc), dtype=torch.uint8, device=dev),
                torch.empty((b, nc, nc), dtype=torch.uint8, device=dev))
        refs = list(planes) + [None] * (3 - len(planes))
        ptrs = [None if ref is None else ref[p].data_ptr()
                for p in range(3) for ref in refs]
        opt = [None if kw.get(k) is None else kw[k].data_ptr()
               for k in ("ref_sel", "win_idx", "org_off_y", "org_off_x")]
        err = fn(*ptrs, *opt[:2], pos_y.data_ptr(), pos_x.data_ptr(),
                 mv_r.data_ptr(), mv_c.data_ptr(), *opt[2:],
                 K._mc_taps_on(dev).data_ptr(),
                 *(o.data_ptr() for o in outs), b, n, rows, cols,
                 *(v for spec in specs for v in spec), K.WIN_R,
                 K.CHROMA_WIN_R,
                 *(planes[0][p].shape[1] for p in range(3)), mi_rows,
                 mi_cols, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.label}: launch failed with {err}")
        return outs


def _cases(dev):
    """{label: the dispatch's arguments and keywords} at the 1080p step's
    three shapes."""
    from tpu_vp9_torch.pipeline import realtime, tpu_encdec as P
    from tpu_vp9_torch.utils.yuv import panning_frames

    g = P.make_geom(1920, 1080)
    rng = np.random.default_rng(7)
    refs = [tuple(realtime.upload_refs(
        [np.asarray(p) for p in (f.y, f.u, f.v)], g, dev))
        for f in panning_frames(1920, 1080, 3, seed=1)]
    filters = torch.as_tensor(np.asarray(P.FILTERS, np.int32)).to(dev)
    edge = P.WIN_R * 8 + 6

    def on(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    b = g.n_blocks32
    grid = (32, 0, g.rows32, g.cols32)
    pos_y = np.repeat(np.arange(g.rows32) * 32, g.cols32)
    pos_x = np.tile(np.arange(g.cols32) * 32, g.rows32)
    mv = rng.integers(-edge, edge + 1, (2, b))
    cases = {"zone B=2040 n=32, LAST GOLDEN ALTREF": (
        refs, on(pos_y), on(pos_x), on(mv[0]), on(mv[1]), 32, g.mi_rows,
        g.mi_cols, filters, grid,
        {"ref_sel": on(rng.integers(0, 3, b), torch.int8)})}
    ii, jj = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
    for label, sel in (("M8 children B=2040 n=16",
                        np.sort(rng.choice(b, b // 4, replace=False))),
                       ("RA children B=8160 n=16", np.arange(b))):
        k = sel.size
        cmv = rng.integers(-edge + 128, edge - 127, (2, 4 * k))
        kw = {"win_idx": on(np.repeat(sel, 4)),
              "org_off_y": on(np.tile(16 * ii, k)),
              "org_off_x": on(np.tile(16 * jj, k))}
        cases[label] = (
            refs[:1], on((pos_y[sel][:, None] + 16 * ii).reshape(-1)),
            on((pos_x[sel][:, None] + 16 * jj).reshape(-1)), on(cmv[0]),
            on(cmv[1]), 16, g.mi_rows, g.mi_cols, filters, grid, kw)
    return cases


def main(argv) -> int:
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.utils.device import card_info, device_ms, require_cuda

    require_cuda()
    print(card_info())
    dev = torch.device("cuda", 0)
    if argv and (len(argv) != 2 or argv[0] != "--other"):
        raise SystemExit(__doc__)
    sources = [Source("this tree's", os.path.join(_build.CSRC,
                                                  "mc_predict.cu"), "tree")]
    if argv:
        sources.append(Source(f"other ({argv[1]})", argv[1], "other"))
    cases = _cases(dev)
    for v in sources:
        print(f"{v.label} kernel: {'; '.join(v.report)}")
        for label, case in cases.items():
            want = P.mc_predict_planes_ref(*case[:10], **case[10])
            for fn in (v.fn, v.sfn):
                got = v.run(fn, case)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{v.label} kernel disagrees with "
                                         f"the plain version on {label}")
            b = case[1].shape[0]
            buf = (ctypes.c_longlong * (3 * MAX_BLOCKS * MAX_STAMPS))()
            v.run(v.sfn, case)
            torch.cuda.synchronize()
            if v.slib.mc_read_stamps(buf, 3 * MAX_BLOCKS * MAX_STAMPS) != 0:
                raise RuntimeError("reading the stamps failed")
            a = np.array(buf, dtype=np.int64).reshape(3, MAX_BLOCKS,
                                                      MAX_STAMPS)[:, :b]
            k = len(v.names)
            print(f"{v.label} kernel, {label}, bit-equal to the plain "
                  "version (both builds); SM cycles a warp's block-plane, "
                  f"median over {b} luma / {2 * b} chroma warps:")
            for name, sel in (("luma", a[:1]), ("chroma", a[1:])):
                d = np.diff(sel[..., :k + 1], axis=-1).reshape(-1, k)
                whole = (sel[..., k] - sel[..., 0]).reshape(-1)
                print(f"  {name}: " + "; ".join(
                    f"{i + 1}. {nm[:40]} {np.median(d[:, i]):.0f}"
                    for i, nm in enumerate(v.names))
                    + f"; start to end {np.median(whole):.0f}")
    order = sources + sources[::-1]
    times = {}
    for v in order:
        for label, case in cases.items():
            ms = device_ms(lambda v=v, c=case: v.run(v.fn, c),
                           "mc_predict_kernel", REPS)
            if ms is None:
                raise RuntimeError("the profiler recorded no launch of the "
                                   "kernel")
            times.setdefault((v.label, label), []).append(ms)
    for (src, label), ms in times.items():
        print(f"{src} kernel, {label}: device "
              f"{', '.join(f'{t:.4f}' for t in ms)} ms per launch "
              f"(profiler, {REPS} launches each, in turns)")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
