"""Smoke run of the tpu_vp9_torch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. the card, the software, and the build of every kernel (one nvcc per
     source, all started together) and of the native host library;
  2. kernels: first a keyframe and an M8 P-frame of the clip through the
     public encoder, the real inputs of the step's loop filter, transform
     and quarter-pel calls recorded; then sad_full_search, block_energy
     (on blocks and positioned, block_energy_at), sse_map_search (one
     level, and both levels fused, hier_search_fused), subpel_search,
     transform_recon, kframe_wave and loop_filter against their plain
     PyTorch versions on the card, bit for bit, at the shapes the 1080p
     paths give them (the M8 children's included), ties, negative minima
     and the largest operands included; subpel_search on the zone's and
     the children's real windows, on windows where all 49 offsets tie, at
     the largest SSE, on 0/255 checkerboards and with winners at +-r;
     transform_recon at its four path shapes on the step's real blocks,
     on source against the previous recon, on +-255 and zero residuals
     and on one nonzero level at each scan place, at four qindex values
     (the 8191 level clip reached), its level flips counted, after the
     ptxas report of each of its template instances (registers, spills,
     which fail the run, static shared memory) and its resident CTAs per
     SM from the CUDA runtime's occupancy query; kframe_wave
     on the first
     panning frame at four qindex values, on patches that make every intra
     mode win (the blocks each mode won printed), on a constant frame whose
     tied modes must all go to the first, on 0/255 blocks at qindex 0 (the
     8191 level clip) and at small geometries, with its chain (93 times
     its own one-block latency);
     loop_filter on made-up planes that reach every class of the edge
     filter (the lanes of each class counted by the plain version and
     printed), without a split mask, with a random one and with all ones,
     at three levels, at small geometries, and on the unfiltered recon,
     mask and level of the real keyframe and M8 P-frame; txq_cost on
     made-up residuals within its tolerance; each timed per call with CUDA
     events and on the host clock, and per launch with the profiler;
  3. M8 end to end: a 1920x1080 M8 low-delay CQP encode (the device
     keyframe, rate tables, the GOLDEN anchor, the 32-against-16 descent)
     through the public Vp9Encoder; the keyframe must launch kframe_wave
     once per anti-diagonal (93) and loop_filter once; per P-frame the
     search entry points must launch twice (hier_search_fused, then
     sse_map_search for the children), subpel_search twice,
     transform_recon 6 times, the block_energy ones 5 times and
     loop_filter once; some parents must split; the stream must decode with
     the port's decoder to the encoder's own recon across two GOLDEN
     refreshes; fps, step time, the host-clock stage split and the send
     split by the spans rt_device_step, rt_stage, rt_rate_args,
     api_scene_cut, api_frame_qindex and rt_d2h_transfer. Inside the
     same counted window txq_cost runs at its own entry point on every
     P-frame's residual (source minus the previous frame's recon), at
     n=32 and n=16;
  4. txq_cost against its plain version on those residuals (B=2040 n=32,
     B=8160 n=16), within the stated tolerance, flipped blocks counted;
  5. M8 profile: three steady P-frames under torch.profiler, for the share
     of their time the device is busy, the top device operations, and
     each stage's device time (its PyTorch ops' from the profiler's
     ranges, plus its hand kernels', which the ranges leave out);
  6. keyframes: four 1080p device keyframes through RtSession, decoded,
     with the send time split by the spans kf_device_step, kf_d2h_transfer
     and kf_serialize, and one more under the profiler;
  7. M8 same bytes: the first frames again with device="cpu" (the plain
     versions) must give identical packets;
  8. M9 (the uniform 32 grid): end to end on the first frames of the same
     clip, profile and same bytes, as before, at a smaller depth;
  9. M7 (the host encode with the device full-pel search): end to end,
     profile and same bytes, as before.
Before the last line it prints one JSON object of the kernels; the last
line is {"ok": true, "device": {...}}. Without a CUDA card it exits
nonzero before printing any result. jax and the JAX package tpu_vp9 are
blocked from being imported: the port stands alone.

    python3 chip_smoke.py --kernels

stops after phase 2 (a short first run of a changed kernel; one keyframe
and one P-frame are encoded for loop_filter's real input) and prints
neither JSON line.
"""

from __future__ import annotations

import contextlib
import io
import json
import statistics
import sys
import time


class _PortOnly:
    """Import hook: the port must run where jax is absent, and must not
    reach into the JAX package."""

    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "tpu_vp9") or name.startswith(
                ("jax.", "jaxlib", "tpu_vp9.")):
            raise ImportError(f"chip_smoke: the port must not import {name}")
        return None


sys.meta_path.insert(0, _PortOnly())

import numpy as np  # noqa: E402
import torch  # noqa: E402

WIDTH, HEIGHT, QP = 1920, 1080, 40
M8_FRAMES, M9_FRAMES, M7_FRAMES, CPU_FRAMES = 20, 10, 4, 3
LIBS = ("sad_search", "block_energy", "sse_search", "txq_cost",
        "loop_filter", "kframe_wave", "transform_recon", "subpel_search")
# main-path shapes at 1080p. M7 searches 32x32 blocks at range 16 over
# the 33 whole block rows; the realtime step's 32-grid has 34 rows (the
# last overhangs the picture by 8 pixels) of 60 blocks; M8 descends a
# quarter of them, so it has as many 16x16 children as 32x32 parents
SAD_B, SAD_N, SAD_R = 33 * 60, 32, 16
M9_B = 34 * 60
# launches per P-frame of the step, by wrapper. M8: the fused two-level
# search of the 32 zone and the children's search; the recon distortion of
# the 32 zone and of the children (block_energy); the 32 zone's ZERO SSE,
# GOLDEN's ZERO and previous-MV SSE in one launch, and the children's ZERO
# SSE (block_energy_at): 2 search and 5 energy launches; the quarter-pel
# search of the zone and of the children; the transform of the zone's Y32,
# U16 and V16 and of the children's Y16, U8 and V8; the loop filter of all
# three planes, split mask included, is one launch. M9: the fused search,
# ZERO SSE, quarter-pel, the zone's three transforms, recon distortion and
# the loop filter (no mask).
M8_LAUNCHES = {"hier_search_fused": 1, "sse_map_search": 1,
               "block_energy": 2, "block_energy_at": 3, "txq_cost": 2,
               "loop_filter": 1, "transform_recon": 6, "subpel_search": 2}
M9_LAUNCHES = {"hier_search_fused": 1, "sse_map_search": 0,
               "block_energy": 1, "block_energy_at": 1, "txq_cost": 0,
               "loop_filter": 1, "transform_recon": 3, "subpel_search": 1}
# launches per keyframe (M8 and M9 alike): one kframe_wave per
# anti-diagonal of the 34 x 60 grid, and the loop filter of the three planes
KF_DIAGONALS = 34 + 60 - 1
KEY_LAUNCHES = {"kframe_wave": KF_DIAGONALS, "loop_filter": 1}
# the wrappers that launch kernels of one source, by the kernel's name in
# the JSON line
ENTRY_WRAPPERS = {"sad_full_search": ("sad_full_search",),
                  "block_energy": ("block_energy", "block_energy_at"),
                  "sse_map_search": ("sse_map_search", "hier_search_fused"),
                  "txq_cost": ("txq_cost",),
                  "loop_filter": ("loop_filter",),
                  "kframe_wave": ("kframe_wave",),
                  "transform_recon": ("transform_recon",),
                  "subpel_search": ("subpel_search",)}
# each wrapper's kernel, by a part of its name in a profile
WRAPPER_KERNELS = {"sad_full_search": "sad_search_kernel",
                   "block_energy": "block_energy_kernel",
                   "block_energy_at": "block_energy_at_kernel",
                   "sse_map_search": "sse_search_kernel",
                   "hier_search_fused": "hier_search_kernel",
                   "txq_cost": "txq_cost_kernel",
                   "loop_filter": "loop_filter_kernel",
                   "kframe_wave": "kframe_wave_kernel",
                   "transform_recon": "transform_recon_kernel",
                   "subpel_search": "subpel_search_kernel"}
# loop_filter: levels with thresh 0 and 3 (and 0: copies), the small
# geometries of the CPU tests (the last no wider than 64: no band), and
# integer operations per filtered edge lane (an upper estimate: 16 loads,
# the masks, filter16's sums and stores)
LF_LEVELS = (0, 9, 50)
LF_SMALL_DIMS = ((128, 128), (192, 120), (160, 96), (96, 64), (64, 64))
LF_OPS_PER_LANE = 100
# published peaks of one H100 SXM (NVIDIA's data sheet, dense): HBM bytes/s
# and operations/s by the type of the operands.
# INT8: sums of products of 8-bit integers, which the tensor cores take
# (sse_map_search on uint8 pixels).
# ALU: float32 work outside the tensor cores (txq_cost, whose function is
# defined in float32), and integer work the tensor cores cannot take: the
# half-res search's operands are sums of four pixels and need 10 bits, and
# |a - b| (sad_full_search, block_energy's SAD) is no product. The data
# sheet gives no other rate off the tensor cores.
HBM_BYTES_PER_S, INT8_OPS_PER_S, ALU_OPS_PER_S = 3.35e12, 1979e12, 67e12
# FP64: float64 work at the data sheet's highest float64 rate (its tensor
# cores', where transform_recon's forward products run), and its rate on
# the CUDA cores (kframe_wave's forward transform runs there; the bounds
# are held against the former)
FP64_OPS_PER_S, FP64_CORE_OPS_PER_S = 67e12, 34e12
# kframe_wave per 32x32 block and its two 16x16 chroma blocks: the float64
# operations of the forward transform (two products a plane, a multiply and
# an add per term) and an estimate of the integer ones: 8 a pixel for each
# of the 10 luma predictions and its SSE, 8 a pixel for the chosen mode's
# three planes, 10 a coefficient to quantize and dequantize, about 500 an
# idct32 line (64) and 200 an idct16 line (64), 4 a pixel for the recon
KF_FP64_OPS = 2 * (2 * 32 ** 3 + 2 * 2 * 16 ** 3)
KF_INT_OPS = (8 * 10 * 1024 + 8 * 1536 + 10 * 1536 + 500 * 64 + 200 * 64
              + 4 * 1536)
# kframe_wave's phase: the quantizer indices (0: the 8191 level clip is
# reached), the mode patches' size, and the small geometries of the CPU
# tests (32x32: one block, one launch; its time is one block's latency)
KF_QINDICES = (10, 100, 255)
KF_SMALL_DIMS = ((128, 96), (160, 120), (96, 64), (64, 64), (192, 120),
                 (32, 32))
# txq_cost's stated tolerance (ops/cuda_kernels.py:txq_cost)
TXQ_RTOL, TXQ_ATOL, TXQ_BAND, TXQ_MAX_FLIPPED = 1e-4, 1e-3, 1e-3, 0.01
# transform_recon: the qindex values of its phase (0: the 8191 level clip),
# the one at which each scan place gets a lone nonzero level (LONE_LEVEL, 4
# at DC), and the band around a rounding boundary where a level may differ
# from the plain version's (the float64 products sum in another order)
TR_QINDICES = (0, 10, 100, 255)
TR_LONE_QINDEX, TR_LONE_LEVEL = 60, 20
TR_FLIP_BAND = 1e-9
# its path's calls per M8 P-frame, in the step's order: the zone's Y, U, V,
# then the children's U, V, Y; and the shapes timed (label, the call's
# index, its launches per P-frame): one launch of each distinct shape, the
# zone's U standing for both its chroma planes and the children's U for
# theirs
TR_CALLS = ("zone Y", "zone U", "zone V", "children U", "children V",
            "children Y")
TR_TIMED = (("zone Y", 0, 1), ("zone U, V", 1, 2), ("children Y", 5, 1),
            ("children U, V", 3, 2))
# integer operations per block besides the float64 transform (an upper
# estimate: the inverse's lines, about 500 an idct32 line, 200 an idct16
# one and 60 an idct8 one, two passes; 16 a pixel for the residual,
# quantizer, dequantizer, eob and recon)
TR_INT_OPS = {32: 500 * 64 + 16 * 1024, 16: 200 * 32 + 16 * 256,
              8: 60 * 16 + 16 * 64}
# subpel_search's path calls per M8 P-frame: the zone's, then the children's
SP_CALLS = ("zone n=32 r=4", "children n=16 r=8")


def _bound(nbytes: float, ops: float, ops_per_s: float):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` (each input read once, each output written once) or
    to do ``ops`` operations at the peak for their operands' type,
    whichever is larger."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1000 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def _sum_bounds(parts):
    """Sum of (count, (ms, by)) bounds; bound_by is that of the larger
    share."""
    total = sum(c * ms for c, (ms, _) in parts)
    by = {}
    for c, (ms, kind) in parts:
        by[kind] = by.get(kind, 0.0) + c * ms
    return total, max(by, key=by.get)


def _cuda_time_ms(fn, reps: int) -> float:
    """Median of per-call device times from CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _max_err(got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        if (g is None) != (w is None):
            raise AssertionError("kernel and plain version disagree on "
                                 "which outputs exist")
        if g is not None:
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def _check(name, label, got, want):
    torch.cuda.synchronize()
    err = _max_err(got, want)
    print(f"kernel {name} [{label}]: max_abs_err={err}")
    if err != 0:
        raise AssertionError(f"{name} disagrees with its plain version on "
                             f"{label}")
    return err


def _device_ms(fn, kernel_key: str, reps: int = 20):
    """Device time per launch of the kernels whose name contains
    ``kernel_key`` over ``reps`` calls of ``fn``, from torch.profiler; None
    if the profiler recorded none in three tries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # a profile now and then records no device event
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and kernel_key in e.key
                  and e.self_device_time_total > 0]
        if events:
            return (sum(e.self_device_time_total for e in events) / 1e3
                    / sum(e.count for e in events))
    return None


def _host_ms(fn, reps: int = 1000) -> float:
    """Host-clock time per call of the wrapper: ``reps`` calls back to
    back without waiting for the device, then one synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1000 * host / reps


def _timed(name, label, kernel_fn, plain_fn, plain_reps, bound, kernel_key,
           count=1):
    """One shape's part of a kernel's entry: (launches of this shape per
    P-frame, label, call ms, plain ms, bound, device ms or None, host ms).
    Call time is the median of CUDA-event times around one call, wrapper
    included; device time is the kernel's own per launch (profiler); host
    time is what the wrapper costs the host per call."""
    ms = _cuda_time_ms(kernel_fn, 50)
    plain_ms = _cuda_time_ms(plain_fn, plain_reps)
    device_ms = _device_ms(kernel_fn, kernel_key)
    host_ms = _host_ms(kernel_fn)
    shown = "not measured" if device_ms is None else f"{device_ms:.4f} ms"
    print(f"kernel {name} {label}: call {ms:.4f} ms (CUDA events, median), "
          f"device {shown} per launch (profiler), host {host_ms:.4f} ms per "
          f"call (1000 back to back); plain {plain_ms:.4f} ms; bound "
          f"{bound[0]:.5f} ms by {bound[1]}")
    return (count, label, ms, plain_ms, bound, device_ms, host_ms)


def _entry(name, source, replaces, max_err, parts):
    """One kernel's line of the JSON from the parts ``_timed`` returns: the
    times are summed over one P-frame's launches on the kernel's main
    path. The bound is to be held against ``device_ms``; the path pays
    ``ms``. No single PyTorch call computes any of these functions, so
    library_ms is null."""
    parts = [p for p in parts if p[0] > 0]
    bound_ms, bound_by = _sum_bounds([(p[0], p[4]) for p in parts])
    measured = all(p[5] is not None for p in parts)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": max_err,
            "ms": sum(p[0] * p[2] for p in parts),
            "plain_ms": sum(p[0] * p[3] for p in parts),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "device_ms": (sum(p[0] * p[5] for p in parts) if measured
                          else None),
            "host_ms": sum(p[0] * p[6] for p in parts),
            "parts": [{"shape": p[1], "per_frame": p[0], "ms": p[2],
                       "device_ms": p[5], "host_ms": p[6],
                       "bound_ms": p[4][0]} for p in parts]}


def _sad_inputs(b, n, r, seed):
    rng = np.random.default_rng(seed)
    win = n + 2 * r
    blocks = rng.integers(0, 256, (b, n, n), dtype=np.uint8)
    regions = rng.integers(0, 256, (b, win, win), dtype=np.uint8)
    # planted exact matches at seeded displacements in every other block
    for i in range(0, b, 2):
        oy, ox = rng.integers(0, 2 * r + 1, 2)
        regions[i, oy:oy + n, ox:ox + n] = blocks[i]
    return blocks, regions


def sad_kernel_phase(dev):
    """sad_full_search (CUDA) against sad_full_search_ref on the card."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    cases = []
    blocks, regions = _sad_inputs(SAD_B, SAD_N, SAD_R, seed=0)
    cases.append(("random+planted", SAD_N, SAD_R, blocks, regions))
    # every candidate ties: the first in dy-major order, (-r, -r), wins
    win = SAD_N + 2 * SAD_R
    cases.append(("constant tie", SAD_N, SAD_R,
                  np.full((SAD_B, SAD_N, SAD_N), 99, np.uint8),
                  np.full((SAD_B, win, win), 99, np.uint8)))
    for n, r in ((16, 4), (64, 16)):
        blocks, regions = _sad_inputs(512, n, r, seed=n + r)
        cases.append((f"random n={n} r={r}", n, r, blocks, regions))
    max_err = 0
    part = None
    for label, n, r, blocks, regions in cases:
        src = torch.from_numpy(blocks).to(dev)
        reg = torch.from_numpy(regions).to(dev)
        got = K.sad_full_search(src, reg, n, r)
        max_err = max(max_err, _check(
            "sad_full_search", f"{label} B={src.shape[0]} n={n} r={r}", got,
            K.sad_full_search_ref(src, reg, n, r)))
        if label == "constant tie":
            if not (bool((got[0] == -r).all()) and bool((got[1] == -r).all())):
                raise AssertionError("sad_full_search: tie did not go to "
                                     "(-r, -r)")
        if part is None:  # the main path's shape
            b, d = src.shape[0], 2 * r + 1
            # reads blocks and regions, writes three int32 per block; two
            # integer operations (|a - b|, add) per candidate pixel
            bound = _bound(b * (n * n + (n + 2 * r) ** 2) + 12 * b,
                           2 * b * d * d * n * n, ALU_OPS_PER_S)
            part = _timed(
                "sad_full_search", f"B={b} n={n} r={r}",
                lambda: K.sad_full_search(src, reg, n, r),
                lambda: K.sad_full_search_ref(src, reg, n, r), 5, bound,
                "sad_search_kernel")
    return _entry("sad_full_search", "tpu_vp9_torch/csrc/sad_search.cu",
                  "tpu_vp9/ops/pallas_kernels.py:76", max_err, [part])


def _energy_at_inputs(n, c, seed):
    """A border-extended 1080p luma plane, source blocks and (c, B) starts
    for B = 2040 blocks: the grid positions (set 0, as the ZERO candidate)
    and seeded starts anywhere in the plane at any alignment (the others),
    with blocks in all four corners and one copied out of the plane at an
    odd start (zero energy)."""
    rng = np.random.default_rng(seed)
    hh, ww = 1088 + 192, WIDTH + 192
    plane = rng.integers(0, 256, (hh, ww), dtype=np.uint8)
    src = rng.integers(0, 256, (M9_B, n, n), dtype=np.uint8)
    cols = WIDTH // n
    idx = np.arange(M9_B)
    y0 = np.empty((c, M9_B), np.int32)
    x0 = np.empty((c, M9_B), np.int32)
    y0[0] = np.minimum(96 + (idx // cols) * n, hh - n)
    x0[0] = 96 + (idx % cols) * n
    y0[1:] = rng.integers(0, hh - n + 1, (c - 1, M9_B))
    x0[1:] = rng.integers(0, ww - n + 1, (c - 1, M9_B))
    last = c - 1
    for i, (y, x) in enumerate(((0, 0), (0, ww - n), (hh - n, 0),
                                (hh - n, ww - n), (hh - n, ww - n - 1),
                                (1, 1), (2, 3))):
        y0[last, i], x0[last, i] = y, x
    y0[last, 7], x0[last, 7] = 101, 203
    src[7] = plane[101:101 + n, 203:203 + n]
    return plane, src, y0, x0


def energy_kernel_phase(dev):
    """block_energy and block_energy_at (CUDA) against their plain
    versions at B=2040, n=32 (the 32 zone) and n=16 (the M8 children)."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    rng = np.random.default_rng(3)
    max_err = 0
    parts = []
    for n, per_frame in ((32, 1), (16, 1), (8, 0), (64, 0)):
        b = M9_B if per_frame else 256
        src = rng.integers(0, 256, (b, n, n), dtype=np.uint8)
        pred = np.clip(src.astype(np.int32) + rng.integers(-40, 41, src.shape),
                       0, 255).astype(np.uint8)
        pred[0] = src[0]  # zero energy
        src[1], pred[1] = 0, 255  # the largest energy of a block
        pred[2] = rng.integers(0, 256, (n, n), dtype=np.uint8)  # unrelated
        s = torch.from_numpy(src).to(dev)
        p = torch.from_numpy(pred).to(dev)
        max_err = max(max_err, _check(
            "block_energy", f"B={b} n={n}", K.block_energy(s, p, n),
            K.block_energy_ref(s, p, n)))
        if per_frame:
            # reads both blocks, writes two int32 per block; subtract,
            # square or abs, add, twice over per pixel
            bound = _bound(2 * b * n * n + 8 * b, 5 * b * n * n,
                           ALU_OPS_PER_S)
            parts.append(_timed(
                "block_energy", f"blocks B={b} n={n}",
                lambda: K.block_energy(s, p, n),
                lambda: K.block_energy_ref(s, p, n), 20, bound,
                "block_energy_kernel", per_frame))
    # positioned: the 32 zone's ZERO (C=1), GOLDEN's ZERO and previous MV
    # (C=2), the children's ZERO (n=16, C=1); other sizes checked only
    K.CHECK_STARTS = True  # the checks below also run the starts' check
    for n, c, per_frame in ((32, 1, 1), (32, 2, 1), (16, 1, 1), (16, 3, 0),
                            (8, 2, 0), (64, 2, 0)):
        plane_np, src_np, y0_np, x0_np = _energy_at_inputs(n, max(c, 2),
                                                           seed=n + c)
        plane = torch.from_numpy(plane_np).to(dev)
        s = torch.from_numpy(src_np).to(dev)
        # C=1 is timed on the grid (the ZERO candidate) and checked on the
        # seeded starts as well
        for rows in ([max(c, 2) - 1], [0]) if c == 1 else (list(range(c)),):
            y0 = torch.from_numpy(y0_np[rows]).to(dev)
            x0 = torch.from_numpy(x0_np[rows]).to(dev)
            got = K.block_energy_at(s, plane, y0, x0, n)
            max_err = max(max_err, _check(
                "block_energy_at", f"B={M9_B} n={n} C={len(rows)} sets "
                f"{rows}", got, K.block_energy_at_ref(s, plane, y0, x0, n)))
            if rows[-1] != 0 and int(got[0][-1, 7]) != 0:
                raise AssertionError("block_energy_at: the copied block has "
                                     "energy")
        # a view of a wider plane: the pitch is not the width
        wide = torch.from_numpy(np.pad(plane_np, ((0, 0), (0, 20)))).to(dev)
        view = wide[:, :plane_np.shape[1]]
        max_err = max(max_err, _check(
            "block_energy_at", f"n={n} C={y0.shape[0]} pitch "
            f"{view.stride(0)} != width {view.shape[1]}",
            K.block_energy_at(s, view, y0, x0, n), got))
        if per_frame:
            K.CHECK_STARTS = False  # as the step runs it
            # reads the blocks once and each candidate's prediction, the
            # starts, writes two int32 per candidate
            bound = _bound(M9_B * n * n * (1 + c) + 16 * c * M9_B,
                           5 * c * M9_B * n * n, ALU_OPS_PER_S)
            parts.append(_timed(
                "block_energy_at", f"positioned B={M9_B} n={n} C={c}",
                lambda: K.block_energy_at(s, plane, y0, x0, n),
                lambda: K.block_energy_at_ref(s, plane, y0, x0, n), 20,
                bound, "block_energy_at_kernel", per_frame))
            K.CHECK_STARTS = True
    K.CHECK_STARTS = False
    return _entry("block_energy", "tpu_vp9_torch/csrc/block_energy.cu",
                  "tpu_vp9/ops/pallas_kernels.py:118", max_err, parts)


def _sse_inputs(n, r, half, seed):
    """Search inputs as the step makes them: windows of n+2r+8 (2x2 sums
    of uint8 pixels at the half-res level, int16), with a planted exact
    match in every other block (its minimum relative SSE is
    -sum(src^2) < 0), block 1 constant (every candidate ties), block 3
    constant but for one bright window pixel, and the largest operands:
    block 5 a window of the largest value against a zero source (the
    largest sum(reg^2)), block 7 against a source of the largest value
    (the largest cross term as well)."""
    rng = np.random.default_rng(seed)
    sw = n + 2 * r + 8
    k = 2 if half else 1
    wins = rng.integers(0, 256, (M9_B, sw * k, sw * k)).astype(np.int32)
    src = rng.integers(0, 256, (M9_B, n * k, n * k)).astype(np.int32)
    if half:
        wins = wins.reshape(M9_B, sw, 2, sw, 2).sum(axis=(2, 4))
        src = src.reshape(M9_B, n, 2, n, 2).sum(axis=(2, 4))
    for i in range(0, M9_B, 2):
        oy, ox = rng.integers(0, 2 * r + 1, 2)
        wins[i, 4 + oy:4 + oy + n, 4 + ox:4 + ox + n] = src[i]
    src[1], wins[1] = 40 * k * k, 40 * k * k
    src[3], wins[3] = 10, 10
    wins[3, 4 + r, 4 + r] = 200
    top = 255 * k * k
    src[5], wins[5] = 0, top
    src[7], wins[7] = top, top
    dt = np.int16 if half else np.uint8
    return src.astype(dt), wins.astype(dt)


def _hier_inputs(seed):
    """(B, 32, 32) sources and (B, 120, 120) windows of the fused search,
    B = 2040. Every fourth block is an exact copy of its window at a
    seeded displacement within +-40 (at an even one the half-res minimum
    is -sum(src_h^2) < 0); the others are such copies plus noise. Block 1
    is constant (every candidate ties at both levels); blocks 2, 3, 6, 10
    are planted at the four corners of the +-40 reach (the centre at its
    clamp of +-36, the refine winner at +-4); block 5 is the largest
    window against a zero source and block 7 against the largest source
    (half-res operands of 1020). The windows are smooth, the corners' a
    bowl."""
    rng = np.random.default_rng(seed)
    # smooth windows (a coarse random field, interpolated, and a little
    # noise), so that the half-res level leads the refine to a planted
    # match
    coarse = torch.from_numpy(rng.uniform(0, 255, (M9_B, 1, 6, 6)))
    field = torch.nn.functional.interpolate(
        coarse, size=(120, 120), mode="bicubic", align_corners=True)
    field = field[:, 0].numpy() + rng.integers(-3, 4, (M9_B, 120, 120))
    wins = np.clip(field, 0, 255).astype(np.uint8)
    src = np.empty((M9_B, 32, 32), np.uint8)
    disp = rng.integers(-40, 41, (M9_B, 2))
    disp[0] = (-12, 22)  # even: its half-res match is exact
    corners = {2: (-40, -40), 3: (-40, 40), 6: (40, -40), 10: (40, 40)}
    yy, xx = np.mgrid[0:120, 0:120]
    for i, c in corners.items():
        disp[i] = c
        # a bowl: the SSE grows with the distance from the planted match,
        # so the half-res level ends at its nearest corner
        wins[i] = ((yy - 60) ** 2 + (xx - 60) ** 2) * 255 // 7200
    for i in range(M9_B):
        oy, ox = 44 + disp[i]
        blk = wins[i, oy:oy + 32, ox:ox + 32]
        if i % 4 and i not in corners:
            blk = np.clip(blk.astype(np.int32) + rng.integers(-6, 7, (32, 32)),
                          0, 255)
        src[i] = blk
    src[1], wins[1] = 77, 77
    src[5], wins[5] = 0, 255
    src[7], wins[7] = 255, 255
    return src, wins, corners


def hier_kernel_checks(dev):
    """hier_search_fused (CUDA) against hier_search_ref, all seven
    outputs; returns (max_abs_err, its part of the sse_map_search
    entry)."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    src_np, wins_np, corners = _hier_inputs(seed=11)
    s = torch.from_numpy(src_np).to(dev)
    w = torch.from_numpy(wins_np).to(dev)
    got = K.hier_search_fused(s, w, 32)
    want = K.hier_search_ref(s, w, 32)
    err = _check("hier_search_fused", f"B={M9_B} n=32 (c_y, c_x, dyr, dxr, "
                 "loc, ssem_h, src2_h)", got, want)
    c_y, c_x, dyr, dxr, _, ssem_h, src2_h = (t.cpu() for t in got)
    if not (int(ssem_h[0].min()) == -int(src2_h[0]) < 0):
        raise AssertionError("hier_search_fused: the planted block's "
                             "half-res minimum is not -sum(src_h^2)")
    if (int(c_y[1]), int(c_x[1]), int(dyr[1]), int(dxr[1])) != (-36, -36,
                                                                -4, -4):
        raise AssertionError("hier_search_fused: ties did not go to the "
                             "first candidate of both levels")
    for i, (dy, dx) in corners.items():
        found = (int(c_y[i] + dyr[i]), int(c_x[i] + dxr[i]))
        if found != (dy, dx) or abs(int(c_y[i])) != 36:
            raise AssertionError(f"hier_search_fused: corner {dy, dx} found "
                                 f"as {found} around centre "
                                 f"{int(c_y[i]), int(c_x[i])}")
    if int(ssem_h[5, 0, 0]) != 256 * 1020 ** 2 or \
            int(ssem_h[7, 0, 0]) != -256 * 1020 ** 2:
        raise AssertionError("hier_search_fused: the largest operands' map "
                             "entries are wrong")
    # least work: reads the source and the window once, writes the map,
    # the refine window and five int32 per block; a multiply and an add
    # per candidate pixel, the half-res level's (10-bit operands) at the
    # rate off the tensor cores and the refine's (pixels) at the 8-bit
    # tensor-core rate, here as operations at the former
    ops = 2 * M9_B * (37 * 37 * 16 * 16
                      + 9 * 9 * 32 * 32 * ALU_OPS_PER_S / INT8_OPS_PER_S)
    bound = _bound(M9_B * (120 * 120 + 32 * 32 + 4 * 37 * 37 + 48 * 48 + 20),
                   ops, ALU_OPS_PER_S)
    part = _timed("hier_search_fused", f"fused B={M9_B} n=32",
                  lambda: K.hier_search_fused(s, w, 32),
                  lambda: K.hier_search_ref(s, w, 32), 3, bound,
                  "hier_search_kernel", 1)
    return err, part


def sse_kernel_phase(dev):
    """sse_map_search (CUDA) against sse_map_search_ref at the shapes of
    both levels of the hierarchical search and of the children's +-8
    search (B = 4 * K = 2040, with the map), then both levels fused. One
    M8 P-frame launches the fused kernel once and the children's search
    once; the two levels on their own are timed beside them."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    max_err = 0
    parts = []
    for label, n, r, half, want_map, per_frame in (
            ("half-res", 16, 18, True, True, 0),
            ("refine", 32, 4, False, False, 0),
            ("children", 16, 8, False, True, 1)):
        s_np, w_np = _sse_inputs(n, r, half, seed=n + r)
        s = torch.from_numpy(s_np).to(dev)
        w = torch.from_numpy(w_np).to(dev)
        for with_map in (True, False):
            got = K.sse_map_search(s, w, n, r, want_map=with_map)
            want = K.sse_map_search_ref(s, w, n, r, want_map=with_map)
            max_err = max(max_err, _check(
                "sse_map_search", f"{label} B={M9_B} n={n} r={r} "
                f"{s.dtype} map={with_map}", got, want))
        rel = K.sse_map_search_ref(s, w, n, r)[2].reshape(M9_B, -1)
        if not bool((rel[0].min() < 0).item()):
            raise AssertionError("sse_map_search: the planted block's "
                                 "minimum relative SSE is not negative")
        if not (int(got[0][1]) == -r and int(got[1][1]) == -r):
            raise AssertionError("sse_map_search: tie did not go to (-r, -r)")
        top = int(w_np.max())
        if int(rel[5, 0]) != n * n * top * top or \
                int(rel[7, 0]) != -n * n * top * top:
            raise AssertionError("sse_map_search: the largest operands' map "
                                 "entries are wrong")
        d, sw = 2 * r + 1, n + 2 * r + 8
        # reads blocks and windows, writes the winner and (if asked) the
        # map; a multiply and an add per candidate pixel, at the tensor
        # cores' 8-bit rate where the operands are pixels
        bound = _bound(M9_B * ((n * n + sw * sw) * s.element_size() + 8
                               + (4 * d * d if want_map else 0)),
                       2 * M9_B * d * d * n * n,
                       ALU_OPS_PER_S if half else INT8_OPS_PER_S)
        part = _timed(
            "sse_map_search", f"{label} B={M9_B} n={n} r={r} map={want_map}",
            lambda: K.sse_map_search(s, w, n, r, want_map),
            lambda: K.sse_map_search_ref(s, w, n, r, want_map), 5, bound,
            "sse_search_kernel", per_frame)
        parts.append(part)
    # small shapes of the other strip width and block size, and B = 1
    for n, r, b in ((8, 3, 1), (8, 12, 33), (32, 6, 17), (16, 4, 5)):
        rng = np.random.default_rng(n * r)
        sw = n + 2 * r + 8
        s = torch.from_numpy(rng.integers(0, 256, (b, n, n),
                                          dtype=np.uint8)).to(dev)
        w = torch.from_numpy(rng.integers(0, 256, (b, sw, sw),
                                          dtype=np.uint8)).to(dev)
        max_err = max(max_err, _check(
            "sse_map_search", f"random B={b} n={n} r={r} uint8",
            K.sse_map_search(s, w, n, r), K.sse_map_search_ref(s, w, n, r)))
    err, part = hier_kernel_checks(dev)
    parts.insert(0, part)
    return _entry("sse_map_search", "tpu_vp9_torch/csrc/sse_search.cu",
                  "tpu_vp9/pipeline/tpu_encdec.py:406", max(max_err, err),
                  parts)


def _residual_blocks(dev, frame, prev_recon, n):
    """(B, n, n) float32 blocks of source minus the co-located previous
    reconstruction, the picture edge-padded to whole 32-blocks (34 rows of
    60 at 1080p): B=2040 at n=32, B=8160 at n=16."""
    h = (HEIGHT + 31) // 32 * 32
    d = (np.pad(frame.y, ((0, h - HEIGHT), (0, 0)), mode="edge")
         .astype(np.float32)
         - np.pad(prev_recon[0], ((0, h - HEIGHT), (0, 0)), mode="edge"))
    t = torch.from_numpy(d).to(dev)
    return t.reshape(h // n, n, WIDTH // n, n).permute(0, 2, 1, 3) \
        .reshape(-1, n, n).contiguous()


def _txq_exposed(resid, dc_q, ac_q, n):
    """Blocks with a coefficient whose |c|/q + 0.38 lies within TXQ_BAND
    of an integer, from float64 products of the float32 DCT matrix."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    d = torch.from_numpy(K.dct_matrix(n)).to(resid.device, torch.float64)
    c = d @ resid.to(torch.float64) @ d.T
    q = torch.full((n, n), float(ac_q), dtype=torch.float64,
                   device=resid.device)
    q[0, 0] = float(dc_q)
    v = c.abs() / q + float(np.float32(K.TXQ_BIAS))
    return ((v - v.round()).abs() < TXQ_BAND).flatten(1).any(dim=1)


def _txq_compare(resid, dc_q, ac_q, n):
    """txq_cost against txq_cost_ref on one batch: (blocks outside the
    tolerance, blocks, largest error of the others). Raises if a block
    with no coefficient near a rounding boundary is outside."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    got = K.txq_cost(resid, dc_q, ac_q, n)
    want = K.txq_cost_ref(resid, dc_q, ac_q, n)
    torch.cuda.synchronize()
    exposed = _txq_exposed(resid, dc_q, ac_q, n)
    bad = torch.zeros_like(exposed)
    max_err = 0.0
    for g, w in zip(got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("txq_cost: non-finite output")
        err = (g.double() - w.double()).abs()
        off = err > TXQ_ATOL + TXQ_RTOL * w.double().abs()
        bad |= off
        if bool((~off).any()):
            max_err = max(max_err, float(err[~off].max()))
    if bool((bad & ~exposed).any()):
        raise AssertionError(
            f"txq_cost n={n}: a block with no coefficient near a rounding "
            "boundary is outside the tolerance")
    return int(bad.sum()), bad.numel(), max_err


def _txq_bound(b, n):
    # reads the residuals and the matrix, writes two floats per block;
    # two n^3 products (a multiply and an add each) and about ten
    # operations per coefficient for the quantizer and the sums
    return _bound(4 * (b * n * n + n * n + 2 * b),
                  b * (4 * n ** 3 + 10 * n * n), ALU_OPS_PER_S)


def _txq_report(label, n, q, flipped, total, max_err):
    print(f"kernel txq_cost [{label} n={n} q=({q[0]}, {q[1]})]: {flipped} "
          f"of {total} blocks outside the tolerance (each with a "
          f"coefficient within {TXQ_BAND} of a rounding boundary); "
          f"max_abs_err of the others {max_err:.6f}")
    if flipped >= TXQ_MAX_FLIPPED * total:
        raise AssertionError(f"txq_cost n={n}: {flipped} of {total} "
                             "blocks flipped")


def txq_synthetic_phase(dev):
    """txq_cost (CUDA) against txq_cost_ref on made-up residuals (a smooth
    field plus noise, as a prediction error looks) at every block size,
    with batch sizes that leave the last unit of the kernel partly empty;
    the two main shapes timed."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    rng = np.random.default_rng(17)
    q = (43.0, 52.0)
    for n, b in ((32, M9_B), (16, 4 * M9_B), (32, 1), (32, 7), (16, 33),
                 (8, 1001), (4, 4099)):
        coarse = torch.from_numpy(rng.normal(0, 12, (b, 1, 3, 3)))
        field = torch.nn.functional.interpolate(
            coarse, size=(n, n), mode="bilinear", align_corners=True)[:, 0]
        resid = (field.numpy() + rng.normal(0, 4, (b, n, n))).round()
        resid = torch.from_numpy(resid.astype(np.float32)).to(dev)
        flipped, total, max_err = _txq_compare(resid, *q, n)
        _txq_report(f"made-up residuals B={b}", n, q, flipped, total,
                    max_err)
        if b >= M9_B:
            _timed("txq_cost", f"made-up B={b} n={n}",
                   lambda: K.txq_cost(resid, *q, n),
                   lambda: K.txq_cost_ref(resid, *q, n), 20,
                   _txq_bound(b, n), "txq_cost_kernel")


def txq_kernel_phase(dev, frames, recons):
    """txq_cost (CUDA) against txq_cost_ref on residuals of the M8
    encode's own frames, at B=2040 n=32 and B=8160 n=16, within the stated
    tolerance: blocks none of whose coefficients sits within 1e-3 of a
    rounding boundary agree within 1e-4 relative + 1e-3 absolute; the
    blocks that disagree are counted and must stay under 1%."""
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline.presets import qp_to_qindex

    qidx = qp_to_qindex(QP)
    dc_q, ac_q = float(T.dc_quant(qidx)), float(T.ac_quant(qidx))
    max_err = 0.0
    parts = []
    for n in (32, 16):
        flipped = total = 0
        for i in (1, len(frames) // 2, len(frames) - 1):
            resid = _residual_blocks(dev, frames[i], recons[i - 1], n)
            f, t, err = _txq_compare(resid, dc_q, ac_q, n)
            flipped, total, max_err = flipped + f, total + t, max(max_err,
                                                                  err)
        b = resid.shape[0]
        _txq_report(f"frames' residuals B={b}", n, (dc_q, ac_q), flipped,
                    total, max_err)
        parts.append(_timed(
            "txq_cost", f"B={b} n={n}",
            lambda: K.txq_cost(resid, dc_q, ac_q, n),
            lambda: K.txq_cost_ref(resid, dc_q, ac_q, n), 20,
            _txq_bound(b, n), "txq_cost_kernel"))
    # an all-zero block costs nothing
    zero = K.txq_cost(torch.zeros((4, 32, 32), device=dev), dc_q, ac_q, 32)
    if float(zero[0].abs().max()) != 0.0 or float(zero[1].abs().max()) != 0.0:
        raise AssertionError("txq_cost: a zero residual has a cost")
    return _entry("txq_cost", "tpu_vp9_torch/csrc/txq_cost.cu",
                  "tpu_vp9/ops/pallas_kernels.py:175", max_err, parts)


def _kf_mode_frame(h, w, patch=96):
    """A luma plane of ``patch``-pixel squares, each of a kind that one
    intra mode predicts best: flat (DC), sinusoids along x (V), along y
    (H) and along the six diagonal directions (D45, D135, D117, D153, D207,
    D63), a ramp in x and y (TM), and noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    phases = (xx, yy, xx + yy, xx - yy, 2 * xx - yy, xx - 2 * yy,
              xx + 2 * yy, 2 * xx + yy)
    kinds = len(phases) + 3
    kind = ((yy // patch) * (w // patch + 1) + xx // patch).astype(int) % kinds
    noise = np.random.default_rng(7).integers(0, 256, (h, w))
    out = np.where(kind == 0, 90.0, 0.0)
    for i, t in enumerate(phases):
        out = np.where(kind == i + 1, 128 + 90 * np.sin(2 * np.pi * t / 14),
                       out)
    out = np.where(kind == kinds - 2,
                   40 + 1.3 * (xx % patch) + 0.9 * (yy % patch), out)
    out = np.where(kind == kinds - 1, noise, out)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _kf_planes(y):
    """Padded (y, u, v) planes from a padded luma plane: chroma subsampled
    from it (v inverted)."""
    u = np.ascontiguousarray(y[::2, ::2])
    return [y, u, np.ascontiguousarray(255 - y[1::2, 1::2])]


def _kf_case(dev, label, geom, planes, qidx, lam=None):
    """kframe_wave (CUDA) against kframe_wave_ref on the card: modes,
    levels, eobs and recon bit for bit. Prints the blocks each mode won and
    the blocks whose levels differ from the plain version's; returns
    (max_abs_err, blocks won by each mode, the kernel's outputs)."""
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    dc_q, ac_q = T.dc_quant(qidx), T.ac_quant(qidx)
    lam = max(1, (ac_q ** 2) >> 6) if lam is None else lam
    ts = [torch.from_numpy(p).to(dev) for p in planes]
    got = K.kframe_wave(*ts, geom, dc_q, ac_q, lam)
    want = P.kframe_wave_ref(*ts, geom, dc_q, ac_q, lam)
    torch.cuda.synchronize()
    b = got[0].numel()
    differ = torch.zeros(b, dtype=torch.bool, device=dev)
    for g_lv, w_lv in zip(got[1:4], want[1:4]):
        differ |= (g_lv != w_lv).reshape(b, -1).any(dim=1)
    won = torch.bincount(got[0].long(), minlength=10).tolist()
    print(f"kframe_wave {label} {geom.width}x{geom.height} qindex {qidx} "
          f"lam {lam}: blocks won by each mode (DC..TM) {won}; "
          f"{int(differ.sum())} of {b} blocks with levels unlike the plain "
          f"version's; largest |level| {int(got[1].abs().max())}")
    err = _check("kframe_wave", f"{label} {geom.width}x{geom.height} qindex "
                 f"{qidx}", got, want)
    return err, won, got


def kframe_kernel_phase(dev):
    """kframe_wave (CUDA) against kframe_wave_ref on the card, bit for bit:
    the first 1080p panning frame at the paths' qindex and at 10, 100 and
    255; 1080p mode patches on which every mode wins somewhere; a constant
    frame at lam 0 (modes tie: DC, the first, must win every block); 0/255
    blocks at qindex 0 (levels reach the 8191 clip); the small geometries
    of the CPU tests. Timed at 1080p: per keyframe (93 launches) with CUDA
    events, the kernel's device time summed over the launches (profiler),
    the host's, the plain version's; the bound; and, beside it, the chain:
    93 times this kernel's own measured latency for one block (the device
    time of the 32x32 geometry's single launch of one CTA), a figure of
    this design, not a limit of the card."""
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.pipeline.presets import qp_to_qindex
    from tpu_vp9_torch.utils.yuv import panning_frames

    g = P.make_geom(WIDTH, HEIGHT)
    if g.rows32 + g.cols32 - 1 != KF_DIAGONALS:
        raise AssertionError("KF_DIAGONALS does not fit the 1080p grid")
    qidx = qp_to_qindex(QP)
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))
    frame = next(panning_frames(WIDTH, HEIGHT, 1, seed=1))
    pan = [P.pad_plane(np.asarray(p), *shp)
           for p, shp in zip((frame.y, frame.u, frame.v), shapes)]
    max_err = 0
    for q in (qidx, *KF_QINDICES):
        max_err = max(max_err, _kf_case(dev, "panning frame", g, pan, q)[0])
    for q in KF_QINDICES:
        err, won, _ = _kf_case(dev, "mode patches", g,
                               _kf_planes(_kf_mode_frame(g.pad_h, g.pad_w)), q)
        max_err = max(max_err, err)
        if not all(won):
            raise AssertionError(f"kframe_wave: a mode won no block of the "
                                 f"mode patches: {won}")
    # a constant 128: every prediction with a neighbour is exact, so DC, V,
    # H, TM and the diagonals tie at SSE 0 and, at lam 0, at cost 0
    const = np.full((g.pad_h, g.pad_w), 128, np.uint8)
    err, won, _ = _kf_case(dev, "constant 128", g, _kf_planes(const), qidx,
                           lam=0)
    max_err = max(max_err, err)
    if won[0] != g.n_blocks32:
        raise AssertionError(f"kframe_wave: tied modes did not all go to the "
                             f"first, DC: {won}")
    yy, xx = np.mgrid[0:g.pad_h, 0:g.pad_w]
    ext = np.where((yy // 32 + xx // 32) % 2, 255, 0).astype(np.uint8)
    err, _, got = _kf_case(dev, "0/255 blocks", g, _kf_planes(ext), 0)
    max_err = max(max_err, err)
    if int(got[1].abs().max()) != 8191:
        raise AssertionError("kframe_wave: qindex 0 did not reach the level "
                             "clip")
    rng = np.random.default_rng(23)
    for dims in KF_SMALL_DIMS:
        gs = P.make_geom(*dims)
        noise = rng.integers(0, 256, (gs.pad_h, gs.pad_w), dtype=np.uint8)
        for label, y in (("noise", noise),
                         ("mode patches",
                          _kf_mode_frame(gs.pad_h, gs.pad_w, 32))):
            for q in KF_QINDICES:
                max_err = max(max_err, _kf_case(dev, label, gs, _kf_planes(y),
                                                q)[0])
    # timing on the panning frame at the paths' qindex
    ts = [torch.from_numpy(p).to(dev) for p in pan]
    dc_q, ac_q = T.dc_quant(qidx), T.ac_quant(qidx)
    lam = max(1, (ac_q ** 2) >> 6)

    def call():
        return K.kframe_wave(*ts, g, dc_q, ac_q, lam)

    ms = _cuda_time_ms(call, 20)
    plain_ms = _cuda_time_ms(lambda: P.kframe_wave_ref(*ts, g, dc_q, ac_q,
                                                       lam), 2)
    per_launch = _device_ms(call, "kframe_wave_kernel", reps=5)
    device_ms = None if per_launch is None else per_launch * KF_DIAGONALS
    host_ms = _host_ms(call, reps=20)
    g1 = P.make_geom(32, 32)
    one = [torch.from_numpy(p).to(dev) for p in _kf_planes(
        rng.integers(0, 256, (g1.pad_h, g1.pad_w), dtype=np.uint8))]
    block_ms = _device_ms(lambda: K.kframe_wave(*one, g1, dc_q, ac_q, lam),
                          "kframe_wave_kernel", reps=50)
    chain_ms = None if block_ms is None else KF_DIAGONALS * block_ms
    # reads the source planes once; writes the recon, the int16 levels, the
    # modes and eobs; the float64 and integer operations of every block,
    # the former at FP64_OPS_PER_S, here as operations at ALU_OPS_PER_S
    nb = g.n_blocks32
    nbytes = sum(t.numel() for t in ts) + nb * 1536 * 3 + 16 * nb
    bound = _bound(nbytes, nb * (KF_FP64_OPS * ALU_OPS_PER_S / FP64_OPS_PER_S
                                 + KF_INT_OPS), ALU_OPS_PER_S)

    def shown(v, unit=" ms"):
        return "not measured" if v is None else f"{v:.4f}{unit}"

    print(f"kernel kframe_wave 1080p keyframe ({KF_DIAGONALS} launches): "
          f"call {ms:.4f} ms (CUDA events, median); device "
          f"{shown(device_ms)} summed over the launches ("
          f"{shown(per_launch)} per launch, profiler); host {host_ms:.4f} ms "
          f"per call; plain {plain_ms:.4f} ms; bound {bound[0]:.5f} ms by "
          f"{bound[1]} ({nbytes / 1e6:.2f} MB, "
          f"{nb * KF_FP64_OPS:.3g} float64 and {nb * KF_INT_OPS:.3g} integer "
          f"operations); chain {shown(chain_ms)} ({KF_DIAGONALS} x this "
          f"kernel's measured latency for one block, {shown(block_ms)}: the "
          "32x32 geometry's single launch; not a bound)")
    return {"name": "kframe_wave", "route": "cuda",
            "source": "tpu_vp9_torch/csrc/kframe_wave.cu",
            "replaces": "tpu_vp9/pipeline/tpu_encdec.py:2259",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "device_ms": device_ms, "host_ms": host_ms,
            "chain_ms": chain_ms,
            "parts": [{"shape": f"1080p keyframe, {KF_DIAGONALS} launches",
                       "per_frame": 1, "ms": ms, "device_ms": device_ms,
                       "host_ms": host_ms, "bound_ms": bound[0]}]}


def _lf_planes(geom, rng):
    """Padded (y, u, v) planes that reach every class of the edge filter:
    32x32 patches (16x16 in chroma), each of one kind. Blocky: 8x8 blocks
    of any level with a little noise (masked-out lanes at the large steps,
    filter4 with and without high edge variance at the small ones);
    gentle: levels within 3 of each other and noise of 0 or 1 (flat and
    flat2); extremes: 8x8 blocks at 0 or 255 and small steps right at
    them (the filters' clamps)."""
    def plane(h, w, patch):
        ph, pw = h // patch + 1, w // patch + 1
        kind = np.kron(rng.integers(0, 3, (ph, pw)),
                       np.ones((patch, patch), np.int64))[:h, :w]
        bh, bw = h // 8 + 1, w // 8 + 1

        def blocks(levels):
            return np.kron(levels, np.ones((8, 8)))[:h, :w]

        blocky = blocks(rng.integers(0, 256, (bh, bw))) \
            + rng.normal(0, 2, (h, w))
        base = np.kron(rng.integers(60, 200, (ph, pw)),
                       np.ones((patch // 8, patch // 8), np.int64))
        gentle = blocks(base[:bh, :bw] + rng.integers(0, 4, (bh, bw))) \
            + rng.integers(0, 2, (h, w))
        ends = blocks(rng.choice([0, 2, 5, 250, 253, 255], (bh, bw))) \
            + rng.integers(-1, 2, (h, w))
        out = np.where(kind == 0, blocky, np.where(kind == 1, gentle, ends))
        return np.ascontiguousarray(np.clip(np.rint(out), 0, 255), np.uint8)

    g = geom
    return [plane(g.pad_h, g.pad_w, 32), plane(g.pad_h // 2, g.pad_w // 2, 16),
            plane(g.pad_h // 2, g.pad_w // 2, 16)]


def _lf_case(label, planes, geom, lvl, lim, mblim, split):
    """loop_filter (CUDA) against loop_filter_ref on one input: all three
    planes bit for bit, the inputs unchanged. Returns (max_abs_err, the
    plain version's lanes per filter class)."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    before = [p.clone() for p in planes]
    mask_before = None if split is None else split.clone()
    got = K.loop_filter(*planes, geom, lvl, lim, mblim, split)
    P.LF_CLASS_COUNTS = {}
    want = P.loop_filter_ref(*planes, geom, lvl, lim, mblim, split)
    counts, P.LF_CLASS_COUNTS = P.LF_CLASS_COUNTS, None
    shown = ", ".join(f"{k} {counts.get(k, 0)}" for k in P.LF_CLASSES)
    err = _check("loop_filter", f"{label} lvl={lvl} lim={lim} mblim={mblim}; "
                 f"lanes: {shown}", got, want)
    for a, b in zip(planes, before):
        if not torch.equal(a, b):
            raise AssertionError("loop_filter changed its input planes")
    if split is not None and not torch.equal(split, mask_before):
        raise AssertionError("loop_filter changed its split mask")
    if lvl == 0 and not all(torch.equal(a, b) for a, b in zip(got, planes)):
        raise AssertionError("loop_filter: lvl 0 is not a copy")
    return err, counts


def _lf_kinds_alone(label, planes, geom, lvl, lim, mblim, split):
    """Device time of loop_filter with every kind of CTA at work and with
    each kind alone (the others return at once): which columns of the
    picture the kernel's time is."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    shown = []
    for name, bits in (("all", K.LF_ALL_PARTS), *K.LF_PARTS.items()):
        ms = _device_ms(lambda: K.loop_filter(*planes, geom, lvl, lim, mblim,
                                              split, parts=bits),
                        "loop_filter_kernel")
        shown.append(f"{name} " + ("not measured" if ms is None
                                   else f"{ms:.4f} ms"))
    print(f"kernel loop_filter on {label}, device time per launch by kind "
          f"of CTA alone: {', '.join(shown)}")


def _real_m8_inputs(dev):
    """The real inputs of three stages of the steps: the first two frames
    of the clip (a keyframe and an M8 P-frame) through the public encoder,
    the steps' calls of ``loop_filter_device`` (keyframe and P-frame),
    ``transform_recon`` and ``subpel_search`` (P-frame) recorded. Returns
    ({"lf": [(y, u, v, geom, lvl, lim, mblim, split32)], "tr": [(src,
    pred, dc_q, ac_q, n)], "sp": [(wins, src, dy, dx, n, r)]}, the two
    frames, their recon)."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.utils.yuv import panning_frames

    calls = {"lf": [], "tr": [], "sp": []}
    real_lf, real_tr, real_sp = (P.loop_filter_device, P.transform_recon,
                                 P.subpel_search)

    def record_lf(y, u, v, geom, lvl, lim, mblim, split32=None):
        calls["lf"].append((y, u, v, geom, lvl, lim, mblim, split32))
        return real_lf(y, u, v, geom, lvl, lim, mblim, split32=split32)

    def record_tr(*args):
        calls["tr"].append(args)
        return real_tr(*args)

    def record_sp(*args):
        calls["sp"].append(args)
        return real_sp(*args)

    P.loop_filter_device = record_lf
    P.transform_recon, P.subpel_search = record_tr, record_sp
    enc = _make_encoder(dev, 8)
    got = _capture(enc)
    frames = list(panning_frames(WIDTH, HEIGHT, 2, seed=1))
    for frame in frames:
        enc.send_picture(frame)
    enc.flush()
    P.loop_filter_device = real_lf
    P.transform_recon, P.subpel_search = real_tr, real_sp
    torch.cuda.synchronize()
    lf = calls["lf"]
    if len(lf) != 2 or lf[0][7] is not None or lf[1][7] is None:
        raise AssertionError(f"the keyframe and the M8 P-frame called the "
                             f"loop filter {len(lf)} times, or the "
                             "keyframe with a mask or the P-frame without")
    if ([c[4] for c in calls["tr"]] != [32, 16, 16, 8, 8, 16]
            or [c[4:] for c in calls["sp"]] != [(32, 4), (16, 8)]):
        raise AssertionError(
            "the M8 P-frame's transform and quarter-pel calls were "
            f"{[c[4] for c in calls['tr']]} and "
            f"{[c[4:] for c in calls['sp']]}")
    return calls, frames, [r for _, r in got]


def loop_filter_kernel_phase(dev, lf_calls):
    """loop_filter (CUDA) against loop_filter_ref on the card; lf_calls:
    the real keyframe's and M8 P-frame's arguments (``_real_m8_inputs``)."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.ops.loopfilter import sharpness_limits
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    lim_t, mblim_t = sharpness_limits(0)
    rng = np.random.default_rng(5)
    max_err = 0
    seen = dict.fromkeys(P.LF_CLASSES, 0)
    for dims in ((WIDTH, HEIGHT),) + LF_SMALL_DIMS:
        g = P.make_geom(*dims)
        planes = [torch.from_numpy(p).to(dev) for p in _lf_planes(g, rng)]
        masks = {"no mask": None,
                 "random mask": torch.from_numpy(rng.integers(
                     0, 2, (g.rows32, g.cols32)).astype(np.int32)).to(dev),
                 "all-ones mask": torch.ones((g.rows32, g.cols32),
                                             dtype=torch.int32, device=dev)}
        for name, mask in masks.items():
            for lvl in LF_LEVELS:
                err, counts = _lf_case(
                    f"made-up {dims[0]}x{dims[1]}, {name}", planes, g, lvl,
                    int(lim_t[lvl]), int(mblim_t[lvl]), mask)
                max_err = max(max_err, err)
                if dims == (WIDTH, HEIGHT):
                    for k in seen:
                        seen[k] += counts.get(k, 0)
        if dims == (WIDTH, HEIGHT):
            made_up = (planes, g, masks["random mask"])
    if not all(seen.values()):
        raise AssertionError(f"the made-up 1080p planes reach no lane of a "
                             f"filter class: {seen}")
    # the real thing: a keyframe's and an M8 P-frame's unfiltered recon,
    # (mask) and level
    key_in, (y, u, v, g, lvl, lim, mblim, split) = lf_calls
    err, _ = _lf_case("real keyframe", key_in[:3], *key_in[3:])
    max_err = max(max_err, err)
    print(f"loop_filter: a real M8 P-frame's input: lvl={lvl} lim={lim} "
          f"mblim={mblim}, {int(split.sum())} of {split.numel()} blocks "
          "split")
    err, counts = _lf_case("real M8 P-frame", (y, u, v), g, lvl, lim, mblim,
                           split)
    max_err = max(max_err, err)
    err, counts9 = _lf_case("real M8 P-frame's planes, no mask", (y, u, v),
                            g, lvl, lim, mblim, None)
    max_err = max(max_err, err)
    parts = []
    nbytes = 2 * sum(t.numel() for t in (y, u, v))
    for label, mask, cnt, per_frame in (
            ("1080p split mask (M8)", split, counts, 1),
            ("1080p no mask (M9)", None, counts9, 0)):
        lanes = sum(cnt.values())
        # every plane read once and written once, and the mask; the
        # arithmetic of this input's edge lanes
        bound = _bound(nbytes + (0 if mask is None else 4 * mask.numel()),
                       LF_OPS_PER_LANE * lanes, ALU_OPS_PER_S)
        parts.append(_timed(
            "loop_filter", f"{label}, {lanes} edge lanes",
            lambda: K.loop_filter(y, u, v, g, lvl, lim, mblim, mask),
            lambda: P.loop_filter_ref(y, u, v, g, lvl, lim, mblim, mask), 2,
            bound, "loop_filter_kernel", per_frame))
    _lf_kinds_alone("the real M8 P-frame", (y, u, v), g, lvl, lim, mblim,
                    split)
    _lf_kinds_alone("the made-up planes, random mask", made_up[0],
                    made_up[1], LF_LEVELS[-1], int(lim_t[LF_LEVELS[-1]]),
                    int(mblim_t[LF_LEVELS[-1]]), made_up[2])
    return _entry("loop_filter", "tpu_vp9_torch/csrc/loop_filter.cu",
                  "tpu_vp9/pipeline/tpu_encdec.py:1115", max_err, parts)


def _tr_resources(dev):
    """Each transform_recon template instance's registers, spill bytes
    and static shared memory from the ptxas report of its build
    (``_build/libtransform_recon.log``), and its resident CTAs per SM and
    dynamic shared memory from the CUDA runtime's occupancy query; printed,
    and raised on if an instance spills."""
    import re

    from tpu_vp9_torch.ops import _build
    from tpu_vp9_torch.ops import cuda_kernels as K

    log = _build.build_log("transform_recon")
    found = {}
    for m in re.finditer(
            r"Compiling entry function '[^']*transform_recon_kernelILi(\d+)E"
            r"[^']*'.*?(\d+) bytes spill stores, (\d+) bytes spill loads"
            r".*?Used (\d+) registers([^\n]*)", log, re.S):
        smem = re.search(r"(\d+) bytes smem", m.group(5))
        found[int(m.group(1))] = (int(m.group(4)), int(m.group(2)),
                                  int(m.group(3)),
                                  int(smem.group(1)) if smem else 0)
    if sorted(found) != [8, 16, 32]:
        raise AssertionError("transform_recon: the ptxas report has the "
                             f"instances {sorted(found)}, want 8, 16, 32")
    for n in (32, 16, 8):
        regs, st, ld, smem = found[n]
        ctas, dyn = K.transform_recon_occupancy(n, dev)
        print(f"transform_recon n={n}: {regs} registers, spill stores {st} "
              f"B, spill loads {ld} B, static shared memory {smem} B "
              f"(ptxas); dynamic shared memory {dyn} B, {ctas} resident "
              "CTAs of 128 threads per SM (occupancy query)")
        if st or ld:
            raise AssertionError(f"transform_recon n={n} spills registers")


def _tr_bound(b, n, fp64_ops_per_s=FP64_OPS_PER_S):
    """transform_recon's bound for B blocks of n: reads src and pred,
    writes int16 levels, recon and eob; the two forward products (a
    multiply and an add per term, n^3 terms each per block) in float64 at
    ``fp64_ops_per_s`` and the integer work, here as operations at
    ALU_OPS_PER_S."""
    return _bound(5 * b * n * n + 4 * b,
                  b * (4 * n ** 3 * ALU_OPS_PER_S / fp64_ops_per_s
                       + TR_INT_OPS[n]), ALU_OPS_PER_S)


def _tr_case(label, src, pred, dc_q, ac_q, n):
    """transform_recon (CUDA) against transform_recon_ref on one batch:
    the level flips counted and printed, each allowed only where the plain
    version's float64 |c| / q + 0.38 lies within TR_FLIP_BAND of an
    integer; eob and recon bit-equal in every block whose levels are.
    Returns (max_abs_err over all three outputs, the kernel's outputs)."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.ops import txfm
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    got = K.transform_recon(src, pred, dc_q, ac_q, n)
    want = P.transform_recon_ref(src, pred, dc_q, ac_q, n)
    torch.cuda.synchronize()
    b = src.shape[0]
    differ = got[0] != want[0]
    flips = int(differ.sum())
    same = ~differ.reshape(b, -1).any(dim=1)
    if flips:
        coef = txfm.fwd_txfm2d_f64(src.to(torch.int32) - pred.to(torch.int32))
        q = torch.full((n, n), float(ac_q), dtype=torch.float64,
                       device=src.device)
        q[0, 0] = float(dc_q)
        if n == 32:
            q = q * 0.5
        mag = (coef.abs() / q + txfm.QBIAS)[differ]
        off = float((mag - mag.round()).abs().max())
        if off >= TR_FLIP_BAND:
            raise AssertionError(f"transform_recon [{label}]: a level flipped "
                                 f"{off:.3g} from a rounding boundary")
    for name, g, w in (("eob", got[1], want[1]), ("recon", got[2], want[2])):
        if not torch.equal(g[same], w[same]):
            raise AssertionError(f"transform_recon [{label}]: {name} differs "
                                 "in a block whose levels are equal")
    err = _max_err(got, want)
    print(f"kernel transform_recon [{label} B={b} n={n} q=({dc_q}, {ac_q})]: "
          f"{flips} level flips in {b - int(same.sum())} of {b} blocks; "
          f"max_abs_err={err}; eob {int(got[1].min())}..{int(got[1].max())}, "
          f"largest |level| {int(got[0].abs().max())}")
    return err, got


def _plane_blocks(plane, h, n, b, dev):
    """The first b (n, n) blocks, raster order, of a host plane
    edge-padded to h rows, on the card."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    t = torch.from_numpy(P.pad_plane(np.asarray(plane), h, plane.shape[1]))
    return P._extract_blocks(t.to(dev), 0, h // n, plane.shape[1] // n,
                             n)[:b].contiguous()


def transform_kernel_phase(dev, real, frames, recons):
    """transform_recon (CUDA) against transform_recon_ref on the card at
    the four shapes of the M8 path at 1080p (B = 2040: the zone's luma at
    32 and chroma at 16, the children's luma at 16 and chroma at 8): the
    step's real blocks (``_real_m8_inputs``), the second frame's source
    against the first frame's recon at four qindex values, +-255
    residuals at the same four (the level clip reached at qindex 0), zero
    residuals (eob 0), and blocks with one nonzero level at each scan place
    (every eob value). Timed on the real blocks."""
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    _tr_resources(dev)
    rng = np.random.default_rng(29)
    max_err = 0
    for label, (src, pred, dc_q, ac_q, n) in zip(TR_CALLS, real):
        max_err = max(max_err, _tr_case(f"M8 P-frame's {label}", src, pred,
                                        dc_q, ac_q, n)[0])
    # (label, plane index, n) of the path's four shapes
    shapes = (("luma", 0, 32), ("chroma", 1, 16), ("luma", 0, 16),
              ("chroma", 1, 8))
    clip = False
    for plane_name, p, n in shapes:
        b = M9_B
        h = (HEIGHT + 31) // 32 * 32 >> (1 if p else 0)
        cur = frames[1]
        src = _plane_blocks((cur.y, cur.u, cur.v)[p], h, n, b, dev)
        prev = _plane_blocks(recons[0][p], h, n, b, dev)
        ext = torch.from_numpy(rng.choice([0, 255], (b, n, n))
                               .astype(np.uint8)).to(dev)
        ext[0], ext[1] = 255, 0
        for q in TR_QINDICES:
            dc_q, ac_q = T.dc_quant(q), T.ac_quant(q)
            max_err = max(max_err, _tr_case(
                f"{plane_name} source against the previous recon", src, prev,
                dc_q, ac_q, n)[0])
            err, got = _tr_case("+-255 residuals", ext, 255 - ext, dc_q, ac_q,
                                n)
            max_err = max(max_err, err)
            clip |= int(got[0].abs().max()) == 8191
        dc_q, ac_q = T.dc_quant(TR_LONE_QINDEX), T.ac_quant(TR_LONE_QINDEX)
        err, got = _tr_case("zero residuals", src, src.clone(), dc_q, ac_q, n)
        max_err = max(max_err, err)
        if int(got[1].abs().max()) or int(got[0].abs().max()):
            raise AssertionError("transform_recon: a zero residual has levels")
        # one lone level at each scan place: its recon is the source
        nn = n * n
        scan = torch.as_tensor(np.asarray(T.scan_order(
            P.txfm.TX_SIZE[n], T.TxType.DCT_DCT)[0]), device=dev)
        levels = torch.zeros((nn, nn), dtype=torch.int32, device=dev)
        levels[torch.arange(nn, device=dev), scan] = TR_LONE_LEVEL
        levels[0, scan[0]] = 4
        pred = torch.full((nn, n, n), 128, dtype=torch.uint8, device=dev)
        lone = P.recon_from_levels(levels.reshape(nn, n, n), pred, dc_q, ac_q,
                                   n)[1]
        err, got = _tr_case("one level at each scan place", lone, pred, dc_q,
                            ac_q, n)
        max_err = max(max_err, err)
        print(f"transform_recon n={n}: the lone levels reach "
              f"{len(set(got[1].tolist()))} of {nn} eob values")
    if not clip:
        raise AssertionError("transform_recon: the 8191 level clip was not "
                             "reached")
    parts = []
    for label, i, per_frame in TR_TIMED:
        src, pred, dc_q, ac_q, n = real[i]
        b = src.shape[0]
        parts.append(_timed(
            "transform_recon", f"{label} B={b} n={n}",
            lambda: K.transform_recon(src, pred, dc_q, ac_q, n),
            lambda: P.transform_recon_ref(src, pred, dc_q, ac_q, n), 5,
            _tr_bound(b, n), "transform_recon_kernel", per_frame))
        print(f"kernel transform_recon {label} B={b} n={n}: bound with the "
              "float64 products on the CUDA cores (34 TFLOP/s) "
              f"{_tr_bound(b, n, FP64_CORE_OPS_PER_S)[0]:.5f} ms")
    return _entry("transform_recon", "tpu_vp9_torch/csrc/transform_recon.cu",
                  "tpu_vp9/pipeline/tpu_encdec.py:820", max_err, parts)


def _sp_bound(b, n):
    """subpel_search's bound for B blocks of n: reads each block's (n+8)^2
    window, its source and two int32, writes three int32; 8-tap sums (a
    multiply and an add a tap) for the 4 H planes of (n+8) x (n+1) and the
    16 V planes of (n+1)^2, and a subtract, multiply and add per pixel of
    the 49 SSEs, at ALU_OPS_PER_S."""
    ops = (4 * (n + 8) * (n + 1) * 16 + 16 * (n + 1) ** 2 * 16
           + 49 * n * n * 3)
    return _bound(b * ((n + 8) ** 2 + n * n + 20), b * ops, ALU_OPS_PER_S)


def subpel_kernel_phase(dev, real):
    """subpel_search (CUDA) against subpel_search_ref on the card, bit for
    bit, at the two shapes of the M8 path at 1080p: the zone's real refine
    windows and winners from hier_search_fused and the children's real
    windows (``_real_m8_inputs``); B = 2040 made-up batches of each shape:
    random windows, winners at the corners of +-r, constant windows (all
    49 offsets tie: (-6, -6) must win), a zero window against a source of
    255 (the largest SSE, tied too) and 0/255 checkerboards. Timed on the
    real inputs."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    rng = np.random.default_rng(31)
    max_err = 0
    for label, args in zip(SP_CALLS, real):
        max_err = max(max_err, _check(
            "subpel_search", f"M8 P-frame's {label}",
            K.subpel_search(*args), P.subpel_search_ref(*args)))
    for _, _, _, _, n, r in real:
        b, sw = M9_B, n + 2 * r + 8

        def on(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        d = on(rng.integers(-r, r + 1, (2, b)).astype(np.int32))
        corner = on(np.array([[(-r, r)[i % 2] for i in range(b)],
                              [(-r, r)[i // 2 % 2] for i in range(b)]],
                             np.int32))
        yy, xx = np.mgrid[0:sw, 0:sw]
        cb = ((yy + xx) % 2 * 255).astype(np.uint8)
        cases = (
            ("random", rng.integers(0, 256, (b, sw, sw), dtype=np.uint8),
             rng.integers(0, 256, (b, n, n), dtype=np.uint8), d, None),
            ("winners at +-r", rng.integers(0, 256, (b, sw, sw),
                                            dtype=np.uint8),
             rng.integers(0, 256, (b, n, n), dtype=np.uint8), corner, None),
            ("constant: all tie", np.full((b, sw, sw), 77, np.uint8),
             np.full((b, n, n), 77, np.uint8), d, 0),
            ("largest SSE: all tie", np.zeros((b, sw, sw), np.uint8),
             np.full((b, n, n), 255, np.uint8), d, n * n * 255 * 255),
            ("0/255 checkerboards", np.repeat(cb[None], b, axis=0),
             np.repeat(255 - cb[None, :n, :n], b, axis=0), d, None))
        for label, wins, src, dyx, tie_sse in cases:
            args = (on(wins), on(src), dyx[0].contiguous(),
                    dyx[1].contiguous(), n, r)
            got = K.subpel_search(*args)
            max_err = max(max_err, _check(
                "subpel_search", f"{label} B={b} n={n} r={r}", got,
                P.subpel_search_ref(*args)))
            if tie_sse is not None and not (
                    torch.equal(got[0], args[2] * 8 - 6)
                    and torch.equal(got[1], args[3] * 8 - 6)
                    and bool((got[2] == tie_sse).all())):
                raise AssertionError(f"subpel_search: ties ({label}) did not "
                                     "go to the first offset, (-6, -6)")
    parts = []
    for label, args in zip(SP_CALLS, real):
        b, n = args[1].shape[0], args[4]
        parts.append(_timed(
            "subpel_search", f"{label} B={b}",
            lambda: K.subpel_search(*args),
            lambda: P.subpel_search_ref(*args), 5, _sp_bound(b, n),
            "subpel_search_kernel", 1))
    return _entry("subpel_search", "tpu_vp9_torch/csrc/subpel_search.cu",
                  "tpu_vp9/pipeline/tpu_encdec.py:510", max_err, parts)


def _psnr(a, b) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _make_encoder(device, enc_mode):
    from tpu_vp9_torch.api import Vp9Encoder
    from tpu_vp9_torch.config import (
        EncoderConfig, PredStructure, RateControlMode,
    )

    enc = Vp9Encoder(device=device)
    # recon_file keeps get_recon on the realtime path; nothing is written
    enc.set_parameter(EncoderConfig(
        source_width=WIDTH, source_height=HEIGHT, enc_mode=enc_mode,
        pred_structure=PredStructure.LOW_DELAY_P,
        rate_control_mode=RateControlMode.CQP, qp=QP, frame_rate=30,
        recon_file="unused.yuv"))
    enc.init()
    return enc


def _capture(enc):
    """(packet, recon) pairs in emission order: the realtime session emits
    a packet one or two sends after its picture, sometimes two at once."""
    got = []
    emit = enc._emit

    def hook(pkt):
        emit(pkt)
        got.append((pkt, enc.get_recon()))

    enc._emit = hook
    return got


def _encode(device, frames, enc_mode):
    """Encode frames one by one. Returns (packets, recons, per-send rows
    (index, seconds, {stage: seconds} from the tracer's spans), the
    encoder, seconds from the first P-frame's send to the end of flush)."""
    from tpu_vp9_torch.utils import trace

    enc = _make_encoder(device, enc_mode)
    got = _capture(enc)
    rows = []
    t_p = None
    for idx, frame in enumerate(frames):
        trace.reset()
        if idx == 1:
            t_p = time.perf_counter()
        tf = time.perf_counter()
        enc.send_picture(frame)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        stages = {k: v["total_s"] for k, v in trace.summary().items()
                  if k != "notices"}
        rows.append((idx, time.perf_counter() - tf, stages))
    enc.flush()
    p_seconds = time.perf_counter() - t_p
    while enc.get_packet() is not None:
        pass
    if [p.pts for p, _ in got] != list(range(len(frames))):
        raise AssertionError(f"packets out of order: {[p.pts for p, _ in got]}")
    return ([p for p, _ in got], [r for _, r in got], rows, enc, p_seconds)


def _decode_check(pkts, recons, frames):
    """Decode the IVF with the port's decoder; bit-exact to the recon; Y
    PSNR per frame."""
    from tpu_vp9_torch.bitstream.ivf import write_ivf_frame, write_ivf_header
    from tpu_vp9_torch.decoder.decoder import decode_ivf

    buf = io.BytesIO()
    write_ivf_header(buf, WIDTH, HEIGHT, 30, 1, len(pkts))
    for p in pkts:
        write_ivf_frame(buf, p.data, p.pts)
    buf.seek(0)
    decoded = list(decode_ivf(buf))
    if len(decoded) != len(pkts):
        raise AssertionError(f"decoded {len(decoded)} of {len(pkts)} frames")
    psnrs = []
    for idx, ((y, u, v, _), rec, src) in enumerate(zip(decoded, recons,
                                                        frames)):
        for plane, want in zip((y, u, v), rec):
            if not np.array_equal(plane, want):
                raise AssertionError(f"decoded frame {idx} differs from the "
                                     "encoder's recon")
        psnrs.append(_psnr(y, src.y))
    if not all(np.isfinite(p) and p > 20 for p in psnrs):
        raise AssertionError(f"implausible Y PSNR {psnrs}")
    return psnrs


def _kernel_fns():
    from tpu_vp9_torch.ops import cuda_kernels as K

    return {"sad_full_search": K.sad_full_search,
            "block_energy": K.block_energy,
            "block_energy_at": K.block_energy_at,
            "sse_map_search": K.sse_map_search,
            "hier_search_fused": K.hier_search_fused,
            "txq_cost": K.txq_cost,
            "loop_filter": K.loop_filter,
            "kframe_wave": K.kframe_wave,
            "transform_recon": K.transform_recon,
            "subpel_search": K.subpel_search}


def _reset_counts():
    for fn in _kernel_fns().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _kernel_fns().items()}


def _stage_means(rows):
    stage_ms = {}
    for _, _, stages in rows:
        for name, s in stages.items():
            stage_ms[name] = stage_ms.get(name, 0.0) + 1000 * s / len(rows)
    return ", ".join(f"{k} {v:.1f} ms" for k, v in
                     sorted(stage_ms.items(), key=lambda kv: -kv[1]))


# the spans that divide a P-frame send on the calling thread (the native
# serializer runs on the session's worker, beside them)
SEND_SPANS = ("rt_device_step", "rt_stage", "rt_rate_args", "api_scene_cut",
              "api_frame_qindex", "rt_d2h_transfer")


def _send_split(rows):
    """A P-frame send's mean host time split by SEND_SPANS, and what none
    of them covers."""
    send = 1000 * statistics.mean(r[1] for r in rows)
    means = {k: 1000 * statistics.mean(r[2].get(k, 0.0) for r in rows)
             for k in SEND_SPANS}
    return (f"send {send:.1f} ms split (mean, host clock): "
            + ", ".join(f"{k} {v:.2f}" for k, v in means.items())
            + f"; outside them {send - sum(means.values()):.1f} ms")


def _stream_line(label, pkts, psnrs):
    """Bytes per frame and Y PSNR over a stream (or its first frames)."""
    total = sum(len(p.data) for p in pkts)
    p_bytes = statistics.mean(len(p.data) for p in pkts if not p.is_keyframe)
    return (f"{label}: Y PSNR mean {statistics.mean(psnrs):.3f} dB "
            f"(P-frames {statistics.mean(psnrs[1:]):.3f}); "
            f"{total / len(pkts):.1f} B/frame ({p_bytes:.1f} B per P-frame) "
            f"over {len(pkts)} frames")


def realtime_end_to_end_phase(dev, frames, enc_mode):
    """M8 or M9 end to end through the public Vp9Encoder, with the launch
    counts of the run. For M8, txq_cost also runs inside the counted
    window, at its own entry point, on every P-frame's residual."""
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline.presets import qp_to_qindex
    from tpu_vp9_torch.utils import trace

    tag = f"m{enc_mode}"
    trace.enable(True)
    _reset_counts()
    pkts, recons, rows, enc, p_seconds = _encode(dev, frames, enc_mode)
    n_p = sum(not p.is_keyframe for p in pkts)
    if enc_mode == 8:
        qidx = qp_to_qindex(QP)
        dc_q, ac_q = float(T.dc_quant(qidx)), float(T.ac_quant(qidx))
        proxies = []
        for i in range(1, len(frames)):
            for n in (32, 16):
                dist, rate = K.txq_cost(
                    _residual_blocks(dev, frames[i], recons[i - 1], n),
                    dc_q, ac_q, n)
                proxies.append((i, n, float(dist.sum()), float(rate.sum())))
        torch.cuda.synchronize()
        i, n, dist, rate = proxies[-2]
        print(f"m8: txq_cost on frame {i}'s residual against frame "
              f"{i - 1}'s recon, n={n}: distortion {dist:.1f}, rate proxy "
              f"{rate:.1f}; n=16: distortion {proxies[-1][2]:.1f}, rate "
              f"proxy {proxies[-1][3]:.1f} (the coded frame took "
              f"{len(pkts[i].data)} bytes)")
        if not all(np.isfinite(v) for p in proxies for v in p[2:]):
            raise AssertionError("txq_cost: non-finite proxy")
    counts = _read_counts()
    n_k = len(pkts) - n_p
    print(f"{tag}: {len(pkts)} frames ({n_k} key, {n_p} P) at "
          f"{WIDTH}x{HEIGHT} M{enc_mode} low-delay CQP qp {QP}: launches "
          f"{counts}")
    per_p = M8_LAUNCHES if enc_mode == 8 else M9_LAUNCHES
    want = {"sad_full_search": 0, "kframe_wave": 0,
            **{k: v * n_p for k, v in per_p.items()}}
    for k, v in KEY_LAUNCHES.items():
        want[k] += v * n_k
    if n_p == 0 or n_k == 0 or counts != want:
        raise AssertionError(f"launches {counts} != {want} for {n_k} "
                             f"keyframes and {n_p} P-frames")
    tally = enc._rt.tally
    n_split, n_gold = tally["split32"], tally["golden32"]
    if tally["p_frames"] != n_p:
        raise AssertionError(f"the session tallied {tally['p_frames']} of "
                             f"{n_p} P-frames")
    print(f"{tag}: {n_split} parents split and {n_gold} blocks chose GOLDEN "
          f"over {n_p} P-frames of {M9_B} 32x32 blocks")
    if enc_mode == 8:
        interval = enc._rt.golden_interval
        if n_split == 0 or n_p <= interval:
            raise AssertionError("m8: no parent split, or no GOLDEN refresh "
                                 "inside the clip")
        print(f"m8: GOLDEN refreshed {n_p // interval} times (every "
              f"{interval} P-frames)")
    psnrs = _decode_check(pkts, recons, frames)
    print(_stream_line(f"{tag}: decode bit-exact to recon", pkts, psnrs))
    if len(pkts) > M9_FRAMES:
        print(_stream_line(f"{tag}: its first {M9_FRAMES} frames",
                           pkts[:M9_FRAMES], psnrs[:M9_FRAMES]))
    print(f"{tag}: keyframe send {rows[0][1] * 1000:.1f} ms; "
          f"{n_p / p_seconds:.3f} fps over the P-frames (first P send to "
          f"end of flush, {p_seconds:.3f} s)")
    print(f"{tag}: per P-frame send (host clock, steady state): mean "
          f"{1000 * statistics.mean(r[1] for r in rows[2:]):.1f} ms; spans "
          + _stage_means(rows[2:]))
    print(f"{tag}: " + _send_split(rows[2:]))
    trace.enable(False)
    step_ms = _step_time(enc._rt, frames[-1])
    print(f"{tag}: device step alone {step_ms:.3f} ms per P-frame "
          f"({1000 / step_ms:.2f} steps/s; host clock over 10 steps, "
          "synchronized)")
    return pkts, recons, counts


def _step_time(sess, frame) -> float:
    """Mean host-clock time of the session's step over 10 steps that run
    on its own references, synchronized before and after."""
    from tpu_vp9_torch.pipeline.presets import qp_to_qindex

    src = sess.stage(frame)
    args = sess.step_args(qp_to_qindex(QP))
    outs, refs = sess._step(*src, *sess._refs, *args)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        outs, refs = sess._step(*src, *refs, *args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 100


def _short(key: str) -> str:
    """A device op's name without its template arguments' namespaces."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::",
                 "at::", "std::"):
        key = key.replace(junk, "")
    return key[:90]


@contextlib.contextmanager
def _count_stage_launches(acc):
    """While active, every stage of the P-frame step adds its wrappers'
    launches to ``acc[stage][wrapper]``."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    real = P._stage

    @contextlib.contextmanager
    def counting(name):
        before = _read_counts()
        with real(name):
            yield
        mine = acc.setdefault(name, {})
        for k, v in _read_counts().items():
            if v != before[k]:
                mine[k] = mine.get(k, 0) + v - before[k]

    P._stage = counting
    yield
    P._stage = real


def _profile(dev, run, label):
    """Device-side records (kernels, copies) of ``run`` under
    torch.profiler, against its host-clock time; and the device time of
    each ``step_*`` stage range of the P-frame step. A range's device time
    is that of its PyTorch ops: kernels launched through ctypes are not
    attributed to it, so each stage's hand kernels are added from the
    launches its wrappers counted and the kernels' own records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stage_launches = {}
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            _count_stage_launches(stage_launches):
        tf = time.perf_counter()
        run()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - tf) * 1000
    averages = prof.key_averages()
    # a CPU op's device time repeats its children's; CUPTI's own buffer
    # requests are not the program's work; a stage range's device-side
    # record spans its first to its last kernel, idle gaps included
    events = [e for e in averages
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.key.startswith(("Activity Buffer", "step_"))]
    if not events:
        print(f"profile {label}: the profiler recorded no device time "
              "(device busy share not measured)")
        return
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile {label}: device busy {busy_ms:.3f} ms of {wall_ms:.1f} "
          f"ms host clock ({100 * busy_ms / wall_ms:.3f}% busy); "
          f"{sum(e.count for e in events)} device ops; top:")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<6} "
              f"{_short(e.key)}")
    per_launch = {}  # wrapper -> its kernel's mean device ms per launch
    for wrapper, key in WRAPPER_KERNELS.items():
        mine = [e for e in events if key in e.key]
        if mine:
            per_launch[wrapper] = (
                sum(e.self_device_time_total for e in mine) / 1e3
                / sum(e.count for e in mine))
            print(f"  kernel {key} ({wrapper}): {per_launch[wrapper]:.4f} "
                  f"ms per launch (device) over "
                  f"{sum(e.count for e in mine)} launches")
            if len(mine) > 1:  # instances of a template, by block size
                for e in mine:
                    print(f"    {e.self_device_time_total / 1e3 / e.count:.4f}"
                          f" ms per launch over {e.count}: {_short(e.key)}")
    # the host-side stage ranges: the device time of their PyTorch ops,
    # and of their hand kernels (launches counted by the wrappers, times
    # the kernel's mean device time in this profile)
    stages = sorted((e for e in averages if e.key.startswith("step_")
                     and e.device_type == DeviceType.CPU),
                    key=lambda e: -e.cpu_time_total)
    for e in stages:
        hand = stage_launches.get(e.key, {})
        if all(w in per_launch for w in hand):
            hand_ms = sum(n * per_launch[w] for w, n in hand.items())
            shown = (f"{hand_ms:.3f} ms in hand kernels {hand}, "
                     f"{(e.device_time_total / 1e3 + hand_ms):.3f} ms "
                     "together" if hand else "no hand kernel")
        else:
            shown = f"hand kernels {hand} not in the profile: not measured"
        print(f"  stage {e.key}: host {e.cpu_time_total / 1e3:.3f} ms, "
              f"device {e.device_time_total / 1e3:.3f} ms in PyTorch ops + "
              f"{shown}, over {e.count} calls (host clock under the "
              "profiler)")


def realtime_profile_phase(dev, frames, enc_mode):
    """Key and two P-frames to warm up, then three P-frame sends (each
    issues its step and fetches and hands on the previous frame) under the
    profiler."""
    enc = _make_encoder(dev, enc_mode)
    for frame in frames[:3]:
        enc.send_picture(frame)
    torch.cuda.synchronize(dev)

    def run():
        for frame in frames[3:6]:
            enc.send_picture(frame)

    _profile(dev, run, f"m{enc_mode} three 1080p P-frames")
    enc.flush()


def keyframe_phase(dev, frames):
    """Four device keyframes at 1080p through the port's RtSession (M8's
    flags, intra_period 0: every frame a keyframe), the first a warm-up:
    launches, decode bit-exact to the recon, the send time and its split by
    the spans kf_device_step (the step, synchronized), kf_d2h_transfer and
    kf_serialize; then one more keyframe send under the profiler."""
    from types import SimpleNamespace

    from tpu_vp9_torch.pipeline.presets import qp_to_qindex
    from tpu_vp9_torch.pipeline.realtime import RtSession
    from tpu_vp9_torch.utils import trace

    qidx = qp_to_qindex(QP)
    sess = RtSession(WIDTH, HEIGHT, device=dev, intra_period=0,
                     want_recon=True, split16=True, golden=True)
    trace.enable(True)
    _reset_counts()
    rows, efs = [], []
    for idx, frame in enumerate(frames[:4]):
        trace.reset()
        tf = time.perf_counter()
        efs += sess.send(frame, qindex=qidx)
        torch.cuda.synchronize()
        stages = {k: v["total_s"] for k, v in trace.summary().items()
                  if k != "notices"}
        rows.append((idx, time.perf_counter() - tf, stages))
    counts = _read_counts()
    trace.enable(False)
    want = {**dict.fromkeys(counts, 0),
            **{k: 4 * v for k, v in KEY_LAUNCHES.items()}}
    print(f"keyframes: 4 device keyframes at {WIDTH}x{HEIGHT} qp {QP}: "
          f"launches {counts}")
    if counts != want or [e.is_keyframe for e in efs] != [True] * 4:
        raise AssertionError(f"launches {counts} != {want}, or not four "
                             "keyframes")
    cw, ch = (WIDTH + 1) >> 1, (HEIGHT + 1) >> 1
    recons = [[e.state.planes[p].recon[:h, :w] for p, (h, w) in
               enumerate(((HEIGHT, WIDTH), (ch, cw), (ch, cw)))]
              for e in efs]
    psnrs = _decode_check([SimpleNamespace(data=e.payload, pts=e.pts)
                           for e in efs], recons, frames[:4])
    print(f"keyframes: decode bit-exact to recon; Y PSNR mean "
          f"{statistics.mean(psnrs):.3f} dB; "
          f"{statistics.mean(len(e.payload) for e in efs):.1f} B/keyframe")
    print(f"keyframes: send {rows[0][1] * 1000:.1f} ms the first (warm-up), "
          f"mean of the next three "
          f"{1000 * statistics.mean(r[1] for r in rows[1:]):.1f} ms; spans "
          + _stage_means(rows[1:]))
    _profile(dev, lambda: sess.send(frames[4], qindex=qidx),
             "one 1080p keyframe send")
    sess.flush()
    sess.close()


def m7_profile_phase(dev, frames):
    enc = _make_encoder(dev, 7)
    enc.send_picture(frames[0])
    _profile(dev, lambda: enc.send_picture(frames[1]), "m7 one 1080p P-frame")


def m7_end_to_end_phase(dev, frames):
    from tpu_vp9_torch.utils import trace

    trace.enable(True)
    _reset_counts()
    pkts, recons, rows, _, p_seconds = _encode(dev, frames, 7)
    counts = _read_counts()
    n_p = sum(not p.is_keyframe for p in pkts)
    print(f"m7: {len(pkts)} frames ({n_p} P) at {WIDTH}x{HEIGHT} M7 "
          f"low-delay CQP qp {QP}: launches {counts}")
    if n_p == 0 or counts != {**dict.fromkeys(counts, 0),
                              "sad_full_search": n_p}:
        raise AssertionError(f"launches {counts} != one sad_full_search for "
                             f"each of {n_p} P-frames")
    psnrs = _decode_check(pkts, recons, frames)
    total = sum(len(p.data) for p in pkts)
    print(f"m7: decode bit-exact to recon; Y PSNR mean "
          f"{statistics.mean(psnrs):.3f} dB; {total / len(pkts):.1f} "
          f"B/frame; {n_p / p_seconds:.3f} fps over the P-frames; P-frame "
          f"mean {1000 * statistics.mean(r[1] for r in rows[1:]):.1f} ms; "
          "spans " + _stage_means(rows[1:]))
    trace.enable(False)
    return pkts, counts


def same_bytes_phase(label, frames, cuda_pkts, enc_mode):
    pkts = _encode("cpu", frames[:CPU_FRAMES], enc_mode)[0]
    for idx, (a, b) in enumerate(zip(pkts, cuda_pkts)):
        if a.data != b.data:
            raise AssertionError(f"{label} frame {idx}: CPU and CUDA packets "
                                 "differ")
    print(f"{label} same bytes: the first {CPU_FRAMES} packets are identical "
          "on cpu and cuda")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from tpu_vp9_torch import native
    from tpu_vp9_torch.ops import _build
    from tpu_vp9_torch.utils.device import card_info
    from tpu_vp9_torch.utils.yuv import panning_frames

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_info()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all(LIBS)
    print(f"nvcc builds, in parallel: {time.perf_counter() - t0:.2f} s ("
          + ", ".join(f"{n} {_build.build_seconds[n]:.2f} s" for n in LIBS)
          + ")")
    for name in LIBS:
        print(_build.build_log(name).strip())
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError("the native host library did not build: "
                           f"{native.build_error}")
    print(f"native host library built and loaded: "
          f"{time.perf_counter() - t0:.2f} s")

    real, real_frames, real_recons = _real_m8_inputs(dev)
    kernels = {k["name"]: k for k in (
        sad_kernel_phase(dev), energy_kernel_phase(dev), sse_kernel_phase(dev),
        subpel_kernel_phase(dev, real["sp"]),
        transform_kernel_phase(dev, real["tr"], real_frames, real_recons),
        kframe_kernel_phase(dev), loop_filter_kernel_phase(dev, real["lf"]))}
    del real, real_frames, real_recons
    txq_synthetic_phase(dev)
    if "--kernels" in sys.argv[1:]:
        print(f"chip_smoke: the kernel phases passed in "
              f"{time.perf_counter() - t_start:.1f} s (--kernels: stopping "
              "before the encodes)")
        return 0
    frames = list(panning_frames(WIDTH, HEIGHT, M8_FRAMES, seed=1))
    m8_pkts, m8_recons, m8_counts = realtime_end_to_end_phase(dev, frames, 8)
    kernels["txq_cost"] = txq_kernel_phase(dev, frames, m8_recons)
    # the counts of the M8 run. No encode path of either package calls
    # txq_cost: its count is this script's own calls, two for each P-frame,
    # made inside the counted window after the encode
    for name in ("block_energy", "sse_map_search", "txq_cost", "loop_filter",
                 "kframe_wave", "transform_recon", "subpel_search"):
        kernels[name]["launches"] = sum(m8_counts[w]
                                        for w in ENTRY_WRAPPERS[name])
    realtime_profile_phase(dev, frames, 8)
    keyframe_phase(dev, frames)
    same_bytes_phase("m8", frames, m8_pkts, 8)
    m9_list = frames[:M9_FRAMES]
    m9_pkts, _, _ = realtime_end_to_end_phase(dev, m9_list, 9)
    realtime_profile_phase(dev, m9_list, 9)
    same_bytes_phase("m9", m9_list, m9_pkts, 9)
    m7_frames = frames[:M7_FRAMES]
    m7_pkts, m7_counts = m7_end_to_end_phase(dev, m7_frames)
    kernels["sad_full_search"]["launches"] = m7_counts["sad_full_search"]
    m7_profile_phase(dev, m7_frames)
    same_bytes_phase("m7", m7_frames, m7_pkts, 7)
    if any(k["launches"] <= 0 for k in kernels.values()):
        raise AssertionError("a kernel was not launched on its main path")

    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
