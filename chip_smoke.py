"""Smoke run of the tpu_vp9_torch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. the card, the software, and the build of every kernel (one nvcc per
     source, all started together);
  2. kernels: every kernel of the port against its plain PyTorch version
     on the card, bit for bit, at the shapes the 1080p paths give it, ties
     and negative minima included; both timed with CUDA events;
  3. M9 end to end: a 1920x1080 M9 low-delay CQP encode through the public
     Vp9Encoder; per P-frame, block_energy and sse_map_search must each
     launch twice; the stream must decode with tpu_vp9.decoder to the
     encoder's own recon; fps, step time and the host-clock stage split;
  4. M9 profile: three steady P-frames under torch.profiler, for the share
     of their time the device is busy and the top device operations;
  5. M9 same bytes: the first frames again with device="cpu" (the plain
     versions) must give identical packets;
  6. M7 (the host encode with the device full-pel search): end to end,
     profile and same bytes, as before, at a smaller depth.
Before the last line it prints one JSON object of the kernels; the last
line is {"ok": true, "device": {...}}. Without a CUDA card it exits
nonzero before printing any result. jax is blocked from being imported.
"""

from __future__ import annotations

import io
import json
import statistics
import sys
import time


class _NoJax:
    """Import hook: the port must run where jax is absent."""

    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError(f"chip_smoke: the port must not import {name}")
        return None


sys.meta_path.insert(0, _NoJax())

import numpy as np  # noqa: E402
import torch  # noqa: E402

WIDTH, HEIGHT, QP = 1920, 1080, 40
M9_FRAMES, M7_FRAMES, CPU_FRAMES = 20, 4, 3
LIBS = ("sad_search", "block_energy", "sse_search")
# main-path shapes at 1080p. M7 searches 32x32 blocks at range 16 over
# the 33 whole block rows; the M9 step's 32-grid has 34 rows (the last
# overhangs the picture by 8 pixels) of 60 blocks
SAD_B, SAD_N, SAD_R = 33 * 60, 32, 16
M9_B = 34 * 60


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
    timing = None
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
        if timing is None:  # the main path's shape
            ms = _cuda_time_ms(lambda: K.sad_full_search(src, reg, n, r), 50)
            plain_ms = _cuda_time_ms(
                lambda: K.sad_full_search_ref(src, reg, n, r), 5)
            timing = (ms, plain_ms)
            print(f"kernel sad_full_search B={SAD_B} n={n} r={r}: "
                  f"{ms:.4f} ms (CUDA), plain {plain_ms:.4f} ms, "
                  f"median of CUDA-event times")
    return {"name": "sad_full_search", "route": "cuda",
            "source": "tpu_vp9_torch/csrc/sad_search.cu",
            "replaces": "tpu_vp9/ops/pallas_kernels.py:76",
            "max_abs_err": max_err, "ms": timing[0], "plain_ms": timing[1]}


def energy_kernel_phase(dev):
    """block_energy (CUDA) against block_energy_ref at B=2040, n=32."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    rng = np.random.default_rng(3)
    max_err = 0
    for n in (32, 8, 16, 64):
        b = M9_B if n == 32 else 256
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
        if n == 32:
            ms = _cuda_time_ms(lambda: K.block_energy(s, p, 32), 50)
            plain_ms = _cuda_time_ms(lambda: K.block_energy_ref(s, p, 32), 20)
    print(f"kernel block_energy B={M9_B} n=32: {ms:.4f} ms (CUDA), plain "
          f"{plain_ms:.4f} ms, median of CUDA-event times")
    return {"name": "block_energy", "route": "cuda",
            "source": "tpu_vp9_torch/csrc/block_energy.cu",
            "replaces": "tpu_vp9/ops/pallas_kernels.py:118",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def _sse_inputs(n, r, half, seed):
    """Search inputs as the M9 step makes them: windows of n+2r+8 (2x2
    sums of uint8 pixels at the half-res level, int16), with a planted
    exact match in every other block (its minimum relative SSE is
    -sum(src^2) < 0), block 1 constant (every candidate ties) and block 3
    constant but for one bright window pixel."""
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
    dt = np.int16 if half else np.uint8
    return src.astype(dt), wins.astype(dt)


def sse_kernel_phase(dev):
    """sse_map_search (CUDA) against sse_map_search_ref at both levels of
    the M9 step's hierarchical search."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    max_err = 0
    ms = plain_ms = 0.0
    for label, n, r, half, want_map in (("half-res", 16, 18, True, True),
                                        ("refine", 32, 4, False, False)):
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
        k_ms = _cuda_time_ms(lambda: K.sse_map_search(s, w, n, r, want_map),
                             50)
        p_ms = _cuda_time_ms(
            lambda: K.sse_map_search_ref(s, w, n, r, want_map), 5)
        print(f"kernel sse_map_search {label} B={M9_B} n={n} r={r} "
              f"map={want_map}: {k_ms:.4f} ms (CUDA), plain {p_ms:.4f} ms, "
              "median of CUDA-event times")
        ms += k_ms
        plain_ms += p_ms
    print(f"kernel sse_map_search both levels of one P-frame: {ms:.4f} ms "
          f"(CUDA), plain {plain_ms:.4f} ms")
    return {"name": "sse_map_search", "route": "cuda",
            "source": "tpu_vp9_torch/csrc/sse_search.cu",
            "replaces": "tpu_vp9/pipeline/tpu_encdec.py:406",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def _psnr(a, b) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _make_encoder(device, enc_mode):
    from tpu_vp9.config import EncoderConfig, PredStructure, RateControlMode
    from tpu_vp9_torch.api import Vp9Encoder

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
    from tpu_vp9.utils import trace

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
    """Decode the IVF with tpu_vp9.decoder; bit-exact to the recon; Y PSNR
    per frame."""
    from tpu_vp9.bitstream.ivf import write_ivf_frame, write_ivf_header
    from tpu_vp9.decoder.decoder import decode_ivf

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


def _reset_counts():
    from tpu_vp9_torch.ops import cuda_kernels as K

    for fn in (K.sad_full_search, K.block_energy, K.sse_map_search):
        fn.launches = 0


def _stage_means(rows):
    stage_ms = {}
    for _, _, stages in rows:
        for name, s in stages.items():
            stage_ms[name] = stage_ms.get(name, 0.0) + 1000 * s / len(rows)
    return ", ".join(f"{k} {v:.1f} ms" for k, v in
                     sorted(stage_ms.items(), key=lambda kv: -kv[1]))


def m9_end_to_end_phase(dev, frames):
    from tpu_vp9.utils import trace
    from tpu_vp9_torch.ops import cuda_kernels as K

    trace.enable(True)
    _reset_counts()
    pkts, recons, rows, enc, p_seconds = _encode(dev, frames, 9)
    counts = {"block_energy": K.block_energy.launches,
              "sse_map_search": K.sse_map_search.launches,
              "sad_full_search": K.sad_full_search.launches}
    n_p = sum(not p.is_keyframe for p in pkts)
    print(f"m9: {len(pkts)} frames ({n_p} P) at {WIDTH}x{HEIGHT} M9 "
          f"low-delay CQP qp {QP}: launches {counts}")
    if n_p == 0 or counts != {"block_energy": 2 * n_p,
                              "sse_map_search": 2 * n_p,
                              "sad_full_search": 0}:
        raise AssertionError(f"per-P-frame launches {counts} != 2 "
                             f"block_energy and 2 sse_map_search for {n_p} "
                             "P-frames")
    psnrs = _decode_check(pkts, recons, frames)
    total = sum(len(p.data) for p in pkts)
    p_bytes = statistics.mean(len(p.data) for p in pkts if not p.is_keyframe)
    print(f"m9: decode bit-exact to recon; Y PSNR mean "
          f"{statistics.mean(psnrs):.3f} dB (P-frames "
          f"{statistics.mean(psnrs[1:]):.3f}); {total / len(pkts):.1f} "
          f"B/frame ({p_bytes:.1f} B per P-frame); keyframe send "
          f"{rows[0][1] * 1000:.1f} ms; {n_p / p_seconds:.3f} fps over the "
          f"P-frames (first P send to end of flush, {p_seconds:.3f} s)")
    print("m9: per P-frame send (host clock, steady state): mean "
          f"{1000 * statistics.mean(r[1] for r in rows[2:]):.1f} ms; spans "
          + _stage_means(rows[2:]))
    trace.enable(False)
    step_ms = _step_time(enc._rt, frames[-1])
    print(f"m9: device step alone {step_ms:.3f} ms per P-frame "
          f"({1000 / step_ms:.2f} steps/s; host clock over 10 steps, "
          "synchronized)")
    return pkts, counts


def _step_time(sess, frame) -> float:
    """Mean host-clock time of the session's step over 10 steps that run
    on its own references, synchronized before and after."""
    from tpu_vp9.bitstream import tables as T
    from tpu_vp9.ops.loopfilter import pick_filter_level
    from tpu_vp9.pipeline.presets import qp_to_qindex

    qidx = qp_to_qindex(QP)
    src = sess.stage(frame)
    lvl = pick_filter_level(qidx, False)
    args = (T.dc_quant(qidx), T.ac_quant(qidx),
            max(1, (T.ac_quant(qidx) ** 2) >> 6), lvl,
            int(sess._lim_tbl[lvl]), int(sess._mblim_tbl[lvl]))
    refs, pm = sess._refs, sess._prev_mv32
    outs, refs = sess._step(*src, *refs, pm, *args)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        outs, refs = sess._step(*src, *refs, pm, *args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 100


def _short(key: str) -> str:
    """A device op's name without its template arguments' namespaces."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::",
                 "at::", "std::"):
        key = key.replace(junk, "")
    return key[:90]


def _profile(dev, run, label):
    """Device-side records (kernels, copies) of ``run`` under
    torch.profiler, against its host-clock time; and the device time of
    each ``step_*`` stage range of the P-frame step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    for e in events:  # the hand kernels' own device time per launch
        if any(k in e.key for k in ("sad_search_kernel", "sse_search_kernel",
                                    "block_energy_kernel")):
            print(f"  kernel {_short(e.key)}: "
                  f"{e.self_device_time_total / 1e3 / e.count:.4f} ms per "
                  f"launch (device) over {e.count} launches")
    # the host-side stage ranges: their device time is their kernels'
    stages = sorted((e for e in averages if e.key.startswith("step_")
                     and e.device_type == DeviceType.CPU),
                    key=lambda e: -e.cpu_time_total)
    for e in stages:
        print(f"  stage {e.key}: host {e.cpu_time_total / 1e3:.3f} ms, "
              f"device {e.device_time_total / 1e3:.3f} ms over {e.count} "
              "calls (host clock under the profiler)")


def m9_profile_phase(dev, frames):
    """Key and two P-frames to warm up, then three P-frame sends (each
    issues its step and fetches and hands on the previous frame) under the
    profiler."""
    enc = _make_encoder(dev, 9)
    for frame in frames[:3]:
        enc.send_picture(frame)
    torch.cuda.synchronize(dev)

    def run():
        for frame in frames[3:6]:
            enc.send_picture(frame)

    _profile(dev, run, "m9 three 1080p P-frames")
    enc.flush()


def m7_profile_phase(dev, frames):
    enc = _make_encoder(dev, 7)
    enc.send_picture(frames[0])
    _profile(dev, lambda: enc.send_picture(frames[1]), "m7 one 1080p P-frame")


def m7_end_to_end_phase(dev, frames):
    from tpu_vp9.utils import trace
    from tpu_vp9_torch.ops import cuda_kernels as K

    trace.enable(True)
    _reset_counts()
    pkts, recons, rows, _, p_seconds = _encode(dev, frames, 7)
    launches = K.sad_full_search.launches
    n_p = sum(not p.is_keyframe for p in pkts)
    print(f"m7: {len(pkts)} frames ({n_p} P) at {WIDTH}x{HEIGHT} M7 "
          f"low-delay CQP qp {QP}: sad_full_search launches={launches}")
    if n_p == 0 or launches != n_p:
        raise AssertionError(f"kernel launches {launches} != P-frames {n_p}")
    psnrs = _decode_check(pkts, recons, frames)
    total = sum(len(p.data) for p in pkts)
    print(f"m7: decode bit-exact to recon; Y PSNR mean "
          f"{statistics.mean(psnrs):.3f} dB; {total / len(pkts):.1f} "
          f"B/frame; {n_p / p_seconds:.3f} fps over the P-frames; P-frame "
          f"mean {1000 * statistics.mean(r[1] for r in rows[1:]):.1f} ms; "
          "spans " + _stage_means(rows[1:]))
    trace.enable(False)
    return pkts, launches


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
    from tpu_vp9 import native
    from tpu_vp9_torch.ops import _build
    from tpu_vp9_torch.utils.device import card_info
    from tpu_vp9_torch.utils.yuv import panning_frames

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
    print(f"native host library loaded: {native.get_lib() is not None}")

    kernels = {k["name"]: k for k in (sad_kernel_phase(dev),
                                       energy_kernel_phase(dev),
                                       sse_kernel_phase(dev))}
    frames = list(panning_frames(WIDTH, HEIGHT, M9_FRAMES, seed=1))
    m9_pkts, counts = m9_end_to_end_phase(dev, frames)
    for name in ("block_energy", "sse_map_search"):
        kernels[name]["launches"] = counts[name]
    m9_profile_phase(dev, frames)
    same_bytes_phase("m9", frames, m9_pkts, 9)
    m7_frames = frames[:M7_FRAMES]
    m7_pkts, launches = m7_end_to_end_phase(dev, m7_frames)
    kernels["sad_full_search"]["launches"] = launches
    m7_profile_phase(dev, m7_frames)
    same_bytes_phase("m7", m7_frames, m7_pkts, 7)

    print(card)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
