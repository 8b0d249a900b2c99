"""Smoke run of the tpu_vp9_torch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. the card, the software and the kernel build;
  2. kernels: every kernel of the port's main path against its plain
     PyTorch version on the card, bit for bit, and both timed with CUDA
     events;
  3. end to end: a 1920x1080 M7 low-delay CQP encode through the public
     Vp9Encoder on the card; the kernel launch count must equal the number
     of P-frames, and the stream must decode with tpu_vp9.decoder to the
     encoder's own recon; per-frame and per-stage host-clock times;
  4. profile: one more P-frame under torch.profiler, for the share of
     the frame the device is busy;
  5. same bytes: the first frames again with device="cpu" (the plain
     version) must give identical packets.
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

WIDTH, HEIGHT, FRAMES, QP = 1920, 1080, 10, 40
CPU_FRAMES = 3
# main-path shape of the device search: 32x32 blocks of a 1080p frame
# (1080 // 32 = 33 rows, 1920 // 32 = 60 columns), range 16
MAIN_B, MAIN_N, MAIN_R = 33 * 60, 32, 16


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


def kernel_phase(dev):
    """sad_full_search (CUDA) against sad_full_search_ref on the card."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    cases = []
    blocks, regions = _sad_inputs(MAIN_B, MAIN_N, MAIN_R, seed=0)
    cases.append(("random+planted", MAIN_N, MAIN_R, blocks, regions))
    # every candidate ties: the first in dy-major order, (-r, -r), wins
    win = MAIN_N + 2 * MAIN_R
    cases.append(("constant tie", MAIN_N, MAIN_R,
                  np.full((MAIN_B, MAIN_N, MAIN_N), 99, np.uint8),
                  np.full((MAIN_B, win, win), 99, np.uint8)))
    for n, r in ((16, 4), (64, 16)):
        blocks, regions = _sad_inputs(512, n, r, seed=n + r)
        cases.append((f"random n={n} r={r}", n, r, blocks, regions))
    max_err = 0
    timing = None
    for name, n, r, blocks, regions in cases:
        src = torch.from_numpy(blocks).to(dev)
        reg = torch.from_numpy(regions).to(dev)
        got = K.sad_full_search(src, reg, n, r)
        torch.cuda.synchronize()
        want = K.sad_full_search_ref(src, reg, n, r)
        err = max(int((g.long() - w.long()).abs().max()) for g, w
                  in zip(got, want))
        print(f"kernel sad_full_search [{name}] B={src.shape[0]} n={n} "
              f"r={r}: max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"sad_full_search disagrees with its plain "
                                 f"version on {name}")
        if name == "constant tie":
            if not (bool((got[0] == -r).all()) and bool((got[1] == -r).all())):
                raise AssertionError("sad_full_search: tie did not go to "
                                     "(-r, -r)")
        max_err = max(max_err, err)
        if timing is None:  # the main path's shape
            ms = _cuda_time_ms(lambda: K.sad_full_search(src, reg, n, r), 50)
            plain_ms = _cuda_time_ms(
                lambda: K.sad_full_search_ref(src, reg, n, r), 5)
            timing = (ms, plain_ms)
            print(f"kernel sad_full_search B={MAIN_B} n={n} r={r}: "
                  f"{ms:.4f} ms (CUDA), plain {plain_ms:.4f} ms, "
                  f"median of CUDA-event times")
    return {"name": "sad_full_search", "route": "cuda",
            "source": "tpu_vp9_torch/csrc/sad_search.cu",
            "replaces": "tpu_vp9/ops/pallas_kernels.py:76",
            "max_abs_err": max_err, "ms": timing[0], "plain_ms": timing[1]}


def _psnr(a, b) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _make_encoder(device):
    from tpu_vp9.config import EncoderConfig, PredStructure, RateControlMode
    from tpu_vp9_torch.api import Vp9Encoder

    enc = Vp9Encoder(device=device)
    enc.set_parameter(EncoderConfig(
        source_width=WIDTH, source_height=HEIGHT, enc_mode=7,
        pred_structure=PredStructure.LOW_DELAY_P,
        rate_control_mode=RateControlMode.CQP, qp=QP, frame_rate=30))
    enc.init()
    return enc


def _encode(device, frames):
    """Encode frames one by one; per frame, the packet, the recon and a row
    (index, is_key, bytes, frame seconds, {stage: seconds} from the
    tracer's spans)."""
    from tpu_vp9.utils import trace

    enc = _make_encoder(device)
    pkts, recons, rows = [], [], []
    t0 = time.perf_counter()
    for idx, frame in enumerate(frames):
        trace.reset()
        tf = time.perf_counter()
        enc.send_picture(frame)
        pkt = enc.get_packet()
        frame_s = time.perf_counter() - tf
        if pkt is None:
            raise AssertionError(f"no packet for frame {idx}")
        pkts.append(pkt)
        recons.append(enc.get_recon())
        stages = {k: v["total_s"] for k, v in trace.summary().items()
                  if k != "notices"}
        rows.append((idx, pkt.is_keyframe, len(pkt.data), frame_s, stages))
    enc.flush()
    if enc.get_packet() is not None:
        raise AssertionError("unexpected packet after flush")
    return pkts, recons, rows, time.perf_counter() - t0


def device_busy_phase(dev, frames):
    """Encode a keyframe, then one P-frame under torch.profiler; report the
    device time it records (kernels and copies) against the P-frame's
    host-clock time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    enc = _make_encoder(dev)
    enc.send_picture(frames[0])
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tf = time.perf_counter()
        enc.send_picture(frames[1])
        torch.cuda.synchronize(dev)
        frame_s = time.perf_counter() - tf
    # device-side records only (kernels, copies): a CPU op's device time
    # repeats its children's; CUPTI's own buffer requests are not the
    # program's work
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.key.startswith("Activity Buffer")]
    if not events:
        print("profile: the profiler recorded no device time "
              "(device busy share not measured)")
        return
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    print(f"profile: one 1080p P-frame: device busy {busy_ms:.3f} ms of "
          f"{frame_s * 1000:.1f} ms host clock "
          f"({100 * busy_ms / (frame_s * 1000):.3f}% busy); top device ops: "
          + "; ".join(f"{e.key} {e.self_device_time_total / 1e3:.3f} ms"
                      for e in top))


def end_to_end_phase(dev, frames):
    from tpu_vp9.bitstream.ivf import write_ivf_frame, write_ivf_header
    from tpu_vp9.decoder.decoder import decode_ivf
    from tpu_vp9.utils import trace
    from tpu_vp9_torch.ops import cuda_kernels as K

    trace.enable(True)
    K.sad_full_search.launches = 0
    pkts, recons, rows, seconds = _encode(dev, frames)
    launches = K.sad_full_search.launches
    n_p = sum(not p.is_keyframe for p in pkts)
    print(f"e2e: {len(pkts)} frames ({n_p} P) at {WIDTH}x{HEIGHT} M7 "
          f"low-delay CQP qp {QP}: sad_full_search launches={launches}")
    if n_p == 0 or launches != n_p:
        raise AssertionError(f"kernel launches {launches} != P-frames {n_p}")
    for idx, key, nbytes, frame_s, stages in rows:
        me = stages.get("device_me", 0.0)
        print(f"e2e frame {idx} {'K' if key else 'P'}: {nbytes} B, "
              f"frame {frame_s * 1000:.1f} ms, device ME {me * 1000:.1f} ms")
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
    total = sum(len(p.data) for p in pkts)
    p_rows = [r for r in rows if not r[1]]
    pf_ms = 1000 * statistics.mean(r[3] for r in p_rows)
    stage_ms = {}
    for row in p_rows:
        for name, s in row[4].items():
            stage_ms[name] = stage_ms.get(name, 0.0) + 1000 * s / len(p_rows)
    stage_ms["unspanned"] = pf_ms - sum(stage_ms.values())
    print(f"e2e: decode bit-exact to recon; Y PSNR mean "
          f"{statistics.mean(psnrs):.3f} dB; {total / len(pkts):.1f} B/frame; "
          f"{len(pkts) / seconds:.3f} fps; P-frame mean {pf_ms:.1f} ms of "
          f"which device ME {stage_ms.get('device_me', 0.0):.1f} ms")
    print("e2e: P-frame mean by stage (host clock): " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in sorted(stage_ms.items(),
                                             key=lambda kv: -kv[1])))
    return pkts, launches


def same_bytes_phase(frames, cuda_pkts):
    pkts, _, _, _ = _encode("cpu", frames[:CPU_FRAMES])
    for idx, (a, b) in enumerate(zip(pkts, cuda_pkts)):
        if a.data != b.data:
            raise AssertionError(f"frame {idx}: CPU and CUDA packets differ")
    print(f"same bytes: the first {CPU_FRAMES} packets are identical on cpu "
          "and cuda")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from tpu_vp9 import native
    from tpu_vp9_torch.ops import _build
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.utils.device import card_info
    from tpu_vp9_torch.utils.yuv import panning_frames

    dev = torch.device("cuda", 0)
    card = card_info()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    K._sad_kernel()
    print(f"nvcc build of sad_search.cu: "
          f"{_build.build_seconds['sad_search']:.2f} s")
    print(_build.build_log("sad_search").strip())
    print(f"native host library loaded: {native.get_lib() is not None}")

    kernel = kernel_phase(dev)
    frames = list(panning_frames(WIDTH, HEIGHT, FRAMES, seed=1))
    cuda_pkts, launches = end_to_end_phase(dev, frames)
    kernel["launches"] = launches
    device_busy_phase(dev, frames)
    same_bytes_phase(frames, cuda_pkts)

    print(card)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
