"""Host and device time of each stage of the 1080p M8 P-frame step, on the
card.

    python3 -m tpu_vp9_torch.utils.step_stages [--frames N] [--calls R]
        [--tune-sq]

and, from the root of another tree of the port (an older checkout), the
same script timing that tree's package:

    python3 -c "import runpy, sys; sys.argv[1:] = ['--frames', 'N']; \
        runpy.run_path('<this file>', run_name='__main__')"

Encodes panning_frames(1920, 1080, 2 + 3N, seed=1) at enc_mode 8, low
delay, CQP qp 40 through the public encoder (the device keyframe, GOLDEN,
the 32-against-16 descent; with ``--tune-sq`` tune SQ, the adaptive
lambda): the keyframe and N P-frames to warm up, then N
P-frames with ``utils.trace`` on (each ``step_*`` span's host-clock time,
mean per P-frame: the time the host spends enqueueing the stage), then N
more under torch.profiler: each ``step_*`` range's device time in PyTorch
ops, plus that of the hand kernels it launched (each wrapper's launches
counted inside the range, times its kernel's mean device time per launch
in the same profile), per P-frame. Prints one line per stage, the P-frame
send's mean host time, the card's name and power limit, and which tree's
package ran. With ``--calls R`` it then times the descent's gather, pack
and split dispatches, the borders' (``extend_borders``) and the MC sites'
on the inputs of one more P-frame's calls, R calls each (CUDA events
around a call, median; the host's time a call over R calls back to
back), each dispatch of ``RECORDED`` the tree calls: where its gather does
not return the children's ZERO SSE, the children's ``block_energy_at``
call too, where its pack does not take their recon SSE, their
``block_energy`` call, and where its MC launches do not make their
decisions (``mode_decide_mc``, ``descent_decide_mc``), the decisions'
``mode_decide`` and ``descent_decide`` calls and the two ``mc_predict``
calls; each of these also with its partner (``PAIRS``).

It reads only the public encoder, ``pipeline/tpu_encdec.py:_stage`` and
the wrappers' ``launches`` counts, so the second form times an older tree
of the port (its kernels built into that tree's ``_build/``): run both
trees in turns in one call to compare them.
"""

from __future__ import annotations

import contextlib
import glob
import os
import statistics
import sys
import time

import torch

WIDTH, HEIGHT, QP = 1920, 1080, 40
# the wrappers whose kernel is named otherwise than <wrapper>_kernel
KERNEL_NAMES = {"hier_search_fused": "hier_search_kernel",
                "sse_map_search": "sse_search_kernel",
                "sad_full_search": "sad_search_kernel"}


def _wrappers():
    """Every kernel wrapper of the tree's ``ops/cuda_kernels.py`` (a
    function with a ``launches`` count), by name."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    return {k: v for k, v in vars(K).items()
            if callable(v) and isinstance(getattr(v, "launches", None), int)}


def _median_call_ms(fn, reps: int) -> float:
    """Median of CUDA-event times around one call of ``fn``."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_call_ms(fn, reps: int) -> float:
    """The host's time a call, ``reps`` calls back to back."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = 1000 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return ms


# the dispatches --calls records where the tree has them (a call made
# inside encode_children_masked is the children's); and the calls each
# pair stands beside: a tree's merged call, or the calls it replaced in an
# older tree, timed one after the other
RECORDED = ("descent_gather", "descent_pack", "descent_split",
            "extend_borders", "block_energy_at", "block_energy",
            "mode_decide", "mc_predict", "descent_decide", "mode_decide_mc",
            "descent_decide_mc")
PAIRS = (("descent_gather", "children block_energy_at"),
         ("descent_pack", "children block_energy"),
         ("mode_decide", "mc_predict"),
         ("children descent_decide", "children mc_predict"))


def _descent_calls(enc, frame, reps: int) -> None:
    """Send ``frame`` with the dispatches of ``RECORDED`` that the tree has
    recorded, then time each on its recorded inputs, and each pair of
    ``PAIRS`` recorded; the split's zone planes are copied when recorded
    (a tree whose split writes them in place changes them in the step)."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    calls, inside = {}, [False]
    names = [k for k in RECORDED if hasattr(P, k)]
    real = {k: getattr(P, k) for k in (*names, "encode_children_masked")}

    def recorder(name):
        def record(*args, **kw):
            key = f"children {name}" if inside[0] else name
            if name == "descent_split":
                args = (*args[:5], *(t.clone() for t in args[5:8]),
                        *args[8:])
            calls[key] = (name, args, kw)
            return real[name](*args, **kw)
        return record

    def children(*args, **kw):
        inside[0] = True
        try:
            return real["encode_children_masked"](*args, **kw)
        finally:
            inside[0] = False

    for name in names:
        setattr(P, name, recorder(name))
    P.encode_children_masked = children
    try:
        enc.send_picture(frame)
        torch.cuda.synchronize()
    finally:
        for k, v in real.items():
            setattr(P, k, v)
    fns = {k: (lambda f=real[name], a=a, kw=kw: f(*a, **kw))
           for k, (name, a, kw) in calls.items()}
    for pair in PAIRS:
        if all(k in fns for k in pair):
            fns[" + ".join(pair)] = \
                lambda fs=[fns[k] for k in pair]: [f() for f in fs]
    for name, fn in fns.items():
        print(f"call {name}: {_median_call_ms(fn, reps):.4f} ms (CUDA "
              f"events, median of {reps}), host {_host_call_ms(fn, reps):.4f}"
              f" ms a call ({reps} back to back)")


@contextlib.contextmanager
def _stage_launches(acc):
    """While active, each ``step_*`` stage adds the launches its wrappers
    counted to ``acc[stage][wrapper]``."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    real, fns = P._stage, _wrappers()

    @contextlib.contextmanager
    def counting(name):
        before = {k: f.launches for k, f in fns.items()}
        with real(name):
            yield
        mine = acc.setdefault(name, {})
        for k, f in fns.items():
            if f.launches != before[k]:
                mine[k] = mine.get(k, 0) + f.launches - before[k]

    P._stage = counting
    try:
        yield
    finally:
        P._stage = real


def main() -> int:
    if not torch.cuda.is_available():
        print("step_stages: no CUDA device available", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import tpu_vp9_torch
    from tpu_vp9_torch.api import Vp9Encoder
    from tpu_vp9_torch.config import EncoderConfig, PredStructure, Tune
    from tpu_vp9_torch.ops import _build
    from tpu_vp9_torch.utils import trace
    from tpu_vp9_torch.utils.device import card_info
    from tpu_vp9_torch.utils.yuv import panning_frames

    n = int(sys.argv[sys.argv.index("--frames") + 1]) \
        if "--frames" in sys.argv else 4
    reps = int(sys.argv[sys.argv.index("--calls") + 1]) \
        if "--calls" in sys.argv else 0
    tune = {"tune": Tune.SQ} if "--tune-sq" in sys.argv else {}
    libs = sorted(os.path.basename(p)[:-3]
                  for p in glob.glob(os.path.join(_build.CSRC, "*.cu")))
    t0 = time.perf_counter()
    _build.build_all(libs)
    print(f"tree {os.path.dirname(tpu_vp9_torch.__file__)}: {len(libs)} "
          f"kernel sources built in {time.perf_counter() - t0:.1f} s")
    frames = list(panning_frames(WIDTH, HEIGHT, 2 + 3 * n, seed=1))
    enc = Vp9Encoder(device="cuda")
    enc.set_parameter(EncoderConfig(
        source_width=WIDTH, source_height=HEIGHT, enc_mode=8,
        pred_structure=PredStructure.LOW_DELAY_P, qp=QP, **tune))
    enc.init()
    for frame in frames[:1 + n]:
        enc.send_picture(frame)
    torch.cuda.synchronize()

    # host clock: the step's spans, per P-frame
    trace.enable(True)
    trace.reset()
    sends = []
    for frame in frames[1 + n:1 + 2 * n]:
        t0 = time.perf_counter()
        enc.send_picture(frame)
        torch.cuda.synchronize()
        sends.append(time.perf_counter() - t0)
    host = {k: 1000 * v["total_s"] / n for k, v in trace.summary().items()
            if k.startswith("step_")}
    trace.enable(False)

    # device: the stages' ranges and their hand kernels, per P-frame
    launches = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            _stage_launches(launches):
        for frame in frames[1 + 2 * n:1 + 3 * n]:
            enc.send_picture(frame)
        torch.cuda.synchronize()
    if reps:
        _descent_calls(enc, frames[-1], reps)
    enc.flush()
    enc.close()
    averages = prof.key_averages()
    per_launch = {}
    for name in _wrappers():
        mine = [e for e in averages if e.device_type == DeviceType.CUDA
                and KERNEL_NAMES.get(name, f"{name}_kernel") in e.key
                and e.self_device_time_total > 0]
        if mine:
            per_launch[name] = (sum(e.self_device_time_total for e in mine)
                                / 1e3 / sum(e.count for e in mine))
    device = {e.key: e.device_time_total / 1e3 / n for e in averages
              if e.key.startswith("step_")
              and e.device_type == DeviceType.CPU}
    print(f"1080p M8{' tune SQ' if tune else ''} P-frame send: "
          f"{1000 * statistics.mean(sends):.2f} ms host clock, mean of {n} "
          "(synchronized)")
    for stage in sorted(set(host) | set(device)):
        hand = {k: v / n for k, v in launches.get(stage, {}).items()}
        hand_ms = sum(v * per_launch.get(k, 0.0) for k, v in hand.items())
        dev_ms = (f"{device.get(stage, 0.0) + hand_ms:.3f}"
                  if all(k in per_launch for k in hand) else "not measured")
        print(f"stage {stage}: host {host.get(stage, 0.0):.3f} ms, device "
              f"{dev_ms} ms ({device.get(stage, 0.0):.3f} in PyTorch ops, "
              f"hand kernels {hand}) per P-frame")
    print(card_info())
    return 0


if __name__ == "__main__":
    sys.exit(main())
