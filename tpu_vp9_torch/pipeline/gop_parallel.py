"""GOP-parallel encoding: independent CQP GOPs across worker processes.

The reference reserves rate-control state for parallel GOP intervals
(``PARALLEL_GOP_MAX_NUMBER``, ``EbRateControlProcess.c:4556``) but never
ships multi-process encoding; here CQP + a fixed intra period makes
every GOP a fully independent bitstream chunk (keyframes reset frame
contexts and refresh the whole DPB), so chunks encode concurrently and
concatenate to a bit-identical stream.

Determinism: each worker primes its scene-change detector with the
trailing frames of the previous chunk, so SCD decisions (and therefore
the bitstream) match the sequential encode byte-for-byte.  This is the
single-host face of the multi-host GOP-parallel design (SURVEY.md §2.7);
across hosts the same chunking rides ``pipeline/distributed.py``.

Workers are spawned, not forked: CUDA does not survive a fork once the
parent has touched the card. Each worker builds its own
``Vp9Encoder(device=...)`` on the device named in its chunk; its kernels'
launch counts and its peak device memory are its own, and come back with
its packets as the chunk's report.
"""

from __future__ import annotations

import multiprocessing as mp

# SCD keeps a 16-entry MAD history -> 17 consecutive warmup frames
# reproduce prev-frame state + full history
_SCD_WARMUP = 17


def _launch_counts() -> dict:
    from tpu_vp9_torch.ops import cuda_kernels as K

    return {name: getattr(K, name).launches for name in K._LAUNCHERS}


def _encode_chunk(payload):
    """Encode one chunk; returns (its packets, its report: the process,
    the chunk's first frame, the seconds from the encoder's creation to
    its close, the kernels it launched by wrapper and the peak device
    memory, None off CUDA)."""
    import os
    import time

    import torch

    cfg, frames, warmup_y, start_idx, qp_overrides, next_hint, device = \
        payload
    from tpu_vp9_torch.api import Vp9Encoder

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.init()  # a spawned worker has not touched the card yet
        torch.cuda.reset_peak_memory_stats(device)
    before = _launch_counts()
    t0 = time.perf_counter()
    enc = Vp9Encoder(device=device)
    enc.set_parameter(cfg)
    enc.init()
    for y in warmup_y:
        enc._scd.is_scene_change(y)
    if warmup_y:
        # low-delay adaptive-kf staticness reads the previous picture;
        # reproduce the sequential state at the chunk boundary
        enc._ld_prev_y = warmup_y[-1]
    for idx, qp in qp_overrides.items():
        enc.set_frame_qp(idx - start_idx, qp)
    for i, fr in enumerate(frames):
        enc.send_picture(fr, force_keyframe=(i == 0))
    # the following chunk's first frame keeps a trailing keyframe's
    # adaptive-QP staticness identical to the sequential encode
    enc.flush(next_frame_hint=next_hint)
    out = []
    while True:
        p = enc.get_packet()
        if p is None:
            break
        out.append((p.data, p.pts + start_idx, p.dts + start_idx,
                    p.is_keyframe, p.qindex))
    enc.close()
    seconds = time.perf_counter() - t0
    after = _launch_counts()
    report = {"pid": os.getpid(), "start": start_idx, "seconds": seconds,
              "launches": {k: after[k] - before[k] for k in after},
              "peak_bytes": (torch.cuda.max_memory_allocated(device)
                             if cuda else None)}
    return out, report


def plan_chunks(frames, cfg, qp_overrides=None, device="cuda"):
    """Independent-GOP chunk plan (shared by the process-pool and the
    multi-host dispatchers).

    Requires CQP and a non-negative intra period (the conditions under
    which chunks are independent).  Each entry carries the SCD warmup
    frames that reproduce the sequential detector state exactly, and the
    device its worker encodes on.
    """
    from tpu_vp9_torch.config import RateControlMode

    if cfg.rate_control_mode != RateControlMode.CQP:
        raise ValueError("GOP-parallel requires CQP rate control")
    if cfg.intra_period < 0:
        raise ValueError("GOP-parallel requires a fixed intra period")
    if cfg.speed_control:
        # wall-clock preset switching is machine-load dependent and
        # would break the bit-identity contract
        raise ValueError("GOP-parallel is incompatible with speed control")
    frames = list(frames)
    qp_overrides = qp_overrides or {}
    gop = cfg.intra_period + 1
    chunks = []
    for s in range(0, len(frames), gop):
        # reproduce the sequential SCD state exactly: the sequential
        # encoder never runs SCD on frame 0 and skips it on the chunk's
        # own (force-keyframed) first frame, but DOES run it on frame s
        # itself; so warm up on frames max(1, s-16)..s inclusive
        warm = [f.y for f in frames[max(1, s - (_SCD_WARMUP - 1)) : s + 1]]
        ovr = {i: q for i, q in qp_overrides.items()
               if s <= i < s + gop}
        nxt = frames[s + gop] if s + gop < len(frames) else None
        chunks.append((cfg, frames[s : s + gop], warm, s, ovr, nxt,
                       str(device)))
    return chunks


def encode_gop_parallel(frames, cfg, workers: int = 2,
                        qp_overrides=None, device="cuda", reports=None):
    """Encode ``frames`` with ``workers`` spawned processes, one GOP per
    task, each on ``device``; ``reports``, a list, gets each chunk's
    report (see ``_encode_chunk``) in chunk order.

    Returns a list of (data, pts, dts, is_keyframe, qindex) tuples in
    presentation order, byte-identical to the sequential encode.
    """
    chunks = plan_chunks(frames, cfg, qp_overrides, device)
    if workers <= 1 or len(chunks) <= 1:
        results = [_encode_chunk(c) for c in chunks]
    else:
        ctx = mp.get_context("spawn")
        with ctx.Pool(processes=min(workers, len(chunks))) as pool:
            results = pool.map(_encode_chunk, chunks)
    out = []
    for pkts, report in results:
        out.extend(pkts)
        if reports is not None:
            reports.append(report)
    return out
