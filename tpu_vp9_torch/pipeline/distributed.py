"""Multi-host GOP-parallel encoding over ``torch.distributed`` (gloo).

The counterpart of ``tpu_vp9/pipeline/distributed.py``, which rides
``jax.distributed``: the same independent-GOP chunking as
``gop_parallel`` across processes on one or several hosts.

  - every process joins a gloo process group at a TCP rendezvous
    (``tcp://coordinator``) and takes chunks round-robin by rank;
  - each chunk encodes on the process's own device through the normal
    ``Vp9Encoder`` (``gop_parallel._encode_chunk``);
  - the finished chunks' packets are exchanged with one
    ``all_gather_object`` (packets are small next to pixels: the sources
    never cross hosts), and every process reassembles the
    presentation-order stream, byte-identical to a sequential encode.

The exchange unpickles only what these processes' own encoders wrote.
"""

from __future__ import annotations

import torch.distributed as dist

from tpu_vp9_torch.pipeline.gop_parallel import _encode_chunk, plan_chunks


def encode_gop_distributed(frames, cfg, *, coordinator: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           qp_overrides=None, device="cuda",
                           reports=None):
    """Encode across the processes of a gloo group; every process returns
    the full presentation-order packet list (byte-identical to the
    sequential encode).

    coordinator ("host:port"), num_processes, process_id: the rendezvous,
    world size and rank for ``init_process_group``; omit them if the
    default group is already initialized (by the launcher). A group this
    call initialized is destroyed before it returns. ``reports``, a list,
    gets the report of each chunk this process encoded.
    """
    own = coordinator is not None
    if own:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    try:
        n = dist.get_world_size()
        rank = dist.get_rank()
        chunks = plan_chunks(frames, cfg, qp_overrides, device)
        mine = [(i, c) for i, c in enumerate(chunks) if i % n == rank]
        results = {}
        for i, c in mine:
            results[i], report = _encode_chunk(c)
            if reports is not None:
                reports.append(report)
        gathered = [None] * n
        dist.all_gather_object(gathered, results)
    finally:
        if own:
            dist.destroy_process_group()
    merged: dict = {}
    for part in gathered:
        merged.update(part)
    out = []
    for i in range(len(chunks)):
        out.extend(merged[i])
    return out
