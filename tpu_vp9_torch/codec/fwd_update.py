"""Two-pass serialization with forward probability updates.

Pass 1 serializes with default probabilities while accumulating symbol
counts; the optimizer picks per-cell coefficient/skip probabilities whose
bit savings beat the header cost; pass 2 re-serializes with the updated
probabilities, and the header carries the subexp-coded deltas.

This is the forward-only adaptation model the reference ships
(frame_parallel_decoding_mode=1: decoders never backward-adapt), applied
per frame (error-resilient contexts reset each frame).
"""

from __future__ import annotations

import numpy as np

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream.prob_update import (
    optimize_binary_probs, optimize_coef_probs,
)
from tpu_vp9_torch.bitstream.tables import TxSize


def serialize_with_updates(st, events, qindex: int, serialize_fn,
                           fc_base=None):
    """Returns (tile_bytes, header_updates, fc_final, counts).

    fc_base: inherited frame context (non-error-resilient persistence);
    defaults to the spec default context.  counts holds every symbol
    count of the frame (probability-independent, so pass 1's counts
    equal the final stream's) for backward adaptation.
    """
    fc0 = fc_base.copy() if fc_base is not None else T.default_frame_context()
    from tpu_vp9_torch.codec.adapt import new_mode_counts
    from tpu_vp9_torch.codec.intra_frame import new_counts_sink

    sink = {**new_counts_sink(), **new_mode_counts()}
    serialize_fn(st, events, qindex, fc=fc0, counts_sink=sink)
    counts = {ts: sink[("coef", ts)] for ts in TxSize}
    eobc = {ts: sink[("eob", ts)] for ts in TxSize}
    new_coef, flags = optimize_coef_probs(fc0, counts, eobc)
    new_skip = optimize_binary_probs(
        fc0.skip_probs, sink["skip"][:, 0], sink["skip"][:, 1])
    fc1 = fc0.copy()
    updates = {"coef": {}, "skip": (fc0.skip_probs.copy(), new_skip)}
    for ts in TxSize:
        updates["coef"][ts] = (fc0.coef_probs[ts].copy(), new_coef[ts],
                               flags[ts])
        fc1.coef_probs[ts] = new_coef[ts]
    fc1.skip_probs = new_skip
    tile = serialize_fn(st, events, qindex, fc=fc1)
    return tile, updates, fc1, sink
