"""Inter (P) frame encoder with the full-pel search on the card.

The counterpart of ``tpu_vp9/codec/inter_frame.py:encode_pframe``. The body
is the TPU package's, and so are all the helpers it calls (imported, not
copied). Only the device motion-search block differs: it calls the port's
``tpu_block_motion`` on ``device`` and lets any failure propagate, where
the TPU package falls back to host search.
"""

from __future__ import annotations

import functools

from tpu_vp9.bitstream import tables as T
from tpu_vp9.bitstream.tables import BlockSize
from tpu_vp9.codec.inter_frame import (
    _encode_intra_in_inter, _native_phase1, batch_encode_inter_blocks,
    decide_leaf_inter, decide_leaf_sub8x8_inter, decide_partition_map,
    decide_partition_tree, decide_tx_sizes, serialize_pframe,
)
from tpu_vp9.codec.intra_frame import make_frame_state, walk_partition_fixed
from tpu_vp9.ops.inter import BORDER
from tpu_vp9.utils.trace import span

from tpu_vp9_torch.pipeline.tpu_me import tpu_block_motion

# the device search runs at a fixed range (one kernel shape per (B, n))
DEVICE_ME_RANGE = 16


def encode_pframe(frame, refs, qindex: int,
                  block_size=BlockSize.BLOCK_32X32, search_range: int = 16,
                  qbias: float = 0.38, do_subpel: bool = True,
                  prob_update: bool = True, log2_tile_cols: int = 0,
                  adaptive_partition: bool = False, golden_refs=None,
                  tx_select: bool = False, use_tpu_me: bool = False,
                  fc_base=None, restrict_mv_modes: bool = False,
                  prev_mvs=None, part_depths=None, altref_refs=None,
                  ref_ranges=None, sign_bias=(0, 0, 0), lambda_map=None,
                  full_loop: bool = False, adp_budget: float = 1.0,
                  device="cuda"):
    """Encode one P frame against border-extended refs [y, u, v].

    Arguments as ``tpu_vp9.codec.inter_frame.encode_pframe``, plus
    ``device``: where the full-pel search runs when ``use_tpu_me`` is set
    and the frame has at least 1280x720 pixels. Returns
    (tile_bytes, FrameState).
    """
    h, w = frame.y.shape
    mi_rows, mi_cols = (h + 7) >> 3, (w + 7) >> 3
    st = make_frame_state(frame, mi_rows, mi_cols)
    st._golden_refs = golden_refs
    st._altref_refs = altref_refs
    st._ref_ranges = ref_ranges
    st._restrict_mv = restrict_mv_modes
    st._prev_mvs = prev_mvs
    st._sign_bias = (0,) + tuple(sign_bias)
    st._lambda_map = lambda_map
    st._qbias = qbias
    st._rd_costs = None
    if full_loop:
        from tpu_vp9.bitstream.tables import default_frame_context
        from tpu_vp9.codec.rd_cost import FrameCosts

        st._rd_costs = FrameCosts(
            fc_base if fc_base is not None else default_frame_context(),
            qindex)
    # Device ME pays off when the per-frame block count is large enough to
    # amortize the host<->device round trip.
    if use_tpu_me and w * h >= 1280 * 720:
        n = T.BLOCK_WH[block_size][0]
        hh = (h // n) * n
        ww = (w // n) * n
        if hh and ww:
            with span("device_me"):
                mvs = tpu_block_motion(st.planes[0].source[:hh, :ww],
                                       refs[0], BORDER, n, DEVICE_ME_RANGE,
                                       device)
            st._tpu_mv = (mvs, n)
    with span("partition"):
        if part_depths is not None:
            events = decide_partition_tree(st, refs, qindex, search_range,
                                           part_depths[0], part_depths[1],
                                           log2_tile_cols)
        else:
            events = walk_partition_fixed(mi_rows, mi_cols, block_size,
                                          log2_tile_cols)
            if adaptive_partition and block_size == BlockSize.BLOCK_32X32:
                events = decide_partition_map(st, refs, events, qindex,
                                              search_range,
                                              budget_frac=adp_budget)
    # phase 1: decisions (decode order; mvrefs see final neighbor choices)
    pending = []
    intra_leaves = []
    with span("mode_decision"):
        native_done = _native_phase1(st, refs, events, qindex, search_range,
                                     do_subpel, pending, intra_leaves)
        if not native_done:
            for ev, mi_row, mi_col, bsize, _ in events:
                if ev == "tile":
                    st.tile_mi_start = mi_row
                    st.mig.tile_mi_start, st.mig.tile_mi_end = mi_row, mi_col
                    continue
                if ev != "leaf":
                    continue
                if bsize < BlockSize.BLOCK_8X8:
                    entry = decide_leaf_sub8x8_inter(
                        st, refs, mi_row, mi_col, bsize, qindex, do_subpel)
                else:
                    entry = decide_leaf_inter(st, refs, mi_row, mi_col,
                                              bsize, qindex, search_range,
                                              do_subpel)
                if entry is None:
                    intra_leaves.append((mi_row, mi_col, bsize))
                else:
                    pending.append(entry)
    # phase 2: all inter blocks batched (independent of each other)
    with span("batch_txfm"):
        if tx_select:
            decide_tx_sizes(st, pending, qindex, qbias)
            for mi, mi_row, mi_col, bsize, _ in pending:
                st.mig.set_block(mi_row, mi_col, bsize, mi)  # refresh tx
        batch_encode_inter_blocks(st, pending, qindex, qbias)
    # phase 3: intra-fallback leaves, exact recon in decode order
    with span("intra_fallback"):
        for mi_row, mi_col, bsize in intra_leaves:
            mi = st.mig.get(mi_row, mi_col)
            st.tile_mi_start = getattr(mi, "tile_mi_start", 0)
            _encode_intra_in_inter(st, mi, mi_row, mi_col, bsize, qindex,
                                   qbias)
    tx_mode = T.TxMode.TX_MODE_SELECT if tx_select else T.TxMode.ALLOW_32X32
    # frame-level reference mode from the per-block outcomes (libvpx
    # vp9_encodeframe: SINGLE if no compound blocks, COMPOUND if all,
    # SELECT otherwise)
    reference_mode = 0
    if len(set(sign_bias)) > 1:
        n_comp = n_single = 0
        for ev, mi_row, mi_col, bsize, _ in events:
            if ev != "leaf":
                continue
            mi = st.mig.get(mi_row, mi_col)
            if mi is None or not mi.is_inter:
                continue
            if mi.ref_frame[1] > 0:
                n_comp += 1
            else:
                n_single += 1
        if n_comp and n_single:
            reference_mode = 2
        elif n_comp:
            reference_mode = 1
    st.reference_mode = reference_mode
    ser = functools.partial(serialize_pframe, tx_mode=tx_mode,
                            reference_mode=reference_mode,
                            sign_bias=st._sign_bias)
    with span("serialize"):
        if prob_update:
            from tpu_vp9.codec.fwd_update import serialize_with_updates

            tile, st.header_updates, st.fc_final, st.counts = \
                serialize_with_updates(
                st, events, qindex, ser, fc_base)
        else:
            tile = ser(st, events, qindex, fc=fc_base)
            st.fc_final = fc_base
    return tile, st
