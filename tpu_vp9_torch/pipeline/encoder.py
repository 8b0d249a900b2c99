"""Top-level encoder orchestration (host path).

Collapses the reference's pipeline stages (SURVEY.md §2.3) into phases:
picture decision (keyframe placement) -> per-frame encode (intra or
inter pass A) -> serialization -> packetization (IVF payloads), with
DPB management mirroring the decoder's.

The JAX package's module asks ``tpu_intra`` for keyframe mode hints when
``use_tpu_hints`` is set and drops the device stages when its accelerator
does not answer; here the hint route raises ``NotImplementedError`` and
there is no probe.
"""

from __future__ import annotations

from dataclasses import dataclass

from tpu_vp9_torch.bitstream.headers import FrameHeader, assemble_frame
from tpu_vp9_torch.bitstream.tables import BlockSize, TxMode
from tpu_vp9_torch.codec.intra_frame import encode_keyframe
from tpu_vp9_torch.codec.inter_frame import encode_pframe
from tpu_vp9_torch.ops.inter import extend_borders


_NO_HINTS = ("tpu_vp9_torch: the device keyframe mode hints "
             "(tpu_intra.decide_modes_openloop) are not ported yet "
             "(ROADMAP.md Queue A item 10)")


@dataclass
class EncodedFrame:
    payload: bytes
    is_keyframe: bool
    qindex: int
    state: object  # FrameState (recon access for tests/PSNR)
    pts: int = 0


def _make_refs(st, width: int, height: int):
    """Border-extended reference planes from a FrameState's recon."""
    refs = []
    mi_w, mi_h = st.mi_cols * 8, st.mi_rows * 8
    for pidx in range(3):
        ss = st.planes[pidx].subsampling
        crop_w = (width + ss) >> ss
        crop_h = (height + ss) >> ss
        plane = st.planes[pidx].recon[: mi_h >> ss, : mi_w >> ss]
        refs.append(extend_borders(plane, crop_w, crop_h))
    return refs


def encode_stream(frames, qindex: int = 100, intra_period: int = -1,
                  block_size=BlockSize.BLOCK_32X32, search_range: int = 16,
                  do_subpel: bool = True, use_tpu_hints: bool = False,
                  log2_tile_cols: int = 0, part_depths=None):
    """Encode frames as IPPP... CQP. Returns list[EncodedFrame].

    intra_period: -1 = only first frame is key; else a keyframe every
    `intra_period + 1` frames.
    """
    out = []
    refs = None
    for idx, frame in enumerate(frames):
        h, w = frame.y.shape
        is_key = idx == 0 or (
            intra_period >= 0 and idx % (intra_period + 1) == 0)
        hints = None
        if is_key:
            if use_tpu_hints and w % 32 == 0 and h % 32 == 0:
                raise NotImplementedError(_NO_HINTS)
            tile, st = encode_keyframe(frame, qindex, block_size,
                                       y_mode_hints=hints,
                                       log2_tile_cols=log2_tile_cols,
                                       part_depths=part_depths)
            hdr = FrameHeader(
                width=w, height=h, is_keyframe=True, error_resilient=True,
                base_qindex=qindex, tx_mode=TxMode.ALLOW_32X32,
                log2_tile_cols=log2_tile_cols)
        else:
            tile, st = encode_pframe(frame, refs, qindex, block_size,
                                     search_range, do_subpel=do_subpel,
                                     log2_tile_cols=log2_tile_cols,
                                     part_depths=part_depths)
            hdr = FrameHeader(
                width=w, height=h, is_keyframe=False, error_resilient=True,
                base_qindex=qindex, tx_mode=TxMode.ALLOW_32X32,
                refresh_frame_mask=0xFF, ref_dpb_index=(0, 0, 0),
                allow_high_precision_mv=False,
                log2_tile_cols=log2_tile_cols)
        _apply_loop_filter(st, hdr, qindex, is_key, enabled=True)
        payload = assemble_frame(hdr, tile, st.header_updates)
        out.append(EncodedFrame(payload=payload, is_keyframe=is_key,
                                qindex=qindex, state=st, pts=idx))
        refs = _make_refs(st, w, h)
    return out


def _apply_loop_filter(st, hdr, qindex, is_key, enabled=True):
    """Pick the frame filter level and filter the recon in place."""
    from tpu_vp9_torch.utils.trace import span

    with span("loop_filter"):
        return _apply_loop_filter_inner(st, hdr, qindex, is_key, enabled)


def _apply_loop_filter_inner(st, hdr, qindex, is_key, enabled=True):
    from tpu_vp9_torch.ops.loopfilter import loop_filter_frame, pick_filter_level

    lvl = pick_filter_level(qindex, is_key) if enabled else 0
    hdr.loop_filter.filter_level = lvl
    if lvl:
        # +8 slack: edge-SB chroma bands legally extend past the nominal
        # plane (identical overhang recon on encoder and decoder sides)
        mi_w, mi_h = st.mi_cols * 8 + 8, st.mi_rows * 8 + 8
        views = [st.planes[0].recon[:mi_h, :mi_w],
                 st.planes[1].recon[:mi_h >> 1, :mi_w >> 1],
                 st.planes[2].recon[:mi_h >> 1, :mi_w >> 1]]
        lf = hdr.loop_filter
        loop_filter_frame(views, st.mig, lvl, lf.sharpness_level,
                          lf.ref_deltas, lf.mode_deltas,
                          lf.mode_ref_delta_enabled)


def encode_video(frames, cfg):
    """Config-driven encode: presets + rate control + GOP placement.

    frames: iterable of Frame420.  Returns list[EncodedFrame].
    This is the orchestration behind the public 7-step API and the CLI.
    """
    from tpu_vp9_torch.pipeline.presets import derive_signals
    from tpu_vp9_torch.pipeline.rate_control import RateControlState

    cfg = cfg.derive()
    cfg.validate()
    sig = derive_signals(cfg)
    rc = RateControlState.create(cfg)
    out = []
    refs = None
    for idx, frame in enumerate(frames):
        h, w = frame.y.shape
        is_key = idx == 0 or (
            cfg.intra_period >= 0 and cfg.intra_period != -1
            and idx % (cfg.intra_period + 1) == 0)
        if cfg.intra_period == -1:
            is_key = idx == 0
        qindex = rc.frame_qindex(is_key)
        hints = None
        if is_key:
            if sig.use_tpu_hints and w % 32 == 0 and h % 32 == 0:
                raise NotImplementedError(_NO_HINTS)
            tile, st = encode_keyframe(frame, qindex, sig.block_size,
                                       qbias=sig.qbias, y_mode_hints=hints)
            hdr = FrameHeader(
                width=w, height=h, is_keyframe=True, error_resilient=True,
                base_qindex=qindex, tx_mode=TxMode.ALLOW_32X32)
        else:
            tile, st = encode_pframe(
                frame, refs, qindex, sig.block_size, sig.search_range,
                qbias=sig.qbias, do_subpel=sig.do_subpel,
                adaptive_partition=sig.adaptive_partition,
                adp_budget=sig.adp_budget,
                full_loop=getattr(sig, "full_loop", False))
            hdr = FrameHeader(
                width=w, height=h, is_keyframe=False, error_resilient=True,
                base_qindex=qindex, tx_mode=TxMode.ALLOW_32X32,
                refresh_frame_mask=0xFF, ref_dpb_index=(0, 0, 0))
        _apply_loop_filter(st, hdr, qindex, is_key, enabled=cfg.loop_filter)
        payload = assemble_frame(hdr, tile, st.header_updates)
        rc.update(len(payload) * 8, is_key)
        out.append(EncodedFrame(payload=payload, is_keyframe=is_key,
                                qindex=qindex, state=st, pts=idx))
        refs = _make_refs(st, w, h)
    return out
