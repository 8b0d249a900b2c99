"""Public encoder API of the port: the 7-step lifecycle on a CUDA card.

The counterpart of ``tpu_vp9/api.py`` (set_parameter -> init ->
send_picture -> get_packet -> get_recon -> flush/close), with a ``device``:
  - enc_mode 8 and 9 (LOW_DELAY_P or no hierarchical levels, CQP,
    tpu_realtime != 0) run the realtime session of
    ``pipeline/realtime.py``, whose P-frame step runs on that device:
    enc_mode 9 on the uniform 32 grid with LAST only, enc_mode 8 with
    rate tables, the GOLDEN anchor and the 32-against-16 descent
    (``RtSession(split16=True, golden=True)``); at a strip geometry
    (mi_rows % 4 == 2: 720p, 4K) the steps add the bottom 16-pixel strip's
    16x16 blocks and the descent is off, as in the JAX package;
  - enc_mode <= 7 runs the low-delay host encode with its full-pel
    motion search on that device.

Routes not ported yet raise ``NotImplementedError`` naming their
``ROADMAP.md`` item: random access with hierarchical levels (the host and
the device RA engines), enc_mode 8 at tune SQ (the adaptive lambda),
enc_mode 8/9 with ``-rt 0`` (the keyframe mode hints), with rate control,
or at a geometry the realtime step does not take (width % 32 != 0,
mi_rows % 4 == 1), speed control and multi-device meshes. No route falls
back to another.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from tpu_vp9_torch.bitstream import tables as _T
from tpu_vp9_torch.bitstream.headers import (
    FrameHeader, assemble_frame, tile_log2_limits,
)
from tpu_vp9_torch.bitstream.tables import TxMode
from tpu_vp9_torch.codec.inter_frame import encode_pframe
from tpu_vp9_torch.codec.intra_frame import encode_keyframe
from tpu_vp9_torch.config import (
    EncoderConfig, PredStructure, RateControlMode, Tune,
)
from tpu_vp9_torch.pipeline.encoder import _apply_loop_filter, _make_refs
from tpu_vp9_torch.pipeline.picture_decision import SceneChangeDetector
from tpu_vp9_torch.pipeline.presets import derive_signals, qp_to_qindex
from tpu_vp9_torch.pipeline.rate_control import RateControlState
from tpu_vp9_torch.pipeline.realtime import RtSession
from tpu_vp9_torch.pipeline.tpu_encdec import make_geom
from tpu_vp9_torch.utils.device import require_cuda
from tpu_vp9_torch.utils.trace import span
from tpu_vp9_torch.utils.yuv import Frame420


@dataclass
class Packet:
    data: bytes
    pts: int
    dts: int
    is_keyframe: bool
    qindex: int


class Vp9Encoder:
    """Streaming VP9 encoder whose device stages run on ``device``."""

    def __init__(self, device="cuda") -> None:
        self.device = torch.device(device)
        self._cfg: Optional[EncoderConfig] = None
        self._initialized = False
        self._rc = None
        self._sig = None
        self._rt = None
        self._refs = None
        self._golden_refs = None
        self._since_golden = 0
        self.golden_interval = 8
        self._scd = None
        self._fc_state = None  # 4 persistent frame contexts (non-ER)
        self._last_key_idx = 0
        self._base_refs = None
        self._last_was_inter = False
        self._prev_snapshot = None  # (ref0, mv) grids of the last frame
        self._ld_prev_y = None
        self._frame_idx = 0
        self._decode_order = 0  # packets emitted so far (decode order)
        self._packets: list = []
        self._last_recon = None
        self._eos = False
        self._last_was_droppable = False
        self._qp_overrides: dict = {}

    # -- lifecycle ---------------------------------------------------------
    def set_parameter(self, cfg: EncoderConfig) -> None:
        cfg = cfg.derive()
        cfg.validate()
        self._cfg = cfg

    def init(self) -> None:
        if self._cfg is None:
            raise RuntimeError("set_parameter must be called before init")
        cfg = self._cfg
        if (cfg.pred_structure == PredStructure.RANDOM_ACCESS
                and cfg.hierarchical_levels >= 1):
            raise NotImplementedError(
                "tpu_vp9_torch: random access with hierarchical levels "
                "(gop.RaEncoder with device ME, ROADMAP.md Queue A item "
                "10; DeviceRaSession, item 9) is not ported yet; use "
                "pred_structure=LOW_DELAY_P")
        realtime = int(cfg.enc_mode) >= 8
        if realtime:
            self._check_realtime(cfg)
        if cfg.speed_control:
            raise NotImplementedError(
                "tpu_vp9_torch: speed control is not ported yet "
                "(ROADMAP.md Queue A item 6)")
        if cfg.tpu_mesh_shape:
            raise NotImplementedError(
                "tpu_vp9_torch: multi-device meshes are not ported yet "
                "(ROADMAP.md Queue A item 11, tpu_shard)")
        if self.device.type == "cuda":
            require_cuda()
        # warm the per-block-size intra predictor tables before streaming
        from tpu_vp9_torch.ops import intra as _intra_ops

        for _bs in (4, 8, 16, 32):
            _intra_ops.dir_maps(_bs)
        _intra_ops.all_modes_matrix(32)
        self._sig = derive_signals(cfg)
        self._scd = SceneChangeDetector()
        self._rc = RateControlState.create(cfg)
        mi_cols = (cfg.source_width + 7) >> 3
        lo, hi = tile_log2_limits(mi_cols)
        want = cfg.tpu_tile_columns
        log2 = int(want - 1).bit_length() if want is not None and want > 1 \
            else 0
        self._log2_tile_cols = min(max(log2, lo), hi)
        if realtime:
            m8 = int(cfg.enc_mode) == 8
            self._rt = RtSession(
                cfg.source_width, cfg.source_height, device=self.device,
                intra_period=cfg.intra_period,
                error_resilient=cfg.error_resilient,
                frame_parallel_decoding=cfg.frame_parallel_decoding,
                want_recon=cfg.recon_file is not None,
                loop_filter=cfg.loop_filter, split16=m8, golden=m8,
                aq=cfg.tune == Tune.SQ)
        self._initialized = True

    @staticmethod
    def _check_realtime(cfg) -> None:
        """Raise for an enc_mode 8/9 configuration the port cannot run."""
        mode = int(cfg.enc_mode)
        if cfg.tpu_realtime == 0:
            raise NotImplementedError(
                f"tpu_vp9_torch: enc_mode {mode} with tpu_realtime 0 (-rt 0) "
                "runs the host encode with the tpu_intra keyframe hints, "
                "not ported yet (ROADMAP.md Queue A item 10)")
        if cfg.rate_control_mode != RateControlMode.CQP:
            raise NotImplementedError(
                "tpu_vp9_torch: the realtime session's rate control "
                "(VBR/CBR) is not ported yet (ROADMAP.md Queue A item 6)")
        if mode == 8 and cfg.tune == Tune.SQ:
            raise NotImplementedError(
                "tpu_vp9_torch: enc_mode 8 at tune SQ runs the step with "
                "the adaptive lambda (aq), not ported yet (ROADMAP.md "
                "Queue A item 6); use tune OQ")
        try:
            make_geom(cfg.source_width, cfg.source_height)
        except ValueError as exc:
            raise NotImplementedError(
                f"tpu_vp9_torch: the realtime step rejects "
                f"{cfg.source_width}x{cfg.source_height} ({exc}); the host "
                "route for it is not ported (ROADMAP.md Queue A item 10)"
            ) from exc

    def close(self) -> None:
        if self._rt is not None:
            self._rt.close()
        self._initialized = False
        self._refs = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # -- data path ---------------------------------------------------------
    def set_frame_qp(self, frame_idx: int, qp: int) -> None:
        """Per-frame qp override (the qp-file's equivalent)."""
        self._qp_overrides[frame_idx] = qp

    def send_picture(self, frame: Frame420, force_keyframe: bool = False):
        """Encode one picture; its packet is queued for ``get_packet``.

        The realtime and the low-delay host branches of
        ``tpu_vp9.api.Vp9Encoder.send_picture``: the port's ``RtSession``
        (enc_mode 8 and 9, one frame of latency), or the host encode with
        ``encode_pframe`` on ``self.device``.
        """
        if not self._initialized:
            raise RuntimeError("encoder not initialized")
        if self._eos:
            raise RuntimeError("send_picture after flush")
        cfg, sig, rc = self._cfg, self._sig, self._rc
        idx = self._frame_idx
        self._frame_idx += 1
        is_key = force_keyframe or idx == 0 or (
            cfg.intra_period >= 0 and idx % (cfg.intra_period + 1) == 0)
        if self._scd is not None:
            with span("api_scene_cut"):
                cut = self._scd.is_scene_change(frame.y)
            if cut and not is_key and cfg.intra_period != -1:
                is_key = True
        if self._rt is not None:
            with span("api_frame_qindex"):
                if idx in self._qp_overrides:
                    qindex = qp_to_qindex(self._qp_overrides[idx])
                else:
                    qindex = rc.frame_qindex(
                        is_key,
                        staticness=self._ld_kf_staticness(frame)
                        if is_key else None)
            for ef in self._rt.send(frame, qindex=qindex,
                                    force_keyframe=is_key):
                self._emit_rt(ef)
            self._ld_prev_y = frame.y
            return
        h, w = frame.y.shape
        er = cfg.error_resilient
        # 2-layer low-delay hierarchy: odd frames are non-reference and
        # quantized harder; base layer in DPB slot 0, GOLDEN in slot 1
        hierarchical = (cfg.hierarchical_levels >= 1
                        and cfg.pred_structure != PredStructure.RANDOM_ACCESS)
        is_nonref = (hierarchical and not is_key
                     and (idx - self._last_key_idx) % 2 == 0)
        if is_key:
            self._last_key_idx = idx
        if idx in self._qp_overrides:
            qindex = qp_to_qindex(self._qp_overrides[idx])
        else:
            qindex = rc.frame_qindex(
                is_key,
                staticness=self._ld_kf_staticness(frame)
                if is_key else None)
            if is_nonref:
                qindex = min(qindex + 20, 255)
            elif hierarchical and not is_key:
                qindex = max(qindex - 12, 0)
        self._ld_prev_y = frame.y
        if self._fc_state is None or is_key or er:
            # setup_past_independence: reset all contexts
            self._fc_state = [_T.default_frame_context() for _ in range(4)]
        fc_base = None if er else self._fc_state[0]
        fpdm = er or cfg.frame_parallel_decoding
        after_key = (not is_key) and not self._last_was_inter
        if is_key:
            tile, st = encode_keyframe(frame, qindex, sig.block_size,
                                       qbias=sig.qbias, fc_base=fc_base,
                                       open_loop_md=sig.use_tpu_hints,
                                       part_depths=sig.part_depths,
                                       log2_tile_cols=self._log2_tile_cols)
            hdr = FrameHeader(width=w, height=h, is_keyframe=True,
                              error_resilient=er, base_qindex=qindex,
                              tx_mode=TxMode.ALLOW_32X32,
                              refresh_frame_context=not er,
                              frame_parallel_decoding_mode=fpdm,
                              frame_context_idx=0,
                              log2_tile_cols=self._log2_tile_cols)
        else:
            refresh_golden = (self._since_golden >= self.golden_interval
                              and not is_nonref)
            restrict = (not er) and self._last_was_inter
            # a frame after a droppable frame must not use its MV snapshot
            prev_usable = restrict and not self._last_was_droppable
            lmap = None
            if sig.qpm or sig.denoise:
                from tpu_vp9_torch.pipeline.picture_analysis import analyze_picture

                stats = analyze_picture(frame, denoise=sig.denoise)
                if sig.qpm:
                    lmap = stats.sb_lambda_map()
            tile, st = encode_pframe(
                frame, self._refs, qindex, sig.block_size,
                sig.search_range, qbias=sig.qbias, do_subpel=sig.do_subpel,
                adaptive_partition=sig.adaptive_partition,
                adp_budget=sig.adp_budget,
                golden_refs=self._golden_refs, tx_select=sig.tx_select,
                use_tpu_me=sig.use_tpu_me, fc_base=fc_base,
                restrict_mv_modes=restrict,
                prev_mvs=(self._prev_snapshot if prev_usable else None),
                part_depths=sig.part_depths, lambda_map=lmap,
                log2_tile_cols=self._log2_tile_cols, device=self.device)
            hdr = FrameHeader(width=w, height=h, is_keyframe=False,
                              error_resilient=er, base_qindex=qindex,
                              tx_mode=TxMode.TX_MODE_SELECT if sig.tx_select
                              else TxMode.ALLOW_32X32,
                              refresh_frame_mask=(0 if is_nonref else
                                                  (0b11 if refresh_golden
                                                   else 0b01)),
                              ref_dpb_index=(0, 1, 1),
                              reset_frame_context=0,
                              refresh_frame_context=not er and not is_nonref,
                              frame_parallel_decoding_mode=fpdm,
                              frame_context_idx=0,
                              log2_tile_cols=self._log2_tile_cols)
        _apply_loop_filter(st, hdr, qindex, is_key, enabled=cfg.loop_filter)
        payload = assemble_frame(hdr, tile, st.header_updates)
        rc.update(len(payload) * 8, is_key)
        if not er and hdr.refresh_frame_context:
            if fpdm:
                if getattr(st, "fc_final", None) is not None:
                    self._fc_state[0] = st.fc_final
            elif getattr(st, "counts", None) is not None:
                from tpu_vp9_torch.codec.adapt import adapt_frame_context

                self._fc_state[0] = adapt_frame_context(
                    fc_base if fc_base is not None
                    else _T.default_frame_context(),
                    st.counts, is_key=is_key, after_key=after_key,
                    tx_select=hdr.tx_mode == TxMode.TX_MODE_SELECT,
                    final_fc=getattr(st, "fc_final", None))
        self._last_was_inter = not is_key
        self._last_was_droppable = is_nonref
        self._prev_snapshot = st.mig.snapshot_mvs()
        if is_nonref:
            # non-reference frame: DPB slot 0 keeps the previous base
            self._refs = self._base_refs
        else:
            self._refs = _make_refs(st, w, h)
            self._base_refs = self._refs
        if is_key or (hdr.refresh_frame_mask & 0b10):
            self._golden_refs = self._refs
            self._since_golden = 0
        else:
            self._since_golden += 1
        self._last_recon = (
            st.planes[0].recon[:h, :w].copy(),
            st.planes[1].recon[: (h + 1) >> 1, : (w + 1) >> 1].copy(),
            st.planes[2].recon[: (h + 1) >> 1, : (w + 1) >> 1].copy(),
        )
        self._emit(Packet(data=payload, pts=idx, dts=0,
                          is_keyframe=is_key, qindex=qindex))

    def _ld_kf_staticness(self, frame):
        """Keyframe staticness for the low-delay paths: at one frame of
        latency the previous picture stands in for the next one, and the
        very first keyframe uses a moderate prior."""
        prev = self._ld_prev_y
        if prev is None or prev.shape != frame.y.shape:
            return (10, 50)
        from tpu_vp9_torch.pipeline.rc_curves import zz_staticness

        return zz_staticness(frame.y, prev, self._cfg.source_width,
                             self._cfg.source_height)

    def _emit(self, pkt: Packet) -> None:
        """Stamp decode-order DTS and queue the packet."""
        pkt.dts = self._decode_order
        self._decode_order += 1
        self._packets.append(pkt)

    def _emit_rt(self, ef) -> None:
        """Book-keep one realtime-path EncodedFrame into the packet queue."""
        self._rc.update(len(ef.payload) * 8, ef.is_keyframe)
        if self._rt.want_recon:
            st = ef.state
            h, w = self._cfg.source_height, self._cfg.source_width
            self._last_recon = (
                st.planes[0].recon[:h, :w].copy(),
                st.planes[1].recon[: (h + 1) >> 1, : (w + 1) >> 1].copy(),
                st.planes[2].recon[: (h + 1) >> 1, : (w + 1) >> 1].copy(),
            )
        self._emit(Packet(data=ef.payload, pts=ef.pts, dts=0,
                          is_keyframe=ef.is_keyframe, qindex=ef.qindex))

    def flush(self, next_frame_hint=None) -> None:
        """Signal end of stream; the realtime session's pipelined frames
        come out. ``next_frame_hint`` serves the random-access engine of
        the JAX package and is unused here."""
        if self._rt is not None and not self._eos:
            for ef in self._rt.flush():
                self._emit_rt(ef)
        self._eos = True

    def get_packet(self, blocking: bool = False) -> Optional[Packet]:
        if self._packets:
            return self._packets.pop(0)
        return None

    def get_recon(self):
        """Last encoded picture's reconstruction (y, u, v) or None."""
        return self._last_recon

    def get_trace_summary(self) -> dict:
        """Per-stage timing summary when tracing is enabled."""
        from tpu_vp9_torch.utils.trace import summary

        return summary()
