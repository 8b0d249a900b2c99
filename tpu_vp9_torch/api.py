"""Public encoder API of the port: ``tpu_vp9.api.Vp9Encoder`` on a CUDA card.

The lifecycle is the TPU package's (set_parameter -> init -> send_picture
-> get_packet -> get_recon -> flush/close); ``flush``, ``get_packet``,
``get_recon`` and the realtime packet book-keeping are inherited. This
class takes a ``device`` and overrides ``init`` and ``send_picture``:
  - enc_mode 9 (CQP, tpu_realtime != 0, no hierarchical random access)
    runs the realtime session of ``pipeline/realtime.py``, whose P-frame
    step runs on that device;
  - enc_mode <= 7 runs the low-delay host encode with its full-pel
    motion search on that device.

Routes not ported yet raise ``NotImplementedError`` (see ROADMAP.md):
random access with hierarchical levels, enc_mode 8, enc_mode 9 with
``-rt 0`` (the keyframe mode hints), rate control or a geometry the
realtime step does not take, speed control and multi-device meshes. No
route falls back to another.
"""

from __future__ import annotations

import torch

from tpu_vp9 import api as _tpu_api
from tpu_vp9.bitstream import tables as _T
from tpu_vp9.bitstream.headers import (
    FrameHeader, assemble_frame, tile_log2_limits,
)
from tpu_vp9.bitstream.tables import TxMode
from tpu_vp9.codec.intra_frame import encode_keyframe
from tpu_vp9.config import PredStructure, RateControlMode
from tpu_vp9.pipeline.encoder import _apply_loop_filter, _make_refs
from tpu_vp9.pipeline.picture_decision import SceneChangeDetector
from tpu_vp9.pipeline.presets import derive_signals, qp_to_qindex
from tpu_vp9.pipeline.rate_control import RateControlState
from tpu_vp9.utils.yuv import Frame420

from tpu_vp9_torch.codec.inter_frame import encode_pframe
from tpu_vp9_torch.pipeline.realtime import RtSession
from tpu_vp9_torch.pipeline.tpu_encdec import make_geom
from tpu_vp9_torch.utils.device import require_cuda

Packet = _tpu_api.Packet


class Vp9Encoder(_tpu_api.Vp9Encoder):
    """Streaming VP9 encoder whose device stages run on ``device``."""

    def __init__(self, device="cuda") -> None:
        super().__init__()
        self.device = torch.device(device)

    def init(self) -> None:
        if self._cfg is None:
            raise RuntimeError("set_parameter must be called before init")
        cfg = self._cfg
        if (cfg.pred_structure == PredStructure.RANDOM_ACCESS
                and cfg.hierarchical_levels >= 1):
            raise NotImplementedError(
                "tpu_vp9_torch: random access with hierarchical levels "
                "(gop.RaEncoder with device ME, ROADMAP.md Queue A) is not "
                "ported yet; use pred_structure=LOW_DELAY_P")
        if int(cfg.enc_mode) == 8:
            raise NotImplementedError(
                "tpu_vp9_torch: enc_mode 8 runs the realtime step with "
                "rate tables, GOLDEN and the split16 descent, not ported "
                "yet (ROADMAP.md Queue A item 4); use enc_mode 9 or <= 7")
        realtime = int(cfg.enc_mode) == 9
        if realtime:
            self._check_realtime(cfg)
        if cfg.speed_control:
            raise NotImplementedError(
                "tpu_vp9_torch: speed control is not ported yet "
                "(ROADMAP.md Queue A)")
        if cfg.tpu_mesh_shape:
            raise NotImplementedError(
                "tpu_vp9_torch: multi-device meshes are not ported yet "
                "(ROADMAP.md Queue A, tpu_shard)")
        if self.device.type == "cuda":
            require_cuda()
        # warm the per-block-size intra predictor tables before streaming
        from tpu_vp9.ops import intra as _intra_ops

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
        self._ra = self._ra_dev = self._rt = self._sc = None
        if realtime:
            self._rt = RtSession(
                cfg.source_width, cfg.source_height, device=self.device,
                intra_period=cfg.intra_period,
                error_resilient=cfg.error_resilient,
                frame_parallel_decoding=cfg.frame_parallel_decoding,
                want_recon=cfg.recon_file is not None,
                loop_filter=cfg.loop_filter, aq=int(cfg.tune) == 0)
        self._initialized = True

    @staticmethod
    def _check_realtime(cfg) -> None:
        """Raise for an enc_mode 9 configuration the port cannot run."""
        if cfg.tpu_realtime == 0:
            raise NotImplementedError(
                "tpu_vp9_torch: enc_mode 9 with tpu_realtime 0 (-rt 0) runs "
                "the host encode with the tpu_intra keyframe hints, not "
                "ported yet (ROADMAP.md Queue A item 10)")
        if cfg.rate_control_mode != RateControlMode.CQP:
            raise NotImplementedError(
                "tpu_vp9_torch: the realtime session's rate control "
                "(VBR/CBR) is not ported yet (ROADMAP.md Queue A item 6)")
        try:
            geom = make_geom(cfg.source_width, cfg.source_height)
        except ValueError as exc:
            raise NotImplementedError(
                f"tpu_vp9_torch: the realtime step rejects "
                f"{cfg.source_width}x{cfg.source_height} ({exc}); the host "
                "route for it is not ported (ROADMAP.md Queue A item 5)"
            ) from exc
        if geom.strip:
            raise NotImplementedError(
                f"tpu_vp9_torch: {cfg.source_width}x{cfg.source_height} "
                "needs the 16-pixel strip zone (mi_rows % 4 == 2), not "
                "ported yet (ROADMAP.md Queue A item 5)")

    def send_picture(self, frame: Frame420, force_keyframe: bool = False):
        """Encode one picture; its packet is queued for ``get_packet``.

        The realtime and the low-delay host branches of
        ``tpu_vp9.api.Vp9Encoder.send_picture``: the port's ``RtSession``
        (enc_mode 9, one frame of latency), or the host encode with the
        port's ``encode_pframe`` on ``self.device``.
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
            cut = self._scd.is_scene_change(frame.y)
            if cut and not is_key and cfg.intra_period != -1:
                is_key = True
        if self._rt is not None:
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
                from tpu_vp9.pipeline.picture_analysis import analyze_picture

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
                from tpu_vp9.codec.adapt import adapt_frame_context

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
