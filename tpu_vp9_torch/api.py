"""Public encoder API of the port: the 7-step lifecycle on a CUDA card.

The counterpart of ``tpu_vp9/api.py`` (set_parameter -> init ->
send_picture -> get_packet -> get_recon -> flush/close), with a ``device``:
  - enc_mode 8 and 9 (LOW_DELAY_P or no hierarchical levels, CQP, VBR
    or CBR, tpu_realtime != 0) run the realtime session of
    ``pipeline/realtime.py``, whose P-frame step runs on that device:
    enc_mode 9 on the uniform 32 grid with LAST only, enc_mode 8 with
    rate tables, the GOLDEN anchor and the 32-against-16 descent
    (``RtSession(split16=True, golden=True)``), at tune SQ with the
    adaptive lambda (``aq``); at a strip geometry (mi_rows % 4 == 2: 720p,
    4K) the steps add the bottom 16-pixel strip's 16x16 blocks and the
    descent is off, as in the JAX package. At VBR and CBR the session
    holds the rate controller (its qindex per frame, its feedback after
    each serialization). A geometry the step rejects (width % 32 != 0,
    mi_rows % 4 == 1: 640x360, 854x480) takes the host route below with a
    notice, and raises ``RuntimeError`` at tpu_realtime 1, as in the JAX
    package;
  - random access with hierarchical levels (the configuration's
    default) at enc_mode 8 and 9, CQP, tpu_realtime != 0, with no recon
    file, speed control, mesh or qp override at ``init``, runs the
    hierarchical ALTREF pyramids of ``pipeline/ra_device.py``
    (``DeviceRaSession``), whose steps run on that device; packets come
    out in decode order with DTS = decode order - 2^levels + 1;
  - every other random-access configuration (enc_mode 0-7, tpu_realtime
    0, VBR or CBR, a recon file, speed control, qp overrides set before
    ``init``, a mesh) runs the host random-access engine
    (``pipeline/gop.py``, ``RaEncoder``): the same pyramids, mini-GOPs
    cut by forced and scene-cut keys, a keyframe held one frame for its
    zz-staticness, the lookahead window's complexities
    (``pipeline/lookahead.py``) handed to the rate controller, its
    full-pel motion search on that device from 1280x720 up. A geometry the device session rejects takes it too,
    with the JAX package's notice, at any tpu_realtime;
  - low delay at enc_mode <= 7, and at enc_mode 8 and 9 with tpu_realtime
    0, runs the host encode, its full-pel motion search on that device
    from 1280x720 up; at enc_mode 8 and 9 its keyframes take the open-loop
    mode hints (``codec/intra_frame.py:openloop_mode_hints_np``, built
    from ``pipeline/tpu_intra.py``).

Speed control tracks the achieved fps on the realtime and host routes and
re-derives the preset's signals when it changes the mode: the host routes
read them (a step to enc_mode 8 or 9 makes the next keyframe take the
hints), the realtime session reads none, as in the JAX package.

A mesh (``tpu_mesh_shape``) shards the realtime step's tile columns over
the first prod(mesh_shape) cards (``pipeline/tpu_shard.py``; with
device="cpu" the CPU repeated), without GOLDEN and the descent, as in the
JAX package; a mesh wider than the machine's card count, width % 64 != 0
or a column count the tiles do not divide takes the host route with a
notice (``RuntimeError`` at tpu_realtime 1). Random access with a mesh
runs the host engine. The geometry fallbacks above are the JAX package's
own; no other route falls back to another.
"""

from __future__ import annotations

import time
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
from tpu_vp9_torch.pipeline.gop import RaEncoder
from tpu_vp9_torch.pipeline.lookahead import LookaheadWindow
from tpu_vp9_torch.pipeline.picture_decision import SceneChangeDetector
from tpu_vp9_torch.pipeline.presets import derive_signals, qp_to_qindex
from tpu_vp9_torch.pipeline.ra_device import DeviceRaSession
from tpu_vp9_torch.pipeline.rate_control import RateControlState
from tpu_vp9_torch.pipeline.rc_curves import zz_staticness
from tpu_vp9_torch.pipeline.realtime import RtSession
from tpu_vp9_torch.pipeline.speed_control import SpeedControl
from tpu_vp9_torch.utils.device import require_cuda
from tpu_vp9_torch.utils.trace import notice, span
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
        self._ra = None
        self._ra_dev = None
        self._ra_buf: dict = {}  # poc -> Frame420 waiting for its mini-GOP
        self._ra_keys: set = set()  # forced and scene-cut keyframes
        self._ra_next_hint = None
        self._la = None
        self._sc = None
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
        self._dts_offset = 0  # DTS = decode_order - 2^levels + 1 (RA)
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
        ra = (cfg.pred_structure == PredStructure.RANDOM_ACCESS
              and cfg.hierarchical_levels >= 1)
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
        if ra:
            # the host random-access engine; the device session below takes
            # its place where it can
            self._ra = RaEncoder(cfg, self._sig, self._rc, device=self.device)
            self._ra.log2_tile_cols = self._log2_tile_cols
            # packetization latency: DTS = decode order - 2^levels + 1
            self._dts_offset = -(1 << cfg.hierarchical_levels) + 1
            # the initial-RC lookahead window: (2 << levels) + 1 frames at
            # CQP, else up to one intra period (64 at most)
            dist = (2 << cfg.hierarchical_levels) + 1
            if (cfg.rate_control_mode != RateControlMode.CQP
                    and cfg.intra_period > 0):
                dist = max(dist, min(cfg.intra_period, 64))
            self._la = LookaheadWindow(dist)
        if cfg.speed_control:
            self._sc = SpeedControl(target_fps=max(cfg.fps, 1.0),
                                    base_mode=cfg.enc_mode)
        if (ra and cfg.tpu_realtime != 0 and int(cfg.enc_mode) >= 8
                and not cfg.tpu_mesh_shape
                and cfg.recon_file is None and self._sc is None
                and not self._qp_overrides
                and cfg.rate_control_mode == RateControlMode.CQP):
            try:
                self._ra_dev = DeviceRaSession(
                    cfg.source_width, cfg.source_height, device=self.device,
                    gop_len=1 << cfg.hierarchical_levels,
                    intra_period=cfg.intra_period,
                    base_qindex=qp_to_qindex(cfg.qp), tune=int(cfg.tune))
            except ValueError as exc:
                # a geometry the device step rejects: the host engine
                # above encodes it, on the same device
                notice(f"device RA session unavailable ({exc}); "
                       "host RA engine")
            else:
                notice("random-access pyramids on the device step "
                       "(DeviceRaSession)")
        if int(cfg.enc_mode) >= 8 and not ra and cfg.tpu_realtime != 0:
            self._rt = self._realtime_session(cfg)
        self._initialized = True

    def _realtime_session(self, cfg):
        """The realtime session of enc_mode 8 and 9, or None where its
        step refuses the configuration with a ValueError (a geometry
        ``make_geom`` rejects; with a mesh too few cards, width % 64 or
        cols32 % tiles): the host route then takes the stream, with a
        notice, as in the JAX package; at tpu_realtime 1 that is a
        ``RuntimeError``."""
        m8 = int(cfg.enc_mode) == 8
        try:
            # VBR/CBR: the session picks each frame's qindex and feeds the
            # controller after each serialization. A mesh drops GOLDEN here,
            # as the JAX package's API does (its session would keep it)
            return RtSession(
                cfg.source_width, cfg.source_height, device=self.device,
                intra_period=cfg.intra_period,
                rc=(self._rc if cfg.rate_control_mode != RateControlMode.CQP
                    else None),
                error_resilient=cfg.error_resilient,
                frame_parallel_decoding=cfg.frame_parallel_decoding,
                want_recon=cfg.recon_file is not None,
                loop_filter=cfg.loop_filter, split16=m8,
                golden=m8 and not cfg.tpu_mesh_shape,
                mesh_shape=(tuple(cfg.tpu_mesh_shape)
                            if cfg.tpu_mesh_shape else None),
                aq=cfg.tune == Tune.SQ)
        except ValueError as exc:
            if cfg.tpu_realtime == 1:
                raise RuntimeError(
                    "tpu_realtime=1 requested but the realtime session "
                    f"rejected {cfg.source_width}x{cfg.source_height}: "
                    f"{exc}") from exc
            notice(f"realtime device session unavailable ({exc}); "
                   "falling back to host encode")
            return None

    def _speed_report(self, n_frames: int, seconds: float) -> None:
        """Feed the speed controller; re-derive the preset's signals when
        it changes the mode (the host routes read them, the realtime
        session none)."""
        if self._sc is None:
            return
        new_mode = self._sc.report(n_frames, seconds)
        if new_mode is None:
            return
        from dataclasses import replace

        self._sig = derive_signals(replace(self._cfg, enc_mode=new_mode))
        if self._ra is not None:
            self._ra.sig = self._sig

    def close(self) -> None:
        if self._rt is not None:
            self._rt.close()
        if self._ra_dev is not None:
            self._ra_dev.close()
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

        The branches of ``tpu_vp9.api.Vp9Encoder.send_picture``: the
        port's ``DeviceRaSession`` (packets once a mini-GOP's future anchor
        has arrived; no scene-cut detection, and a forced keyframe is
        ignored, as there), the host random-access engine (``RaEncoder``:
        forced and scene-cut keys, mini-GOPs encoded as they complete), its
        ``RtSession`` (enc_mode 8 and 9, one frame of latency), or the
        low-delay host encode with ``encode_pframe`` on ``self.device``.
        """
        if not self._initialized:
            raise RuntimeError("encoder not initialized")
        if self._eos:
            raise RuntimeError("send_picture after flush")
        cfg, sig, rc = self._cfg, self._sig, self._rc
        idx = self._frame_idx
        self._frame_idx += 1
        if self._ra_dev is not None:
            if force_keyframe and idx > 0:
                notice("device RA session ignores mid-stream keyframe "
                       "requests (scheduled intra period only)")
            self._emit_ra(self._ra_dev.push(frame))
            return
        if self._ra is not None:
            if force_keyframe:
                self._ra_keys.add(idx)
            elif idx > 0 and cfg.intra_period != -1:
                with span("api_scene_cut"):
                    cut = self._scd.is_scene_change(frame.y)
                if cut:
                    self._ra_keys.add(idx)
            self._ra_buf[idx] = frame
            self._la.push(idx, frame.y)
            if self._sc is not None:
                n0, t0 = len(self._packets), time.perf_counter()
                self._ra_drain(flush=False)
                self._speed_report(len(self._packets) - n0,
                                   time.perf_counter() - t0)
            else:
                self._ra_drain(flush=False)
            return
        sc_t0 = time.perf_counter()
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
            self._speed_report(1, time.perf_counter() - sc_t0)
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
        self._speed_report(1, time.perf_counter() - sc_t0)

    def _ld_kf_staticness(self, frame):
        """Keyframe staticness for the low-delay paths: at one frame of
        latency the previous picture stands in for the next one, and the
        very first keyframe uses a moderate prior."""
        prev = self._ld_prev_y
        if prev is None or prev.shape != frame.y.shape:
            return (10, 50)
        return zz_staticness(frame.y, prev, self._cfg.source_width,
                             self._cfg.source_height)

    def _emit(self, pkt: Packet) -> None:
        """Stamp decode-order DTS and queue the packet."""
        pkt.dts = self._decode_order + self._dts_offset
        self._decode_order += 1
        self._packets.append(pkt)

    def _emit_ra(self, ra_packets) -> None:
        for p in ra_packets:
            self._emit(Packet(data=p.data, pts=p.pts, dts=0,
                              is_keyframe=p.is_keyframe, qindex=p.qindex))

    def _ra_drain(self, flush: bool) -> None:
        """Encode every complete (or, at ``flush``, truncated) mini-GOP in
        the buffer: mini-GOP assembly and split driven by the keyframe
        schedule, forced and scene-cut keys, and the input available."""
        cfg, ra = self._cfg, self._ra
        max_gop = 1 << cfg.hierarchical_levels
        while True:
            next_poc = ra.base_poc + 1 if ra.base_poc >= 0 else 0
            # the next scheduled or requested keyframe at or after next_poc
            key_req = [k for k in self._ra_keys if k >= next_poc]
            next_key = min(key_req) if key_req else None
            if cfg.intra_period >= 0:
                period = cfg.intra_period + 1
                sched = ((next_poc + period - 1) // period) * period
                next_key = sched if next_key is None else min(next_key, sched)
            elif next_poc == 0:
                next_key = 0
            if next_key == next_poc:
                if next_poc not in self._ra_buf:
                    break
                # the adaptive keyframe qindex reads the next picture's
                # zz-staticness: hold the key one frame unless flushing
                nxt = self._ra_buf.get(next_poc + 1)
                if (nxt is None and not flush
                        and cfg.pred_structure == PredStructure.RANDOM_ACCESS):
                    break
                if nxt is None:
                    nxt = self._ra_next_hint
                staticness = None
                if nxt is not None:
                    cur = self._ra_buf[next_poc]
                    staticness = zz_staticness(cur.y, nxt.y, cfg.source_width,
                                               cfg.source_height)
                qov = self._qp_overridden(next_poc)
                qindex = qov if qov is not None else \
                    self._rc.frame_qindex(True, staticness=staticness)
                pkt = ra.encode_key(self._ra_buf.pop(next_poc), next_poc,
                                    qindex)
                self._la.drop([next_poc])  # retire its complexity entry
                self._ra_keys.discard(next_poc)
                self._emit_ra([pkt])
                continue
            # the mini-GOP's span ends before the next keyframe
            span_len = (max_gop if next_key is None
                        else next_key - 1 - ra.base_poc)
            if span_len <= 0:
                break  # a key is due but its frame has not arrived
            gop = 1
            while gop * 2 <= min(span_len, max_gop):
                gop *= 2
            avail = 0
            while ra.base_poc + 1 + avail in self._ra_buf:
                avail += 1
            if avail < gop:
                if not flush or avail == 0:
                    break
                gop = 1
                while gop * 2 <= avail:
                    gop *= 2
            frames = {ra.base_poc + 1 + i: self._ra_buf[ra.base_poc + 1 + i]
                      for i in range(gop)}
            qov = self._qp_overridden(ra.base_poc + 1)
            # the window's relative complexities, before qindexes are set
            self._rc.set_lookahead_scales(self._la.scales(frames))
            pkts = ra.encode_minigop(frames, ra.base_poc, gop,
                                     qindex_override=qov)
            self._la.drop(frames)
            for p in frames:
                del self._ra_buf[p]
            self._emit_ra(pkts)

    def _qp_overridden(self, poc: int):
        if poc in self._qp_overrides:
            return qp_to_qindex(self._qp_overrides[poc])
        return None

    def _emit_rt(self, ef) -> None:
        """Book-keep one realtime-path EncodedFrame into the packet queue."""
        if self._rt.rc is None:  # a session's controller had its feedback
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
        """Signal end of stream; the random-access routes' held key and
        buffered tail, and the realtime session's pipelined frames, come
        out. ``next_frame_hint``: the picture that would follow this
        stream (a GOP-parallel chunk's boundary), which the host
        random-access engine reads for a trailing keyframe's adaptive
        qindex, so that chunked encodes equal sequential ones."""
        if self._ra_dev is not None and not self._eos:
            self._emit_ra(self._ra_dev.flush())
        elif self._ra is not None and not self._eos:
            self._ra_next_hint = next_frame_hint
            self._ra_drain(flush=True)
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
