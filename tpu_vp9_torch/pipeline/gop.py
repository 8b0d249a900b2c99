"""Hierarchical (random-access) GOP engine: ALTREF pyramids.

Capability parity with the reference's prediction structures and RPS
generation (``EbPredictionStructure.c:64-120`` hierarchical tables;
``EbPictureDecisionProcess.c:943`` generate_rps_info: DPB slots,
refresh_frame_mask, show_existing_frame) and the packetization kernel's
show_existing trailer frames (``EbPacketizationProcess.c:415-453``) —
re-designed for VP9's actual mechanism instead of a table port:

VP9 outputs decoded frames in decode order, so a dyadic B-pyramid is
expressed with *hidden* ALTREF frames (show_frame=0) coded ahead of
their display time, plus 1-byte show_existing_frame packets emitted
when their display time arrives.  A minigop of length G = 2^L decodes
as::

    [ARF G hidden][ARF G/2 hidden]...[F1 shown][SE G/4]...[SE G]

Every hidden run is packed with the next shown frame into a spec Annex-B
superframe, so each IVF packet displays exactly one frame and PTS stays
monotonic.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream.headers import (
    FrameHeader, assemble_frame, build_superframe,
)
from tpu_vp9_torch.bitstream.tables import TxMode
from tpu_vp9_torch.codec.intra_frame import encode_keyframe
from tpu_vp9_torch.codec.inter_frame import encode_pframe
from tpu_vp9_torch.pipeline.encoder import _apply_loop_filter, _make_refs


@dataclass
class GopFrame:
    """One decode-order step of a minigop plan."""

    poc: int
    show: bool  # decoded-and-shown leaf vs hidden ARF
    temporal_layer: int
    last_poc: int = -1
    golden_poc: int = -1
    alt_poc: int = -1
    is_ref: bool = False
    show_existing_poc: int = -1  # >= 0: emit a show_existing packet


def plan_minigop(base_poc: int, gop_len: int, golden_poc: int) -> list:
    """Decode-order plan for frames base_poc+1 .. base_poc+gop_len.

    gop_len must be a power of two >= 1.  base_poc (and golden_poc) must
    already be in the DPB.  The frame at base_poc+gop_len is the top
    ALTREF anchor; interior frames form the dyadic pyramid.
    """
    assert gop_len >= 1 and (gop_len & (gop_len - 1)) == 0
    out = []
    top = base_poc + gop_len
    if gop_len == 1:
        out.append(GopFrame(poc=top, show=True, temporal_layer=0,
                            last_poc=base_poc, golden_poc=golden_poc,
                            is_ref=True))
        return out
    out.append(GopFrame(poc=top, show=False, temporal_layer=0,
                        last_poc=base_poc, golden_poc=golden_poc,
                        is_ref=True))

    def rec(lo: int, hi: int, layer: int) -> None:
        if hi - lo < 2:
            return
        m = (lo + hi) // 2
        leaf = (hi - lo) == 2
        out.append(GopFrame(
            poc=m, show=leaf, temporal_layer=layer, last_poc=lo,
            golden_poc=golden_poc, alt_poc=hi, is_ref=not leaf))
        if not leaf:
            rec(lo, m, layer + 1)
            out.append(GopFrame(poc=m, show=True, temporal_layer=layer,
                                show_existing_poc=m))
            rec(m, hi, layer + 1)

    rec(base_poc, top, 1)
    out.append(GopFrame(poc=top, show=True, temporal_layer=0,
                        show_existing_poc=top))
    return out


def layer_qindex(base_q: int, layer: int, n_layers: int,
                 tune: int = 1) -> int:
    """CQP per-layer quantizer ladder via the exact libvpx curve math
    (eb_vp9_qp_scaling_calc, EbRateControlProcess.c:44): layer-0 anchors
    (ARF/base) target 0.35x of the base q-value, interior layers the
    tune's delta-rate fractions."""
    from tpu_vp9_torch.pipeline import rc_curves as C

    if n_layers <= 1:
        return base_q
    # NEW_PRED_STRUCT indexes the OQ delta table with
    # [hierarchical_levels == 4] (EbRateControlProcess.c:4703): 16-frame
    # 4-level GOPs already ride the deeper 0.30/0.60/0.80/0.90 ladder
    return C.qp_scaling_qindex(base_q, False, layer, tune=tune,
                               five_level=n_layers >= 5)


class DpbAllocator:
    """POC -> VP9 DPB slot map with refresh-mask bookkeeping."""

    def __init__(self):
        self.slot_of = {}  # poc -> slot
        self.free = list(range(8))

    def slot(self, poc: int) -> int:
        return self.slot_of[poc]

    def allocate(self, poc: int) -> int:
        if not self.free:
            raise RuntimeError("DPB overflow (pyramid too deep)")
        s = self.free.pop(0)
        self.slot_of[poc] = s
        return s

    def release(self, poc: int) -> None:
        s = self.slot_of.pop(poc, None)
        if s is not None:
            self.free.append(s)

    def retain_only(self, pocs) -> None:
        for p in [p for p in self.slot_of if p not in pocs]:
            self.release(p)


@dataclass
class RaPacket:
    data: bytes
    pts: int
    dts: int
    is_keyframe: bool
    qindex: int
    temporal_layer: int = 0
    visible: bool = True  # False only for internal bookkeeping


class RaEncoder:
    """Random-access hierarchical encoder core.

    Owns the DPB (recon planes per live POC), persistent frame contexts,
    and the previous-decoded-frame MV snapshot, all tracked in decode
    order exactly as a conformant decoder would.
    """

    def __init__(self, cfg, sig, rc, device="cuda"):
        self.cfg = cfg
        self.device = device  # where encode_pframe's full-pel search runs
        self.sig = sig
        self.rc = rc
        self.dpb = DpbAllocator()
        self.planes_of = {}  # poc -> border-extended [y,u,v]
        self.fc_state = [T.default_frame_context() for _ in range(4)]
        # previous decoded frame state for use_prev_frame_mvs
        self._prev = None  # (snapshot, show_frame, (w,h), intra_only)
        self._last_was_key = False
        self._last_was_inter = False
        self.golden_poc = -1
        self.base_poc = -1
        self.log2_tile_cols = 0  # real VP9 tile columns (scale-out unit)
        self.keep_recon = False  # tests: poc -> (y, u, v) cropped recon
        self.recon_log = {}

    # -- helpers ------------------------------------------------------------

    def _store(self, poc: int, st, w: int, h: int):
        refs = _make_refs(st, w, h)
        self.planes_of[poc] = refs
        return refs

    def _log_recon(self, poc: int, st, w: int, h: int) -> None:
        if self.keep_recon:
            self.recon_log[poc] = (
                st.planes[0].recon[:h, :w].copy(),
                st.planes[1].recon[: (h + 1) >> 1, : (w + 1) >> 1].copy(),
                st.planes[2].recon[: (h + 1) >> 1, : (w + 1) >> 1].copy(),
            )

    def _fc_for_frame(self, is_key: bool):
        er = self.cfg.error_resilient
        if is_key or er:
            self.fc_state = [T.default_frame_context() for _ in range(4)]
        return None if er else self.fc_state[0]

    def _finish_frame(self, st, hdr, is_key: bool, fc_base):
        """Frame-context refresh + prev-MV snapshot, in decode order."""
        er = self.cfg.error_resilient
        after_key = (not is_key) and not self._last_was_inter
        if not er and hdr.refresh_frame_context:
            if hdr.frame_parallel_decoding_mode:
                if getattr(st, "fc_final", None) is not None:
                    self.fc_state[hdr.frame_context_idx] = st.fc_final
            elif getattr(st, "counts", None) is not None:
                from tpu_vp9_torch.codec.adapt import adapt_frame_context

                self.fc_state[hdr.frame_context_idx] = adapt_frame_context(
                    fc_base if fc_base is not None
                    else T.default_frame_context(),
                    st.counts, is_key=is_key, after_key=after_key,
                    tx_select=hdr.tx_mode == TxMode.TX_MODE_SELECT,
                    final_fc=getattr(st, "fc_final", None))
        self._last_was_key = is_key
        self._last_was_inter = not is_key
        self._prev = (st.mig.snapshot_mvs(), hdr.show_frame,
                      (hdr.width, hdr.height), is_key or hdr.intra_only)

    def _prev_mvs_for(self, w: int, h: int):
        """use_prev_frame_mvs, mirroring the decoder's rule exactly."""
        if self.cfg.error_resilient or self._prev is None:
            return None
        snap, shown, dims, intra = self._prev
        if shown and not intra and dims == (w, h):
            return snap
        return None

    # -- frame encoders -----------------------------------------------------

    def encode_key(self, frame, poc: int, qindex: int) -> RaPacket:
        cfg, sig = self.cfg, self.sig
        h, w = frame.y.shape
        fc_base = self._fc_for_frame(True)
        er = cfg.error_resilient
        tile, st = encode_keyframe(frame, qindex, sig.block_size,
                                   qbias=sig.qbias, fc_base=fc_base,
                                   open_loop_md=sig.use_tpu_hints,
                                   part_depths=sig.part_depths,
                                   log2_tile_cols=self.log2_tile_cols)
        hdr = FrameHeader(width=w, height=h, is_keyframe=True,
                          error_resilient=er, base_qindex=qindex,
                          tx_mode=TxMode.ALLOW_32X32,
                          refresh_frame_context=not er,
                          frame_parallel_decoding_mode=(
                              er or cfg.frame_parallel_decoding),
                          frame_context_idx=0,
                          log2_tile_cols=self.log2_tile_cols)
        _apply_loop_filter(st, hdr, qindex, True, enabled=cfg.loop_filter)
        payload = assemble_frame(hdr, tile, st.header_updates)
        self._finish_frame(st, hdr, True, fc_base)
        # keyframe refreshes every slot; keep it as base + golden
        self.dpb.slot_of.clear()
        self.dpb.free = list(range(8))
        self.planes_of.clear()
        slot = self.dpb.allocate(poc)
        assert slot == 0
        self._store(poc, st, w, h)
        self._log_recon(poc, st, w, h)
        self.base_poc = poc
        self.golden_poc = poc
        self.rc.update(len(payload) * 8, True)
        return RaPacket(data=payload, pts=poc, dts=poc, is_keyframe=True,
                        qindex=qindex, temporal_layer=0)

    def encode_minigop(self, frames: dict, base_poc: int, gop_len: int,
                       qindex_override=None) -> list:
        """Encode frames base_poc+1..base_poc+gop_len; returns RaPackets.

        frames: {poc: Frame420} for every poc in that range.
        qindex_override: qp-file base qindex (per-layer ladder still
        applies); None = ask the rate controller per frame.
        """
        cfg, sig = self.cfg, self.sig
        er = cfg.error_resilient
        n_layers = max(1, gop_len.bit_length())  # 2^L -> L+1 layers (0..L)
        plan = plan_minigop(base_poc, gop_len, self.golden_poc)
        # release DPB entries that this minigop will never touch
        needed = {base_poc, self.golden_poc}
        for gf in plan:
            needed |= {gf.last_poc, gf.golden_poc, gf.alt_poc, gf.poc}
        self.dpb.retain_only(needed)

        # last decode-order use of each poc: after that its slot is free
        last_use = {}
        for i, gf in enumerate(plan):
            for p in (gf.last_poc, gf.golden_poc, gf.alt_poc,
                      gf.show_existing_poc):
                if p >= 0:
                    last_use[p] = i
        packets = []
        hidden = []  # pending hidden payloads for the next superframe
        for i, gf in enumerate(plan):
            if gf.show_existing_poc >= 0:
                hdr = FrameHeader(
                    show_existing_frame=True,
                    show_existing_frame_index=self.dpb.slot(
                        gf.show_existing_poc))
                payload = assemble_frame(hdr, b"")
                assert not hidden
                packets.append(RaPacket(
                    data=payload, pts=gf.poc, dts=gf.poc, is_keyframe=False,
                    qindex=0, temporal_layer=gf.temporal_layer))
            else:
                pkt_payload, qindex = self._encode_inter_frame(
                    frames[gf.poc], gf, qindex_override, n_layers)
                if gf.show:
                    packets.append(RaPacket(
                        data=build_superframe(hidden + [pkt_payload]),
                        pts=gf.poc, dts=gf.poc, is_keyframe=False,
                        qindex=qindex, temporal_layer=gf.temporal_layer))
                    hidden = []
                else:
                    hidden.append(pkt_payload)
            # free slots whose poc is no longer needed (keep the new base)
            for p in [p for p, li in last_use.items() if li == i]:
                if p != base_poc + gop_len and p != self.golden_poc:
                    self.dpb.release(p)
                    self.planes_of.pop(p, None)
        assert not hidden
        self.base_poc = base_poc + gop_len
        # long-term GOLDEN refresh: rotate the anchor onto the new base
        # once it has aged past ~2 minigops (picture-manager long-term
        # reference policy analogue)
        if self.base_poc - self.golden_poc >= max(2 * gop_len, 8):
            old_g = self.golden_poc
            self.golden_poc = self.base_poc
            if old_g != self.base_poc and old_g in self.dpb.slot_of:
                self.dpb.release(old_g)
                self.planes_of.pop(old_g, None)
        return packets

    def _encode_inter_frame(self, frame, gf: GopFrame, qindex_override,
                            n_layers: int):
        cfg, sig = self.cfg, self.sig
        er = cfg.error_resilient
        h, w = frame.y.shape
        if qindex_override is not None:
            qindex = layer_qindex(qindex_override, gf.temporal_layer,
                                  n_layers, tune=int(cfg.tune))
        else:
            qindex = self.rc.frame_qindex(False, gf.temporal_layer,
                                          poc=gf.poc)
        fc_base = self._fc_for_frame(False)
        refs = self.planes_of[gf.last_poc]
        golden = (self.planes_of.get(gf.golden_poc)
                  if gf.golden_poc >= 0 and gf.golden_poc != gf.last_poc
                  else None)
        alt = (self.planes_of.get(gf.alt_poc)
               if gf.alt_poc >= 0 else None)
        dist_l = max(1, abs(gf.poc - gf.last_poc))
        ranges = {
            int(T.RefFrame.LAST): min(64, sig.search_range * dist_l),
        }
        if alt is not None:
            ranges[int(T.RefFrame.ALTREF)] = min(
                64, sig.search_range * max(1, abs(gf.alt_poc - gf.poc)))
        if golden is not None:
            ranges[int(T.RefFrame.GOLDEN)] = min(
                64, max(8, (sig.search_range
                            * max(1, abs(gf.poc - gf.golden_poc))) // 2))
        prev_mvs = self._prev_mvs_for(w, h)
        # picture analysis -> QPM/BEA lambda map (quality presets)
        lmap = None
        if sig.qpm or sig.denoise:
            from tpu_vp9_torch.pipeline.picture_analysis import analyze_picture

            stats = analyze_picture(frame, denoise=sig.denoise)
            if sig.qpm:
                lmap = stats.sb_lambda_map()
        # ALTREF anchors are future frames: opposite sign bias, which also
        # unlocks compound (past+future averaged) prediction.  Error-
        # resilient frames run setup_past_independence at the decoder,
        # which ZEROES the parsed sign biases (spec 7.2) — compound is
        # normatively unavailable there, so encode with all-zero biases.
        sign_bias = ((0, 0, 1) if alt is not None and gf.alt_poc > gf.poc
                     and not er else (0, 0, 0))
        tile, st = encode_pframe(
            frame, refs, qindex, sig.block_size, sig.search_range,
            qbias=sig.qbias, do_subpel=sig.do_subpel,
            adaptive_partition=sig.adaptive_partition,
            adp_budget=sig.adp_budget,
            golden_refs=golden, altref_refs=alt, ref_ranges=ranges,
            tx_select=sig.tx_select, use_tpu_me=sig.use_tpu_me,
            fc_base=fc_base, restrict_mv_modes=False, prev_mvs=prev_mvs,
            part_depths=sig.part_depths, sign_bias=sign_bias,
            lambda_map=lmap, log2_tile_cols=self.log2_tile_cols,
            full_loop=getattr(sig, "full_loop", False), device=self.device)
        # DPB wiring: LAST/GOLDEN/ALTREF -> slots; refresh for references
        last_slot = self.dpb.slot(gf.last_poc)
        golden_slot = (self.dpb.slot(gf.golden_poc)
                       if gf.golden_poc in self.dpb.slot_of else last_slot)
        alt_slot = (self.dpb.slot(gf.alt_poc)
                    if gf.alt_poc in self.dpb.slot_of else last_slot)
        refresh_mask = 0
        if gf.is_ref:
            slot = self.dpb.allocate(gf.poc)
            refresh_mask = 1 << slot
        fpdm = er or cfg.frame_parallel_decoding
        hdr = FrameHeader(
            width=w, height=h, is_keyframe=False, show_frame=gf.show,
            error_resilient=er, base_qindex=qindex,
            tx_mode=(TxMode.TX_MODE_SELECT if sig.tx_select
                     else TxMode.ALLOW_32X32),
            refresh_frame_mask=refresh_mask,
            ref_dpb_index=(last_slot, golden_slot, alt_slot),
            ref_sign_bias=sign_bias,
            reference_mode=getattr(st, "reference_mode", 0),
            reset_frame_context=0,
            refresh_frame_context=not er and gf.is_ref,
            frame_parallel_decoding_mode=fpdm,
            frame_context_idx=0, log2_tile_cols=self.log2_tile_cols)
        _apply_loop_filter(st, hdr, qindex, False, enabled=cfg.loop_filter)
        payload = assemble_frame(hdr, tile, st.header_updates)
        self._finish_frame(st, hdr, False, fc_base)
        self._log_recon(gf.poc, st, w, h)
        if gf.is_ref:
            self._store(gf.poc, st, w, h)
        self.rc.update(len(payload) * 8, False)
        return payload, qindex
