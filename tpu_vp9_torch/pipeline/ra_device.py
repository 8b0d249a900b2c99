"""Hierarchical random-access encode session on torch: ALTREF pyramids.

The counterpart of ``tpu_vp9/pipeline/ra_device.py:DeviceRaSession``, the
route of the encoder's default configuration (random access, 4
hierarchical levels, enc_mode 8 and 9, CQP). The dyadic mini-GOP plan of
``pipeline/gop.py`` (decode order, hidden ALTREF frames, show_existing
trailers, superframes) drives the device P-frame step of
``pipeline/tpu_encdec.py`` with a multi-slot DPB whose reference planes
stay on ``device``. Every frame searches its nearer past anchor (LAST)
and, inside the pyramid, its future anchor (ALTREF: a full search of its
own, the opposite sign bias), and may take the long-term GOLDEN anchor,
chosen per block in the step; the descent takes every parent
(``descend_frac=1``) where the geometry has no strip. The keyframe is the
device keyframe of a private ``RtSession``. Each frame is serialized
natively as soon as it is fetched, and the frame context backward-adapts
in decode order, as a decoder's does.

CQP per-layer quantizers follow the qp-scaling ladder of
``gop.layer_qindex``. Per frame the rate tables are made from the frame
context of that moment (serialization is synchronous).

One behaviour differs from the JAX session on purpose: when a scheduled
keyframe comes while frames of an unfinished mini-GOP wait (or while the
previous keyframe is still held, at ``intra_period`` 0), those frames are
encoded first, the held key with the new picture as its next one, the
others as the tail that ``flush`` encodes (a chain of single-frame
mini-GOPs). The JAX session leaves them behind: they are never coded, and
its ``flush`` then fails to find the next frame it plans. With
``intra_period`` -1 the two sessions are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream.headers import (
    FrameHeader, assemble_frame, build_superframe,
)
from tpu_vp9_torch.bitstream.tables import TxMode
from tpu_vp9_torch.ops.loopfilter import pick_filter_level
from tpu_vp9_torch.pipeline.gop import (
    DpbAllocator, RaPacket, layer_qindex, plan_minigop,
)
from tpu_vp9_torch.pipeline.realtime import (
    RtSession, _device_out_to_host, serialize_device_frame,
)
from tpu_vp9_torch.pipeline.tpu_encdec import (
    make_pframe_step, make_rate_tabs, upload_rate_tabs,
)
from tpu_vp9_torch.utils.trace import span


class DeviceRaSession:
    """Streaming hierarchical random-access encoder whose steps run on
    ``device``.

    ``push`` buffers pictures; a mini-GOP is encoded once its future
    anchor has arrived. Packets come out in decode order, each hidden
    frame in a superframe with the next shown one, each shown frame that
    was coded hidden as a show_existing packet; pts = poc.
    """

    def __init__(self, width: int, height: int, *, device="cuda",
                 gop_len: int = 8, intra_period: int = -1,
                 base_qindex: int = 100, tune: int = 1,
                 want_recon: bool = False):
        if gop_len < 1 or gop_len & (gop_len - 1):
            raise ValueError(f"gop_len {gop_len} is not a power of two")
        self.device = torch.device(device)
        self.w, self.h = width, height
        self.gop_len = gop_len
        self.intra_period = intra_period
        self.base_qindex = base_qindex
        self.tune = tune
        # the keyframe machinery (the device keyframe and its serializer)
        # rides a private RtSession; its P-frame state goes unused
        self._rt = RtSession(width, height, device=self.device,
                             want_recon=want_recon)
        self.g = self._rt.g
        self._lim_tbl = self._rt._lim_tbl
        self._mblim_tbl = self._rt._mblim_tbl
        self.dpb = DpbAllocator()
        self.planes_of = {}   # poc -> (y, u, v) border-extended, on device
        self.mv_of = {}       # poc -> (B32, 2) int32 MVs (search seeds)
        self.fc = [T.default_frame_context() for _ in range(4)]
        self._prev = None     # (mv snapshot, shown, dims, intra)
        self.golden_poc = -1
        self.base_poc = -1
        self._buf = {}        # poc -> Frame420
        self._pending_key = None
        self._next_poc = 0
        self._since_key = 0
        self._steps = {}
        # what the P-frames decided, in 32x32 blocks (children excluded)
        self.tally = {"p_frames": 0, "split32": 0, "golden32": 0,
                      "altref32": 0, "split_not_last": 0,
                      "split_overhang": 0}

    # -- device step variants -------------------------------------------

    def _step_for(self, golden: bool, altref: bool):
        key = (golden, altref)
        if key not in self._steps:
            self._steps[key] = make_pframe_step(
                self.g, self.device, split16=not self.g.strip,
                golden=golden, altref=altref, with_rates=True,
                descend_frac=1)
        return self._steps[key]

    # -- streaming API ---------------------------------------------------

    def push(self, frame):
        """Feed one picture (display order); returns the RaPackets that
        are ready."""
        out = []
        poc = self._next_poc
        self._next_poc += 1
        is_key = poc == 0 or (
            self.intra_period >= 0
            and self._since_key > self.intra_period)
        if is_key:
            # a key still held (intra_period 0), and the frames of an
            # unfinished mini-GOP, go first
            if self._pending_key is not None:
                out.extend(self._encode_pending_key(next_frame=frame))
            out.extend(self._encode_tail())
            # hold the key one frame: its quantizer takes the following
            # picture's zz-staticness
            self._pending_key = (frame, poc)
            self._since_key = 1
            return out
        self._since_key += 1
        if self._pending_key is not None:
            out.extend(self._encode_pending_key(next_frame=frame))
        self._buf[poc] = frame
        if poc == self.base_poc + self.gop_len:
            out.extend(self._encode_minigop())
        return out

    def _encode_pending_key(self, next_frame=None):
        kf, kpoc = self._pending_key
        self._pending_key = None
        staticness = None
        if next_frame is not None:
            from tpu_vp9_torch.pipeline.rc_curves import zz_staticness

            staticness = zz_staticness(kf.y, next_frame.y, self.w, self.h)
        return self._encode_key(kf, kpoc, staticness=staticness)

    def _encode_tail(self):
        """Encode the buffered frames as single-frame mini-GOPs."""
        out = []
        while self._buf:
            pocs = sorted(self._buf)
            out.extend(self._encode_minigop(gop_len=1))
            if sorted(self._buf) == pocs:
                break
        return out

    def flush(self):
        """Encode the held key and the buffered tail (a low-delay chain
        of single-frame mini-GOPs)."""
        out = []
        if self._pending_key is not None:
            out.extend(self._encode_pending_key())
        out.extend(self._encode_tail())
        return out

    def close(self):
        """Stop the private session's worker; call after ``flush``."""
        self._rt.close()

    # -- keyframe --------------------------------------------------------

    def _encode_key(self, frame, poc: int, staticness=None):
        from tpu_vp9_torch.pipeline import rc_curves as C

        rt = self._rt
        # the keyframe quantizer rides the I-slice qp-scaling curves
        if staticness is not None:
            qidx = C.adaptive_kf_qindex(self.base_qindex, staticness[0],
                                        staticness[1], self.w, self.h)
        else:
            qidx = C.qp_scaling_qindex(self.base_qindex, True, 0,
                                       tune=self.tune, five_level=False)
        ef = rt._encode_key(frame, poc, qidx)
        self.fc = rt._fc
        self.dpb.slot_of.clear()
        self.dpb.free = list(range(8))
        self.planes_of.clear()
        self.mv_of.clear()
        slot = self.dpb.allocate(poc)
        assert slot == 0
        self.planes_of[poc] = rt._refs
        self.base_poc = poc
        self.golden_poc = poc
        self._prev = None
        return [RaPacket(data=ef.payload, pts=poc, dts=poc,
                         is_keyframe=True, qindex=qidx, temporal_layer=0)]

    # -- mini-GOP --------------------------------------------------------

    def _release(self, poc: int) -> None:
        self.dpb.release(poc)
        self.planes_of.pop(poc, None)
        self.mv_of.pop(poc, None)

    def _encode_minigop(self, gop_len: int = None):
        gop_len = gop_len or self.gop_len
        base_poc = self.base_poc
        n_layers = max(1, gop_len.bit_length())
        plan = plan_minigop(base_poc, gop_len, self.golden_poc)
        needed = {base_poc, self.golden_poc}
        for gf in plan:
            needed |= {gf.last_poc, gf.golden_poc, gf.alt_poc, gf.poc}
        self.dpb.retain_only(needed)
        for p in list(self.planes_of):
            if p not in self.dpb.slot_of:
                self.planes_of.pop(p, None)
                self.mv_of.pop(p, None)
        last_use = {}
        for i, gf in enumerate(plan):
            for p in (gf.last_poc, gf.golden_poc, gf.alt_poc,
                      gf.show_existing_poc):
                if p >= 0:
                    last_use[p] = i
        packets = []
        hidden = []
        for i, gf in enumerate(plan):
            if gf.show_existing_poc >= 0:
                hdr = FrameHeader(
                    show_existing_frame=True,
                    show_existing_frame_index=self.dpb.slot(
                        gf.show_existing_poc))
                packets.append(RaPacket(
                    data=assemble_frame(hdr, b""), pts=gf.poc, dts=gf.poc,
                    is_keyframe=False, qindex=0,
                    temporal_layer=gf.temporal_layer))
                assert not hidden
            else:
                payload, qidx = self._encode_frame(gf, n_layers)
                if gf.show:
                    packets.append(RaPacket(
                        data=build_superframe(hidden + [payload]),
                        pts=gf.poc, dts=gf.poc, is_keyframe=False,
                        qindex=qidx, temporal_layer=gf.temporal_layer))
                    hidden = []
                else:
                    hidden.append(payload)
                self._buf.pop(gf.poc, None)
            for p in [p for p, li in last_use.items() if li == i]:
                if p != base_poc + gop_len and p != self.golden_poc:
                    self._release(p)
        assert not hidden
        self.base_poc = base_poc + gop_len
        if self.base_poc - self.golden_poc >= max(2 * gop_len, 8):
            old_g = self.golden_poc
            self.golden_poc = self.base_poc
            if old_g != self.base_poc and old_g in self.dpb.slot_of:
                self._release(old_g)
        return packets

    def _encode_frame(self, gf, n_layers: int):
        from tpu_vp9_torch.codec.adapt import adapt_frame_context

        g = self.g
        frame = self._buf[gf.poc]
        qidx = int(layer_qindex(self.base_qindex, gf.temporal_layer,
                                n_layers, tune=self.tune))
        refs = self.planes_of[gf.last_poc]
        golden = (self.planes_of.get(gf.golden_poc)
                  if gf.golden_poc >= 0 and gf.golden_poc != gf.last_poc
                  else None)
        alt = self.planes_of.get(gf.alt_poc) if gf.alt_poc >= 0 else None
        sign_bias = ((0, 0, 0, 1) if alt is not None and gf.alt_poc > gf.poc
                     else (0, 0, 0, 0))
        step = self._step_for(golden is not None, alt is not None)
        src = self._rt.stage(frame)
        ac_q = T.ac_quant(qidx)
        lf_lvl = pick_filter_level(qidx, False)
        with span("ra_rate_args"):
            rates = upload_rate_tabs(make_rate_tabs(self.fc[0], qidx),
                                     self.device)
        prev_mv = self.mv_of.get(gf.last_poc)
        if prev_mv is None:
            prev_mv = torch.zeros((g.n_blocks32, 2), dtype=torch.int32,
                                  device=self.device)
        prev16 = torch.zeros((g.cols16 if g.strip else 1, 2),
                             dtype=torch.int32, device=self.device)
        args = [*src, *refs]
        if golden is not None:
            args += list(golden)
        if alt is not None:
            args += list(alt)
        args += [prev_mv, prev16, T.dc_quant(qidx), ac_q,
                 max(1, (ac_q ** 2) >> 6), lf_lvl,
                 int(self._lim_tbl[lf_lvl]), int(self._mblim_tbl[lf_lvl]),
                 rates]
        with span("ra_device_step"):
            outs, new_refs = step(*args)
        with span("ra_d2h_transfer"):
            host = _device_out_to_host(outs, g, False)
        self._count(host)
        # the header's DPB wiring, as gop.RaEncoder's
        last_slot = self.dpb.slot(gf.last_poc)
        golden_slot = (self.dpb.slot(gf.golden_poc)
                       if gf.golden_poc in self.dpb.slot_of else last_slot)
        alt_slot = (self.dpb.slot(gf.alt_poc)
                    if gf.alt_poc in self.dpb.slot_of else last_slot)
        refresh_mask = 0
        if gf.is_ref:
            refresh_mask = 1 << self.dpb.allocate(gf.poc)
        hdr = FrameHeader(
            width=self.w, height=self.h, is_keyframe=False,
            show_frame=gf.show, error_resilient=False,
            base_qindex=qidx, tx_mode=TxMode.ALLOW_32X32,
            refresh_frame_mask=refresh_mask,
            ref_dpb_index=(last_slot, golden_slot, alt_slot),
            ref_sign_bias=tuple(sign_bias[1:]),
            reset_frame_context=0,
            refresh_frame_context=gf.is_ref,
            frame_parallel_decoding_mode=False)
        hdr.loop_filter.filter_level = lf_lvl
        # the device loop filter applies one level frame-wide
        hdr.loop_filter.mode_ref_delta_enabled = False
        prev_mvs = None
        if self._prev is not None:
            snap, shown, dims, intra = self._prev
            if shown and not intra and dims == (self.w, self.h):
                prev_mvs = snap
        fc0 = self.fc[0].copy()
        with span("ra_serialize"):
            r = serialize_device_frame(g, host, hdr, fc0, False, prev_mvs,
                                       sign_bias=sign_bias)
        if r is None:
            raise RuntimeError("native serializer unavailable for RA")
        payload, fields, counts, fc_final = r
        # decode-order state
        if hdr.refresh_frame_context:
            self.fc[0] = adapt_frame_context(
                fc0, counts, is_key=False, after_key=self._prev is None,
                tx_select=False, final_fc=fc_final)
        snap = (fields[1].copy(), fields[2].copy(), fields[4].copy(),
                fields[5].copy())
        self._prev = (snap, hdr.show_frame, (self.w, self.h), False)
        if gf.is_ref:
            self.planes_of[gf.poc] = new_refs
            self.mv_of[gf.poc] = outs["m32"]["mv"].to(torch.int32)
        return payload, qidx

    def _count(self, host) -> None:
        t = self.tally
        t["p_frames"] += 1
        ref = np.asarray(host["m32"]["ref"])
        t["golden32"] += int((ref == 1).sum())
        t["altref32"] += int((ref == 2).sum())
        split = host.get("split32")
        if split is not None:
            split = np.asarray(split).reshape(-1)
            t["split32"] += int(split.sum())
            t["split_not_last"] += int(((split > 0) & (ref > 0)).sum())
            if self.g.mi_rows % 4 == 3:
                t["split_overhang"] += int(split[-self.g.cols32:].sum())
