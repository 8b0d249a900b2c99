"""Realtime low-delay encode session on torch: the M9 and M8 configurations.

The counterpart of ``tpu_vp9/pipeline/realtime.py:RtSession``. Every
frame is encoded on ``device``: the keyframe by ``make_kframe_step`` (the
intra wavefront, the loop filter and the border extension; its modes,
levels and eobs come back to the host, where the Python serializer writes
the tile with forward updates), every P-frame by ``make_pframe_step``. The
reference planes stay on the device. Per P-frame the levels, eobs and MVs
(and the recon when asked) come back to the host, where the native
serializer writes the tile (the Python one when the native library is
absent). ``_kstep = None`` switches the keyframe to the host encoder, whose
recon is then uploaded (``upload_refs``), as the JAX session allows.

M8 (``split16=True, golden=True``) adds the GOLDEN anchor (a second set of
reference planes on the device, refreshed from the new reconstruction
every ``golden_interval`` P-frames and at every keyframe; DPB slot 1), the
32-against-16 descent (the step's "m16f" children and "split32" mask,
scattered into the full 16 grid for the serializers), and candidate costs
from the frame's entropy tables. The tables are made from the frame
context captured at the last join of the serialization worker, never from
whatever the worker has reached, so a stream does not depend on thread
timing or on the device.

The step for frame N is issued before frame N-1 is fetched and
serialized, as in the JAX package. At CQP serialization runs on a worker
thread. With a rate controller (``rc``, VBR or CBR) it runs inline, after
frame N's step is issued and frame N-1 fetched: ``rc.frame_qindex`` picks
frame N's qindex before frame N-1's bits reach ``rc.update``, so the
feedback lags one frame, as the JAX session's does, and the tables read
the current context. Keyframes feed the controller too. On CUDA the fetch
of frame N-1's outputs is a blocking copy that waits for frame N's step
too; overlapping the two is later work. ``flush`` drains the pipeline and
leaves the session usable; ``close`` stops the worker.

``send`` takes a ``Frame420`` or a ``(y, u, v)`` tuple of padded device
planes from ``stage`` (not for a keyframe). ``TPU_VP9_DESCEND_FRAC``
overrides the descent's share (``DESCEND_FRAC``, 4; 1 descends every
parent). ``measure_step_fps`` times the step alone; ``encode_stream_rt``
encodes a list of frames through one session.

At a strip geometry (mi_rows % 4 == 2: 720p, 4K) the steps add the bottom
strip's 16x16 blocks (the outputs' "m16" zone, serialized with the 32
grid; the session keeps the strip's MVs as its temporal candidates,
``_prev_mv16``), and the descent is off, as in the JAX session.

``aq`` (tune SQ) gives the M8 step the adaptive lambda: each block's rate
lambda scaled by its variance (``tpu_encdec.aq_scale``); as in the
JAX session it takes effect with GOLDEN only (the step's rate tables).

Each frame's scalars (quantizers, lambda, loop filter level and limits)
reach the steps as one int32 row on the device (``tpu_encdec.
step_scalars``), which the session holds for its life and refills in
place before each step, keyframes included; the rate tables likewise. So
the steps' launches are the same from frame to frame.

``mesh_shape`` shards the P-frame step's tile columns over a mesh of
devices (``pipeline/tpu_shard.make_rt_step_sharded``: the first
prod(mesh_shape) cards, or ``device`` repeated off CUDA; ``mesh_devices``
names them instead, a device may repeat), with GOLDEN,
without the descent (a notice where it was asked for) and without aq, as
in the JAX session; the keyframe stays on ``device``. The streams equal
the single-device session's.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import functools
import os
import time

import numpy as np
import torch

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream.headers import FrameHeader, assemble_frame
from tpu_vp9_torch.bitstream.tables import (
    BlockSize, Partition, RefFrame, TxMode,
)
from tpu_vp9_torch.codec import modeinfo as MI
from tpu_vp9_torch.codec import mv as MV
from tpu_vp9_torch.codec.intra_frame import (
    make_frame_state, walk_partition_fixed,
)
from tpu_vp9_torch.ops.cuda_kernels import STEP_SCALARS, kf_check_status
from tpu_vp9_torch.ops.loopfilter import pick_filter_level, sharpness_limits
from tpu_vp9_torch.pipeline.encoder import EncodedFrame, _apply_loop_filter
from tpu_vp9_torch.pipeline.tpu_encdec import (
    DESCEND_FRAC, ZONE_KEYS, Geom, extend_borders, make_geom,
    make_kframe_step, make_pframe_step, make_rate_tabs, pad_plane,
    recon_crops, step_scalars, upload_rate_tabs,
)
from tpu_vp9_torch.pipeline.tpu_shard import make_rt_step_sharded
from tpu_vp9_torch.utils.trace import notice, span
from tpu_vp9_torch.utils.yuv import Frame420

LAST = int(RefFrame.LAST)
_CHILD_KEYS = tuple(k for k in ZONE_KEYS if k != "ref") + ("sel_idx",)
_KEY_KEYS = ("mode", "skip", "eob_y", "eob_u", "eob_v", "lv_y", "lv_u",
             "lv_v")


def _leaf_grid_index(geom: Geom, mi_row: int, mi_col: int, bsize,
                     split_mode: bool = False):
    """(zone, flat block index) of a leaf in the device output: the 32
    grid, the full 16 grid of the split children (``split_mode``), or the
    bottom strip's row of 16x16 blocks."""
    if bsize == BlockSize.BLOCK_32X32:
        return "m32", (mi_row // 4) * geom.cols32 + (mi_col // 4)
    assert bsize == BlockSize.BLOCK_16X16
    if split_mode:
        return "m16f", (mi_row // 2) * (geom.cols32 * 2) + (mi_col // 2)
    return "m16", mi_col // 2


def walk_partition_split(mi_rows: int, mi_cols: int, split32):
    """Decode-order events for the device's mixed 32/16 partitioning.

    Mirrors intra_frame.walk_partition_fixed's node semantics; at the
    32 level the partition follows split32[(mi_row//4, mi_col//4)].
    split32 must be 0 wherever a split child would need forced edge
    descent (pframe_step never descends the overhang row)."""
    events = []

    def node(mi_row, mi_col, bsize):
        if mi_row >= mi_rows or mi_col >= mi_cols:
            return
        has_rows, has_cols = MI.partition_rule(
            bsize, mi_row, mi_col, mi_rows, mi_cols)
        bw = 1 << MI.MI_WIDTH_LOG2[bsize]
        if bsize == BlockSize.BLOCK_64X64:
            part = Partition.SPLIT
        elif bsize == BlockSize.BLOCK_32X32 and has_rows and has_cols:
            part = (Partition.SPLIT
                    if split32[mi_row // 4, mi_col // 4] else
                    Partition.NONE)
        elif has_rows and has_cols:
            part = Partition.NONE
        else:
            part = Partition.SPLIT  # forced descent at edges
        events.append(("part", mi_row, mi_col, bsize, part))
        if part == Partition.NONE:
            events.append(("leaf", mi_row, mi_col, bsize, None))
        else:
            sub = T.SUBSIZE[(Partition.SPLIT, bsize)]
            half = bw >> 1
            node(mi_row, mi_col, sub)
            node(mi_row, mi_col + half, sub)
            node(mi_row + half, mi_col, sub)
            node(mi_row + half, mi_col + half, sub)

    events.append(("tile", 0, mi_cols, None, None))
    for sb_r in range(0, mi_rows, 8):
        for sb_c in range(0, mi_cols, 8):
            node(sb_r, sb_c, BlockSize.BLOCK_64X64)
    return events


def classify_and_fill_state(frame, geom: Geom, host_out: dict,
                            qindex: int, prev_mvs=None):
    """Build a FrameState from the device outputs; classify inter modes
    (the Python serializer's input, used when the native one is absent).

    Decode-order walk: each leaf's NEAREST/NEAR/ZERO/NEW classification
    uses the normative mv-reference scan over already-final neighbours
    (every block is single-ref, LAST or GOLDEN). Returns (FrameState,
    events)."""
    g = geom
    st = make_frame_state(frame, g.mi_rows, g.mi_cols)
    split = host_out.get("split32")
    if split is not None:
        events = walk_partition_split(g.mi_rows, g.mi_cols, split)
    else:
        events = walk_partition_fixed(g.mi_rows, g.mi_cols,
                                      BlockSize.BLOCK_32X32, 0)
    for ev, mi_row, mi_col, bsize, _ in events:
        if ev == "tile":
            st.tile_mi_start = mi_row
            st.mig.tile_mi_start, st.mig.tile_mi_end = mi_row, mi_col
            continue
        if ev != "leaf":
            continue
        zone, bi = _leaf_grid_index(g, mi_row, mi_col, bsize,
                                    split_mode=split is not None)
        z = host_out[zone]
        mv = (int(z["mv"][bi, 0]), int(z["mv"][bi, 1]))
        ref_id = LAST
        if "ref" in z and int(z["ref"][bi]):
            ref_id = int(RefFrame.GOLDEN)
        mv_list, mode_context = MV.find_mv_refs(
            st.mig, mi_row, mi_col, bsize, ref_id,
            st.mig.tile_mi_start, st.mig.tile_mi_end, prev_mvs=prev_mvs)
        nearest, near = MV.find_best_ref_mvs(
            mv_list, False, mi_row, mi_col, bsize, g.mi_rows, g.mi_cols)
        if mv == nearest:
            mode = 0
        elif mv == near:
            mode = 1
        elif mv == (0, 0):
            mode = 2
        else:
            mode = 3
        mi = MI.ModeInfo(bsize=bsize, tx_size=T.MAX_TX_SIZE[bsize],
                         skip=bool(z["skip"][bi]), is_inter=True,
                         ref_frame=(ref_id, -1), mv=(mv, (0, 0)),
                         inter_mode=mode)
        mi.mode_context = mode_context
        mi.best_ref_mv = nearest
        st.mig.set_block(mi_row, mi_col, bsize, mi)
        for p, (r, c) in enumerate(((mi_row * 2, mi_col * 2),
                                    (mi_row, mi_col), (mi_row, mi_col))):
            k = "yuv"[p]
            st.levels[(p, r, c)] = z[f"lv_{k}"][bi]
            st.eobs[(p, r, c)] = int(z[f"eob_{k}"][bi])
    return st, events


def _expand_m16f(host, geom: Geom):
    """Scatter the masked child-zone outputs (4K arrays for the K
    descended parents) into full 16-grid arrays so the walk and the
    serializers stay selection-agnostic. Child order: k*4 + 2*i + j."""
    z = host.get("m16f")
    if z is None or "sel_idx" not in z:
        return
    g = geom
    sel = np.asarray(z.pop("sel_idx"), np.int64)
    cols16 = g.cols32 * 2
    b16 = g.rows32 * 2 * cols16
    pr, pc = sel // g.cols32, sel % g.cols32
    ii = np.array([0, 0, 1, 1])
    jj = np.array([0, 1, 0, 1])
    cidx = ((2 * pr[:, None] + ii[None]) * cols16
            + 2 * pc[:, None] + jj[None]).reshape(-1)  # (4K,)
    for k in list(z):
        arr = z[k]
        full = np.zeros((b16,) + arr.shape[1:], arr.dtype)
        full[cidx] = arr
        z[k] = full


def serialize_device_frame(g: Geom, host, hdr, fc0, er: bool, prev_mvs,
                           sign_bias=(0, 0, 0, 0)):
    """Native 2-pass whole-tile serialization of one device frame.

    Pass 1 collects symbol counts against fc0, the header's forward
    probability updates are optimized from them, and pass 2 emits the
    final tile. Full level planes (scan_ks 0). Returns (payload,
    grid_fields, counts, fc_final), or None when the native library
    cannot take this configuration."""
    from tpu_vp9_torch import native as nat
    from tpu_vp9_torch.bitstream.prob_update import (
        optimize_binary_probs, optimize_coef_probs,
    )
    from tpu_vp9_torch.bitstream.tables import TxSize

    lib = nat.get_lib()
    if lib is None or not hasattr(lib, "rt_serialize"):
        return None
    m32 = host["m32"]
    split32 = host.get("split32")
    m16f = None
    if split32 is not None:
        m16f = dict(host["m16f"])
        m16f.setdefault("ref", None)
    strip = None
    if g.strip:
        strip = dict(host["m16"])
        strip.setdefault("ref", None)
    zones = (g, split32, m32, m16f, strip, prev_mvs)
    r1 = nat.native_rt_serialize(*zones, fc0, counts_on=not er,
                                 sign_bias=sign_bias)
    if r1 is None:
        return None
    tile1, counts, fields, _ = r1
    if er:
        tile, updates, fc_final = tile1, None, None
    else:
        coefc = {ts: counts[("coef", ts)] for ts in TxSize}
        eobc = {ts: counts[("eob", ts)] for ts in TxSize}
        new_coef, flags = optimize_coef_probs(fc0, coefc, eobc)
        new_skip = optimize_binary_probs(
            fc0.skip_probs, counts["skip"][:, 0], counts["skip"][:, 1])
        fc1 = fc0.copy()
        updates = {"coef": {}, "skip": (fc0.skip_probs.copy(), new_skip)}
        for ts in TxSize:
            updates["coef"][ts] = (fc0.coef_probs[ts].copy(),
                                   new_coef[ts], flags[ts])
            fc1.coef_probs[ts] = new_coef[ts]
        fc1.skip_probs = new_skip
        r2 = nat.native_rt_serialize(*zones, fc1, counts_on=False,
                                     sign_bias=sign_bias)
        if r2 is None:
            return None
        tile, _, fields, _ = r2
        fc_final = fc1
    payload = assemble_frame(hdr, tile, updates)
    return payload, fields, counts, fc_final


def upload_refs(recon_planes, geom: Geom, device):
    """Pad host recon planes (numpy) and border-extend them on ``device``:
    the device references the next P-frame searches."""
    g = geom
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))
    return extend_borders(
        tuple(torch.from_numpy(pad_plane(np.asarray(p), *shp)).to(device)
              for p, shp in zip(recon_planes, shapes)), recon_crops(g))


def _device_out_to_host(outs, geom: Geom, want_recon: bool):
    """Copy the per-frame device outputs the host needs (full planes) and
    scatter the children into the full 16 grid."""
    host = {"m32": {k: outs["m32"][k].cpu().numpy() for k in ZONE_KEYS}}
    if geom.strip:
        host["m16"] = {k: outs["m16"][k].cpu().numpy() for k in ZONE_KEYS}
    if "m16f" in outs:
        host["split32"] = outs["split32"].cpu().numpy()
        host["m16f"] = {k: outs["m16f"][k].cpu().numpy()
                        for k in _CHILD_KEYS}
        _expand_m16f(host, geom)
    if want_recon:
        host["rec"] = [outs[k].cpu().numpy()
                       for k in ("rec_y", "rec_u", "rec_v")]
    return host


class RtSession:
    """Streaming low-delay encoder session whose keyframe and P-frame
    steps run on ``device`` (the JAX package's ``RtSession``).

    Frame-context persistence is on by default (error_resilient=False):
    every frame is serialized against the inherited context, carries
    forward probability updates, and the context backward-adapts from the
    frame's symbol counts; temporal MV candidates enter the mv-ref scan
    whenever a decoder would use them.
    """

    def __init__(self, width: int, height: int, *, device="cuda",
                 intra_period: int = -1, rc=None,
                 error_resilient: bool = False,
                 frame_parallel_decoding: bool = False,
                 want_recon: bool = True, loop_filter: bool = True,
                 split16: bool = False, golden: bool = False,
                 golden_interval: int = 8, mesh_shape=None,
                 aq: bool = False, mesh_devices=None):
        self.g = make_geom(width, height)
        self.device = torch.device(device)
        self.w, self.h = width, height
        self.intra_period = intra_period
        self.rc = rc
        self.er = error_resilient
        self.fpdm = error_resilient or frame_parallel_decoding
        self.want_recon = want_recon
        self.loop_filter = loop_filter
        # the 32-against-16 descent needs a strip-free geometry
        self.split16 = split16 and not self.g.strip
        # long-term GOLDEN anchor on the device with per-block ref choice
        self.golden = golden
        self.golden_interval = golden_interval
        # the descent's budget: the B32 // descend_frac parents of the
        # largest distortion; 1 descends every parent
        dfrac = int(os.environ.get("TPU_VP9_DESCEND_FRAC",
                                   str(DESCEND_FRAC)))
        # without GOLDEN the step takes no rate tables, and aq nothing to
        # scale (the JAX session passes aq and golden too)
        self.aq = aq and golden
        self.mesh_shape = mesh_shape
        if mesh_shape is not None:
            # tile columns over a device mesh (``pipeline/tpu_shard.py``),
            # GOLDEN kept; as in the JAX session the descent stays off (its
            # frame-wide choice of parents has no per-shard form) and aq is
            # not taken
            if self.split16:
                notice("mesh-sharded realtime session: split16 descent "
                       "disabled (uniform 32 grid + GOLDEN)")
            self.split16 = False
            self.aq = False
            self._step = make_rt_step_sharded(self.g, mesh_shape,
                                              self.device, golden=golden,
                                              devices=mesh_devices)
        else:
            self._step = make_pframe_step(self.g, self.device,
                                          split16=self.split16,
                                          golden=golden, descend_frac=dfrac,
                                          aq=self.aq)
        # the device keyframe, as the JAX session always takes it; None
        # selects the host encoder
        self._kstep = make_kframe_step(self.g, self.device)
        self._lim_tbl, self._mblim_tbl = sharpness_limits(0)
        self._fc = [T.default_frame_context() for _ in range(4)]
        self._refs = None
        self._gold = None
        self._since_gold = 0
        self._rates_key = None
        self._rates_dev = None
        # the frame's row of scalars (step_scalars), held for the life of
        # the session and refilled before each step, keyframes' too
        self._sc = torch.zeros(len(STEP_SCALARS), dtype=torch.int32,
                               device=self.device)
        self._prev_mv32 = torch.zeros((self.g.n_blocks32, 2),
                                      dtype=torch.int32, device=self.device)
        # the children carry no temporal candidate, so only the strip
        # tracks a 16-grid motion field (a placeholder without one)
        self._prev_mv16 = torch.zeros(
            (self.g.cols16 if self.g.strip else 1, 2), dtype=torch.int32,
            device=self.device)
        self._pending = None  # (frame, idx, hdr, device outs, qidx)
        self._zero = None  # the stand-in Frame420 of staged input
        self._prev_snap = None  # mv snapshot of the last serialized frame
        self._last_was_inter = False
        self._idx = 0
        # at CQP frame N-1's host serialization runs on a worker while
        # frame N's step runs; device fetches stay on the calling thread.
        # The rate tables then read the frame context captured at the last
        # join (the state after frame N-2): the same whatever the thread
        # timing. A rate controller needs rc.update before the next
        # frame_qindex, so that session serializes inline
        self._ser_async = rc is None
        self._ser_pool = (cf.ThreadPoolExecutor(max_workers=1)
                          if self._ser_async else None)
        self._futs = collections.deque()
        self._rates_fc = self._fc[0]
        # what the P-frames serialized so far decided, in 32x32 blocks
        self.tally = {"p_frames": 0, "split32": 0, "golden32": 0}

    def _drain_futs(self, out):
        while self._futs:
            ef, fc = self._futs.popleft().result()
            self._rates_fc = fc
            out.append(ef)
        return out

    def _rate_args(self, qidx: int):
        """The step's rate tables on the device, made from the frame
        context of the last join (inline serialization: the current one)
        and cached by (its identity, qindex); the session's tables are
        refilled in place, so that their tensors stay the same."""
        with span("rt_rate_args"):
            fc = self._rates_fc if self._ser_async else self._fc[0]
            key = (id(fc), qidx)
            if self._rates_key != key:
                self._rates_dev = upload_rate_tabs(make_rate_tabs(fc, qidx),
                                                   self.device,
                                                   out=self._rates_dev)
                self._rates_key = key
                self._rates_held = fc  # keeps the id from being reused
            return self._rates_dev

    # -- frame-context chain (matches the decoder's refresh rules) ------
    def _fc_update(self, st, hdr, is_key: bool, fc_base):
        from tpu_vp9_torch.codec.adapt import adapt_frame_context

        after_key = (not is_key) and not self._last_was_inter
        if not self.er and hdr.refresh_frame_context:
            if self.fpdm:
                if getattr(st, "fc_final", None) is not None:
                    self._fc[hdr.frame_context_idx] = st.fc_final
            elif getattr(st, "counts", None) is not None:
                self._fc[hdr.frame_context_idx] = adapt_frame_context(
                    fc_base if fc_base is not None
                    else T.default_frame_context(),
                    st.counts, is_key=is_key, after_key=after_key,
                    tx_select=hdr.tx_mode == TxMode.TX_MODE_SELECT,
                    final_fc=getattr(st, "fc_final", None))
        self._last_was_inter = not is_key

    def _scalars(self, qidx: int, is_key: bool):
        """The session's row of scalars (``step_scalars``) refilled for a
        frame at ``qidx``: its quantizers, lambda and loop filter level and
        limits (the level 0 with the filter off)."""
        lf_lvl = pick_filter_level(qidx, is_key) if self.loop_filter else 0
        ac_q = T.ac_quant(qidx)
        return step_scalars(T.dc_quant(qidx), ac_q, max(1, (ac_q ** 2) >> 6),
                            lf_lvl, int(self._lim_tbl[lf_lvl]),
                            int(self._mblim_tbl[lf_lvl]), out=self._sc)

    def _set_recon(self, st, host):
        if self.want_recon:
            mi_h, mi_w = self.g.h_mi, self.g.w_mi
            for pidx in range(3):
                ss = 0 if pidx == 0 else 1
                st.planes[pidx].recon[: mi_h >> ss, : mi_w >> ss] = \
                    host["rec"][pidx][: mi_h >> ss, : mi_w >> ss]

    def _finish_native(self, frame, idx, hdr, host, qidx, prev_mvs):
        """Whole-tile native serialization. Returns an EncodedFrame, or
        None when the native library cannot take this configuration."""
        g = self.g
        fc0 = (T.default_frame_context() if self.er
               else self._fc[0].copy())
        r = serialize_device_frame(g, host, hdr, fc0, self.er, prev_mvs)
        if r is None:
            return None
        payload, fields, counts, fc_final = r
        # light state: planes for recon consumers + the motion field for
        # the next frame's temporal candidates
        st = make_frame_state(frame, g.mi_rows, g.mi_cols)
        mig = st.mig
        (mig.f_inter[:], mig.f_ref0[:], mig.f_ref1[:], mig.f_mode[:],
         mig.f_mv[:], mig.f_mv1[:], mig.f_skip[:]) = (
            fields[0].astype(bool), fields[1], fields[2], fields[3],
            fields[4], fields[5], fields[6].astype(bool))
        st.counts = counts
        st.fc_final = fc_final
        if not self.er:
            self._fc_update(st, hdr, False, fc0)
            self._prev_snap = mig.snapshot_mvs()
        else:
            self._last_was_inter = True
        if self.rc is not None:
            self.rc.update(len(payload) * 8, False)
        self._set_recon(st, host)
        return EncodedFrame(payload=payload, is_keyframe=False,
                            qindex=qidx, state=st, pts=idx)

    def _finish_host(self, frame, idx, hdr, host, qidx):
        """Serialize an already-fetched frame (host work only)."""
        from tpu_vp9_torch.codec.fwd_update import serialize_with_updates
        from tpu_vp9_torch.codec.inter_frame import serialize_pframe

        g = self.g
        self.tally["p_frames"] += 1
        if "split32" in host:
            self.tally["split32"] += int(host["split32"].sum())
        if host["m32"].get("ref") is not None:
            self.tally["golden32"] += int((host["m32"]["ref"] == 1).sum())
        prev_mvs = (self._prev_snap
                    if (not self.er and self._last_was_inter) else None)
        with span("rt_serialize_native"):
            ef = self._finish_native(frame, idx, hdr, host, qidx, prev_mvs)
        if ef is not None:
            return ef
        st, events = classify_and_fill_state(frame, g, host, qidx,
                                             prev_mvs=prev_mvs)
        if self.er:
            tile = serialize_pframe(st, events, qidx, fc=None,
                                    tx_mode=TxMode.ALLOW_32X32)
            updates = None
        else:
            ser = functools.partial(serialize_pframe,
                                    tx_mode=TxMode.ALLOW_32X32)
            tile, updates, st.fc_final, st.counts = serialize_with_updates(
                st, events, qidx, ser, self._fc[0])
        payload = assemble_frame(hdr, tile, updates)
        if not self.er:
            self._fc_update(st, hdr, False, self._fc[0])
            self._prev_snap = st.mig.snapshot_mvs()
        else:
            self._last_was_inter = True
        if self.rc is not None:
            self.rc.update(len(payload) * 8, False)
        self._set_recon(st, host)
        return EncodedFrame(payload=payload, is_keyframe=False,
                            qindex=qidx, state=st, pts=idx)

    def _finish(self, frame, idx, hdr, outs, qidx):
        with span("rt_d2h_transfer"):
            host = _device_out_to_host(outs, self.g, self.want_recon)
        return self._finish_host(frame, idx, hdr, host, qidx)

    def _encode_key_device(self, frame, idx, qidx):
        """Keyframe on the device (``make_kframe_step``): its refs become
        the LAST and GOLDEN references where they lie, and the host
        serializes its modes, levels and eobs over the 32 grid."""
        from tpu_vp9_torch.bitstream.tables import IntraMode, TxSize
        from tpu_vp9_torch.codec.fwd_update import serialize_with_updates
        from tpu_vp9_torch.codec.intra_frame import serialize_frame

        g = self.g
        # keyframes reset every context (setup_past_independence)
        self._fc = [T.default_frame_context() for _ in range(4)]
        lf_lvl = pick_filter_level(qidx, True) if self.loop_filter else 0
        with span("kf_device_step"):
            outs, self._refs = self._kstep(*self.stage(frame),
                                           self._scalars(qidx, True))
            # the fetch waits for the step anyway; waiting here lets the
            # two spans split the step from the copy
            self._sync()
        if self.golden:
            # a keyframe refreshes every DPB slot; the steps never write
            # into their inputs, so the anchor can share the planes
            self._gold = self._refs
            self._since_gold = 0
        self._prev_mv32 = torch.zeros_like(self._prev_mv32)
        self._prev_mv16 = torch.zeros_like(self._prev_mv16)
        with span("kf_d2h_transfer"):
            # a wave that gave up waiting left its outputs incomplete
            kf_check_status(outs["kf_status"].cpu())
            host = {k: outs["m32"][k].cpu().numpy() for k in _KEY_KEYS}
            host16 = ({k: outs["m16"][k].cpu().numpy() for k in _KEY_KEYS}
                      if g.strip else None)
            recs = ([outs[k].cpu().numpy() for k in ("rec_y", "rec_u",
                                                     "rec_v")]
                    if self.want_recon else None)
        with span("kf_serialize"):
            st = make_frame_state(frame, g.mi_rows, g.mi_cols)
            events = walk_partition_fixed(g.mi_rows, g.mi_cols,
                                          BlockSize.BLOCK_32X32, 0)
            for ev, mi_row, mi_col, bsize, _ in events:
                if ev != "leaf":
                    continue
                if bsize == BlockSize.BLOCK_32X32:
                    z, ts = host, TxSize.TX_32X32
                    bi = (mi_row // 4) * g.cols32 + (mi_col // 4)
                else:  # the bottom strip of a strip geometry
                    assert bsize == BlockSize.BLOCK_16X16 and host16
                    z, ts, bi = host16, TxSize.TX_16X16, mi_col // 2
                m = IntraMode(int(z["mode"][bi]))
                st.mig.set_block(mi_row, mi_col, bsize, MI.ModeInfo(
                    bsize=bsize, y_mode=m, uv_mode=m, tx_size=ts,
                    skip=bool(z["skip"][bi]), is_inter=False))
                for p, (r, c) in enumerate(((mi_row * 2, mi_col * 2),
                                            (mi_row, mi_col),
                                            (mi_row, mi_col))):
                    k = "yuv"[p]
                    st.levels[(p, r, c)] = z[f"lv_{k}"][bi]
                    st.eobs[(p, r, c)] = int(z[f"eob_{k}"][bi])
            tile, updates, st.fc_final, st.counts = serialize_with_updates(
                st, events, qidx, serialize_frame, None)
            hdr = FrameHeader(width=self.w, height=self.h, is_keyframe=True,
                              error_resilient=self.er, base_qindex=qidx,
                              tx_mode=TxMode.ALLOW_32X32,
                              refresh_frame_context=not self.er,
                              frame_parallel_decoding_mode=self.fpdm)
            hdr.loop_filter.filter_level = lf_lvl
            # the device loop filter applies one level frame-wide: the
            # intra ref delta (+1 scale step) is switched off
            hdr.loop_filter.mode_ref_delta_enabled = False
            payload = assemble_frame(hdr, tile, updates)
        self._fc_update(st, hdr, True, None)
        self._rates_fc = self._fc[0]
        self._prev_snap = None
        if recs is not None:
            mi_h, mi_w = g.h_mi, g.w_mi
            for pidx in range(3):
                ss = 0 if pidx == 0 else 1
                st.planes[pidx].recon[: mi_h >> ss, : mi_w >> ss] = \
                    recs[pidx][: mi_h >> ss, : mi_w >> ss]
        if self.rc is not None:
            self.rc.update(len(payload) * 8, True)
        return EncodedFrame(payload=payload, is_keyframe=True,
                            qindex=qidx, state=st, pts=idx)

    def _encode_key(self, frame, idx, qidx):
        """Keyframe on the device, or with ``_kstep = None`` on the host
        encoder, whose recon becomes the device reference (and the GOLDEN
        anchor: a keyframe refreshes every DPB slot)."""
        from tpu_vp9_torch.codec.intra_frame import encode_keyframe

        if self._kstep is not None:
            return self._encode_key_device(frame, idx, qidx)
        g = self.g
        # keyframes reset every context (setup_past_independence)
        self._fc = [T.default_frame_context() for _ in range(4)]
        tile, st = encode_keyframe(frame, qidx, BlockSize.BLOCK_32X32)
        hdr = FrameHeader(width=self.w, height=self.h, is_keyframe=True,
                          error_resilient=self.er, base_qindex=qidx,
                          tx_mode=TxMode.ALLOW_32X32,
                          refresh_frame_context=not self.er,
                          frame_parallel_decoding_mode=self.fpdm)
        _apply_loop_filter(st, hdr, qidx, True, enabled=self.loop_filter)
        payload = assemble_frame(hdr, tile, st.header_updates)
        self._fc_update(st, hdr, True, None)
        self._rates_fc = self._fc[0]
        self._prev_snap = None
        mi_h, mi_w = g.h_mi, g.w_mi
        recon = [st.planes[p].recon[: mi_h >> (0 if p == 0 else 1),
                                    : mi_w >> (0 if p == 0 else 1)]
                 for p in range(3)]
        self._refs = upload_refs(recon, g, self.device)
        if self.golden:
            # the step returns new reference tensors and never writes into
            # its inputs, so the anchor can share the planes
            self._gold = self._refs
            self._since_gold = 0
        self._prev_mv32 = torch.zeros_like(self._prev_mv32)
        self._prev_mv16 = torch.zeros_like(self._prev_mv16)
        if self.rc is not None:
            self.rc.update(len(payload) * 8, True)
        return EncodedFrame(payload=payload, is_keyframe=True,
                            qindex=qidx, state=st, pts=idx)

    def _plane_shapes(self):
        g = self.g
        return ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
                (g.pad_h // 2, g.pad_w // 2))

    def stage(self, frame):
        """Upload one picture as padded device planes."""
        with span("rt_stage"):
            return tuple(
                torch.from_numpy(pad_plane(np.asarray(p), *shp))
                .to(self.device)
                for p, shp in zip((frame.y, frame.u, frame.v),
                                  self._plane_shapes()))

    def _check_staged(self, src):
        """Refuse a staged tuple that is not three padded uint8 planes on
        the session's device, as ``stage`` makes them."""
        ok = len(src) == 3 and all(
            isinstance(p, torch.Tensor) and p.dtype == torch.uint8
            and p.device.type == self.device.type
            and tuple(p.shape) == shp and p.is_contiguous()
            for p, shp in zip(src, self._plane_shapes()))
        if not ok:
            raise ValueError(
                "a staged frame is the (y, u, v) tuple of contiguous uint8 "
                f"planes of shapes {self._plane_shapes()} on "
                f"{self.device} that stage() returns")

    def step_args(self, qidx: int, prev_mvs=None):
        """The step's arguments after the source and reference planes for
        a P-frame at ``qidx``, from the session's present state
        (``prev_mvs``: other previous MVs, (32 grid, strip))."""
        pm32, pm16 = prev_mvs or (self._prev_mv32, self._prev_mv16)
        args = (pm32, pm16, self._scalars(qidx, False))
        if self.golden:
            return (*self._gold, *args, self._rate_args(qidx))
        return args

    def _zero_frame(self):
        """The host-state stand-in of a staged frame (its source is read
        only by PSNR and recon consumers, which staged callers lack)."""
        if self._zero is None:
            ch, cw = (self.h + 1) // 2, (self.w + 1) // 2
            self._zero = Frame420(y=np.zeros((self.h, self.w), np.uint8),
                                  u=np.zeros((ch, cw), np.uint8),
                                  v=np.zeros((ch, cw), np.uint8))
        return self._zero

    def send(self, frame, qindex: int = 100, force_keyframe: bool = False):
        """Encode one picture; returns 0..2 EncodedFrames (frame N's step
        is issued before frame N-1 is fetched and serialized).

        frame: a Frame420, or a staged (y, u, v) tuple of device planes
        from ``stage`` (not for a keyframe: the keyframe's host state is
        made from the Frame420). With ``rc`` the controller's qindex
        replaces ``qindex``."""
        idx = self._idx
        self._idx += 1
        is_key = force_keyframe or idx == 0 or (
            self.intra_period >= 0
            and idx % (self.intra_period + 1) == 0)
        qidx = qindex if self.rc is None else self.rc.frame_qindex(is_key)
        out = []
        staged = isinstance(frame, tuple)
        if is_key:
            if staged:
                raise ValueError("staged frames cannot be keyframes")
            self._drain_futs(out)
            if self._pending is not None:
                out.append(self._finish(*self._pending))
                self._pending = None
            out.append(self._encode_key(frame, idx, qidx))
            return out
        if staged:
            self._check_staged(frame)
            src, frame = frame, self._zero_frame()
        else:
            src = self.stage(frame)
        args = self.step_args(qidx)
        refresh_gold = False
        if self.golden:
            self._since_gold += 1
            refresh_gold = self._since_gold >= self.golden_interval
        with span("rt_device_step"):
            outs, self._refs = self._step(*src, *self._refs, *args)
        if refresh_gold:
            self._gold = self._refs
            self._since_gold = 0
        self._prev_mv32 = outs["m32"]["mv"].to(torch.int32)
        if self.g.strip:
            self._prev_mv16 = outs["m16"]["mv"].to(torch.int32)
        hdr = FrameHeader(
            width=self.w, height=self.h, is_keyframe=False,
            error_resilient=self.er, base_qindex=qidx,
            tx_mode=TxMode.ALLOW_32X32,
            refresh_frame_mask=0x03 if refresh_gold else 0x01,
            ref_dpb_index=(0, 1, 1) if self.golden else (0, 0, 0),
            reset_frame_context=0,
            refresh_frame_context=not self.er,
            frame_parallel_decoding_mode=self.fpdm)
        hdr.loop_filter.filter_level = (
            pick_filter_level(qidx, False) if self.loop_filter else 0)
        if self.golden:
            # the device loop filter applies one level frame-wide; the
            # spec's default ref deltas would lower GOLDEN blocks by one
            # scale step, so they are switched off for device P-frames
            hdr.loop_filter.mode_ref_delta_enabled = False
        # fetch the previous frame (after this frame's step was issued)
        # and serialize it: on the worker, or inline with a controller
        if self._pending is not None:
            pf, pidx, phdr, pouts, pq = self._pending
            with span("rt_d2h_transfer"):
                phost = _device_out_to_host(pouts, self.g, self.want_recon)
            if self._ser_async:
                self._drain_futs(out)

                def task(args=(pf, pidx, phdr, phost, pq)):
                    ef = self._finish_host(*args)
                    return ef, self._fc[0]

                self._futs.append(self._ser_pool.submit(task))
            else:
                out.append(self._finish_host(pf, pidx, phdr, phost, pq))
        self._pending = (frame, idx, hdr, outs, qidx)
        return out

    def flush(self):
        """Drain the pipelined frames at end of stream; the session can
        encode on after it, as the JAX session can."""
        out = self._drain_futs([])
        if self._pending is not None:
            out.append(self._finish(*self._pending))
            self._pending = None
        return out

    def close(self):
        """Stop the serialization worker, if any; call after the last
        ``flush``."""
        if self._ser_pool is not None:
            self._ser_pool.shutdown()

    def measure_step_fps(self, frame, iters: int = 20,
                         qindex: int = 160) -> float:
        """Steps per second of the P-frame step alone (no fetch, no
        serialization): ``iters`` steps on a copy of the session's
        references, each on the last one's output, with zero previous MVs
        and the session's GOLDEN anchor and rate tables, after one warm-up
        step, synchronized before and after. The session's references,
        motion field and stream are left as they were. Needs a session
        that has coded a keyframe."""
        if self._refs is None:
            raise RuntimeError("measure_step_fps: send a keyframe first")
        src = self.stage(frame)
        args = self.step_args(qindex, (torch.zeros_like(self._prev_mv32),
                                       torch.zeros_like(self._prev_mv16)))
        refs = tuple(p.clone() for p in self._refs)
        outs, refs = self._step(*src, *refs, *args)  # warm-up
        self._sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            outs, refs = self._step(*src, *refs, *args)
        self._sync()
        return iters / (time.perf_counter() - t0)

    def _sync(self):
        if self.device.type == "cuda":
            for dev in getattr(self._step, "devices", (self.device,)):
                torch.cuda.synchronize(dev)


def encode_stream_rt(frames, qindex: int = 100, intra_period: int = -1,
                     want_recon: bool = True, rc=None,
                     error_resilient: bool = False, split16: bool = False,
                     golden: bool = False, golden_interval: int = 8,
                     device="cuda"):
    """Realtime encode of a list of Frame420 through one ``RtSession`` on
    ``device``. Returns list[EncodedFrame]. rc: a RateControlState that
    picks each frame's qindex (CQP at ``qindex`` when None)."""
    h, w = frames[0].y.shape
    sess = RtSession(w, h, device=device, intra_period=intra_period, rc=rc,
                     error_resilient=error_resilient,
                     want_recon=want_recon, split16=split16,
                     golden=golden, golden_interval=golden_interval)
    out = []
    for frame in frames:
        out.extend(sess.send(frame, qindex=qindex))
    out.extend(sess.flush())
    sess.close()
    return out
