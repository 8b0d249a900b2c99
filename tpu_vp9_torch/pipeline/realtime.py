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
serialized, and serialization runs on a worker thread (CQP), as in the
JAX package. On CUDA the fetch of frame N-1's outputs is a blocking copy
that waits for frame N's step too; overlapping the two is later work.
``flush`` drains the pipeline and leaves the session usable; ``close``
stops the worker.

Not ported yet, and refused with NotImplementedError: the adaptive lambda
(``aq`` with GOLDEN, tune SQ), meshes, rate control, strip geometries.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import functools

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
from tpu_vp9_torch.ops.loopfilter import pick_filter_level, sharpness_limits
from tpu_vp9_torch.pipeline.encoder import EncodedFrame, _apply_loop_filter
from tpu_vp9_torch.pipeline.tpu_encdec import (
    Geom, extend_borders_device, make_geom, make_kframe_step,
    make_pframe_step, make_rate_tabs, pad_plane, upload_rate_tabs,
)
from tpu_vp9_torch.utils.trace import span

LAST = int(RefFrame.LAST)
_ZONE_KEYS = ("mv", "ref", "skip", "eob_y", "eob_u", "eob_v", "lv_y",
              "lv_u", "lv_v")
_CHILD_KEYS = tuple(k for k in _ZONE_KEYS if k != "ref") + ("sel_idx",)
_KEY_KEYS = ("mode", "skip", "eob_y", "eob_u", "eob_v", "lv_y", "lv_u",
             "lv_v")


def _leaf_grid_index(geom: Geom, mi_row: int, mi_col: int, bsize):
    """(zone, flat block index) of a leaf in the device output: the 32
    grid, or the full 16 grid of the split children."""
    if bsize == BlockSize.BLOCK_32X32:
        return "m32", (mi_row // 4) * geom.cols32 + (mi_col // 4)
    assert bsize == BlockSize.BLOCK_16X16
    return "m16f", (mi_row // 2) * (geom.cols32 * 2) + (mi_col // 2)


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
        zone, bi = _leaf_grid_index(g, mi_row, mi_col, bsize)
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
    zones = (g, split32, m32, m16f, None, prev_mvs)
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
    cw, ch = (g.width + 1) >> 1, (g.height + 1) >> 1
    crops = ((g.width, g.height), (cw, ch), (cw, ch))
    return tuple(
        extend_borders_device(
            torch.from_numpy(pad_plane(np.asarray(p), *shp)).to(device), *cr)
        for p, shp, cr in zip(recon_planes, shapes, crops))


def _device_out_to_host(outs, geom: Geom, want_recon: bool):
    """Copy the per-frame device outputs the host needs (full planes) and
    scatter the children into the full 16 grid."""
    host = {"m32": {k: outs["m32"][k].cpu().numpy() for k in _ZONE_KEYS}}
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
                 aq: bool = False):
        if mesh_shape is not None:
            raise NotImplementedError(
                "tpu_vp9_torch RtSession: meshes are not ported yet "
                "(ROADMAP.md Queue A item 11)")
        if rc is not None:
            raise NotImplementedError(
                "tpu_vp9_torch RtSession: rate control is not ported yet "
                "(ROADMAP.md Queue A item 6)")
        if aq and golden:
            # without GOLDEN the JAX session drops aq too (aq=aq and golden)
            raise NotImplementedError(
                "tpu_vp9_torch RtSession: the adaptive lambda (aq, tune "
                "SQ) is not ported yet (ROADMAP.md Queue A item 6)")
        self.g = make_geom(width, height)
        if self.g.strip:
            raise NotImplementedError(
                "tpu_vp9_torch RtSession: strip geometries (mi_rows % 4 "
                "== 2) are not ported yet (ROADMAP.md Queue A item 5)")
        self.device = torch.device(device)
        self.w, self.h = width, height
        self.intra_period = intra_period
        self.rc = rc
        self.er = error_resilient
        self.fpdm = error_resilient or frame_parallel_decoding
        self.want_recon = want_recon
        self.loop_filter = loop_filter
        self.split16 = split16
        # long-term GOLDEN anchor on the device with per-block ref choice
        self.golden = golden
        self.golden_interval = golden_interval
        self._step = make_pframe_step(self.g, self.device, split16=split16,
                                      golden=golden)
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
        self._prev_mv32 = torch.zeros((self.g.n_blocks32, 2),
                                      dtype=torch.int32, device=self.device)
        self._pending = None  # (frame, idx, hdr, device outs, qidx)
        self._prev_snap = None  # mv snapshot of the last serialized frame
        self._last_was_inter = False
        self._idx = 0
        # frame N-1's host serialization runs on a worker while frame N's
        # step runs; device fetches stay on the calling thread. The rate
        # tables always read the frame context captured at the last join
        # (the state after frame N-2): the same whatever the thread timing
        self._ser_pool = cf.ThreadPoolExecutor(max_workers=1)
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
        context of the last join and cached by (its identity, qindex)."""
        with span("rt_rate_args"):
            fc = self._rates_fc
            key = (id(fc), qidx)
            if self._rates_key != key:
                self._rates_dev = upload_rate_tabs(make_rate_tabs(fc, qidx),
                                                   self.device)
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
        lam = max(1, (T.ac_quant(qidx) ** 2) >> 6)
        with span("kf_device_step"):
            outs, self._refs = self._kstep(
                *self.stage(frame), T.dc_quant(qidx), T.ac_quant(qidx), lam,
                lf_lvl, int(self._lim_tbl[lf_lvl]),
                int(self._mblim_tbl[lf_lvl]))
            if self.device.type == "cuda":
                # the fetch waits for the step anyway; waiting here lets
                # the two spans split the step from the copy
                torch.cuda.synchronize(self.device)
        if self.golden:
            # a keyframe refreshes every DPB slot; the steps never write
            # into their inputs, so the anchor can share the planes
            self._gold = self._refs
            self._since_gold = 0
        self._prev_mv32 = torch.zeros_like(self._prev_mv32)
        with span("kf_d2h_transfer"):
            host = {k: outs["m32"][k].cpu().numpy() for k in _KEY_KEYS}
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
                bi = (mi_row // 4) * g.cols32 + (mi_col // 4)
                m = IntraMode(int(host["mode"][bi]))
                st.mig.set_block(mi_row, mi_col, bsize, MI.ModeInfo(
                    bsize=bsize, y_mode=m, uv_mode=m, tx_size=TxSize.TX_32X32,
                    skip=bool(host["skip"][bi]), is_inter=False))
                for p, (r, c) in enumerate(((mi_row * 2, mi_col * 2),
                                            (mi_row, mi_col),
                                            (mi_row, mi_col))):
                    k = "yuv"[p]
                    st.levels[(p, r, c)] = host[f"lv_{k}"][bi]
                    st.eobs[(p, r, c)] = int(host[f"eob_{k}"][bi])
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
        return EncodedFrame(payload=payload, is_keyframe=True,
                            qindex=qidx, state=st, pts=idx)

    def stage(self, frame):
        """Upload one picture as padded device planes."""
        g = self.g
        shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
                  (g.pad_h // 2, g.pad_w // 2))
        with span("rt_stage"):
            return tuple(
                torch.from_numpy(pad_plane(np.asarray(p), *shp))
                .to(self.device)
                for p, shp in zip((frame.y, frame.u, frame.v), shapes))

    def step_args(self, qidx: int):
        """The step's arguments after the source and reference planes for
        a P-frame at ``qidx``, from the session's present state."""
        lf_lvl = pick_filter_level(qidx, False) if self.loop_filter else 0
        args = (self._prev_mv32, T.dc_quant(qidx), T.ac_quant(qidx),
                max(1, (T.ac_quant(qidx) ** 2) >> 6), lf_lvl,
                int(self._lim_tbl[lf_lvl]), int(self._mblim_tbl[lf_lvl]))
        if self.golden:
            return (*self._gold, *args, self._rate_args(qidx))
        return args

    def send(self, frame, qindex: int = 100, force_keyframe: bool = False):
        """Encode one picture; returns 0..2 EncodedFrames (frame N's step
        is issued before frame N-1 is fetched and serialized)."""
        idx = self._idx
        self._idx += 1
        is_key = force_keyframe or idx == 0 or (
            self.intra_period >= 0
            and idx % (self.intra_period + 1) == 0)
        qidx = qindex
        out = []
        if is_key:
            self._drain_futs(out)
            if self._pending is not None:
                out.append(self._finish(*self._pending))
                self._pending = None
            out.append(self._encode_key(frame, idx, qidx))
            return out
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
        # and hand its serialization to the worker
        if self._pending is not None:
            pf, pidx, phdr, pouts, pq = self._pending
            with span("rt_d2h_transfer"):
                phost = _device_out_to_host(pouts, self.g, self.want_recon)
            self._drain_futs(out)

            def task(args=(pf, pidx, phdr, phost, pq)):
                ef = self._finish_host(*args)
                return ef, self._fc[0]

            self._futs.append(self._ser_pool.submit(task))
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
        """Stop the serialization worker; call after the last ``flush``."""
        self._ser_pool.shutdown()
