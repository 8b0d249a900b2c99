"""Tile-column sharding of the device P-frame step over a mesh of devices.

The port's counterpart of ``tpu_vp9/pipeline/tpu_shard.py``: one frame's
grid of 32x32 blocks is cut into column shards laid along the ``tile``
axis of a mesh, and a ``frame`` axis carries independent frames. A mesh is
a 2-D list of ``torch.device`` (rows: frame, columns: tile), driven by one
process, and it may name one device more than once (a mesh on one card).
Each shard runs the step's search, quarter-pel search, decision, MC and
transform stages on its own columns, on its own device, through the same
kernels as the single-device step (``tpu_encdec.zone_search`` and
``zone_code``), at shard-local batch sizes. The reference planes are cut
into columns, and each shard takes a BORDER-wide halo of its neighbours'
columns (``_halo_exchange``): the pixels the single-device step can reach
(search centres are clamped to +-(BORDER - r - 8)), so a shard's planes
are the columns of the frame's border-extended planes and positions and
UMV clamps stay global. Chroma takes a BORDER-wide halo too, where the
JAX package takes BORDER // 2 and moves its window origin by the
difference: the same pixels, and the window extractor is the
single-device step's. The one exchange inside a zone is the previous
shard's last column of NEW MVs, the LEFT candidate of the shard's first
column (``_encode_zone_shard``).

The loop filter crosses tile columns, so each frame's recon columns are
gathered on its row's first device and filtered there in one launch, as
the JAX package gathers, filters and re-shards them; the filtered planes
are the new references, and the next step hands each shard its columns
again. The distortion and rate sums are added up there too (the JAX
package's ``psum``).

Every copy between devices is ``Tensor.to(device)``, which PyTorch orders
against the current streams of both devices; nothing here makes a stream
of its own, and nothing reads a result on the host.

Levels, MVs, eobs, recon, distortion and rate equal the single-device
step's for any shard count (``tests/test_torch_shard.py`` against the JAX
package's sharded step on the CPU; ``chip_smoke.py --mesh`` on the card).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tpu_vp9_torch.pipeline.tpu_encdec import (
    BORDER, FILTERS, ZONE_KEYS, Geom, _pad_edge, _zone, extend_borders_device,
    loop_filter_device, new_bits_table, zone_code, zone_search,
)


def _shard_positions(geom: Geom, n_tiles: int, tile_idx: int, device,
                     n: int = 32):
    """Global (pos_y, pos_x) int32 of one column shard's n-blocks (the 32
    grid's, or at n=16 the strip's), raster order within the shard, with
    the shard's (rows, cols) and its first global column x0."""
    y0, rows, n_cols = _zone(geom, n)
    cols = n_cols // n_tiles
    x0 = tile_idx * cols * n
    ys = torch.arange(rows, dtype=torch.int32, device=device) * n + y0
    xs = torch.arange(cols, dtype=torch.int32, device=device) * n + x0
    return (ys[:, None].expand(rows, cols).reshape(-1),
            xs[None, :].expand(rows, cols).reshape(-1), rows, cols, x0)


def _halo_exchange(ref_locs, halo: int):
    """Attach ``halo`` neighbour columns on each side of every column
    shard of one frame row: ``ref_locs`` lists the shards' (H, wl) planes,
    left to right, each on its device. The frame's edges replicate their
    boundary column (libvpx extend_frame), so each result is the matching
    columns of the frame's border-extended plane. Wide shards (wl >= halo)
    take their neighbours' edge columns; narrow ones gather the whole row
    and take their window of it, as the JAX package's all-gather path
    does. Returns the (H, wl + 2 halo) planes on the shards' devices."""
    n = len(ref_locs)
    wl = ref_locs[0].shape[1]
    out = []
    for t, p in enumerate(ref_locs):
        dev = p.device
        if n == 1 or wl >= halo:
            left = (p[:, :1].expand(-1, halo) if t == 0
                    else ref_locs[t - 1][:, -halo:].to(dev))
            right = (p[:, -1:].expand(-1, halo) if t == n - 1
                     else ref_locs[t + 1][:, :halo].to(dev))
            out.append(torch.cat([left, p, right], dim=1))
        else:
            full = torch.cat([q.to(dev) for q in ref_locs], dim=1)
            cols = (torch.arange(-halo, wl + halo, device=dev)
                    + t * wl).clamp(0, full.shape[1] - 1)
            out.append(full.index_select(1, cols))
    return out


def _pad_rows(plane, border: int):
    """Replicate the first and last rows ``border`` times."""
    return torch.cat([plane[:1].expand(border, -1), plane,
                      plane[-1:].expand(border, -1)])


def _halo_planes(planes_by_shard):
    """The shards' (y, u, v) planes, unbordered, to border-extended shard
    planes: ``_halo_exchange`` across the row, then the rows' border."""
    return [tuple(_pad_rows(p, BORDER) for p in trio) for trio in zip(
        *(_halo_exchange(list(col), BORDER)
          for col in zip(*planes_by_shard)))]


def _encode_zone_shard(src, ref_h, prev_mv, geom: Geom, consts, n: int = 32,
                       gold_h=None, rates=None):
    """The zone of n-blocks on every column shard of one frame row.

    src: per shard the (y, u, v) source planes of its columns; ref_h,
    gold_h: per shard the border-extended reference planes of
    ``_halo_planes``; prev_mv: per shard its blocks' previous MVs;
    consts: (dc_q, ac_q, lam, filters by device, new_bits by device);
    rates: per shard ``upload_rate_tabs`` on its device, or None. Every
    shard searches first; then each takes the previous shard's last column
    of NEW MVs (the first shard: the frame's edge, zeros) and codes its
    blocks. Returns per shard ``zone_code``'s dict."""
    dc_q, ac_q, lam, filters, new_bits = consts
    n_tiles = len(src)
    y0 = _zone(geom, n)[0]
    mes, x0s = [], []
    for t in range(n_tiles):
        dev = src[t][0].device
        pos_y, pos_x, rows, cols, x0 = _shard_positions(geom, n_tiles, t,
                                                        dev, n)
        mes.append(zone_search(src[t][0], ref_h[t][0], (pos_y, pos_x, rows,
                                                        cols), y0, n,
                               rates=None if rates is None else rates[t]))
        x0s.append(x0)
    outs = []
    for t, me in enumerate(mes):
        dev = src[t][0].device
        edge = None
        if t > 0:
            left = mes[t - 1]
            edge = torch.stack([left["new_r"], left["new_c"]], dim=-1) \
                .reshape(left["rows"], left["cols"], 2)[:, -1].to(dev)
        outs.append(zone_code(
            me, src[t][1], src[t][2], ref_h[t][1], ref_h[t][2], prev_mv[t],
            geom, dc_q, ac_q, lam, filters[dev], new_bits[dev],
            gold=None if gold_h is None else gold_h[t], left_edge=edge,
            x_base=x0s[t]))
    return outs


def _rates_on(rates, device):
    """``upload_rate_tabs``' dict with its lookup tables on ``device``."""
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v
            for k, v in rates.items()}


def make_pframe_step_sharded(geom: Geom, mesh, n_tiles: int,
                             golden: bool = False):
    """The P-frame step over a mesh with axes ('frame', 'tile'):

        step(src_y, src_u, src_v, ref_y, ref_u, ref_v, prev_mv, prev_mv16,
             dc_q, ac_q, lam, lf_lvl, lf_lim, lf_mblim
             [, gold_y, gold_u, gold_v, rates])            # golden

    mesh: rows of ``n_tiles`` devices (a device may repeat). The planes
    are (F, H, W) tensors on any device, F a multiple of the rows: frame
    row r takes frames [r F/R, (r+1) F/R) and loops them; tile t takes
    columns [t W/n, (t+1) W/n). The references come without borders (each
    step derives them). prev_mv: (F, n_blocks32, 2) in shard-major order
    (each shard's blocks in raster order, the shards left to right);
    prev_mv16: (F, cols16, 2), the strip's (read at a strip geometry
    only). The scalars are host ints; ``rates`` is
    ``upload_rate_tabs(...)``, which a GOLDEN step takes, as in the JAX
    package.

    Returns (outs, (ref_y, ref_u, ref_v)) on the mesh's first device:
    outs' per-block arrays (F, n_blocks32, ...) in shard-major order (a
    strip geometry adds the strip's "m16_*"), "rec_y"/"rec_u"/"rec_v" the
    gathered unfiltered recon of the zones, "dist" and "rate" (F,) int64
    sums over the frame; the new references are the loop-filtered padded
    planes (F, pad_h, pad_w), without borders.

    Raises ValueError where the JAX package's does: cols32 not a multiple
    of n_tiles, width % 64 != 0."""
    if geom.cols32 % n_tiles:
        raise ValueError("cols32 must divide n_tiles")
    if geom.pad_w != geom.width:
        raise ValueError("sharded step requires width % 64 == 0")
    g = geom
    mesh = [[torch.device(d) for d in row] for row in mesh]
    if not mesh or any(len(row) != n_tiles for row in mesh):
        raise ValueError(f"a mesh row holds n_tiles={n_tiles} devices")
    devices = list(dict.fromkeys(d for row in mesh for d in row))
    filters = {d: torch.as_tensor(np.asarray(FILTERS, np.int32), device=d)
               for d in devices}
    new_bits = {d: new_bits_table(d) for d in devices}
    n_fixed = 14 + (4 if golden else 0)
    wl = g.pad_w // n_tiles
    b_loc = g.n_blocks32 // n_tiles
    s_loc = g.cols16 // n_tiles

    def split(planes, devs):
        """(y, u, v) planes -> per shard its columns on its device."""
        return [tuple(p[:, t * (wl >> ss):(t + 1) * (wl >> ss)].to(dev)
                      for p, ss in zip(planes, (0, 1, 1)))
                for t, dev in enumerate(devs)]

    def one_frame(devs, src, ref, gold, prev_mv, prev_mv16, scal, rates):
        dc_q, ac_q, lam, lf_lvl, lf_lim, lf_mblim = scal
        consts = (dc_q, ac_q, lam, filters, new_bits)
        shards = range(n_tiles)
        src_s = split(src, devs)
        ref_h = _halo_planes(split(ref, devs))
        gold_h = None
        rates_s = None
        if golden:
            gold_h = _halo_planes(split(gold, devs))
            rates_s = [_rates_on(rates, devs[t]) for t in shards]
        pm = [prev_mv[t * b_loc:(t + 1) * b_loc].to(devs[t]) for t in shards]
        zones = [_encode_zone_shard(src_s, ref_h, pm, g, consts,
                                    gold_h=gold_h, rates=rates_s)]
        if g.strip:
            pm16 = [prev_mv16[t * s_loc:(t + 1) * s_loc].to(devs[t])
                    for t in shards]
            zones.append(_encode_zone_shard(src_s, ref_h, pm16, g, consts,
                                            n=16, gold_h=gold_h,
                                            rates=rates_s))
        # the frame's sums and recon come to the row's first device, where
        # one launch filters the whole frame (the filter crosses tiles)
        dev0 = devs[0]
        out = {}
        for prefix, zone in zip(("", "m16_"), zones):
            for k in ZONE_KEYS:
                out[prefix + k] = torch.cat([o[k].to(dev0) for o in zone])
        out["dist"] = sum(o["dist"].to(dev0) for z in zones for o in z)
        out["rate"] = sum(o["rate"].to(dev0) for z in zones for o in z)
        recs = [torch.cat([torch.cat([o[k].to(dev0) for o in z], dim=1)
                           for z in zones])
                for k in ("rec_y", "rec_u", "rec_v")]
        out["rec_y"], out["rec_u"], out["rec_v"] = recs
        rec_y = _pad_edge(recs[0], g.pad_h, g.pad_w)
        rec_u = _pad_edge(recs[1], g.pad_h // 2, g.pad_w // 2)
        rec_v = _pad_edge(recs[2], g.pad_h // 2, g.pad_w // 2)
        return out, loop_filter_device(rec_y, rec_u, rec_v, g, lf_lvl,
                                       lf_lim, lf_mblim)

    def step(src_y, src_u, src_v, ref_y, ref_u, ref_v, prev_mv, prev_mv16,
             *rest):
        if len(rest) + 8 != n_fixed:
            raise TypeError(f"step takes {n_fixed} arguments, got "
                            f"{len(rest) + 8}")
        scal = rest[:6]
        gold = rest[6:9]
        rates = rest[9] if golden else None
        n_frames = src_y.shape[0]
        if n_frames % len(mesh):
            raise ValueError(f"{n_frames} frames over {len(mesh)} frame "
                             "rows")
        per_row = n_frames // len(mesh)
        frames = []
        for r, devs in enumerate(mesh):
            for f in range(r * per_row, (r + 1) * per_row):
                frames.append(one_frame(
                    devs, (src_y[f], src_u[f], src_v[f]),
                    (ref_y[f], ref_u[f], ref_v[f]),
                    tuple(p[f] for p in gold), prev_mv[f], prev_mv16[f],
                    scal, rates))
        dev00 = mesh[0][0]
        outs = {k: torch.stack([o[k].to(dev00) for o, _ in frames])
                for k in frames[0][0]}
        refs = tuple(torch.stack([r[i].to(dev00) for _, r in frames])
                     for i in range(3))
        return outs, refs

    return step


def mesh_devices(n_tiles: int, device):
    """The devices of a (1, n_tiles) mesh for a session on ``device``: on
    CUDA the first ``n_tiles`` cards, a ValueError if the machine has
    fewer (the JAX package's); elsewhere ``device`` repeated, the
    counterpart of the JAX tests' virtual CPU devices."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n_tiles
    avail = torch.cuda.device_count()
    if avail < n_tiles:
        raise ValueError(
            f"mesh requests {n_tiles} devices, {avail} available")
    return [torch.device("cuda", i) for i in range(n_tiles)]


def make_rt_step_sharded(geom: Geom, mesh_shape, device,
                         split16: bool = False, golden: bool = False):
    """The sharded step behind ``RtSession(mesh_shape=)``, with
    ``make_pframe_step``'s call and outputs (one frame, border-extended
    references in and out, block arrays in raster order, "m32" and at a
    strip geometry "m16"), so that the session, its fetch and the
    serializer do not know about shards:

        step(src_y, src_u, src_v, ref_y, ref_u, ref_v,
             [gold_y, gold_u, gold_v,] prev_mv32, prev_mv16, dc_q, ac_q,
             lam, lf_lvl, lf_lim, lf_mblim [, rates])       # golden

    The mesh is (1, prod(mesh_shape)) over ``mesh_devices``; the outputs
    and references land on ``device``. Raises ValueError as the JAX
    package's does: split16 (not sharded), too few cards, and the
    geometries ``make_pframe_step_sharded`` refuses. The step carries
    ``devices``, its mesh's devices."""
    if split16:
        raise ValueError("split16 is not supported on the sharded step")
    n_tiles = math.prod(int(d) for d in mesh_shape)
    devs = mesh_devices(n_tiles, device)
    base = make_pframe_step_sharded(geom, [devs], n_tiles, golden=golden)
    out_dev = torch.device(device)
    g = geom
    B = BORDER
    rows, cols_loc = g.rows32, g.cols32 // n_tiles
    n_refs = 6 if golden else 3
    n_fixed = 3 + n_refs + 8 + (1 if golden else 0)

    def to_shard_major(pm):
        return pm.reshape(rows, n_tiles, cols_loc, 2).permute(1, 0, 2, 3) \
            .reshape(-1, 2)

    def to_raster(arr):
        lead = tuple(arr.shape[1:])
        return arr.reshape(n_tiles, rows, cols_loc, *lead) \
            .permute(1, 0, 2, *range(3, 3 + len(lead))) \
            .reshape(rows * n_tiles * cols_loc, *lead).to(out_dev)

    def unbordered(p):
        return p[B:-B, B:-B][None]

    def step(src_y, src_u, src_v, *rest):
        if len(rest) + 3 != n_fixed:
            raise TypeError(f"step takes {n_fixed} arguments, got "
                            f"{len(rest) + 3}")
        refs = rest[:n_refs]
        (prev_mv32, prev_mv16, dc_q, ac_q, lam, lf_lvl, lf_lim,
         lf_mblim) = rest[n_refs:n_refs + 8]
        extra = tuple(unbordered(p) for p in refs[3:]) + rest[n_refs + 8:]
        outs, (nry, nru, nrv) = base(
            src_y[None], src_u[None], src_v[None],
            *(unbordered(p) for p in refs[:3]),
            to_shard_major(prev_mv32)[None], prev_mv16[None], dc_q, ac_q,
            lam, lf_lvl, lf_lim, lf_mblim, *extra)
        m32 = {k: to_raster(outs[k][0]) for k in ZONE_KEYS}
        m32["dist"] = outs["dist"][0].to(out_dev)
        m32["rate"] = outs["rate"][0].to(out_dev)
        rec_y, rec_u, rec_v = (p[0].to(out_dev) for p in (nry, nru, nrv))
        out = {"m32": m32, "rec_y": rec_y, "rec_u": rec_u, "rec_v": rec_v}
        if g.strip:
            # one row of blocks: shard-major is raster
            out["m16"] = {k: outs[f"m16_{k}"][0].to(out_dev)
                          for k in ZONE_KEYS}
        cw, ch = (g.width + 1) >> 1, (g.height + 1) >> 1
        return out, (extend_borders_device(rec_y, g.width, g.height),
                     extend_borders_device(rec_u, cw, ch),
                     extend_borders_device(rec_v, cw, ch))

    step.devices = devs
    return step
