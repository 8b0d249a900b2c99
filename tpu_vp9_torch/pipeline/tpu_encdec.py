"""The realtime device P-frame step on torch: the M9 and M8 configurations.

The counterpart of ``tpu_vp9/pipeline/tpu_encdec.py`` for the 32x32 grid
without a strip: for every 32x32 block of the frame at once,

    window extraction -> 2-level full-pel SSE search -> quarter-pel search
    -> ZERO/NEW/PREV/LEFT/ABOVE decision -> exact 8-tap MC (Y/U/V)
    -> float64 forward transform + quantizer -> exact integer recon
    -> eob/skip -> exact VP9 loop filter -> border extension.

M9 runs that with the LAST reference and rate proxies. M8 adds, each
behind its own argument of ``make_pframe_step``: candidate costs from the
frame's entropy tables (``make_rate_tabs``, ``rates=``), the GOLDEN anchor
(two more candidates per block and a per-block choice of MC windows,
``gold=``), and the 32-against-4x16 descent (``split16``): the quarter of
the parents with the largest distortion get their four 16x16 children
searched +-8 inside the parent's window, encoded, and compared with the
parent by cost; the loop filter then takes the per-parent split mask. The
adaptive lambda (``aq``), the ALTREF reference and strip geometries are
not ported.

The new reference planes stay on the step's device; the host receives the
levels, eobs, MVs (and the recon when asked) and serializes them with the
native serializer.

Every stage computes what the JAX package's stage computes, as plain
functions on tensors of the caller's device, with CUDA kernels in
``ops/cuda_kernels.py``: the full-pel search (``hier_search_fused`` for
both levels of the 32 zone in one launch, ``sse_map_search`` for the
children), the quarter-pel search (``subpel_search``), the distortion
(``block_energy`` on blocks, ``block_energy_at`` on candidates read in
place out of a reference plane), the transform stage (``transform_recon``:
forward DCT, quantizer, inverse, recon and eob) and the loop filter
(``loop_filter``, all three planes in one launch). The plain versions of
the last three kernels and of the quarter-pel search live here
(``subpel_search_ref``, ``transform_recon_ref``, ``loop_filter_ref``), each
reached through its dispatch (``subpel_search``, ``transform_recon``,
``loop_filter_device``): CPU tensors take the plain version, CUDA tensors
the kernel's wrapper, which launches or raises. Formulations that
exist only to suit the TPU are not carried over: one-hot matmul gathers
(``_oh_take_rows/_cols``) are plain indexing, float32 stand-ins for
integer arithmetic are int32, and the scan-prefix level transfer is not
ported (the step ships full int16 level planes). Indexing in torch does
not clamp out-of-range starts the way ``lax.dynamic_slice`` does, so every
slice here is either proven in range or checked.

The keyframe has its own step, ``make_kframe_step``: the closed-loop
intra encode of the 32 grid by anti-diagonals (``kframe_wave``, a CUDA
kernel, with its plain version ``kframe_wave_ref`` here; all 10 intra modes
predicted by ``predict_intra_all``), then the same loop filter and border
extension.

Geometries: width % 32 == 0 and mi_rows % 4 in {0, 3} (the 16-pixel strip
of mi_rows % 4 == 2 is not ported yet; ``make_geom`` still describes it).
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.utils.trace import span

from tpu_vp9_torch.ops import cuda_kernels, intra, txfm
from tpu_vp9_torch.ops.cuda_kernels import (
    HALF_R, KF_MODE_BIAS, KF_STRIP, REFINE_R, WIN_R, check_kf_args,
    block_energy, block_energy_at, hier_search_fused, kf_diagonal,
    kf_outputs, kframe_wave, loop_filter, sse_map_search,
    take_windows as _take_windows,
)

BORDER = 96  # matches tpu_vp9/ops/inter.py (host refs interop)
CHROMA_WIN_R = 21  # chroma MC window reach: 40.75/2 pel rounded up
CHILD_R = 8  # 16-block refinement radius around the 32-parent's winner
# extra syntax cost (in rate_b units) a 32->16 split pays: partition
# symbol + 3 extra mode/skip/mv sets
SPLIT_RATE_EXTRA = 4.0
DESCEND_FRAC = 4  # the descent takes the B32 // DESCEND_FRAC worst parents
# candidate rate proxies in lambda units (zero, new-base, new-per-log2mvd,
# prev/temporal, spatial left/above), as the TPU package's
CAND_RATE_PROXY = (2.0, 10.0, 2.0, 6.0, 4.0)
_Q3_OFFS = tuple(range(-6, 7, 2))  # quarter-pel reach, q3 units
# largest |NEW - LEFT| mvd (q3, row + col): NEW MVs lie within
# +-(8 * (WIN_R - REFINE_R) + 8 * REFINE_R + 6) and LEFT is one of them
MVD_MAX = 4 * (8 * WIN_R + 6)
FILTERS = T.subpel_filters(T.InterpFilter.EIGHTTAP)  # (16, 8) int


@contextlib.contextmanager
def _stage(name: str):
    """A stage of the step: a host-clock span of ``utils.trace``
    (enqueue time on a card) and a ``torch.profiler`` range, whose device
    time a profile attributes to the stage."""
    with span(name), torch.profiler.record_function(name):
        yield


# ---------------------------------------------------------------------------
# Geometry (as tpu_vp9/pipeline/tpu_encdec.py has it)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Geom:
    """Static per-resolution geometry of the uniform device grid."""

    width: int          # visible luma width (must be a multiple of 32)
    height: int         # visible luma height
    mi_rows: int
    mi_cols: int
    rows32: int         # 32-block rows in the main zone
    cols32: int         # 32-block cols
    strip: bool         # 16x16 bottom strip present (mi_rows % 4 == 2)
    pad_w: int          # device plane width (multiple of 64)
    pad_h: int          # device plane height (main zone + strip)

    @property
    def h_mi(self) -> int:
        return self.mi_rows * 8

    @property
    def w_mi(self) -> int:
        return self.mi_cols * 8

    @property
    def n_blocks32(self) -> int:
        return self.rows32 * self.cols32

    @property
    def cols16(self) -> int:
        return self.width // 16

    @property
    def strip_y(self) -> int:
        return self.rows32 * 32


def make_geom(width: int, height: int) -> Geom:
    """Geometry for the device path, or raises if unsupported."""
    if width % 32 != 0:
        raise ValueError("device path requires width % 32 == 0")
    mi_rows = (height + 7) >> 3
    mi_cols = (width + 7) >> 3
    rem = mi_rows % 4
    if rem == 1:
        raise ValueError("mi_rows % 4 == 1 unsupported by device path")
    strip = rem == 2
    rows32 = mi_rows // 4 + (1 if rem == 3 else 0)
    # SB-aligned (64-multiple) plane dims, as the JAX package pads them
    pad_h = (rows32 * 32 + (16 if strip else 0) + 63) // 64 * 64
    pad_w = (width + 63) // 64 * 64
    return Geom(width=width, height=height, mi_rows=mi_rows,
                mi_cols=mi_cols, rows32=rows32, cols32=width // 32,
                strip=strip, pad_w=pad_w, pad_h=pad_h)


def pad_plane(plane: np.ndarray, ph: int, pw: int) -> np.ndarray:
    """Edge-replicate a host plane to (ph, pw)."""
    h, w = plane.shape
    return np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")


def extend_borders_device(plane, crop_w: int, crop_h: int,
                          border: int = BORDER):
    """libvpx extend_frame semantics (tpu_vp9/ops/inter.py:109): the
    visible crop replicated outward, to (H + 2 border, W + 2 border)."""
    dev = plane.device
    rows = torch.arange(-border, plane.shape[0] + border,
                        device=dev).clamp(0, crop_h - 1)
    cols = torch.arange(-border, plane.shape[1] + border,
                        device=dev).clamp(0, crop_w - 1)
    return plane.index_select(0, rows).index_select(1, cols)


def _pad_edge(plane, h: int, w: int):
    """Edge-replicate a device plane on the bottom and right to (h, w)."""
    ph, pw = plane.shape
    if pw < w:
        plane = torch.cat([plane, plane[:, -1:].expand(ph, w - pw)], dim=1)
    if ph < h:
        plane = torch.cat([plane, plane[-1:].expand(h - ph, w)], dim=0)
    return plane


# ---------------------------------------------------------------------------
# Blocks and windows
# ---------------------------------------------------------------------------


def _zone_positions(geom: Geom, device):
    """(pos_y, pos_x) int32 plane-pixel positions of the 32-grid's blocks
    in raster order, with the grid's (rows, cols)."""
    rows, cols = geom.rows32, geom.cols32
    ys = torch.arange(rows, dtype=torch.int32, device=device) * 32
    xs = torch.arange(cols, dtype=torch.int32, device=device) * 32
    return (ys[:, None].expand(rows, cols).reshape(-1),
            xs[None, :].expand(rows, cols).reshape(-1), rows, cols)


def _extract_blocks(plane, y0: int, rows: int, cols: int, n: int):
    """(rows*n, cols*n) region at row y0 -> (rows*cols, n, n)."""
    reg = plane[y0:y0 + rows * n, :cols * n]
    if tuple(reg.shape) != (rows * n, cols * n):
        raise ValueError(f"_extract_blocks: {rows}x{cols} blocks of {n} at "
                         f"row {y0} leave the {tuple(plane.shape)} plane")
    return reg.reshape(rows, n, cols, n).permute(0, 2, 1, 3).reshape(-1, n, n)


def _scatter_blocks(blocks, rows: int, cols: int, n: int):
    """(rows*cols, n, n) -> (rows*n, cols*n)."""
    return blocks.reshape(rows, cols, n, n).permute(0, 2, 1, 3) \
        .reshape(rows * n, cols * n)


def window_bounds(ref_shape, n: int, rows: int, cols: int, y_base: int,
                  r: int = WIN_R):
    """(y0, x0, height, width) of the border-extended plane region that
    the search windows of an n-grid zone read; raises if it leaves the
    plane (torch slicing would cut it short, lax slicing would refuse)."""
    sw = n + 2 * r + 8
    y0 = y_base + BORDER - r - 4
    x0 = BORDER - r - 4
    hh = (rows - 1) * n + sw
    ww = (cols - 1) * n + sw
    if y0 < 0 or x0 < 0 or y0 + hh > ref_shape[0] or x0 + ww > ref_shape[1]:
        raise ValueError(f"search windows of {rows}x{cols} blocks of {n} "
                         f"(r={r}) leave the {tuple(ref_shape)} plane")
    return y0, x0, hh, ww


def _extract_search_windows(ref_padded, n: int, rows: int, cols: int,
                            y_base: int, r: int = WIN_R):
    """Static (B, SW, SW) uint8 search windows, SW = n + 2r + 8, whose
    origin is the block's top-left minus (r + 4): the +-r full-pel search
    plus the 8-tap subpel halo. Blocks in raster order."""
    sw = n + 2 * r + 8
    y0, x0, hh, ww = window_bounds(ref_padded.shape, n, rows, cols, y_base,
                                   r)
    region = ref_padded[y0:y0 + hh, x0:x0 + ww]
    wins = region.unfold(0, sw, n).unfold(1, sw, n)  # (rows, cols, sw, sw)
    return wins.reshape(rows * cols, sw, sw)


@functools.lru_cache(maxsize=None)
def _grid_starts(rows: int, cols: int, n: int, device):
    """(y0, x0) int32 (1, rows*cols): where the blocks of the n-grid at
    the plane's origin start in a border-extended plane, raster order."""
    ys = torch.arange(rows, dtype=torch.int32, device=device) * n + BORDER
    xs = torch.arange(cols, dtype=torch.int32, device=device) * n + BORDER
    return (ys[:, None].expand(rows, cols).reshape(1, -1).contiguous(),
            xs[None, :].expand(rows, cols).reshape(1, -1).contiguous())


def _zero_sse(ref_padded, src_blocks, rows: int, cols: int, n: int):
    """SSE of the ZERO-MV candidate of the n-grid at the plane's origin.

    Zero MV is never moved by the UMV clamp and its subpel phase is the
    identity tap, so the prediction is the co-located reference block,
    read in place."""
    y0, x0 = _grid_starts(rows, cols, n, ref_padded.device)
    return block_energy_at(src_blocks, ref_padded, y0, x0, n)[0][0]


def _block_sq_sum(src_blocks):
    """Per-block sum(src^2), int32."""
    s = src_blocks.to(torch.int32)
    return (s * s).sum(dim=(1, 2), dtype=torch.int32)


def _fullpel_starts(plane_shape, pos_y, pos_x, mv_r_q3, mv_c_q3, n: int):
    """(y0, x0) int32 (B,): where the n x n block at the rounded full-pel
    position of a q3 MV starts in a border-extended plane.

    The MV gets no UMV clamp here, as in the JAX package, which relies
    on ``lax.dynamic_slice``: a negative start wraps once (the dimension
    is added to it, as in Python indexing) and the result is clamped so
    that the slice stays inside the plane. The same is done to the starts
    here, since neither torch indexing nor the kernel would."""
    hh, ww = plane_shape

    def start(idx, size):
        return torch.where(idx < 0, idx + size, idx).clamp(0, size - n)

    return (start(BORDER + pos_y + ((mv_r_q3 + 4) >> 3), hh),
            start(BORDER + pos_x + ((mv_c_q3 + 4) >> 3), ww))


def _fullpel_sse(ref_padded, src_blocks, pos_y, pos_x, mv_r_q3, mv_c_q3,
                 n: int):
    """SSE at the rounded full-pel position (no interpolation): the score
    of a candidate that has no search-map entry (GOLDEN's previous MV)."""
    y0, x0 = _fullpel_starts(ref_padded.shape, pos_y, pos_x, mv_r_q3,
                             mv_c_q3, n)
    return block_energy_at(src_blocks, ref_padded, y0[None], x0[None],
                           n)[0][0]


# ---------------------------------------------------------------------------
# Motion search
# ---------------------------------------------------------------------------


def hier_search(src_blocks, wins, n: int):
    """Two-level full-pel search: exhaustive +-HALF_R at 2x decimation
    (2x2 sums), then exhaustive +-REFINE_R at full resolution around the
    upscaled winner. On a card both levels, the decimation, the centre
    and the refine windows are one launch of ``hier_search_fused``; on
    the CPU its plain version composes them from ``sse_map_search_ref``.

    Returns (c_y, c_x, dyr, dxr, loc, ssem_h, src2_h):
      c_y/c_x  int32 refine centre (upscaled half-res winner, clipped so
               the refine window stays inside the search window)
      dyr/dxr  int32 refine winner relative to the centre
      loc      (B, n+2*REFINE_R+8, ...) uint8 refine windows whose origin
               is block + centre - (REFINE_R+4)
      ssem_h   (B, 2*HALF_R+1, ...) int32 half-res relative-SSE map
      src2_h   (B,) int32 half-res sum(src_h^2)
    """
    return hier_search_fused(src_blocks, wins, n)


def _conv8(x, taps, axis: int, m: int):
    """8-tap pass with static taps along ``axis`` (1 rows, 2 columns),
    m outputs, libvpx rounding: clamp((acc + 64) >> 7, 0, 255); int32."""
    acc = None
    for k, t in enumerate(int(v) for v in taps):
        if t == 0:
            continue
        term = x.narrow(axis, k, m) * t
        acc = term if acc is None else acc + term
    return ((acc + 64) >> 7).clamp(0, 255)


def subpel_search_ref(wins, src_blocks, dy, dx, n: int, r: int):
    """Exhaustive quarter-pel search around a full-pel winner (plain
    version of the step's quarter-pel stage, ``_subpel_exhaustive``).

    wins: (B, n+2r+8, ...) uint8 windows whose origin is the block minus
    (r + 4); dy/dx: int32 full-pel winner in [-r, r]. Builds the 16 phase
    planes (4 x-phases by 4 y-phases, H then V 8-tap with libvpx rounding)
    in int32, and scores the 7x7 q3 offsets in +-6/8 pel by SSE, keeping
    the first best in oy-major order (strict '<').
    Returns (mv_r_q3, mv_c_q3, sse) int32, mv relative to the window's
    centre.
    """
    loc = _take_windows(wins, dy + r, dx + r, n + 8).to(torch.int32)
    src = src_blocks.to(torch.int32)
    phases = (0, 4, 8, 12)
    ih = {px: _conv8(loc, FILTERS[px], 2, n + 1) for px in phases}
    planes = {(py, px): _conv8(ih[px], FILTERS[py], 1, n + 1)
              for py in phases for px in phases}
    best_sse = best_oy = best_ox = None
    for oy in _Q3_OFFS:
        qy = oy * 2
        sy, py = (qy >> 4) + 1, qy & 15
        for ox in _Q3_OFFS:
            qx = ox * 2
            sx, px = (qx >> 4) + 1, qx & 15
            d = planes[(py, px)][:, sy:sy + n, sx:sx + n] - src
            sse = (d * d).sum(dim=(1, 2), dtype=torch.int32)
            if best_sse is None:
                best_sse = sse
                best_oy = torch.full_like(sse, oy)
                best_ox = torch.full_like(sse, ox)
            else:
                better = sse < best_sse
                best_sse = torch.where(better, sse, best_sse)
                best_oy = torch.where(better, oy, best_oy)
                best_ox = torch.where(better, ox, best_ox)
    return dy * 8 + best_oy, dx * 8 + best_ox, best_sse


def subpel_search(wins, src_blocks, dy, dx, n: int, r: int):
    """The step's quarter-pel search (contract: ``subpel_search_ref``).
    Tensors that all lie on the CPU take the plain version; anything else
    goes to the CUDA kernel's wrapper, which launches or raises."""
    if all(t.device.type == "cpu" for t in (wins, src_blocks, dy, dx)):
        return subpel_search_ref(wins, src_blocks, dy, dx, n, r)
    return cuda_kernels.subpel_search(wins, src_blocks, dy, dx, n, r)


# ---------------------------------------------------------------------------
# Motion compensation (vpx_convolve8 semantics; parity: ops/inter.py)
# ---------------------------------------------------------------------------


def _clamp_mv_umv(mv_r, mv_c, mi_r, mi_c, bw: int, bh: int, ss: int,
                  mi_rows: int, mi_cols: int):
    """Vectorized clamp_mv_to_umv_border (vp9_reconinter.c:68).

    mv in q3 luma units; returns plane-space q4 (row, col)."""
    spel_left = (4 + bw) << 4
    spel_right = spel_left - 16
    spel_top = (4 + bh) << 4
    spel_bottom = spel_top - 16
    scale = 1 << (1 - ss)
    mb_l = -(mi_c * 8) * 8
    mb_r = ((mi_cols - (bw << ss) // 8) - mi_c) * 64
    mb_t = -(mi_r * 8) * 8
    mb_b = ((mi_rows - (bh << ss) // 8) - mi_r) * 64
    row = torch.clamp(mv_r * scale, mb_t * scale - spel_top,
                      mb_b * scale + spel_bottom)
    col = torch.clamp(mv_c * scale, mb_l * scale - spel_left,
                      mb_r * scale + spel_right)
    return row, col


def mc_predict_from_wins(wins, pos_y, pos_x, mv_r_q3, mv_c_q3, n_out: int,
                         ss: int, mi_rows: int, mi_cols: int, filters,
                         win_r: int, org_off_y=0, org_off_x=0):
    """Exact MC prediction from per-block windows whose origin is the
    block's top-left minus (win_r + 4), minus ``org_off`` (a child block
    that reads its parent's window passes its offset inside the parent).

    Bit-identical to MC on the full border-extended plane while every
    UMV-clamped mv stays within +-(win_r + 0.75) pel, which holds for the
    realtime candidates (all derive from the +-WIN_R search). filters:
    (16, 8) int32 tensor of 8-tap kernels by phase. Returns
    (B, n_out, n_out) uint8.
    """
    mi_r = (pos_y << ss) // 8
    mi_c = (pos_x << ss) // 8
    row_q4, col_q4 = _clamp_mv_umv(mv_r_q3, mv_c_q3, mi_r, mi_c, n_out,
                                   n_out, ss, mi_rows, mi_cols)
    x_q4 = (pos_x << 4) + col_q4
    y_q4 = (pos_y << 4) + row_q4
    sw = wins.shape[-1]
    ln = n_out + 7
    s_y = ((y_q4 >> 4) - pos_y + win_r + 1 + org_off_y).clamp(0, sw - ln)
    s_x = ((x_q4 >> 4) - pos_x + win_r + 1 + org_off_x).clamp(0, sw - ln)
    loc = _take_windows(wins, s_y, s_x, ln).to(torch.int32)
    fx = filters[(x_q4 & 15).long()]  # (B, 8)
    fy = filters[(y_q4 & 15).long()]
    acc = loc[:, :, 0:n_out] * fx[:, 0, None, None]
    for k in range(1, 8):
        acc = acc + loc[:, :, k:k + n_out] * fx[:, k, None, None]
    inter = ((acc + 64) >> 7).clamp(0, 255)
    acc = inter[:, 0:n_out, :] * fy[:, 0, None, None]
    for k in range(1, 8):
        acc = acc + inter[:, k:k + n_out, :] * fy[:, k, None, None]
    return ((acc + 64) >> 7).clamp(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# Mode decision (rate proxies at M9, the frame's entropy tables at M8)
# ---------------------------------------------------------------------------


def make_rate_tabs(fc, qindex: int):
    """Per-frame entropy-table rates for the step's mode decision (host,
    numpy; ``tpu_vp9/pipeline/tpu_encdec.py:make_rate_tabs``).

    Inter-mode tree costs (context-averaged), the nmv component cost LUTs
    for NEWMV's mvd bits, the mv-joint tree and the single-ref signalling
    bits, all in 1/256-bit units; the step combines them as
    SSE + lam_bits * rate / 256."""
    from tpu_vp9_torch.codec.rd_cost import (
        MV_COST_MAX, PROB_COST, _mv_component_costs, tree_token_costs,
    )

    mode_cost = np.stack([
        tree_token_costs("inter_mode_tree", fc.inter_mode_probs[c])
        for c in range(7)]).mean(axis=0).astype(np.int32)  # (4,)
    joint_cost = tree_token_costs("mv_joint_tree",
                                  fc.nmv.joints).astype(np.int32)  # (4,)
    nmv_row = _mv_component_costs(fc.nmv.comps[0]).astype(np.int32)
    nmv_col = _mv_component_costs(fc.nmv.comps[1]).astype(np.int32)
    # single-ref bits, context-averaged: LAST = p1-bit 0;
    # GOLDEN = p1-bit 1 + p2-bit 0; ALTREF = p1-bit 1 + p2-bit 1
    p1 = fc.single_ref_probs[:, 0].astype(np.int32)
    p2 = fc.single_ref_probs[:, 1].astype(np.int32)
    last_c = int(PROB_COST[p1].mean())
    gold_c = int(PROB_COST[256 - p1].mean() + PROB_COST[p2].mean())
    alt_c = int(PROB_COST[256 - p1].mean() + PROB_COST[256 - p2].mean())
    ac_q = T.ac_quant(qindex)
    lam_bits = max(1.0, 0.85 * (ac_q / 8.0) ** 2)
    return {
        "mode_cost": mode_cost,
        "joint_cost": joint_cost,
        "nmv_row": nmv_row,
        "nmv_col": nmv_col,
        "ref_cost": np.array([last_c, gold_c, alt_c], np.int32),
        "lam_bits": np.float32(lam_bits),
        "mv_cost_max": MV_COST_MAX,
    }


def upload_rate_tabs(tabs, device):
    """The step's ``rates`` argument from ``make_rate_tabs``: the three
    LUTs the step gathers from go to ``device``; the scalars it only
    broadcasts stay host numbers (``lam_bits`` the float32 value)."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return {
        "mode_cost": [int(v) for v in tabs["mode_cost"]],
        "ref_cost": [int(v) for v in tabs["ref_cost"]],
        "lam_bits": float(np.float32(tabs["lam_bits"])),
        "mv_cost_max": int(tabs["mv_cost_max"]),
        "joint_cost": dev(tabs["joint_cost"]),
        "nmv_row": dev(tabs["nmv_row"]),
        "nmv_col": dev(tabs["nmv_col"]),
    }


def _mvd_bits(rates, dr, dc):
    """NEWMV's mvd cost in 1/256 bit against a predictor: the joint's tree
    cost plus the two component LUTs, the components clipped to the LUTs'
    reach."""
    m = rates["mv_cost_max"]
    j = 2 * (dr != 0).to(torch.int32) + (dc != 0).to(torch.int32)
    return (rates["joint_cost"][j.long()]
            + rates["nmv_row"][(dr.clamp(-m, m) + m).long()]
            + rates["nmv_col"][(dc.clamp(-m, m) + m).long()])


def _table_costs(sads, rate, lam_bits: float):
    """SSE + lam_bits * rate / 256 in float32. The multiply, the divide
    and the add are separate operations in the JAX package's order (a
    fused multiply-add would round differently)."""
    return sads.to(torch.float32) + lam_bits * rate.to(torch.float32) / 256.0


def _first_min(costs, cands):
    """Per column of (C, B) ``costs`` the first minimum (as ``jnp.argmin``)
    and that row's entry of every (C, B) tensor in ``cands``."""
    best = torch.argmin(costs, dim=0)
    ar = torch.arange(costs.shape[1], device=costs.device)
    return [c[best, ar] for c in cands], costs[best, ar], best


def new_bits_table(device):
    """float32 ``rn0 + rnb * log2(1 + k)`` for integer mvd k in
    [0, MVD_MAX], the NEWMV rate proxy, computed once on the host.

    log2 is taken in float64 and rounded to float32 (correctly rounded
    but for rare double roundings), then multiplied and added in float32
    as separate operations. The same table serves the CPU and the card,
    whose float32 log2 differ in the last bit for some k."""
    k = np.arange(MVD_MAX + 1, dtype=np.float64)
    lg = np.log2(1.0 + k).astype(np.float32)
    _, rn0, rnb, _, _ = CAND_RATE_PROXY
    bits = np.float32(rn0) + np.float32(rnb) * lg
    return torch.from_numpy(bits.astype(np.float32)).to(device)


def _ssem_gather(ssem, mv_r_q3, mv_c_q3, r: int, q3_shift: int):
    """Relative SSE of q3 MVs at their nearest map entry; MVs outside the
    map clamp to its edge (score only)."""
    d = 2 * r + 1
    half = 1 << (q3_shift - 1)
    fy = ((mv_r_q3 + half) >> q3_shift).clamp(-r, r) + r
    fx = ((mv_c_q3 + half) >> q3_shift).clamp(-r, r) + r
    flat = ssem.reshape(ssem.shape[0], d * d)
    return flat.gather(1, (fy * d + fx).long()[:, None])[:, 0]


def _candidate_decide(ssem, src2m, sse_zero, sse_new, new_r, new_c,
                      prev_mv, rows: int, cols: int, r_map: int,
                      q3_shift: int, sse_scale: int, lam: int, new_bits,
                      rates=None):
    """Pick the best MV among {ZERO, NEW, PREV, LEFT-new, ABOVE-new}.

    ZERO and NEW carry exact SSEs; PREV/LEFT/ABOVE score at their rounded
    entry of the search's SSE map (src2m restores the map's dropped
    constant, sse_scale its decimation). With ``rates``
    (``upload_rate_tabs``) the rate is the frame's entropy tables': the
    mode tree's costs, and for NEW the mvd bits against the left NEW MV,
    combined by ``_table_costs``. Without, cost = SSE + lam * rate in
    float32, the multiply and the add as separate operations; NEW's rate
    is looked up in ``new_bits`` (``new_bits_table``) by its mvd against
    the left NEW MV. ``torch.argmin`` returns the first minimum, as
    ``jnp.argmin`` does.
    Returns (mv_r, mv_c, best_cost).
    """
    b = new_r.shape[0]
    nr2 = new_r.reshape(rows, cols)
    nc2 = new_c.reshape(rows, cols)
    left_r = F.pad(nr2[:, :-1], (1, 0)).reshape(-1)
    left_c = F.pad(nc2[:, :-1], (1, 0)).reshape(-1)
    above_r = F.pad(nr2[:-1, :], (0, 0, 1, 0)).reshape(-1)
    above_c = F.pad(nc2[:-1, :], (0, 0, 1, 0)).reshape(-1)
    prev_r, prev_c = prev_mv[:, 0], prev_mv[:, 1]
    zero = torch.zeros_like(new_r)
    cand_r = torch.stack([zero, new_r, prev_r, left_r, above_r])  # (5, B)
    cand_c = torch.stack([zero, new_c, prev_c, left_c, above_c])

    def score(mr, mc):
        return (_ssem_gather(ssem, mr, mc, r_map, q3_shift) + src2m) \
            * sse_scale

    sads = torch.stack([sse_zero, sse_new, score(prev_r, prev_c),
                        score(left_r, left_c), score(above_r, above_c)])
    if rates is not None:
        mc = rates["mode_cost"]
        ones = torch.ones((b,), dtype=torch.int32, device=new_r.device)
        mvd_bits = _mvd_bits(rates, new_r - left_r, new_c - left_c)
        rate = torch.stack([mc[2] * ones, mc[3] + mvd_bits, mc[0] * ones,
                            mc[0] * ones, mc[0] * ones])
        costs = _table_costs(sads, rate, rates["lam_bits"])
    else:
        mvd = (new_r - left_r).abs() + (new_c - left_c).abs()
        rz, _, _, rp, rs = CAND_RATE_PROXY
        ones = torch.ones((b,), dtype=torch.float32, device=new_r.device)
        rate = torch.stack([rz * ones, new_bits[mvd.long()], rp * ones,
                            rs * ones, rs * ones])
        costs = sads.to(torch.float32) + float(lam) * rate
    (mv_r, mv_c), cost, _ = _first_min(costs, (cand_r, cand_c))
    return mv_r, mv_c, cost


def _golden_decide(gold_y, src_blocks, pos_y, pos_x, prev_mv, rows: int,
                   cols: int, n: int, lam: int, rates):
    """The GOLDEN reference's best candidate per block: ZERO (exact SSE)
    or the block's previous-frame MV (SSE at its rounded full-pel
    position), first minimum. Returns (mv_r, mv_c, cost) without the
    reference's own signalling cost."""
    zero = torch.zeros_like(prev_mv[:, 0])
    cand_r = torch.stack([zero, prev_mv[:, 0]])
    cand_c = torch.stack([zero, prev_mv[:, 1]])
    zy, zx = _grid_starts(rows, cols, n, gold_y.device)
    py, px = _fullpel_starts(gold_y.shape, pos_y, pos_x, prev_mv[:, 0],
                             prev_mv[:, 1], n)
    sses = block_energy_at(src_blocks, gold_y, torch.cat([zy, py[None]]),
                           torch.cat([zx, px[None]]), n)[0]  # both: (2, B)
    if rates is not None:
        mc = rates["mode_cost"]
        g_rate = torch.tensor([[mc[2]], [mc[0]]], dtype=torch.int32,
                              device=sses.device)
        costs = _table_costs(sses, g_rate, rates["lam_bits"])
    else:
        rz, _, _, rp, _ = CAND_RATE_PROXY
        costs = sses.to(torch.float32) + float(lam) * torch.tensor(
            [[rz], [rp]], dtype=torch.float32, device=sses.device)
    (mv_r, mv_c), cost, _ = _first_min(costs, (cand_r, cand_c))
    return mv_r, mv_c, cost


def _ref_extra(lam: int, rates):
    """Signalling cost of choosing (LAST, GOLDEN) in cost units: two
    float32 values, as host floats."""
    if rates is not None:
        lam_f = np.float32(rates["lam_bits"])
        return [float(np.float32(c) * lam_f / np.float32(256.0))
                for c in rates["ref_cost"][:2]]
    return [0.0, float(np.float32(2.0) * np.float32(lam))]


# ---------------------------------------------------------------------------
# Transform / quant / recon (normative inverse path)
# ---------------------------------------------------------------------------

_SCAN_CACHE: dict = {}


def _scan(n: int, device):
    key = (n, str(device))
    if key not in _SCAN_CACHE:
        order = T.scan_order(txfm.TX_SIZE[n], T.TxType.DCT_DCT)[0]
        _SCAN_CACHE[key] = torch.as_tensor(np.asarray(order, np.int64),
                                           device=device)
    return _SCAN_CACHE[key]


def transform_recon_ref(src_blocks, pred_blocks, dc_q: int, ac_q: int,
                        n: int):
    """Forward DCT + quantize + dequant + exact integer inverse add for
    (B, n, n) blocks (plain version of the kernel behind
    ``ops/cuda_kernels.py:transform_recon``). Returns (levels int16, eob
    int32, recon uint8); eob is one past the last nonzero level in scan
    order (0 if none)."""
    resid = src_blocks.to(torch.int32) - pred_blocks.to(torch.int32)
    levels = txfm.quantize_f64(txfm.fwd_txfm2d_f64(resid), dc_q, ac_q, n)
    eob, recon = recon_from_levels(levels, pred_blocks, dc_q, ac_q, n)
    return levels.to(torch.int16), eob, recon


def transform_recon(src_blocks, pred_blocks, dc_q: int, ac_q: int, n: int):
    """The step's transform stage (contract: ``transform_recon_ref``).
    Blocks that both lie on the CPU take the plain version; anything else
    goes to the CUDA kernel's wrapper, which launches or raises (and
    refuses blocks on two devices)."""
    if all(t.device.type == "cpu" for t in (src_blocks, pred_blocks)):
        return transform_recon_ref(src_blocks, pred_blocks, dc_q, ac_q, n)
    return cuda_kernels.transform_recon(src_blocks, pred_blocks, dc_q, ac_q,
                                        n)


def recon_from_levels(levels, pred_blocks, dc_q: int, ac_q: int, n: int):
    """(eob int32, recon uint8) of int32 (B, n, n) quantized levels: the
    integer half of ``transform_recon_ref``."""
    ts = txfm.TX_SIZE[n]
    recon = txfm.inv_txfm_add(
        txfm.dequant_block(levels, dc_q, ac_q, ts, xp=torch), pred_blocks,
        ts, T.TxType.DCT_DCT, xp=torch)
    b = levels.shape[0]
    nz = levels.reshape(b, n * n)[:, _scan(n, levels.device)] != 0
    pos = torch.arange(1, n * n + 1, dtype=torch.int32,
                       device=levels.device)
    eob = torch.where(nz, pos, 0).amax(dim=1)
    return eob.to(torch.int32), recon


# ---------------------------------------------------------------------------
# Exact VP9 loop filter (parity: tpu_vp9/ops/loopfilter.py)
# ---------------------------------------------------------------------------


def _c8(x):
    return x.clamp(-128, 127)


def _rp2(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _flat_sums(P, Q, n: int, shift: int):
    """The n outputs on each side of the flat (n=3, 8-wide) or flat2
    (n=7, 16-wide) filter: p_k' = RP2((k+1) p_n + p_k + sum_{j<n} p_j
    + sum_{j<n-k} q_j, shift), and q_k' likewise (libvpx filter8 and
    filter16, written as prefix sums)."""
    k = torch.arange(1, n + 1, dtype=torch.int32, device=P.device)
    k = k.view(n, *([1] * (P.dim() - 1)))
    pc = P[:n].cumsum(0, dtype=torch.int32)
    qc = Q[:n].cumsum(0, dtype=torch.int32)
    return (_rp2(k * P[n] + P[:n] + pc[n - 1] + qc.flip(0), shift),
            _rp2(k * Q[n] + Q[:n] + qc[n - 1] + pc.flip(0), shift))


# Set to a dict to have ``_lf_mixed`` count the lanes of each filter class
# it meets (a device-to-host sync per edge call: for coverage checks only)
LF_CLASS_COUNTS = None
LF_CLASSES = ("masked_out", "filter4_hev", "filter4", "flat", "flat2")


def _count_lf_classes(width, mask, hev, flat, flat2) -> None:
    """Add this call's lanes of a positive width to LF_CLASS_COUNTS."""
    live = (width > 0).expand_as(mask)
    four = mask & ~flat
    for name, lanes in zip(LF_CLASSES, (
            live & ~mask, four & hev, four & ~hev, flat & ~flat2, flat2)):
        LF_CLASS_COUNTS[name] = (LF_CLASS_COUNTS.get(name, 0)
                                 + int(lanes.sum()))


def _lf_mixed(P, Q, width, thresh: int, limit: int, blimit: int):
    """One edge filter (``ops/loopfilter._filter_edge_mixed``).

    P/Q: (taps, ...) int32 stacks, P[k] the k-th pixel before the edge and
    Q[k] the k-th after, taps 8 (or 4: edge classes of width <= 8);
    width: int32 tensor (0/4/8/16) broadcastable to P[0]; width 0 lanes
    pass through unchanged. Returns new (P, Q) stacks of the 7 (or 3)
    pixels on each side that the filter may change."""
    dp = (P[1:4] - P[:3]).abs()  # |p1-p0|, |p2-p1|, |p3-p2|
    dq = (Q[1:4] - Q[:3]).abs()
    m = torch.maximum(dp.amax(0), dq.amax(0)) > limit
    m = m | (((P[0] - Q[0]).abs() * 2 + (P[1] - Q[1]).abs() // 2) > blimit)
    mask = (~m) & (width > 0)
    hev = torch.maximum(dp[0], dq[0]) > thresh
    ps1, ps0 = P[1] - 128, P[0] - 128
    qs0, qs1 = Q[0] - 128, Q[1] - 128
    f = torch.where(hev, _c8(ps1 - qs1), 0)
    f = torch.where(mask, _c8(f + 3 * (qs0 - ps0)), 0)
    f1 = _c8(f + 4) >> 3
    f2 = _c8(f + 3) >> 3
    fa = torch.where(hev, 0, (f1 + 1) >> 1)
    p4 = torch.stack([_c8(ps0 + f2), _c8(ps1 + fa)]) + 128
    q4 = torch.stack([_c8(qs0 - f1), _c8(qs1 - fa)]) + 128
    flat = torch.maximum((P[1:4] - P[0]).abs().amax(0),
                         (Q[1:4] - Q[0]).abs().amax(0)) <= 1
    flat = flat & mask & (width >= 8)
    s_p, s_q = _flat_sums(P, Q, 3, 3)
    pout = torch.where(flat, s_p, torch.cat([p4, P[2:3].expand_as(p4[:1])]))
    qout = torch.where(flat, s_q, torch.cat([q4, Q[2:3].expand_as(q4[:1])]))
    if P.shape[0] < 8:  # taps-4 call sites never reach the 16-wide stage
        if LF_CLASS_COUNTS is not None:
            _count_lf_classes(width, mask, hev, flat, torch.zeros_like(flat))
        return pout, qout
    flat2 = torch.maximum((P[4:8] - P[0]).abs().amax(0),
                          (Q[4:8] - Q[0]).abs().amax(0)) <= 1
    flat2 = flat2 & flat & (width >= 16)
    if LF_CLASS_COUNTS is not None:
        _count_lf_classes(width, mask, hev, flat, flat2)
    s_p, s_q = _flat_sums(P, Q, 7, 4)
    keep = (4, *pout.shape[1:])
    return (torch.where(flat2, s_p, torch.cat([pout, P[3:7].expand(keep)])),
            torch.where(flat2, s_q, torch.cat([qout, Q[3:7].expand(keep)])))


def _filter_seg(seg, axis: int, width, thresh, limit, blimit):
    """Filter int32 ``seg`` in place across the edge in the middle of its
    ``axis`` (length 2*taps: p side first)."""
    taps = seg.shape[axis] // 2
    s = seg.movedim(axis, 0)  # a view: writes through it land in seg
    pout, qout = _lf_mixed(s[:taps].flip(0), s[taps:], width, thresh, limit,
                           blimit)
    n = pout.shape[0]
    s[taps - n:taps] = pout.flip(0)  # every output is a new tensor
    s[taps:taps + n] = qout


def _lf_vert(plane, rows0: int, nrows: int, xs: np.ndarray, width,
             thresh, limit, blimit, taps: int = 8):
    """Filter vertical edges at columns xs over rows [rows0, rows0+nrows),
    in place; the +-taps column windows of distinct edges must not
    overlap (taps=4 for edge classes of width <= 8 that sit 8 pixels
    apart). width: broadcastable to (nrows, E)."""
    if xs.size == 0 or nrows <= 0:
        return
    if np.any(np.diff(xs) < 2 * taps) or xs[0] < taps \
            or xs[-1] + taps > plane.shape[1]:
        raise ValueError(f"vertical edges {xs.tolist()} overlap or leave "
                         f"the {plane.shape[1]}-column plane")
    cols = torch.as_tensor(xs[:, None] + np.arange(-taps, taps)[None, :],
                           device=plane.device)  # (E, 2 taps)
    seg = plane[rows0:rows0 + nrows][:, cols].to(torch.int32)
    _filter_seg(seg, 2, width, thresh, limit, blimit)
    plane[rows0:rows0 + nrows, cols] = seg.to(torch.uint8)


def _lf_horz(plane, ys: np.ndarray, width, thresh, limit, blimit):
    """Filter horizontal edges at rows ys over all columns, in place
    (width carries the per-column masking). The +-8 row windows must not
    overlap and must lie inside the plane."""
    if ys.size == 0:
        return
    if np.any(np.diff(ys) < 16) or ys[0] < 8 or ys[-1] + 8 > plane.shape[0]:
        raise ValueError(f"horizontal edges {ys.tolist()} overlap or leave "
                         f"the {plane.shape[0]}-row plane")
    rows = torch.as_tensor(ys[:, None] + np.arange(-8, 8)[None, :],
                           device=plane.device)  # (E, 16)
    seg = plane[rows].to(torch.int32)  # (E, 16, W)
    _filter_seg(seg, 1, width, thresh, limit, blimit)
    plane[rows] = seg.to(torch.uint8)


def _band_rows(bt, y0: int, nrows: int):
    if y0 < 0 or y0 + nrows > bt.shape[0]:
        raise ValueError(f"band rows [{y0}, {y0 + nrows}) leave the "
                         f"{bt.shape[0]}-row band tensor")
    return bt[y0:y0 + nrows]


def _band_vert(bt, y0: int, nrows: int, width_rows, thresh, limit,
               blimit):
    """Boundary vertical edges of every band at once, in place.
    bt: (H, nb, 16) int32 band tensor (band columns x_b-8..x_b+8)."""
    _filter_seg(_band_rows(bt, y0, nrows), 2, width_rows, thresh, limit,
                blimit)


def _band_horz_multi(bt, y0p: int, dys, c0: int, widths, thresh, limit,
                     blimit):
    """Horizontal band edges at rows y0p + dy (pairwise disjoint +-8
    windows) on one 8-column band half (c0 0: x_b-8..x_b, 8: x_b..x_b+8),
    in place. bt is padded with 8 rows top and bottom; widths (D, nb, 1)
    or broadcastable."""
    lo = min(dys)
    span = max(dys) - lo + 16
    seg = _band_rows(bt, y0p + lo - 8, span)[:, :, c0:c0 + 8]
    subs = torch.stack([seg[dy - lo:dy - lo + 16] for dy in dys])
    _filter_seg(subs, 1, widths, thresh, limit, blimit)
    for i, dy in enumerate(dys):
        seg[dy - lo:dy - lo + 16] = subs[i]


def _cols_away_from_boundaries(width_px: int, sb: int) -> np.ndarray:
    """Columns >= 8px away from every interior SB-boundary column."""
    cols = []
    for x in range(width_px):
        near = False
        b = (x // sb) * sb
        for bb in (b, b + sb):
            if sb <= bb < width_px and bb - 8 <= x < bb + 8:
                near = True
        if not near:
            cols.append(x)
    return np.asarray(cols, np.int64)


def loop_filter_ref(y, u, v, geom: Geom, lvl: int, lim: int,
                    mblim: int, split32=None):
    """Exact VP9 loop filter for the 32 grid without a strip: the plain
    version, in PyTorch ops on the planes' device, of the kernel behind
    ``ops/cuda_kernels.py:loop_filter``.

    Ordering contract (bit-exact with libvpx; see ops/loopfilter.py:1):
    SBs in raster order, per SB all vertical then all horizontal edges.
    The order-preserving decomposition of the JAX package's
    ``loop_filter_device``, whose read/write sets it proves disjoint:
      1. interior vertical edges (>= 8px from SB-boundary columns);
      2. horizontal edges on columns >= 8px from SB-boundary columns;
      3. per SB row in order: on the 16px bands around each interior
         SB-boundary column, the left halves' horizontal edges, the
         boundary vertical edge, the right halves' horizontal edges.
    Without ``split32`` every edge is width 16 (tx32 luma, tx16 chroma).

    split32: optional (rows32, cols32) 0/1 tensor of 32-blocks coded as
    four 16x16 blocks (tx16 luma, tx8 chroma). Width rules mirror the host
    oracle (ops/loopfilter.py _edges_for_mi): luma gains 16-offset edges
    (width 16) inside split blocks; chroma edges over split blocks are
    width 8 on the full 8px grid, width 16 at 16px multiples otherwise.
    The deciding block is the block at the edge position. Width-8 edges
    write at most +-3 pixels, so they never meet the neighbouring
    8-offset windows; on the bands the chroma horizontals 8 pixels apart
    chain through overlapping windows and run one after the other.

    lvl/lim/mblim are host ints (lvl 0 leaves the planes as they are).
    Returns new planes; the inputs are not modified.
    """
    g = geom
    if g.strip:
        raise NotImplementedError("loop_filter_device: strip geometries "
                                  "are not ported yet (ROADMAP.md Queue A "
                                  "item 5)")
    y, u, v = y.clone(), u.clone(), v.clone()
    dev = y.device
    thresh = lvl >> 4
    h_mi, w_mi = g.h_mi, g.w_mi
    h_mi_c, w_mi_c = h_mi >> 1, w_mi >> 1
    w16 = 16 * int(lvl > 0)
    w8 = 8 * int(lvl > 0)
    w16_t = torch.tensor(w16, dtype=torch.int32, device=dev)
    lf = (thresh, lim, mblim)
    split = split32 is not None
    if split:
        split32 = split32.to(torch.int32)
        # per-pixel-row expansions of the split mask
        sp_y = split32.repeat_interleave(32, dim=0)[:h_mi]    # (h, cols32)
        sp_c = split32.repeat_interleave(16, dim=0)[:h_mi_c]  # (hc, cols32)

    def where8(sp):
        """Width 8 where ``sp`` marks a split block, else 16."""
        return torch.where(sp > 0, w8, w16).to(torch.int32)

    # ---- pass 1: interior vertical edges ----
    xs_y = np.array([x for x in range(32, w_mi, 32) if x % 64], np.int64)
    _lf_vert(y, 0, h_mi, xs_y, w16_t, *lf)
    xs_c = np.array([x for x in range(16, w_mi_c, 16) if x % 32], np.int64)
    if not split:
        _lf_vert(u, 0, h_mi_c, xs_c, w16_t, *lf)
        _lf_vert(v, 0, h_mi_c, xs_c, w16_t, *lf)
    else:
        # luma 16-offset verticals: exist only inside split blocks
        xs_y16 = np.array([x for x in range(16, w_mi, 16) if x % 32],
                          np.int64)
        _lf_vert(y, 0, h_mi, xs_y16, w16 * sp_y[:, xs_y16 // 32], *lf)
        # chroma 8-offset verticals (split blocks only, tx8: width 8,
        # narrow taps); raster puts each before the 16-multiple edge to
        # its right, which its +-3 writes never reach
        xs_c8 = np.array([x for x in range(8, w_mi_c, 8) if x % 16],
                         np.int64)
        w_c8 = w8 * sp_c[:, xs_c8 // 16]
        # chroma 16-multiple (non-band) verticals: width 8 over split
        # blocks
        w_c16 = where8(sp_c[:, xs_c // 16])
        for plane in (u, v):
            _lf_vert(plane, 0, h_mi_c, xs_c8, w_c8, *lf, taps=4)
            _lf_vert(plane, 0, h_mi_c, xs_c, w_c16, *lf)

    # ---- pass 2: horizontal edges away from SB-boundary columns ----
    # (the band columns, and pad columns past the visible width, are
    # masked to width 0)
    def col_mask(n_cols, width_px, sb):
        mask = np.zeros((n_cols,), np.int32)
        mask[_cols_away_from_boundaries(width_px, sb)] = 1
        return torch.as_tensor(mask, device=dev)[None, :]

    mask_y = col_mask(y.shape[1], w_mi, 64)
    mask_c = col_mask(u.shape[1], w_mi_c, 32)
    _lf_horz(y, np.arange(32, h_mi, 32, dtype=np.int64), w16 * mask_y, *lf)
    ys_c = np.arange(16, h_mi_c, 16, dtype=np.int64)
    if not split:
        _lf_horz(u, ys_c, w16 * mask_c, *lf)
        _lf_horz(v, ys_c, w16 * mask_c, *lf)
    else:
        colblk_y = np.clip(np.arange(y.shape[1]) // 32, 0, g.cols32 - 1)
        colblk_c = np.clip(np.arange(u.shape[1]) // 16, 0, g.cols32 - 1)
        # luma 16-offset horizontals inside split blocks
        ys_y16 = np.array([yy for yy in range(16, h_mi, 16) if yy % 32],
                          np.int64)
        if ys_y16.size:
            _lf_horz(y, ys_y16,
                     w16 * split32[ys_y16 // 32][:, colblk_y] * mask_y, *lf)
        # chroma 8-offset horizontals (split blocks, width 8: +-3 writes
        # leave the 16-multiple windows below untouched per row)
        ys_c8 = np.array([yy for yy in range(8, h_mi_c, 8) if yy % 16],
                         np.int64)
        w_hc8 = (w8 * split32[ys_c8 // 16][:, colblk_c] * mask_c
                 if ys_c8.size else None)
        w_hc16 = (where8(split32[ys_c // 16][:, colblk_c]) * mask_c
                  if ys_c.size else None)
        for plane in (u, v):
            _lf_horz(plane, ys_c8, w_hc8, *lf)
            _lf_horz(plane, ys_c, w_hc16, *lf)

    # ---- pass 3: SB-boundary bands, in parallel over bands, SB rows in
    # order (bands are 64px apart, 32 for chroma, hence disjoint) ----
    xs_b = np.arange(64, w_mi, 64, dtype=np.int64)
    xcs_b = np.arange(32, w_mi_c, 32, dtype=np.int64)
    if xs_b.size == 0:
        return y, u, v
    bcols_y = torch.as_tensor(xs_b[:, None] + np.arange(-8, 8)[None, :],
                              device=dev)  # (nb, 16)
    bcols_c = torch.as_tensor(xcs_b[:, None] + np.arange(-8, 8)[None, :],
                              device=dev)
    # band tensors padded 8 rows top and bottom; u and v side by side on
    # the band axis (same edge geometry, one filter call for both)
    bt_y = F.pad(y[:, bcols_y].to(torch.int32), (0, 0, 0, 0, 8, 8))
    bt_c = F.pad(torch.cat([u[:, bcols_c], v[:, bcols_c]], dim=1)
                 .to(torch.int32), (0, 0, 0, 0, 8, 8))
    rowi = torch.arange(64, device=dev)[:, None]
    rowi_c = torch.arange(32, device=dev)[:, None]
    # the 32-block columns that decide each band half's widths
    lb_y, rb_y = xs_b // 32 - 1, xs_b // 32
    lb_c, rb_c = xcs_b // 16 - 1, xcs_b // 16
    n_sbr = (h_mi + 63) // 64
    if split:
        sp_pad = F.pad(split32, (0, 0, 0, 2 * n_sbr - split32.shape[0]))
    for r in range(n_sbr):
        y0, y0c = r * 64, r * 32
        sp2 = sp_pad[2 * r:2 * r + 2] if split else None  # (2, cols32)

        def widths(dys, half_cols, chroma: bool):
            """(D, bands, 1) widths of the band h edges at y0 + dy on one
            band half; ``half_cols`` are the 32-block columns that decide
            them. Edges on the 32 grid (16 for chroma) always exist,
            narrowed to 8 over a split chroma block; the others only
            inside split blocks."""
            base, hgt, unit = (y0c, h_mi_c, 16) if chroma else (y0, h_mi, 32)
            oks = [int(0 < base + dy < hgt) for dy in dys]
            if not split:
                return torch.tensor([w16 * ok for ok in oks],
                                    dtype=torch.int32,
                                    device=dev)[:, None, None]
            rows = []
            for dy, ok in zip(dys, oks):
                sp = sp2[dy // unit][half_cols]
                if dy % unit:
                    rows.append((w8 if chroma else w16) * ok * sp)
                elif chroma:
                    rows.append(where8(sp) * ok)
                else:
                    rows.append(torch.full_like(sp, w16 * ok))
            ws = torch.stack(rows)
            if chroma:  # u and v side by side on the band axis
                ws = torch.cat([ws, ws], dim=1)
            return ws[:, :, None]

        # luma: all dys are 16+ apart, so their +-8 windows are disjoint
        dys_y = (0, 16, 32, 48) if split else (0, 32)
        _band_horz_multi(bt_y, y0 + 8, dys_y, 0,
                         widths(dys_y, lb_y, False), *lf)
        _band_vert(bt_y, y0 + 8, 64,
                   torch.where(y0 + rowi < h_mi, w16_t, 0), *lf)
        _band_horz_multi(bt_y, y0 + 8, dys_y, 8,
                         widths(dys_y, rb_y, False), *lf)
        # chroma: the same structure at half scale
        alive_c = y0c + rowi_c < h_mi_c
        if not split:
            wc = torch.where(alive_c, w16_t, 0)
            groups = ((0, 16),)
        else:
            spc2 = sp2.repeat_interleave(16, dim=0)  # (32, cols32)
            wc = torch.where(alive_c, where8(spc2[:, rb_c]), 0)
            wc = torch.cat([wc, wc], dim=1)
            groups = ((0,), (8,), (16,), (24,))
        for dys_c in groups:
            _band_horz_multi(bt_c, y0c + 8, dys_c, 0,
                             widths(dys_c, lb_c, True), *lf)
        _band_vert(bt_c, y0c + 8, 32, wc, *lf)
        for dys_c in groups:
            _band_horz_multi(bt_c, y0c + 8, dys_c, 8,
                             widths(dys_c, rb_c, True), *lf)
    nb = xcs_b.size
    y[:, bcols_y] = bt_y[8:-8].to(torch.uint8)
    u[:, bcols_c] = bt_c[8:-8, :nb].to(torch.uint8)
    v[:, bcols_c] = bt_c[8:-8, nb:].to(torch.uint8)
    return y, u, v


def loop_filter_device(y, u, v, geom: Geom, lvl: int, lim: int,
                       mblim: int, split32=None):
    """The step's loop filter (contract: ``loop_filter_ref``). Planes (and
    mask) that all lie on the CPU take the plain version; anything else
    goes to the CUDA kernel's wrapper, which launches or raises. Both
    refuse a strip geometry."""
    tensors = (y, u, v) if split32 is None else (y, u, v, split32)
    if all(t.device.type == "cpu" for t in tensors):
        return loop_filter_ref(y, u, v, geom, lvl, lim, mblim, split32)
    return loop_filter(y, u, v, geom, lvl, lim, mblim, split32)


# ---------------------------------------------------------------------------
# The 32-grid zone, the 16x16 children and the P-frame step
# ---------------------------------------------------------------------------


def encode_zone(src_y, src_u, src_v, ref_y, ref_u, ref_v, prev_mv,
                geom: Geom, dc_q: int, ac_q: int, lam: int, filters,
                new_bits, gold=None, rates=None, return_me: bool = False):
    """MD + recon for the uniform 32-grid (the JAX package's
    ``encode_zone`` at n=32 without ALTREF and without ``aq``).

    src planes: padded device planes; ref planes: border-extended
    previous reconstruction; prev_mv: (B, 2) int32 q3 MVs of the previous
    frame (the temporal candidate). gold: optional (y, u, v)
    border-extended GOLDEN planes: each block then chooses LAST or GOLDEN
    (strict '<' against LAST) and is compensated from that reference's
    windows. rates: ``upload_rate_tabs`` (entropy-table candidate costs)
    or None (proxies). return_me: also return the search intermediates the
    children refine ("wins", "dy", "dx", "wu", "wv").
    Returns a dict with mv (B, 2 int16), ref (B int8: 0 LAST, 1 GOLDEN),
    skip, eob_y/u/v, lv_y/u/v (int16 blocks), rec_y/u/v (unfiltered zone
    planes), dist_b, rate_b, dist, rate.
    """
    g = geom
    n, nc = 32, 16
    pos_y, pos_x, rows, cols = _zone_positions(g, src_y.device)
    b = rows * cols
    with _stage("step_search"):
        src_blocks = _extract_blocks(src_y, 0, rows, cols, n)
        wins = _extract_search_windows(ref_y, n, rows, cols, 0)
        sse_zero = _zero_sse(ref_y, src_blocks, rows, cols, n)
        c_y, c_x, dyr, dxr, loc, ssem, src2m = hier_search(src_blocks,
                                                           wins, n)
    with _stage("step_subpel"):
        sub_r, sub_c, sse_new = subpel_search(loc, src_blocks, dyr, dxr, n,
                                              REFINE_R)
    with _stage("step_md"):
        mv_r, mv_c, cost_last = _candidate_decide(
            ssem, src2m, sse_zero, sse_new, c_y * 8 + sub_r,
            c_x * 8 + sub_c, prev_mv, rows, cols, HALF_R, 4, 4, lam,
            new_bits, rates=rates)
    ref_sel = torch.zeros((b,), dtype=torch.int8, device=src_y.device)
    if gold is not None:
        with _stage("step_golden"):
            extra = _ref_extra(lam, rates)
            g_mv_r, g_mv_c, g_cost = _golden_decide(
                gold[0], src_blocks, pos_y, pos_x, prev_mv, rows, cols, n,
                lam, rates)
            use_gold = (g_cost + extra[1]) < (cost_last + extra[0])
            ref_sel = use_gold.to(torch.int8)
            mv_r = torch.where(use_gold, g_mv_r, mv_r)
            mv_c = torch.where(use_gold, g_mv_c, mv_c)
    # window MC: every winner derives from the +-WIN_R search (or is ZERO
    # or PREV, equally bounded)
    with _stage("step_mc"):
        wu = _extract_search_windows(ref_u, nc, rows, cols, 0,
                                     r=CHROMA_WIN_R)
        wv = _extract_search_windows(ref_v, nc, rows, cols, 0,
                                     r=CHROMA_WIN_R)
        wy_mc = wins
        if gold is not None:
            msel = use_gold[:, None, None]
            wy_mc = torch.where(msel, _extract_search_windows(
                gold[0], n, rows, cols, 0), wins)
            wu = torch.where(msel, _extract_search_windows(
                gold[1], nc, rows, cols, 0, r=CHROMA_WIN_R), wu)
            wv = torch.where(msel, _extract_search_windows(
                gold[2], nc, rows, cols, 0, r=CHROMA_WIN_R), wv)
        mi = (g.mi_rows, g.mi_cols)
        pred_y = mc_predict_from_wins(wy_mc, pos_y, pos_x, mv_r, mv_c, n, 0,
                                      *mi, filters, WIN_R)
        pred_u = mc_predict_from_wins(wu, pos_y // 2, pos_x // 2, mv_r,
                                      mv_c, nc, 1, *mi, filters,
                                      CHROMA_WIN_R)
        pred_v = mc_predict_from_wins(wv, pos_y // 2, pos_x // 2, mv_r,
                                      mv_c, nc, 1, *mi, filters,
                                      CHROMA_WIN_R)
    with _stage("step_txfm"):
        lv_y, eob_y, rec_y = transform_recon(src_blocks, pred_y, dc_q, ac_q,
                                             n)
        src_ub = _extract_blocks(src_u, 0, rows, cols, nc)
        src_vb = _extract_blocks(src_v, 0, rows, cols, nc)
        lv_u, eob_u, rec_u = transform_recon(src_ub, pred_u, dc_q, ac_q, nc)
        lv_v, eob_v, rec_v = transform_recon(src_vb, pred_v, dc_q, ac_q, nc)
        skip = (eob_y == 0) & (eob_u == 0) & (eob_v == 0)
        dist_b = block_energy(src_blocks, rec_y, n)[0]
        rate_b = ((lv_y != 0).sum(dim=(1, 2)) + (lv_u != 0).sum(dim=(1, 2))
                  + (lv_v != 0).sum(dim=(1, 2)))
    out = {
        "mv": torch.stack([mv_r, mv_c], dim=-1).to(torch.int16),
        "ref": ref_sel,
        "skip": skip,
        "eob_y": eob_y, "eob_u": eob_u, "eob_v": eob_v,
        "lv_y": lv_y, "lv_u": lv_u, "lv_v": lv_v,
        "rec_y": _scatter_blocks(rec_y, rows, cols, n),
        "rec_u": _scatter_blocks(rec_u, rows, cols, nc),
        "rec_v": _scatter_blocks(rec_v, rows, cols, nc),
        "dist_b": dist_b, "rate_b": rate_b,
        "dist": dist_b.sum(), "rate": rate_b.sum(),
    }
    if return_me:
        # the search's windows (LAST's, even where GOLDEN won: GOLDEN
        # parents are never descended) and the MC windows of the chroma
        out.update(wins=wins, dy=c_y + dyr, dx=c_x + dxr, wu=wu, wv=wv)
    return out


def _merge4(blocks, k: int, n: int):
    """(4K, n, n) children in k*4 + 2*i + j order -> (K, 2n, 2n)."""
    return blocks.reshape(k, 2, 2, n, n).permute(0, 1, 3, 2, 4) \
        .reshape(k, 2 * n, 2 * n)


def encode_children_masked(src_y, src_u, src_v, ref_y, parent_me,
                           parent_mv, sel_idx, geom: Geom, dc_q: int,
                           ac_q: int, lam: int, filters, new_bits,
                           rates=None):
    """Masked 32->16 descent: encode the four 16x16 children of the K
    selected parents only (``tpu_vp9/pipeline/tpu_encdec.py:
    encode_children_masked``).

    parent_me: {"wins", "dy", "dx", "wu", "wv"} from the 32 zone: the
    children search +-CHILD_R inside their parent's window (one 64x64
    union slice per parent around its full-pel winner, clipped into the
    window, and four 40x40 sub-slices of it) and are compensated straight
    out of the parent's luma and chroma windows through per-child origin
    offsets. parent_mv: (B32, 2) int32 final q3 MVs of the parents (the
    PARENT candidate, scored at its entry of the child's SSE map).
    sel_idx: (K,) raster parent indices. Candidates {ZERO, NEW, PARENT},
    first minimum. Child order: k*4 + 2*i + j for parent sel_idx[k], child
    row i, column j.
    Returns per-child arrays (4K: mv, skip, eob_*, lv_*), sel_idx, and
    per-parent dist4, rate4 and the merged recon blocks rec_y32, rec_u16,
    rec_v16.
    """
    g = geom
    dev = src_y.device
    sel = sel_idx.long()
    k = sel.shape[0]
    cols32, rows32 = g.cols32, g.rows32
    cols16 = cols32 * 2
    pr = sel // cols32
    pc = sel % cols32
    with _stage("step_children"):
        wk = parent_me["wins"][sel]                 # (K, SW, SW)
        sw = wk.shape[-1]
        s_y = (parent_me["dy"][sel] + 36).clamp(0, sw - 64)
        s_x = (parent_me["dx"][sel] + 36).clamp(0, sw - 64)
        union = _take_windows(wk, s_y, s_x, 64)     # (K, 64, 64)
        base_y = (s_y - 32).repeat_interleave(4)    # map-centre displ.
        base_x = (s_x - 32).repeat_interleave(4)
        cw = torch.stack([union[:, 16 * i:16 * i + 40, 16 * j:16 * j + 40]
                          for i in (0, 1) for j in (0, 1)], dim=1) \
            .reshape(k * 4, 40, 40)

        ii = torch.tensor([0, 0, 1, 1], device=dev)
        jj = torch.tensor([0, 1, 0, 1], device=dev)
        c_row = (2 * pr)[:, None] + ii[None]        # (K, 4)
        c_col = (2 * pc)[:, None] + jj[None]
        cidx = (c_row * cols16 + c_col).reshape(-1)  # (4K,)
        csrc = _extract_blocks(src_y, 0, rows32 * 2, cols16, 16)[cidx]

        ddy, ddx, ssem_c = sse_map_search(csrc, cw, 16, CHILD_R)
        sub_r, sub_c, sse_new = subpel_search(cw, csrc, ddy, ddx, 16,
                                              CHILD_R)
        mv_new_r = base_y * 8 + sub_r
        mv_new_c = base_x * 8 + sub_c
        # exact ZERO SSE: the co-located reference block, read in place
        sse_zero = block_energy_at(
            csrc, ref_y,
            (c_row * 16 + BORDER).reshape(1, -1).to(torch.int32),
            (c_col * 16 + BORDER).reshape(1, -1).to(torch.int32), 16)[0][0]
        # PARENT candidate: the parent's final MV at its child-map entry
        par_r = parent_mv[sel, 0].repeat_interleave(4)
        par_c = parent_mv[sel, 1].repeat_interleave(4)
        rch = CHILD_R
        dch = 2 * rch + 1
        fy = (((par_r + 4) >> 3) - base_y).clamp(-rch, rch) + rch
        fx = (((par_c + 4) >> 3) - base_x).clamp(-rch, rch) + rch
        sse_par = ssem_c.reshape(k * 4, dch * dch).gather(
            1, (fy * dch + fx).long()[:, None])[:, 0] + _block_sq_sum(csrc)

        zero = torch.zeros_like(mv_new_r)
        cand_r = torch.stack([zero, mv_new_r, par_r])
        cand_c = torch.stack([zero, mv_new_c, par_c])
        sads = torch.stack([sse_zero, sse_new, sse_par])
        if rates is not None:
            mc = rates["mode_cost"]
            ones = torch.ones_like(mv_new_r)
            mvd_bits = _mvd_bits(rates, mv_new_r - par_r, mv_new_c - par_c)
            rate = torch.stack([mc[2] * ones, mc[3] + mvd_bits,
                                mc[0] * ones])
            costs = _table_costs(sads, rate, rates["lam_bits"])
        else:
            rz, _, _, _, rs = CAND_RATE_PROXY
            mvd = (mv_new_r - par_r).abs() + (mv_new_c - par_c).abs()
            ones = torch.ones((k * 4,), dtype=torch.float32, device=dev)
            rate = torch.stack([rz * ones, new_bits[mvd.long()],
                                rs * ones])
            costs = sads.to(torch.float32) + float(lam) * rate
        (mv_r, mv_c), _, _ = _first_min(costs, (cand_r, cand_c))

        # MC straight out of the parent windows (every child candidate is
        # reachable there; org_off = the child's offset inside the parent)
        pos_y = (c_row * 16).reshape(-1).to(torch.int32)
        pos_x = (c_col * 16).reshape(-1).to(torch.int32)
        off_y = (ii * 16).repeat(k).to(torch.int32)
        off_x = (jj * 16).repeat(k).to(torch.int32)
        mi = (g.mi_rows, g.mi_cols)
        pred_y = mc_predict_from_wins(
            wk.repeat_interleave(4, dim=0), pos_y, pos_x, mv_r, mv_c, 16, 0,
            *mi, filters, WIN_R, org_off_y=off_y, org_off_x=off_x)
        chroma = []
        for key, plane in (("wu", src_u), ("wv", src_v)):
            pred = mc_predict_from_wins(
                parent_me[key][sel].repeat_interleave(4, dim=0), pos_y // 2,
                pos_x // 2, mv_r, mv_c, 8, 1, *mi, filters, CHROMA_WIN_R,
                org_off_y=off_y // 2, org_off_x=off_x // 2)
            csrc_c = _extract_blocks(plane, 0, rows32 * 2, cols16, 8)[cidx]
            chroma.append(transform_recon(csrc_c, pred, dc_q, ac_q, 8))
        lv_y, eob_y, rec_y = transform_recon(csrc, pred_y, dc_q, ac_q, 16)
        (lv_u, eob_u, rec_u), (lv_v, eob_v, rec_v) = chroma
        skip = (eob_y == 0) & (eob_u == 0) & (eob_v == 0)
        dist_c = block_energy(csrc, rec_y, 16)[0]
        rate_c = ((lv_y != 0).sum(dim=(1, 2)) + (lv_u != 0).sum(dim=(1, 2))
                  + (lv_v != 0).sum(dim=(1, 2)))
    return {
        "mv": torch.stack([mv_r, mv_c], dim=-1).to(torch.int16),
        "skip": skip,
        "eob_y": eob_y, "eob_u": eob_u, "eob_v": eob_v,
        "lv_y": lv_y, "lv_u": lv_u, "lv_v": lv_v,
        "sel_idx": sel_idx.to(torch.int32),
        "dist4": dist_c.reshape(k, 4).sum(dim=1),
        "rate4": rate_c.reshape(k, 4).sum(dim=1),
        "rec_y32": _merge4(rec_y, k, 16),
        "rec_u16": _merge4(rec_u, k, 8),
        "rec_v16": _merge4(rec_v, k, 8),
    }


def descent_parents(score, k: int):
    """Indices of the k largest entries of ``score``, the lower index
    first among equals (what ``lax.top_k`` returns; ``torch.topk``
    promises no order among ties, so this is a stable descending sort).
    The -1 sentinels of GOLDEN parents and of the overhang row make ties
    routine."""
    return torch.sort(score, descending=True, stable=True)[1][:k]


def split_decide(out32, out16, lam: int, geom: Geom):
    """The 32-against-4x16 decision for the descended parents and the
    recon merge (``tpu_vp9/pipeline/tpu_encdec.py:pframe_step``).

    Costs are dist + lam * rate in float32 (rate in nonzero-level counts,
    the split paying SPLIT_RATE_EXTRA more), strict '<' for the split.
    Removes dist4, rate4 and the merged recon blocks from ``out16``.
    Returns (split32 (rows32, cols32) int32, rec_y, rec_u, rec_v)."""
    g = geom
    r32, c32, b32 = g.rows32, g.cols32, g.n_blocks32
    sel = out16["sel_idx"].long()
    d16 = out16.pop("dist4").to(torch.float32)
    rt16 = out16.pop("rate4").to(torch.float32)
    lam_f = float(lam)
    cost32k = (out32["dist_b"][sel].to(torch.float32)
               + lam_f * out32["rate_b"][sel].to(torch.float32))
    cost16k = d16 + lam_f * (rt16 + SPLIT_RATE_EXTRA)
    use16 = cost16k < cost32k  # (K,)
    split32 = torch.zeros((b32,), dtype=torch.int32, device=sel.device)
    split32[sel] = use16.to(torch.int32)

    def merge(plane, rep, nb):
        blocks = _extract_blocks(plane, 0, r32, c32, nb).clone()
        blocks[sel] = torch.where(use16[:, None, None], rep, blocks[sel])
        return _scatter_blocks(blocks, r32, c32, nb)

    return (split32.reshape(r32, c32),
            merge(out32["rec_y"], out16.pop("rec_y32"), 32),
            merge(out32["rec_u"], out16.pop("rec_u16"), 16),
            merge(out32["rec_v"], out16.pop("rec_v16"), 16))


def pframe_step(src_y, src_u, src_v, ref_y, ref_u, ref_v, prev_mv32,
                geom: Geom, dc_q: int, ac_q: int, lam: int, lf_lvl: int,
                lf_lim: int, lf_mblim: int, filters, new_bits,
                split16: bool = False, gold=None, rates=None):
    """One device P-frame encode step (the JAX package's ``pframe_step``
    without a strip, ALTREF or ``aq``).

    src planes: padded (pad_h, pad_w) / (pad_h/2, pad_w/2) uint8 device
    tensors; ref planes: the border-extended previous reconstruction.
    split16: descend the B32 // DESCEND_FRAC parents of the largest
    distortion (GOLDEN parents and the overhang row never) and decide 32
    against 4x16 for each. gold: optional GOLDEN planes. rates: optional
    ``upload_rate_tabs``.
    Returns (outputs dict, new border-extended (ref_y, ref_u, ref_v));
    outputs hold the "m32" zone, with split16 the children "m16f" and
    "split32", and the loop-filtered padded recon planes
    "rec_y"/"rec_u"/"rec_v". The references are new tensors.
    """
    g = geom
    if g.strip:
        raise NotImplementedError("pframe_step: strip geometries are not "
                                  "ported yet (ROADMAP.md Queue A item 5)")
    out32 = encode_zone(src_y, src_u, src_v, ref_y, ref_u, ref_v,
                        prev_mv32, g, dc_q, ac_q, lam, filters, new_bits,
                        gold=gold, rates=rates, return_me=split16)
    outs = {"m32": out32}
    rec_y, rec_u, rec_v = out32["rec_y"], out32["rec_u"], out32["rec_v"]
    split32 = None
    if split16:
        parent_me = {kk: out32.pop(kk)
                     for kk in ("wins", "dy", "dx", "wu", "wv")}
        with _stage("step_children"):
            score = out32["dist_b"]
            if gold is not None:
                score = torch.where(out32["ref"] > 0, -1, score)
            if g.mi_rows % 4 == 3:
                score = score.clone()
                score[-g.cols32:] = -1
            sel_idx = descent_parents(score,
                                      max(1, g.n_blocks32 // DESCEND_FRAC))
        out16 = encode_children_masked(
            src_y, src_u, src_v, ref_y, parent_me,
            out32["mv"].to(torch.int32), sel_idx, g, dc_q, ac_q, lam,
            filters, new_bits, rates=rates)
        with _stage("step_children"):
            split32, rec_y, rec_u, rec_v = split_decide(out32, out16, lam,
                                                        g)
        outs["m16f"] = out16
        outs["split32"] = split32
    with _stage("step_loop_filter"):
        # pad recon to the full device plane (the coded region is g.width)
        rec_y = _pad_edge(rec_y, g.pad_h, g.pad_w)
        rec_u = _pad_edge(rec_u, g.pad_h // 2, g.pad_w // 2)
        rec_v = _pad_edge(rec_v, g.pad_h // 2, g.pad_w // 2)
        rec_y, rec_u, rec_v = loop_filter_device(rec_y, rec_u, rec_v, g,
                                                 lf_lvl, lf_lim, lf_mblim,
                                                 split32=split32)
    outs.update(rec_y=rec_y, rec_u=rec_u, rec_v=rec_v)
    cw, ch = (g.width + 1) >> 1, (g.height + 1) >> 1
    with _stage("step_borders"):
        refs = (extend_borders_device(rec_y, g.width, g.height),
                extend_borders_device(rec_u, cw, ch),
                extend_borders_device(rec_v, cw, ch))
    return outs, refs


def make_pframe_step(geom: Geom, device, split16: bool = False,
                     golden: bool = False, with_rates: bool = False):
    """The step for one geometry on one device, with the filter taps and
    the NEWMV rate-proxy table uploaded once:

        step(src_y, src_u, src_v, ref_y, ref_u, ref_v,
             [gold_y, gold_u, gold_v,]          # golden
             prev_mv32, dc_q, ac_q, lam, lf_lvl, lf_lim, lf_mblim
             [, rates])                          # golden or with_rates

    ``rates`` is ``upload_rate_tabs(make_rate_tabs(fc, qindex), device)``;
    as in the JAX package a GOLDEN step always takes them. It runs
    eagerly; there is nothing to compile."""
    device = torch.device(device)
    filters = torch.as_tensor(np.asarray(FILTERS, np.int32), device=device)
    new_bits = new_bits_table(device)
    with_rates = with_rates or golden
    n_fixed = 13 + (3 if golden else 0) + (1 if with_rates else 0)

    def step(src_y, src_u, src_v, ref_y, ref_u, ref_v, *rest):
        if len(rest) + 6 != n_fixed:
            raise TypeError(f"step takes {n_fixed} arguments, got "
                            f"{len(rest) + 6}")
        gold = tuple(rest[:3]) if golden else None
        rest = rest[3:] if golden else rest
        rates = rest[7] if with_rates else None
        prev_mv32, dc_q, ac_q, lam, lf_lvl, lf_lim, lf_mblim = rest[:7]
        return pframe_step(src_y, src_u, src_v, ref_y, ref_u, ref_v,
                           prev_mv32, geom, dc_q, ac_q, lam, lf_lvl,
                           lf_lim, lf_mblim, filters, new_bits,
                           split16=split16, gold=gold, rates=rates)

    return step


# ---------------------------------------------------------------------------
# The device keyframe: the intra wavefront, the loop filter, the borders
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _intra_maps_on(bs: int, device):
    idx, w = intra.stacked_dir_maps(bs)
    return (torch.as_tensor(idx.astype(np.int64), device=device),
            torch.as_tensor(w, dtype=torch.int32, device=device))


def predict_intra_all(ref, have_above, have_left, bs: int):
    """All 10 intra predictions of a batch of blocks, exact, as
    ``ops/intra.py:predict_all_modes`` computes them: ref (B, 3*bs+1) int32
    in that module's layout [left, above-left, above and above-right],
    have_above and have_left (B,) bool. Returns (B, 10, bs, bs) int32 in
    IntraMode order; the six diagonals, V and H from the module's index and
    weight maps."""
    idx, w = _intra_maps_on(bs, ref.device)
    dirs = ((ref[:, idx] * w).sum(dim=2) + 2) >> 2  # (B, 8, bs, bs)
    left, al = ref[:, :bs], ref[:, bs]
    above = ref[:, bs + 1:2 * bs + 1]
    sum_a, sum_l = above.sum(dim=1), left.sum(dim=1)
    lg = bs.bit_length() - 1
    dc = torch.where(
        have_above & have_left, (sum_a + sum_l + bs) >> (lg + 1),
        torch.where(have_above, (sum_a + (bs >> 1)) >> lg,
                    torch.where(have_left, (sum_l + (bs >> 1)) >> lg, 128)))
    tm = (left[:, :, None] + above[:, None, :] - al[:, None, None]) \
        .clamp(0, 255)
    b = ref.shape[0]
    return torch.cat([dc[:, None, None, None].expand(b, 1, bs, bs), dirs,
                      tm[:, None]], dim=1).to(torch.int32)


def _kf_refs(rec, rr, cc, n: int, visible_h: int):
    """(ref, have_above, have_left) of the blocks (rr, cc) of size n from
    the recon plane ``rec`` (``ops/intra.py`` layout: left, above-left,
    above, above-right). Above is 127 without a row above, left 129 without
    a column to the left; above-right repeats above[n-1]; the left column
    clamps to the last visible row (``visible_h``)."""
    ha, hl = rr >= 1, cc >= 1
    ar = torch.arange(n, device=rec.device)
    ya = (rr * n - 1).clamp(min=0)
    xl = (cc * n - 1).clamp(min=0)
    above = rec[ya[:, None], (cc * n)[:, None] + ar].to(torch.int32)
    above = torch.where(ha[:, None], above, 127)
    lrow = rr[:, None] * n + torch.minimum(
        ar[None, :], (visible_h - 1 - n * rr).clamp(min=0)[:, None])
    left = rec[lrow, xl[:, None]].to(torch.int32)
    left = torch.where(hl[:, None], left, 129)
    al = rec[ya, xl].to(torch.int32)
    al = torch.where(ha, torch.where(hl, al, 129), 127)
    ref = torch.cat([left, al[:, None], above,
                     above[:, -1:].expand(-1, n)], dim=1)
    return ref, ha, hl


def kframe_wave_ref(src_y, src_u, src_v, geom: Geom, dc_q: int, ac_q: int,
                    lam: int):
    """Plain PyTorch version of the kernel behind
    ``ops/cuda_kernels.py:kframe_wave`` (same arguments and outputs): the
    anti-diagonals in order, each diagonal's blocks as one batch whose
    reference samples come from the recon planes that earlier diagonals
    filled."""
    g = geom
    rows, cols = g.rows32, g.cols32
    dev = src_y.device
    mode, lvs, eob, recs = kf_outputs(g, dev)
    vis = (g.height, (g.height + 1) >> 1, (g.height + 1) >> 1)
    bias = torch.tensor(KF_MODE_BIAS, dtype=torch.int64, device=dev) * lam
    for d in range(rows + cols - 1):
        r0, nb = kf_diagonal(d, rows, cols)
        rr = torch.arange(r0, r0 + nb, device=dev)
        cc = d - rr
        bi = rr * cols + cc
        for p, (src, n) in enumerate(zip((src_y, src_u, src_v),
                                         (32, 16, 16))):
            ref, ha, hl = _kf_refs(recs[p], rr, cc, n, vis[p])
            ar = torch.arange(n, device=dev)
            ys = (rr * n)[:, None, None] + ar[None, :, None]
            xs = (cc * n)[:, None, None] + ar[None, None, :]
            blocks = src[ys, xs]
            preds = predict_intra_all(ref, ha, hl, n)
            if p == 0:
                err = preds - blocks[:, None].to(torch.int32)
                sse = (err * err).sum(dim=(2, 3))
                # torch.argmin returns the first minimum
                m = torch.argmin(sse + bias, dim=1)
                mode[bi] = m.to(torch.int32)
            pred = preds[torch.arange(nb, device=dev), m]
            # the plain transform: this whole function is the kernel's
            # plain version, on any device
            lv, e, rec = transform_recon_ref(blocks, pred, dc_q, ac_q, n)
            lvs[p][bi] = lv
            eob[p][bi] = e
            recs[p][ys, xs] = rec
    return (mode, *lvs, *eob.unbind(0), *recs)


def kframe_wave_device(src_y, src_u, src_v, geom: Geom, dc_q: int,
                       ac_q: int, lam: int):
    """The keyframe's intra wavefront (contract: ``kframe_wave_ref``).
    Planes that all lie on the CPU take the plain version; anything else
    goes to the CUDA kernel's wrapper, which launches or raises. Both
    refuse a strip geometry."""
    if all(t.device.type == "cpu" for t in (src_y, src_u, src_v)):
        dc_q, ac_q, lam = int(dc_q), int(ac_q), int(lam)
        check_kf_args(src_y, src_u, src_v, geom, dc_q, ac_q, lam)
        return kframe_wave_ref(src_y, src_u, src_v, geom, dc_q, ac_q, lam)
    return kframe_wave(src_y, src_u, src_v, geom, dc_q, ac_q, lam)


def kframe_step(src_y, src_u, src_v, geom: Geom, dc_q: int, ac_q: int,
                lam: int, lf_lvl: int, lf_lim: int, lf_mblim: int):
    """The closed-loop intra keyframe encode on the device (the JAX
    package's ``kframe_step`` without a strip).

    src planes: padded (pad_h, pad_w) / (pad_h/2, pad_w/2) uint8 tensors.
    The 32x32 blocks are encoded by anti-diagonals (``kframe_wave_device``:
    a CUDA kernel for CUDA planes, its plain version for CPU planes), the
    recon edge-padded to the device planes, loop filtered frame-wide at
    ``lf_lvl`` and border-extended. Returns (outputs, new border-extended
    (ref_y, ref_u, ref_v)); outputs hold "m32" (mode, skip, eob_y/u/v,
    lv_y/u/v in raster block order) and the filtered planes
    "rec_y"/"rec_u"/"rec_v".
    """
    g = geom
    (mode, lv_y, lv_u, lv_v, eob_y, eob_u, eob_v, rec_y, rec_u,
     rec_v) = kframe_wave_device(src_y, src_u, src_v, g, dc_q, ac_q, lam)
    outs = {"m32": {
        "mode": mode, "skip": (eob_y == 0) & (eob_u == 0) & (eob_v == 0),
        "eob_y": eob_y, "eob_u": eob_u, "eob_v": eob_v,
        "lv_y": lv_y, "lv_u": lv_u, "lv_v": lv_v}}
    rec_y = _pad_edge(rec_y, g.pad_h, g.pad_w)
    rec_u = _pad_edge(rec_u, g.pad_h // 2, g.pad_w // 2)
    rec_v = _pad_edge(rec_v, g.pad_h // 2, g.pad_w // 2)
    rec_y, rec_u, rec_v = loop_filter_device(rec_y, rec_u, rec_v, g, lf_lvl,
                                             lf_lim, lf_mblim)
    outs.update(rec_y=rec_y, rec_u=rec_u, rec_v=rec_v)
    cw, ch = (g.width + 1) >> 1, (g.height + 1) >> 1
    refs = (extend_borders_device(rec_y, g.width, g.height),
            extend_borders_device(rec_u, cw, ch),
            extend_borders_device(rec_v, cw, ch))
    return outs, refs


def make_kframe_step(geom: Geom, device):
    """The keyframe step for one geometry on one device:

        step(src_y, src_u, src_v, dc_q, ac_q, lam, lf_lvl, lf_lim, lf_mblim)

    Refuses a strip geometry here, before any frame, and planes that do
    not lie on ``device``'s kind of device."""
    if geom.strip:
        raise NotImplementedError(f"make_kframe_step: {KF_STRIP}")
    kind = torch.device(device).type

    def step(src_y, src_u, src_v, dc_q, ac_q, lam, lf_lvl, lf_lim,
             lf_mblim):
        if any(t.device.type != kind for t in (src_y, src_u, src_v)):
            raise ValueError(f"the keyframe step for {kind} was given "
                             "planes on another device")
        return kframe_step(src_y, src_u, src_v, geom, dc_q, ac_q, lam,
                           lf_lvl, lf_lim, lf_mblim)

    return step
