"""The realtime device P-frame step on torch: the M9 and M8 configurations.

The counterpart of ``tpu_vp9/pipeline/tpu_encdec.py``: for every 32x32
block of the frame at once,

    window extraction -> 2-level full-pel SSE search -> quarter-pel search
    -> ZERO/NEW/PREV/LEFT/ABOVE decision -> exact 8-tap MC (Y/U/V)
    -> float64 forward transform + quantizer -> exact integer recon
    -> eob/skip -> exact VP9 loop filter -> border extension.

At a strip geometry (mi_rows % 4 == 2: 720p, 4K) the 16x16 blocks of the
bottom 16-pixel strip are a second zone of the same encode (``encode_zone``
at n=16: a flat +-WIN_R full-pel search, the quarter-pel search on its
windows, the same decision, MC and transform), whose recon rows join the
32 zone's before the loop filter.

M9 runs that with the LAST reference and rate proxies. M8 adds, each
behind its own argument of ``make_pframe_step``: candidate costs from the
frame's entropy tables (``make_rate_tabs``, ``rates=``), the GOLDEN anchor
(two more candidates per block and a per-block choice of MC reference,
``gold=``), and the 32-against-4x16 descent (``split16``): the
``1/descend_frac`` of the parents with the largest distortion get their
four 16x16 children searched +-8 inside the parent's LAST window,
encoded as LAST blocks, and compared with the parent by cost; the loop
filter then takes the per-parent split mask. The random-access session
(``pipeline/ra_device.py``) adds the ALTREF reference (``alt=``, the
pyramid's future anchor: its own search as LAST's, ZERO and NEW) and
descends every parent (``descend_frac=1``). At tune SQ the M8 session
adds the adaptive lambda (``aq``): a zone's rate lambda becomes a float32
vector, one value a block, scaled by the block's variance against the
frame's (``aq_scale``, a kernel on the card); the descent's children and
its split decision keep the frame's value. The descent is off at a strip
geometry, as in the JAX package.

One place differs from the JAX package on purpose: its children take
their chroma from the parent's merged MC windows, another reference's
where the parent took GOLDEN or ALTREF, while they are coded as LAST
blocks, so a decoder predicted them otherwise; here they take LAST's
(``encode_zone``'s ``return_me``). And a parent of the overhang row keeps
its 32 whatever the descent selects (``descent_split``). Neither changes a
stream whose recon the JAX package's decode matches.

The new reference planes stay on the step's device; the host receives the
levels, eobs, MVs (and the recon when asked) and serializes them with the
native serializer.

Every stage computes what the JAX package's stage computes, as plain
functions on tensors of the caller's device, with CUDA kernels in
``ops/cuda_kernels.py``: the search windows (``extract_windows``: every
window set of a call site in one launch), the full-pel search
(``hier_search_fused`` for both levels of the 32 zone in one launch,
``sse_map_search`` for the children), the quarter-pel search
(``subpel_search``), the mode decision and motion compensation in one
launch a call site (``mode_decide_mc``: LAST, GOLDEN, ALTREF and the
reference choice of a zone, then Y, U and V of its blocks, every block's
window read in place out of its reference's planes;
``descent_decide_mc``: the children's decision, then their MC in their
parents' windows by index), the distortion (``block_energy`` on blocks,
``block_energy_at`` on candidates read in place out of a reference
plane), the transform stage
(``transform_recon``: forward DCT, quantizer, inverse, recon and eob), the
loop filter (``loop_filter``, all three planes in one launch) and the
border extension (``extend_borders``, the three planes in one launch).
The plain versions of these kernels but the search's and the distortion's
live here (``_extract_search_windows``, ``subpel_search_ref``,
``mode_decide_mc_ref`` and ``descent_decide_mc_ref`` (the decisions'
``mode_decide_ref`` and ``descent_decide_ref``, then
``mc_predict_planes_ref``), ``transform_recon_ref``, ``loop_filter_ref``,
``extend_borders_device``), each reached through its dispatch
(``extract_windows``, ``subpel_search``, ``mode_decide_mc``,
``descent_decide_mc``, ``transform_recon``, ``loop_filter_device``,
``extend_borders``): CPU tensors take the plain version, CUDA tensors the
kernel's wrapper, which launches or raises. The dispatches of the
decisions alone and of MC alone (``mode_decide``, ``descent_decide``,
``mc_predict``) stay for the checks that hold the decided launches against
the two they replace; no step calls them. Formulations that
exist only to suit the TPU are not carried over: one-hot matmul gathers
(``_oh_take_rows/_cols``) are plain indexing, float32 stand-ins for
integer arithmetic are int32, and the scan-prefix level transfer is not
ported (the step ships full int16 level planes). Indexing in torch does
not clamp out-of-range starts the way ``lax.dynamic_slice`` does, so every
slice here is either proven in range or checked.

The keyframe has its own step, ``make_kframe_step``: the closed-loop
intra encode of the 32 grid in wave order (``kframe_wave``, a CUDA kernel
of one launch, a CTA per block row; its plain version ``kframe_wave_ref``
here goes by anti-diagonals; all 10 intra modes predicted by
``predict_intra_all``), at a strip geometry the strip's 16x16 blocks with
the above-only modes V, D45 and D63 (ADST_DCT, DCT_DCT and ADST_DCT at
TX16), then the same loop filter and border extension.

The per-frame scalars (the quantizers, the lambda, the loop filter's
level and limits) reach both steps as one int32 device row
(``step_scalars``), as the JAX package passes each as a device value, and
the rate tables' scalars as another (``upload_rate_tabs``' "scalars");
every kernel reads its words there, a session refills both rows in place
before each frame, and nothing in a step reads a value back to the host:
a step's launches are the same from frame to frame, whatever the qindex.

Geometries: width % 32 == 0 and mi_rows % 4 in {0, 2, 3}; ``make_geom``
refuses the others, as the JAX package's does.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.codec.modeinfo import INTRA_MODE_TO_TX_TYPE
from tpu_vp9_torch.utils.trace import span

from tpu_vp9_torch.ops import cuda_kernels, txfm
from tpu_vp9_torch.ops.cuda_kernels import (
    CHROMA_WIN_R, HALF_R, KF_MODE_BIAS, REFINE_R, WIN_R, check_kf_args,
    block_energy, block_energy_at, hier_search_fused, kf_diagonal,
    kf_outputs, kframe_wave, loop_filter, predict_intra_all,
    sse_map_search, take_windows as _take_windows,
)

BORDER = 96  # matches tpu_vp9/ops/inter.py (host refs interop)
CHILD_R = 8  # 16-block refinement radius around the 32-parent's winner
# extra syntax cost (in rate_b units) a 32->16 split pays: partition
# symbol + 3 extra mode/skip/mv sets
SPLIT_RATE_EXTRA = 4.0
# the descent's default share: the B32 // DESCEND_FRAC worst parents (the
# realtime session's; the random-access session passes 1, every parent)
DESCEND_FRAC = 4
# candidate rate proxies in lambda units (zero, new-base, new-per-log2mvd,
# prev/temporal, spatial left/above), as the TPU package's
CAND_RATE_PROXY = (2.0, 10.0, 2.0, 6.0, 4.0)
_Q3_OFFS = tuple(range(-6, 7, 2))  # quarter-pel reach, q3 units
# largest |NEW - LEFT| mvd (q3, row + col): NEW MVs lie within
# +-(8 * (WIN_R - REFINE_R) + 8 * REFINE_R + 6) and LEFT is one of them
MVD_MAX = 4 * (8 * WIN_R + 6)
FILTERS = T.subpel_filters(T.InterpFilter.EIGHTTAP)  # (16, 8) int
# a zone's per-block outputs that the host serializes
ZONE_KEYS = ("mv", "ref", "skip", "eob_y", "eob_u", "eob_v", "lv_y", "lv_u",
             "lv_v")


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


def extend_borders(planes, crops, border: int = BORDER):
    """The border extension of a recon's planes (contract:
    ``extend_borders_device`` on each plane with its (crop_w, crop_h) of
    ``crops``). Planes that all lie on the CPU take the plain version;
    anything else goes to the CUDA kernel's wrapper, which extends all of
    them in one launch or raises. Returns a tuple of new planes."""
    if all(p.device.type == "cpu" for p in planes):
        return tuple(extend_borders_device(p, cw, ch, border)
                     for p, (cw, ch) in zip(planes, crops, strict=True))
    return cuda_kernels.extend_borders(planes, crops, border)


def recon_crops(geom: Geom):
    """(crop_w, crop_h) of the luma and the two chroma planes of a
    recon: the visible picture, chroma rounded up."""
    cw, ch = (geom.width + 1) >> 1, (geom.height + 1) >> 1
    return ((geom.width, geom.height), (cw, ch), (cw, ch))


def _pad_edge(plane, h: int, w: int):
    """Edge-replicate a device plane on the bottom and right to (h, w)."""
    ph, pw = plane.shape
    if pw < w:
        plane = torch.cat([plane, plane[:, -1:].expand(ph, w - pw)], dim=1)
    if ph < h:
        plane = torch.cat([plane, plane[-1:].expand(h - ph, w)], dim=0)
    return plane


# ---------------------------------------------------------------------------
# The step's per-frame scalars: one int32 device row
# ---------------------------------------------------------------------------

# the row's words (``cuda_kernels.STEP_SCALARS``, csrc/step_scalars.cuh)
SC_DC_Q, SC_AC_Q, SC_LAM, SC_LF_LVL, SC_LF_LIM, SC_LF_MBLIM = range(
    len(cuda_kernels.STEP_SCALARS))


def step_scalars(dc_q: int, ac_q: int, lam: int, lf_lvl: int, lf_lim: int,
                 lf_mblim: int, device="cpu", out=None):
    """The step's per-frame scalars as one int32 row (``cuda_kernels.
    STEP_SCALARS``), the form in which the steps, their dispatches and
    kernels take them (the JAX package passes each as a device value).

    The values are checked here, while they are host ints, as the kernels
    that read them take them: the quantizers in [1, TXFM_MAX_Q] (the
    transform's and the keyframe's), lam in [0, KF_MAX_LAM), the filter
    level in [0, 63] and its limits not negative; nothing downstream reads
    them back. ``out``: a row held for the life of a session, refilled in
    place (``refill``: on its device's current stream, so behind the
    previous step's readers), so that its pointer, and with it every
    launch of the step, stays the same from frame to frame; else a new row
    on ``device``. Returns the row."""
    vals = [int(v) for v in (dc_q, ac_q, lam, lf_lvl, lf_lim, lf_mblim)]
    cuda_kernels.check_step_scalars(*vals)
    host = torch.tensor(vals, dtype=torch.int32)
    if out is None:
        return host.to(device)
    return refill(out, host)


def refill(dst, host):
    """Copy the CPU tensor ``host`` into ``dst`` in place, on the current
    stream of ``dst``'s device: where ``dst`` lies on a card, from pinned
    memory and without a wait (PyTorch's pinned allocator keeps the block
    until the copy has run). Returns ``dst``."""
    if dst.device.type == "cuda":
        with torch.cuda.device(dst.device):
            dst.copy_(host.pin_memory(), non_blocking=True)
    else:
        dst.copy_(host)
    return dst


def _row_ints(sc):
    """A CPU row's values as host ints (reading it does not wait)."""
    return sc.tolist()


# ---------------------------------------------------------------------------
# Blocks and windows
# ---------------------------------------------------------------------------


def _zone(geom: Geom, n: int):
    """(first plane row, rows, cols) of the zone of n-blocks: the 32 grid,
    or at n=16 the bottom strip, one row of ``cols16`` blocks from row
    ``strip_y``."""
    if n == 32:
        return 0, geom.rows32, geom.cols32
    if n != 16 or not geom.strip:
        raise ValueError(f"no zone of {n}-blocks in a geometry with strip="
                         f"{geom.strip}")
    return geom.strip_y, 1, geom.cols16


def _zone_positions(geom: Geom, device, n: int = 32):
    """(pos_y, pos_x) int32 plane-pixel positions of the zone's blocks in
    raster order (the 32 grid's, or at n=16 the strip's), contiguous (one
    row of blocks would otherwise leave pos_y a stride-0 view), with the
    zone's (rows, cols)."""
    y0, rows, cols = _zone(geom, n)
    ys = torch.arange(rows, dtype=torch.int32, device=device) * n + y0
    xs = torch.arange(cols, dtype=torch.int32, device=device) * n
    return (ys[:, None].expand(rows, cols).reshape(-1).contiguous(),
            xs[None, :].expand(rows, cols).reshape(-1).contiguous(), rows,
            cols)


def _extract_blocks(plane, y0: int, rows: int, cols: int, n: int):
    """(rows*n, cols*n) region at row y0 -> (rows*cols, n, n), contiguous
    (the kernels take contiguous blocks; one row of blocks, the strip's,
    would otherwise stay a strided view of the plane)."""
    reg = plane[y0:y0 + rows * n, :cols * n]
    if tuple(reg.shape) != (rows * n, cols * n):
        raise ValueError(f"_extract_blocks: {rows}x{cols} blocks of {n} at "
                         f"row {y0} leave the {tuple(plane.shape)} plane")
    return reg.reshape(rows, n, cols, n).permute(0, 2, 1, 3) \
        .reshape(-1, n, n).contiguous()


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
    plus the 8-tap subpel halo. Blocks in raster order, contiguous (one
    row of blocks would otherwise stay an overlapping view)."""
    sw = n + 2 * r + 8
    y0, x0, hh, ww = window_bounds(ref_padded.shape, n, rows, cols, y_base,
                                   r)
    region = ref_padded[y0:y0 + hh, x0:x0 + ww]
    wins = region.unfold(0, sw, n).unfold(1, sw, n)  # (rows, cols, sw, sw)
    return wins.reshape(rows * cols, sw, sw).contiguous()


def extract_windows(jobs, rows: int, cols: int):
    """Search windows of one zone of rows x cols blocks out of several
    border-extended planes (contract: ``_extract_search_windows`` for each
    job): jobs are (plane, n, y_base, r). ``window_bounds`` refuses a
    region that leaves its plane first. Planes that all lie on the CPU
    take the plain version; anything else goes to the CUDA kernel's
    wrapper, which cuts every set in one launch or raises. Returns a list
    of contiguous (B, SW, SW) uint8 tensors, one a job."""
    if all(job[0].device.type == "cpu" for job in jobs):
        return [_extract_search_windows(plane, n, rows, cols, y_base, r)
                for plane, n, y_base, r in jobs]
    return cuda_kernels.extract_windows(window_specs(jobs, rows, cols), rows,
                                        cols)


def window_specs(jobs, rows: int, cols: int):
    """``extract_windows``' jobs as its kernel takes them: (plane, n, SW,
    y0, x0), the first window's origin from ``window_bounds``, which
    raises for a region that leaves its plane (checked once a shape)."""
    return [(plane, *_window_spec(tuple(plane.shape), n, rows, cols, y_base,
                                  r))
            for plane, n, y_base, r in jobs]


@functools.lru_cache(maxsize=256)
def _window_spec(shape, n: int, rows: int, cols: int, y_base: int, r: int):
    """(n, SW, y0, x0) of a window set (``window_specs``)."""
    y0, x0, _, _ = window_bounds(shape, n, rows, cols, y_base, r)
    return n, n + 2 * r + 8, y0, x0


@functools.lru_cache(maxsize=None)
def _grid_starts(rows: int, cols: int, n: int, device, y_base: int = 0):
    """(y0, x0) int32 (1, rows*cols): where the blocks of the n-grid whose
    first row is plane row ``y_base`` start in a border-extended plane,
    raster order."""
    ys = torch.arange(rows, dtype=torch.int32, device=device) * n + BORDER \
        + y_base
    xs = torch.arange(cols, dtype=torch.int32, device=device) * n + BORDER
    return (ys[:, None].expand(rows, cols).reshape(1, -1).contiguous(),
            xs[None, :].expand(rows, cols).reshape(1, -1).contiguous())


def _zero_sse(ref_padded, src_blocks, rows: int, cols: int, n: int,
              y_base: int = 0):
    """SSE of the ZERO-MV candidate of the n-grid whose first row is plane
    row ``y_base``.

    Zero MV is never moved by the UMV clamp and its subpel phase is the
    identity tap, so the prediction is the co-located reference block,
    read in place."""
    y0, x0 = _grid_starts(rows, cols, n, ref_padded.device, y_base)
    return block_energy_at(src_blocks, ref_padded, y0, x0, n)[0][0]


def _block_sq_sum(src_blocks):
    """Per-block sum(src^2), int32."""
    s = src_blocks.to(torch.int32)
    return (s * s).sum(dim=(1, 2), dtype=torch.int32)


@functools.lru_cache(maxsize=8)
def _zero_blocks(b: int, n: int, device):
    return torch.zeros((b, n, n), dtype=torch.uint8, device=device)


def _aq_var(src_sum, src2, n: int):
    """Per-block variance of a zone's n x n blocks from their exact int32
    sums (tensors on any device), as the JAX package's ``_sb_lambda_scale``
    takes it, in float32 op for op on the host: float32(src2) (rounded
    above 2^24) / n^2 - mean * mean, clipped at 0. The cancellation is
    float32's, as there. Returns (B,) float32 numpy (the read waits for
    the device)."""
    f32 = np.float32
    sums = torch.stack([src_sum, src2]).cpu().numpy()
    mean = sums[0].astype(f32) / f32(n * n)
    return np.maximum(sums[1].astype(f32) / f32(n * n) - mean * mean, f32(0))


def _sb_lambda_scale(src_sum, src2, n: int):
    """Per-block variance-adaptive rate-lambda scale (tune SQ), as the JAX
    package's ``_sb_lambda_scale`` computes it from a zone's n x n source
    blocks: flat blocks get a lower rate lambda, busy ones a higher, the
    frame's geometric mean normalised to 1, clipped to [0.5, 2].

    src_sum, src2: (B,) int32 exact per-block sums of the pixels and of
    their squares, on any device. After ``_aq_var`` the chain stays float32
    on the host: + 16, log, minus the mean of the logs, * 0.25, exp, the
    clip. log and exp are taken in float64 and rounded to float32, the mean
    of the logs summed in float64 and rounded, so the scale is the same
    bits on the CPU and the card. XLA's float32 log and exp are not always
    correctly rounded and its sum takes another order, so a scale may
    differ from the JAX package's by a few ulps (``tests/
    test_torch_rt_aq.py`` bounds it). Returns (B,) float32 on
    ``src_sum``'s device."""
    f32 = np.float32
    var = _aq_var(src_sum, src2, n)
    logv = np.log((var + f32(16)).astype(np.float64)).astype(f32)
    mean_log = f32(np.sum(logv, dtype=np.float64)) / f32(logv.size)
    scale = np.exp(((logv - mean_log) * f32(0.25)).astype(np.float64))
    scale = np.clip(scale.astype(f32), f32(0.5), f32(2.0))
    return torch.from_numpy(scale).to(src_sum.device)


def aq_scale_ref(src_sum, src2, n: int, scalars):
    """The zone's per-block rate lambda (plain version of the kernel
    behind ``ops/cuda_kernels.py:aq_scale``, same arguments): the frame's
    float32 lam_bits, the word of the rate tables' device row ``scalars``
    (``RATE_SCALARS``), times ``_sb_lambda_scale`` of the blocks' exact
    sums, the product in float32. Returns (B,) float32 on ``src_sum``'s
    device."""
    k = cuda_kernels.RATE_SCALARS.index("lam_bits")
    lam_bits = float(scalars[k:k + 1].view(torch.float32).item())
    return _sb_lambda_scale(src_sum, src2, n) * lam_bits


def aq_scale(src_sum, src2, n: int, scalars):
    """The zone's per-block rate lambda (contract: ``aq_scale_ref``).
    Tensors that all lie on the CPU take the plain version; anything else
    goes to the CUDA kernel's wrapper, which launches or raises."""
    if all(t.device.type == "cpu" for t in (src_sum, src2, scalars)):
        return aq_scale_ref(src_sum, src2, n, scalars)
    return cuda_kernels.aq_scale(src_sum, src2, n, scalars)


def _aq_rates(rates, src_blocks, n: int):
    """``rates`` with the zone's per-block rate lambda (``aq_scale``) of
    the blocks, whose exact sums come from one ``block_energy`` launch
    against zero blocks (its SSE the sum of squares, its SAD the sum)."""
    zeros = _zero_blocks(src_blocks.shape[0], n, src_blocks.device)
    src2, src_sum = block_energy(src_blocks, zeros, n)
    return dict(rates, lam_bits=aq_scale(src_sum, src2, n,
                                         rates["scalars"]))


def _fullpel_starts(plane_shape, pos_y, pos_x, mv_r_q3, mv_c_q3, n: int,
                    x_base: int = 0):
    """(y0, x0) int32 (B,): where the n x n block at the rounded full-pel
    position of a q3 MV starts in a border-extended plane. ``x_base``: the
    global column of the plane's first column past its border (a column
    shard's plane, whose positions stay global; 0 for a whole frame).

    The MV gets no UMV clamp here, as in the JAX package, which relies
    on ``lax.dynamic_slice``: a negative start wraps once (the dimension
    is added to it, as in Python indexing) and the result is clamped so
    that the slice stays inside the plane. The same is done to the starts
    here, since neither torch indexing nor the kernel would."""
    hh, ww = plane_shape

    def start(idx, size):
        return torch.where(idx < 0, idx + size, idx).clamp(0, size - n)

    return (start(BORDER + pos_y + ((mv_r_q3 + 4) >> 3), hh),
            start(BORDER + pos_x + ((mv_c_q3 + 4) >> 3) - x_base, ww))


def _fullpel_sse(ref_padded, src_blocks, pos_y, pos_x, mv_r_q3, mv_c_q3,
                 n: int, x_base: int = 0):
    """SSE at the rounded full-pel position (no interpolation): the score
    of a candidate that has no search-map entry (GOLDEN's previous MV).
    ``x_base`` as in ``_fullpel_starts``."""
    y0, x0 = _fullpel_starts(ref_padded.shape, pos_y, pos_x, mv_r_q3,
                             mv_c_q3, n, x_base)
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


def mc_predict_ref(wins, pos_y, pos_x, mv_r, mv_c, n: int, mi_rows: int,
                   mi_cols: int, filters, ref_sel=None, win_idx=None,
                   org_off_y=None, org_off_x=None):
    """MC of B blocks' Y, U and V from per-block reference windows (the
    building block of ``mc_predict_planes_ref``, the plain version of the
    kernel behind ``ops/cuda_kernels.py:mc_predict``, which cuts the
    windows it takes): each plane's windows are picked per block, by the
    window index ``win_idx`` (window b without one) and by ``ref_sel`` among
    ``wins``' references (LAST, GOLDEN, ALTREF; LAST where the block's has
    none), and ``mc_predict_from_wins`` predicts from them, Y at n and
    WIN_R, U and V at n / 2 and CHROMA_WIN_R, positions and offsets
    halved. Returns (pred_y, pred_u, pred_v)."""
    idx = None if win_idx is None else win_idx.long()
    preds = []
    for p in range(3):
        w = wins[0][p] if idx is None else wins[0][p][idx]
        for ref_id, ref in enumerate(wins):
            if ref_id == 0 or ref is None or ref_sel is None:
                continue
            w_ref = ref[p] if idx is None else ref[p][idx]
            w = torch.where((ref_sel == ref_id)[:, None, None], w_ref, w)
        ss = min(p, 1)
        preds.append(mc_predict_from_wins(
            w, pos_y >> ss, pos_x >> ss, mv_r, mv_c, n >> ss, ss, mi_rows,
            mi_cols, filters, (WIN_R, CHROMA_WIN_R)[ss],
            org_off_y=0 if org_off_y is None else org_off_y >> ss,
            org_off_x=0 if org_off_x is None else org_off_x >> ss))
    return tuple(preds)


def mc_predict_planes_ref(planes, pos_y, pos_x, mv_r, mv_c, n: int,
                          mi_rows: int, mi_cols: int, filters, grid,
                          ref_sel=None, win_idx=None, org_off_y=None,
                          org_off_x=None):
    """MC of B blocks' Y, U and V out of the border-extended reference
    planes (plain version of the kernel behind ``ops/cuda_kernels.py:
    mc_predict``, which reads the windows in place): each reference's
    windows of the zone's grid (step, y_base, rows, cols) cut by
    ``_extract_search_windows`` (Y at step, y_base and WIN_R, U and V at
    half of both and CHROMA_WIN_R), then ``mc_predict_ref`` on them.
    planes: LAST's (y, u, v), then optionally GOLDEN's and ALTREF's (None
    where absent). Returns (pred_y, pred_u, pred_v)."""
    step, y_base, rows, cols = grid
    wins = [None if ref is None else tuple(
        _extract_search_windows(pl, step >> ss, rows, cols, y_base >> ss, r)
        for pl, ss, r in zip(ref, (0, 1, 1),
                             (WIN_R, CHROMA_WIN_R, CHROMA_WIN_R)))
            for ref in planes]
    return mc_predict_ref(wins, pos_y, pos_x, mv_r, mv_c, n, mi_rows,
                          mi_cols, filters, ref_sel, win_idx, org_off_y,
                          org_off_x)


def mc_predict(planes, pos_y, pos_x, mv_r, mv_c, n: int, mi_rows: int,
               mi_cols: int, filters, grid, ref_sel=None, win_idx=None,
               org_off_y=None, org_off_x=None):
    """The step's MC (contract: ``mc_predict_planes_ref``; ``filters`` the
    EIGHTTAP table, which the kernel holds its own checked copy of).
    Tensors that all lie on the CPU take the plain version; anything else
    goes to the CUDA kernel's wrapper with the grid's windows as
    ``mc_window_grid`` places them, which reads the planes in place and
    launches or raises."""
    tensors = [t for t in (*(pl for ref in planes if ref is not None
                             for pl in ref), pos_y, pos_x, mv_r, mv_c,
                           ref_sel, win_idx, org_off_y, org_off_x)
               if t is not None]
    if all(t.device.type == "cpu" for t in tensors):
        return mc_predict_planes_ref(planes, pos_y, pos_x, mv_r, mv_c, n,
                                     mi_rows, mi_cols, filters, grid,
                                     ref_sel, win_idx, org_off_y, org_off_x)
    shapes = tuple(tuple(t.shape) for t in planes[0])
    return cuda_kernels.mc_predict(planes, pos_y, pos_x, mv_r, mv_c, n,
                                   mi_rows, mi_cols,
                                   mc_window_grid(shapes, tuple(grid)),
                                   ref_sel, win_idx, org_off_y, org_off_x)


@functools.lru_cache(maxsize=64)
def mc_window_grid(shapes, grid):
    """``mc_predict``'s window grid as its kernel takes it: (rows, cols,
    then Y's, U's and V's (step, SW, y0, x0)) for the zone's grid (step,
    y_base, rows, cols) in planes of ``shapes``, each plane's windows
    those ``_extract_search_windows`` cuts (``_window_spec``, which refuses
    windows that leave the plane; checked once a shape)."""
    step, y_base, rows, cols = grid
    return (rows, cols, *(
        _window_spec(shp, step >> ss, rows, cols, y_base >> ss, r)
        for shp, ss, r in zip(shapes, (0, 1, 1),
                              (WIN_R, CHROMA_WIN_R, CHROMA_WIN_R))))


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


# the rate tables' device tensors (``upload_rate_tabs``)
RATE_TENSORS = ("joint_cost", "nmv_row", "nmv_col", "scalars")


def upload_rate_tabs(tabs, device, out=None):
    """The step's ``rates`` argument from ``make_rate_tabs``: the three
    LUTs the step gathers from go to ``device``, and so do the scalars, as
    one int32 row (``cuda_kernels.rate_scalars``, key "scalars"), which
    the kernels read; beside it the scalars stay host numbers
    (``lam_bits`` the float32 value) for the plain versions. Both come
    from ``tabs``: a caller that changes a host scalar uploads again.
    ``out``: a dict this function returned before, held for the life of a
    session, whose device tensors are refilled in place (``refill``) and
    whose host numbers are replaced; else a new dict."""
    host = {
        "joint_cost": tabs["joint_cost"], "nmv_row": tabs["nmv_row"],
        "nmv_col": tabs["nmv_col"],
        "scalars": cuda_kernels.rate_scalars(tabs)}
    host = {k: torch.from_numpy(np.ascontiguousarray(v, np.int32))
            for k, v in host.items()}
    rates = {
        "mode_cost": [int(v) for v in tabs["mode_cost"]],
        "ref_cost": [int(v) for v in tabs["ref_cost"]],
        "lam_bits": float(np.float32(tabs["lam_bits"])),
        "mv_cost_max": int(tabs["mv_cost_max"]),
    }
    if out is None:
        rates.update((k, v.to(device)) for k, v in host.items())
        return rates
    for k in RATE_TENSORS:
        refill(out[k], host[k])
    out.update(rates)
    return out


def _mvd_bits(rates, dr, dc):
    """NEWMV's mvd cost in 1/256 bit against a predictor: the joint's tree
    cost plus the two component LUTs, the components clipped to the LUTs'
    reach."""
    m = rates["mv_cost_max"]
    j = 2 * (dr != 0).to(torch.int32) + (dc != 0).to(torch.int32)
    return (rates["joint_cost"][j.long()]
            + rates["nmv_row"][(dr.clamp(-m, m) + m).long()]
            + rates["nmv_col"][(dc.clamp(-m, m) + m).long()])


def _table_costs(sads, rate, lam_bits):
    """SSE + lam_bits * rate / 256 in float32. The multiply, the divide
    and the add are separate operations in the JAX package's order (a
    fused multiply-add would round differently). lam_bits: the frame's
    float32 value as a host float, or (aq) a float32 (B,) tensor, one a
    block (the columns of ``sads`` and ``rate``)."""
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
                      rates=None, left_edge=None):
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
    ``jnp.argmin`` does. left_edge: (rows, 2) NEW MVs of the column left
    of the zone (the previous column shard's last); None at the frame's
    left edge, whose LEFT candidate is zero.
    Returns (mv_r, mv_c, best_cost).
    """
    b = new_r.shape[0]
    nr2 = new_r.reshape(rows, cols)
    nc2 = new_c.reshape(rows, cols)
    if left_edge is None:
        left_r = F.pad(nr2[:, :-1], (1, 0)).reshape(-1)
        left_c = F.pad(nc2[:, :-1], (1, 0)).reshape(-1)
    else:
        edge = left_edge.to(new_r.dtype)
        left_r = torch.cat([edge[:, 0:1], nr2[:, :-1]], dim=1).reshape(-1)
        left_c = torch.cat([edge[:, 1:2], nc2[:, :-1]], dim=1).reshape(-1)
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


def _golden_sses(gold_y, src_blocks, pos_y, pos_x, prev_mv, rows: int,
                 cols: int, n: int, y_base: int = 0, x_base: int = 0):
    """The SSEs of GOLDEN's two candidates per block of the zone whose
    first row is plane row ``y_base``, (2, B) int32 from one
    ``block_energy_at`` launch: ZERO (the co-located block) and the
    block's previous-frame MV at its rounded full-pel position.
    ``x_base`` as in ``_fullpel_starts`` (the ZERO candidate reads the
    zone's columns of ``gold_y`` whatever it is)."""
    zy, zx = _grid_starts(rows, cols, n, gold_y.device, y_base)
    py, px = _fullpel_starts(gold_y.shape, pos_y, pos_x, prev_mv[:, 0],
                             prev_mv[:, 1], n, x_base)
    return block_energy_at(src_blocks, gold_y, torch.cat([zy, py[None]]),
                           torch.cat([zx, px[None]]), n)[0]


def _golden_costs(sses, prev_mv, lam: int, rates):
    """GOLDEN's first minimum of ZERO and the previous MV on their (2, B)
    SSEs (``_golden_sses``). Returns (mv_r, mv_c, cost) without the
    reference's own signalling cost."""
    zero = torch.zeros_like(prev_mv[:, 0])
    cand_r = torch.stack([zero, prev_mv[:, 0]])
    cand_c = torch.stack([zero, prev_mv[:, 1]])
    if rates is not None:
        # the mode costs of ZERO and PREV out of the device row (words 2
        # and 0 of RATE_SCALARS)
        row = rates["scalars"]
        g_rate = torch.stack([row[2:3], row[0:1]])
        costs = _table_costs(sses, g_rate, rates["lam_bits"])
    else:
        rz, _, _, rp, _ = CAND_RATE_PROXY
        costs = sses.to(torch.float32) + float(lam) * torch.tensor(
            [[rz], [rp]], dtype=torch.float32, device=sses.device)
    (mv_r, mv_c), cost, _ = _first_min(costs, (cand_r, cand_c))
    return mv_r, mv_c, cost


def _golden_decide(gold_y, src_blocks, pos_y, pos_x, prev_mv, rows: int,
                   cols: int, n: int, lam: int, rates, y_base: int = 0,
                   x_base: int = 0):
    """The GOLDEN reference's best candidate per block of the zone whose
    first row is plane row ``y_base``: ZERO (exact SSE) or the block's
    previous-frame MV (SSE at its rounded full-pel position), first
    minimum (``_golden_sses``, then ``_golden_costs``). Returns (mv_r,
    mv_c, cost) without the reference's own signalling cost."""
    sses = _golden_sses(gold_y, src_blocks, pos_y, pos_x, prev_mv, rows,
                        cols, n, y_base, x_base)
    return _golden_costs(sses, prev_mv, lam, rates)


def _ref_extra(lam: int, rates):
    """Signalling cost of choosing (LAST, GOLDEN, ALTREF) in cost units:
    three float32 values, as host floats, or (aq: a per-block lam_bits)
    three float32 (B,) tensors."""
    if rates is not None and isinstance(rates["lam_bits"], torch.Tensor):
        return [float(c) * rates["lam_bits"] / 256.0
                for c in rates["ref_cost"][:3]]
    if rates is not None:
        lam_f = np.float32(rates["lam_bits"])
        return [float(np.float32(c) * lam_f / np.float32(256.0))
                for c in rates["ref_cost"][:3]]
    two = float(np.float32(2.0) * np.float32(lam))
    return [0.0, two, two]


def _altref_search(alt_y, src_blocks, rows: int, cols: int, n: int,
                   y_base: int = 0):
    """The ALTREF reference's own search for the blocks of the zone whose
    first row is plane row ``y_base`` (the search half of the JAX
    package's ALTREF block of ``encode_zone``): its windows, the ZERO SSE,
    the 32 grid's two-level full search (``hier_search``) refined to
    quarter-pel in the refine windows, or the strip's flat one at +-WIN_R
    (``sse_map_search``) refined in its windows. Returns (sse_zero,
    sse_new, new_r, new_c, the ALTREF luma windows)."""
    wins, = extract_windows([(alt_y, n, y_base, WIN_R)], rows, cols)
    sse0 = _zero_sse(alt_y, src_blocks, rows, cols, n, y_base)
    if n == 32:
        c_y, c_x, dyr, dxr, loc, _, _ = hier_search(src_blocks, wins, n)
        sub_r, sub_c, sse1 = subpel_search(loc, src_blocks, dyr, dxr, n,
                                           REFINE_R)
        new_r, new_c = c_y * 8 + sub_r, c_x * 8 + sub_c
    else:
        dy, dx, _ = sse_map_search(src_blocks, wins, n, WIN_R)
        new_r, new_c, sse1 = subpel_search(wins, src_blocks, dy, dx, n,
                                           WIN_R)
    return sse0, sse1, new_r, new_c, wins


def _altref_costs(sse0, sse1, new_r, new_c, rates):
    """ALTREF's first minimum of ZERO and NEW (its mvd taken against
    zero), costed with the frame's entropy tables. Returns (mv_r, mv_c,
    cost) without the reference's own signalling cost."""
    mc = rates["mode_cost"]
    ones = torch.ones_like(new_r)
    rate = torch.stack([mc[2] * ones, mc[3] + _mvd_bits(rates, new_r, new_c)])
    costs = _table_costs(torch.stack([sse0, sse1]), rate, rates["lam_bits"])
    zero = torch.zeros_like(new_r)
    (mv_r, mv_c), cost, _ = _first_min(
        costs, (torch.stack([zero, new_r]), torch.stack([zero, new_c])))
    return mv_r, mv_c, cost


def _altref_decide(alt_y, src_blocks, rows: int, cols: int, n: int,
                   rates, y_base: int = 0):
    """The ALTREF reference's best candidate per block of the zone whose
    first row is plane row ``y_base`` (the JAX package's ALTREF block of
    ``encode_zone``): ``_altref_search``, then ``_altref_costs``. Returns
    (mv_r, mv_c, cost without the reference's own signalling cost, the
    ALTREF luma windows)."""
    sse0, sse1, new_r, new_c, wins = _altref_search(alt_y, src_blocks, rows,
                                                    cols, n, y_base)
    return (*_altref_costs(sse0, sse1, new_r, new_c, rates), wins)


def mode_decide_ref(ssem, src2m, sse_zero, sse_new, new_r, new_c, prev_mv,
                    rows: int, cols: int, r_map: int, q3_shift: int,
                    sse_scale: int, lam: int, new_bits, rates=None,
                    left_edge=None, gold_sse=None, alt=None):
    """The zone's mode decision (plain version of the kernel behind
    ``ops/cuda_kernels.py:mode_decide``, its arguments but ``proxy``,
    which is ``CAND_RATE_PROXY``'s here): LAST's five candidates
    (``_candidate_decide``); with ``gold_sse`` ((2, B) int32,
    ``_golden_sses``) GOLDEN's ZERO and previous MV (``_golden_costs``),
    taken on a strict '<' against LAST's best; with ``alt`` = (sse_zero,
    sse_new, new_r, new_c) of ALTREF's search (``_altref_search``; needs
    ``rates``) ALTREF's ZERO and NEW (``_altref_costs``), taken on a
    strict '<' against the best after GOLDEN; each reference's cost with
    its signalling cost (``_ref_extra``). rates: ``upload_rate_tabs``, its
    ``lam_bits`` a host number or (aq) a (B,) float32 tensor, or None
    (the proxies). Returns (mv_r, mv_c int32, ref_sel int8: 0 LAST, 1
    GOLDEN, 2 ALTREF)."""
    mv_r, mv_c, cost_last = _candidate_decide(
        ssem, src2m, sse_zero, sse_new, new_r, new_c, prev_mv, rows, cols,
        r_map, q3_shift, sse_scale, lam, new_bits, rates=rates,
        left_edge=left_edge)
    ref_sel = torch.zeros((new_r.shape[0],), dtype=torch.int8,
                          device=new_r.device)
    if gold_sse is None and alt is None:
        return mv_r, mv_c, ref_sel
    extra = _ref_extra(lam, rates)
    best_cost = cost_last + extra[0]
    if gold_sse is not None:
        g_mv_r, g_mv_c, g_cost = _golden_costs(gold_sse, prev_mv, lam, rates)
        g_cost = g_cost + extra[1]
        use_gold = g_cost < best_cost
        best_cost = torch.where(use_gold, g_cost, best_cost)
        ref_sel = use_gold.to(torch.int8)
        mv_r = torch.where(use_gold, g_mv_r, mv_r)
        mv_c = torch.where(use_gold, g_mv_c, mv_c)
    if alt is not None:
        a_mv_r, a_mv_c, a_cost = _altref_costs(*alt, rates)
        use_alt = (a_cost + extra[2]) < best_cost
        ref_sel = torch.where(use_alt, 2, ref_sel).to(torch.int8)
        mv_r = torch.where(use_alt, a_mv_r, mv_r)
        mv_c = torch.where(use_alt, a_mv_c, mv_c)
    return mv_r, mv_c, ref_sel


def mode_decide(ssem, src2m, sse_zero, sse_new, new_r, new_c, prev_mv,
                rows: int, cols: int, r_map: int, q3_shift: int,
                sse_scale: int, sc, new_bits, rates=None,
                left_edge=None, gold_sse=None, alt=None):
    """The zone's mode decision (contract: ``mode_decide_ref``, its lam
    the word of the step's row ``sc``). Tensors that all lie on the CPU
    take the plain version; anything else goes to the CUDA kernel's
    wrapper, which launches or raises."""
    if alt is not None and rates is None:
        raise ValueError("mode_decide: ALTREF takes the frame's rate tables")
    tensors = [ssem, src2m, sse_zero, sse_new, new_r, new_c, prev_mv,
               new_bits, left_edge, gold_sse, *(alt or ()), sc]
    if rates is not None:
        tensors += [rates["joint_cost"], rates["nmv_row"], rates["nmv_col"],
                    rates["scalars"]]
        if isinstance(rates["lam_bits"], torch.Tensor):
            tensors.append(rates["lam_bits"])
    if all(t.device.type == "cpu" for t in tensors if t is not None):
        return mode_decide_ref(ssem, src2m, sse_zero, sse_new, new_r, new_c,
                               prev_mv, rows, cols, r_map, q3_shift,
                               sse_scale, _row_ints(sc)[SC_LAM], new_bits,
                               rates, left_edge, gold_sse, alt)
    return cuda_kernels.mode_decide(
        ssem, src2m, sse_zero, sse_new, new_r, new_c, prev_mv, rows, cols,
        r_map, q3_shift, sse_scale, sc, new_bits, rates, left_edge,
        gold_sse, alt, CAND_RATE_PROXY)


def mode_decide_mc_ref(ssem, src2m, sse_zero, sse_new, new_r, new_c,
                       prev_mv, rows: int, cols: int, r_map: int,
                       q3_shift: int, sse_scale: int, lam: int, new_bits,
                       rates, left_edge, gold_sse, alt, planes, pos_y, pos_x,
                       n: int, mi_rows: int, mi_cols: int, filters, grid):
    """The zone's decision and its MC (plain version of the kernel behind
    ``ops/cuda_kernels.py:mode_decide_mc``, its arguments but ``proxy``,
    which is ``CAND_RATE_PROXY``'s here): ``mode_decide_ref``, then
    ``mc_predict_planes_ref`` with its MVs and ref_sel at the zone's grid
    (step, y_base, rows, cols). Returns (mv_r, mv_c, ref_sel, mv (B, 2)
    int16, pred_y, pred_u, pred_v)."""
    mv_r, mv_c, ref_sel = mode_decide_ref(
        ssem, src2m, sse_zero, sse_new, new_r, new_c, prev_mv, rows, cols,
        r_map, q3_shift, sse_scale, lam, new_bits, rates, left_edge,
        gold_sse, alt)
    preds = mc_predict_planes_ref(planes, pos_y, pos_x, mv_r, mv_c, n,
                                  mi_rows, mi_cols, filters, grid,
                                  ref_sel=ref_sel)
    return (mv_r, mv_c, ref_sel,
            torch.stack([mv_r, mv_c], dim=-1).to(torch.int16), *preds)


def mode_decide_mc(ssem, src2m, sse_zero, sse_new, new_r, new_c, prev_mv,
                   rows: int, cols: int, r_map: int, q3_shift: int,
                   sse_scale: int, sc, new_bits, rates, left_edge,
                   gold_sse, alt, planes, pos_y, pos_x, n: int, mi_rows: int,
                   mi_cols: int, filters, grid):
    """The zone's decision and its MC in one launch (contract:
    ``mode_decide_mc_ref``, its lam the word of the step's row ``sc``; the
    first eighteen arguments are ``mode_decide``'s, the rest
    ``mc_predict``'s but the MVs and ref_sel).
    Tensors that all lie on the CPU take the plain version; anything else
    goes to the CUDA kernel's wrapper with the grid's windows as
    ``mc_window_grid`` places them, which launches or raises."""
    if alt is not None and rates is None:
        raise ValueError("mode_decide_mc: ALTREF takes the frame's rate "
                         "tables")
    tensors = [ssem, src2m, sse_zero, sse_new, new_r, new_c, prev_mv,
               new_bits, left_edge, gold_sse, *(alt or ()), pos_y, pos_x,
               *(pl for ref in planes if ref is not None for pl in ref), sc]
    if rates is not None:
        tensors += [rates["joint_cost"], rates["nmv_row"], rates["nmv_col"],
                    rates["scalars"]]
        if isinstance(rates["lam_bits"], torch.Tensor):
            tensors.append(rates["lam_bits"])
    if all(t.device.type == "cpu" for t in tensors if t is not None):
        return mode_decide_mc_ref(ssem, src2m, sse_zero, sse_new, new_r,
                                  new_c, prev_mv, rows, cols, r_map,
                                  q3_shift, sse_scale, _row_ints(sc)[SC_LAM],
                                  new_bits, rates, left_edge, gold_sse, alt,
                                  planes, pos_y, pos_x, n, mi_rows, mi_cols,
                                  filters, grid)
    shapes = tuple(tuple(t.shape) for t in planes[0])
    return cuda_kernels.mode_decide_mc(
        ssem, src2m, sse_zero, sse_new, new_r, new_c, prev_mv, rows, cols,
        r_map, q3_shift, sse_scale, sc, new_bits, rates, left_edge,
        gold_sse, alt, CAND_RATE_PROXY, planes, pos_y, pos_x, n, mi_rows,
        mi_cols, mc_window_grid(shapes, tuple(grid)))


# ---------------------------------------------------------------------------
# Transform / quant / recon (normative inverse path)
# ---------------------------------------------------------------------------

_SCAN_CACHE: dict = {}


def _scan(n: int, device, tx_type=T.TxType.DCT_DCT):
    key = (n, str(device), int(tx_type))
    if key not in _SCAN_CACHE:
        order = T.scan_order(txfm.TX_SIZE[n], T.TxType(tx_type))[0]
        _SCAN_CACHE[key] = torch.as_tensor(np.asarray(order, np.int64),
                                           device=device)
    return _SCAN_CACHE[key]


def transform_recon_ref(src_blocks, pred_blocks, dc_q: int, ac_q: int,
                        n: int, tx_type=T.TxType.DCT_DCT):
    """Forward transform + quantize + dequant + exact integer inverse add
    for (B, n, n) blocks (plain version of the kernel behind
    ``ops/cuda_kernels.py:transform_recon``), of ``tx_type``: DCT_DCT, or
    at n=16 the keyframe strip's ADST_DCT (ADST down the columns, DCT
    along the rows). Returns (levels int16, eob int32, recon uint8); eob
    is one past the last nonzero level in the type's scan order (0 if
    none)."""
    resid = src_blocks.to(torch.int32) - pred_blocks.to(torch.int32)
    levels = txfm.quantize_f64(txfm.fwd_txfm2d_f64(resid, tx_type), dc_q,
                               ac_q, n)
    eob, recon = recon_from_levels(levels, pred_blocks, dc_q, ac_q, n,
                                   tx_type)
    return levels.to(torch.int16), eob, recon


def transform_recon(src_blocks, pred_blocks, sc, n: int,
                    tx_type=T.TxType.DCT_DCT):
    """The step's transform stage (contract: ``transform_recon_ref``, its
    quantizers the words of the step's row ``sc``). Blocks and row that
    all lie on the CPU take the plain version; anything else goes to the
    CUDA kernel's wrapper, which launches or raises (and refuses blocks on
    two devices)."""
    if all(t.device.type == "cpu" for t in (src_blocks, pred_blocks, sc)):
        row = _row_ints(sc)
        return transform_recon_ref(src_blocks, pred_blocks, row[SC_DC_Q],
                                   row[SC_AC_Q], n, tx_type)
    return cuda_kernels.transform_recon(src_blocks, pred_blocks, sc, n,
                                        tx_type)


def recon_from_levels(levels, pred_blocks, dc_q: int, ac_q: int, n: int,
                      tx_type=T.TxType.DCT_DCT):
    """(eob int32, recon uint8) of int32 (B, n, n) quantized levels of
    ``tx_type``: the integer half of ``transform_recon_ref``."""
    ts = txfm.TX_SIZE[n]
    recon = txfm.inv_txfm_add(
        txfm.dequant_block(levels, dc_q, ac_q, ts, xp=torch), pred_blocks,
        ts, T.TxType(tx_type), xp=torch)
    b = levels.shape[0]
    nz = levels.reshape(b, n * n)[:, _scan(n, levels.device, tx_type)] != 0
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
    """Exact VP9 loop filter for the 32 grid and its bottom 16-pixel strip
    (``geom.strip``): the plain version, in PyTorch ops on the planes'
    device, of the kernel behind ``ops/cuda_kernels.py:loop_filter``.

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

    The strip (rows from ``geom.strip_y``, its 16x16 blocks coded with
    tx16 luma and tx8 chroma) adds, as the JAX package's
    ``loop_filter_device`` does: luma verticals at the 16-offsets of its
    rows (width 16); chroma verticals every 8 pixels of its rows (width 8,
    the 16-multiples included) and, on the bands, a boundary vertical of
    width 8; the chroma horizontal edge at ``strip_y / 2`` at width 8.
    A split mask with a strip geometry raises ValueError, as it does
    there.

    lvl/lim/mblim are host ints (lvl 0 leaves the planes as they are).
    Returns new planes; the inputs are not modified.
    """
    g = geom
    if split32 is not None and g.strip:
        raise ValueError("loop_filter: a split mask with a strip geometry "
                         "(its blocks are 16x16 already)")
    y, u, v = y.clone(), u.clone(), v.clone()
    dev = y.device
    thresh = lvl >> 4
    h_mi, w_mi = g.h_mi, g.w_mi
    h_mi_c, w_mi_c = h_mi >> 1, w_mi >> 1
    strip_y, strip_yc = g.strip_y, g.strip_y >> 1
    ch_rows = strip_yc if g.strip else h_mi_c  # chroma rows above a strip
    w16 = 16 * int(lvl > 0)
    w8 = 8 * int(lvl > 0)
    w16_t = torch.tensor(w16, dtype=torch.int32, device=dev)
    w8_t = torch.tensor(w8, dtype=torch.int32, device=dev)
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
        _lf_vert(u, 0, ch_rows, xs_c, w16_t, *lf)
        _lf_vert(v, 0, ch_rows, xs_c, w16_t, *lf)
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
    if g.strip:
        # the strip's 16x16 blocks: luma 16-offset verticals; chroma
        # verticals every 8 pixels but the band columns', width 8
        xs_ys = np.array([x for x in range(16, w_mi, 16) if x % 32],
                         np.int64)
        _lf_vert(y, strip_y, h_mi - strip_y, xs_ys, w16_t, *lf)
        xs_cs = np.array([x for x in range(8, w_mi_c, 8) if x % 32],
                         np.int64)
        for plane in (u, v):
            _lf_vert(plane, strip_yc, h_mi_c - strip_yc, xs_cs, w8_t, *lf,
                     taps=4)

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
    ys_c = np.arange(16, ch_rows, 16, dtype=np.int64)
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
    if g.strip:  # the chroma edge at the strip's top: tx8, width 8
        for plane in (u, v):
            _lf_horz(plane, np.array([strip_yc], np.int64), w8 * mask_c,
                     *lf)

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
            if not split:  # width 8 at the chroma strip's top edge
                return torch.tensor(
                    [(w8 if chroma and g.strip and base + dy >= strip_yc
                      else w16) * ok for dy, ok in zip(dys, oks)],
                    dtype=torch.int32, device=dev)[:, None, None]
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
        if not split:  # the strip's rows are tx8: width 8
            strip_rows = (y0c + rowi_c >= strip_yc) & g.strip
            wc = torch.where(alive_c, torch.where(strip_rows, w8_t, w16_t),
                             0)
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


def loop_filter_device(y, u, v, geom: Geom, sc, split32=None):
    """The step's loop filter (contract: ``loop_filter_ref``, its level
    and limits the words of the step's row ``sc``). Planes, row (and mask)
    that all lie on the CPU take the plain version; anything else goes to
    the CUDA kernel's wrapper, which launches or raises, at every level (a
    level of 0 is the kernel's own branch). Both refuse a split mask with
    a strip geometry."""
    tensors = (y, u, v, sc) if split32 is None else (y, u, v, sc, split32)
    if all(t.device.type == "cpu" for t in tensors):
        row = _row_ints(sc)
        return loop_filter_ref(y, u, v, geom, row[SC_LF_LVL],
                               row[SC_LF_LIM], row[SC_LF_MBLIM], split32)
    return loop_filter(y, u, v, geom, sc, split32)


# ---------------------------------------------------------------------------
# The 32-grid zone, the 16x16 children and the P-frame step
# ---------------------------------------------------------------------------


def encode_zone(src_y, src_u, src_v, ref_y, ref_u, ref_v, prev_mv,
                geom: Geom, sc, filters, new_bits, gold=None, alt=None,
                rates=None, return_me: bool = False, n: int = 32,
                aq: bool = False):
    """MD + recon for one uniform zone (the JAX package's ``encode_zone``):
    at n=32 the 32 grid, at n=16 the bottom strip of a strip geometry (one
    row of ``cols16`` blocks from plane row ``strip_y``).

    src planes: padded device planes; ref planes: border-extended
    previous reconstruction; prev_mv: (B, 2) int32 q3 MVs of the zone's
    blocks in the previous frame (the temporal candidate); sc: the step's
    row of scalars (``step_scalars``) on their device. The 32 grid
    searches in two levels (``hier_search``) and refines to quarter-pel in
    the refine windows; the strip searches its +-WIN_R windows flat
    (``sse_map_search``) and refines in them. gold: optional (y, u, v)
    border-extended GOLDEN planes: each block may then take GOLDEN
    (strict '<' against LAST). alt: optional (y, u, v) ALTREF planes (the
    random-access pyramid's future anchor; needs ``rates``): searched as
    LAST is, and taken on a strict '<' against the best after GOLDEN.
    Each block is compensated from its reference's windows, read in place
    in its planes. rates:
    ``upload_rate_tabs`` (entropy-table candidate costs) or None
    (proxies). return_me (n=32): also return what the children refine in,
    all of LAST, whatever reference a parent took ("wins", "dy", "dx" of
    the search, LAST's "planes" and the windows' "grid" (step, y_base,
    rows, cols) that MC reads them at): every child is a LAST block. aq (with ``rates``): the zone's candidate and reference costs
    take a per-block rate lambda (``_aq_rates``; tune SQ).
    Returns a dict with mv (B, 2 int16), ref (B int8: 0 LAST, 1 GOLDEN,
    2 ALTREF), skip, eob_y/u/v, lv_y/u/v (int16 blocks), rec_y/u/v
    (unfiltered zone planes), dist_b, rate_b, dist, rate.

    It runs in two halves, ``zone_search`` and ``zone_code``: a column
    shard of the frame (``pipeline/tpu_shard.py``) runs them on its own
    columns and hands its last column's NEW MVs to the next shard between
    the two.
    """
    if alt is not None and rates is None:
        raise ValueError("encode_zone: ALTREF takes the frame's rate tables")
    me = zone_search(src_y, ref_y, _zone_positions(geom, src_y.device, n),
                     _zone(geom, n)[0], n, rates=rates, aq=aq)
    return zone_code(me, src_u, src_v, ref_u, ref_v, prev_mv, geom, sc,
                     filters, new_bits, gold=gold, alt=alt,
                     return_me=return_me)


def zone_search(src_y, ref_y, positions, y0: int, n: int, rates=None,
                aq: bool = False):
    """The first half of ``encode_zone`` for the n-blocks at ``positions``
    = (pos_y, pos_x, rows, cols), whose first row is plane row ``y0``:
    the source blocks, LAST's search windows, the ZERO SSE, the full-pel
    search and the quarter-pel refinement (with ``aq`` the per-block
    rates). ``src_y`` and the border-extended ``ref_y`` start at the
    blocks' first column (a column shard's planes, or the frame's); the
    positions are global. Returns the state that ``zone_code`` takes."""
    pos_y, pos_x, rows, cols = positions
    with _stage("step_search"):
        src_blocks = _extract_blocks(src_y, y0, rows, cols, n)
        wins, = extract_windows([(ref_y, n, y0, WIN_R)], rows, cols)
        sse_zero = _zero_sse(ref_y, src_blocks, rows, cols, n, y0)
        if n == 32:
            c_y, c_x, dyr, dxr, loc, ssem, src2m = hier_search(src_blocks,
                                                               wins, n)
        else:
            dy, dx, ssem = sse_map_search(src_blocks, wins, n, WIN_R)
            src2m = _block_sq_sum(src_blocks)
    with _stage("step_subpel"):
        if n == 32:
            sub_r, sub_c, sse_new = subpel_search(loc, src_blocks, dyr, dxr,
                                                  n, REFINE_R)
            new_r, new_c = c_y * 8 + sub_r, c_x * 8 + sub_c
            dy, dx = c_y + dyr, c_x + dxr
            # the map is the half-res level's: +-HALF_R at 2x decimation
            r_map, q3s, scale = HALF_R, 4, 4
        else:
            new_r, new_c, sse_new = subpel_search(wins, src_blocks, dy, dx,
                                                  n, WIN_R)
            r_map, q3s, scale = WIN_R, 3, 1
    if aq and rates is not None:
        with _stage("step_aq"):
            rates = _aq_rates(rates, src_blocks, n)
    return {"pos_y": pos_y, "pos_x": pos_x, "rows": rows, "cols": cols,
            "y0": y0, "n": n, "src_blocks": src_blocks, "ref_y": ref_y,
            "wins": wins,
            "sse_zero": sse_zero, "ssem": ssem, "src2m": src2m,
            "sse_new": sse_new, "new_r": new_r, "new_c": new_c, "dy": dy,
            "dx": dx, "r_map": r_map, "q3s": q3s, "scale": scale,
            "rates": rates}


def zone_code(me, src_u, src_v, ref_u, ref_v, prev_mv, geom: Geom, sc,
              filters, new_bits, gold=None, alt=None,
              return_me: bool = False, left_edge=None, x_base: int = 0):
    """The second half of ``encode_zone``, on ``zone_search``'s state
    ``me``: the candidate decision (``left_edge``: the NEW MVs of the
    column left of the blocks, as ``_candidate_decide`` takes them),
    GOLDEN and ALTREF, and MC read in place out of the reference planes,
    in one launch (``mode_decide_mc``), the transforms and the recon.
    The planes start at the blocks' first column as ``zone_search``'s do;
    ``x_base`` is the global column of that column (``_fullpel_starts``).
    Returns ``encode_zone``'s dict."""
    g = geom
    n, rows, cols, y0 = me["n"], me["rows"], me["cols"], me["y0"]
    pos_y, pos_x = me["pos_y"], me["pos_x"]
    src_blocks, wins, rates = me["src_blocks"], me["wins"], me["rates"]
    nc = n // 2
    gold_sse = alt_me = None
    if gold is not None:
        with _stage("step_golden"):
            gold_sse = _golden_sses(gold[0], src_blocks, pos_y, pos_x,
                                    prev_mv, rows, cols, n, y0, x_base)
    if alt is not None:
        with _stage("step_altref"):
            alt_me = _altref_search(alt[0], src_blocks, rows, cols, n, y0)
    # the decision and MC in one launch, MC read in place out of the
    # reference planes at the windows' grid: every winner derives from a
    # +-WIN_R search (or is ZERO or PREV, equally bounded), and a read past
    # a window clamps into it
    grid = (n, y0, rows, cols)
    with _stage("step_mc"):
        _, _, ref_sel, mv, pred_y, pred_u, pred_v = mode_decide_mc(
            me["ssem"], me["src2m"], me["sse_zero"], me["sse_new"],
            me["new_r"], me["new_c"], prev_mv, rows, cols, me["r_map"],
            me["q3s"], me["scale"], sc, new_bits, rates, left_edge,
            gold_sse, None if alt_me is None else alt_me[:4],
            [(me["ref_y"], ref_u, ref_v), gold, alt], pos_y, pos_x, n,
            g.mi_rows, g.mi_cols, filters, grid)
    with _stage("step_txfm"):
        lv_y, eob_y, rec_y = transform_recon(src_blocks, pred_y, sc, n)
        src_ub = _extract_blocks(src_u, y0 // 2, rows, cols, nc)
        src_vb = _extract_blocks(src_v, y0 // 2, rows, cols, nc)
        lv_u, eob_u, rec_u = transform_recon(src_ub, pred_u, sc, nc)
        lv_v, eob_v, rec_v = transform_recon(src_vb, pred_v, sc, nc)
        skip = (eob_y == 0) & (eob_u == 0) & (eob_v == 0)
        dist_b = block_energy(src_blocks, rec_y, n)[0]
        rate_b = ((lv_y != 0).sum(dim=(1, 2)) + (lv_u != 0).sum(dim=(1, 2))
                  + (lv_v != 0).sum(dim=(1, 2)))
    out = {
        "mv": mv,
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
        if n != 32:
            raise ValueError("encode_zone: only the 32 grid has children")
        # LAST's search windows and planes, where a parent took GOLDEN or
        # ALTREF too. The JAX package hands the children the merged chroma
        # windows, so a descended GOLDEN or ALTREF parent's children,
        # serialized as LAST blocks, were predicted from another
        # reference's chroma than a decoder reads
        out.update(wins=wins, dy=me["dy"], dx=me["dx"],
                   planes=(me["ref_y"], ref_u, ref_v), grid=grid)
    return out


def _merge4(blocks, k: int, n: int):
    """(4K, n, n) children in k*4 + 2*i + j order -> (K, 2n, 2n)."""
    return blocks.reshape(k, 2, 2, n, n).permute(0, 1, 3, 2, 4) \
        .reshape(k, 2 * n, 2 * n)


def descent_gather_ref(sel_idx, wins, dy, dx, parent_mv, src_y, src_u,
                       src_v, ref_y, geom: Geom):
    """The descent's gathers for the 4K children of the K parents
    ``sel_idx`` (plain version of the kernel behind ``ops/cuda_kernels.py:
    descent_gather``, same arguments): each child's 40x40 search window,
    a 16-block of its parent's (SW, SW) LAST window (one 64x64 union slice
    per parent around its full-pel winner (dy, dx), clipped into the
    window, and four 40x40 sub-slices of it), its luma and chroma source
    blocks, sum(src^2), its exact ZERO SSE against the co-located block of
    ``ref_y`` (LAST's border-extended luma, at the child's position plus
    BORDER), and the int32 vectors the descent reads (the map centre's
    displacement, the child's position, its offset in the parent's window,
    the window index, the parent's final MV). Child order: k*4 + 2*i + j
    for parent sel_idx[k], child row i, column j. Returns a dict ``cw``,
    ``csrc``, ``csrc_u``, ``csrc_v`` and the keys of
    ``cuda_kernels.GATHER_INTS``."""
    g = geom
    dev = src_y.device
    sel = sel_idx.long()
    k = sel.shape[0]
    cols32, rows32 = g.cols32, g.rows32
    cols16 = cols32 * 2
    pr = sel // cols32
    pc = sel % cols32
    wk = wins[sel]                              # (K, SW, SW)
    sw = wk.shape[-1]
    s_y = (dy[sel] + 36).clamp(0, sw - 64)
    s_x = (dx[sel] + 36).clamp(0, sw - 64)
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
    csrc_u, csrc_v = (_extract_blocks(plane, 0, rows32 * 2, cols16, 8)[cidx]
                      for plane in (src_u, src_v))
    cref = _extract_blocks(ref_y[:, BORDER:], BORDER, rows32 * 2, cols16,
                           16)[cidx]
    diff = csrc.to(torch.int32) - cref.to(torch.int32)
    return {
        "cw": cw, "csrc": csrc, "csrc_u": csrc_u, "csrc_v": csrc_v,
        "src2": _block_sq_sum(csrc),
        "sse_zero": (diff * diff).sum(dim=(1, 2), dtype=torch.int32),
        "base_y": base_y, "base_x": base_x,
        "pos_y": (c_row * 16).reshape(-1).to(torch.int32),
        "pos_x": (c_col * 16).reshape(-1).to(torch.int32),
        "off_y": (ii * 16).repeat(k).to(torch.int32),
        "off_x": (jj * 16).repeat(k).to(torch.int32),
        "win_idx": sel.to(torch.int32).repeat_interleave(4),
        "par_r": parent_mv[sel, 0].repeat_interleave(4),
        "par_c": parent_mv[sel, 1].repeat_interleave(4),
    }


def descent_gather(sel_idx, wins, dy, dx, parent_mv, src_y, src_u, src_v,
                   ref_y, geom: Geom):
    """The descent's gathers and the children's ZERO SSE (contract:
    ``descent_gather_ref``). Tensors that all lie on the CPU take the
    plain version; anything else goes to the CUDA kernel's wrapper, which
    launches or raises."""
    if all(t.device.type == "cpu" for t in (sel_idx, wins, dy, dx,
                                            parent_mv, src_y, src_u, src_v,
                                            ref_y)):
        return descent_gather_ref(sel_idx, wins, dy, dx, parent_mv, src_y,
                                  src_u, src_v, ref_y, geom)
    return cuda_kernels.descent_gather(sel_idx, wins, dy, dx, parent_mv,
                                       src_y, src_u, src_v, ref_y, geom,
                                       BORDER)


def descent_decide_ref(ssem_c, sse_zero, sse_new, sub_r, sub_c, src2,
                       base_y, base_x, par_r, par_c, lam: int, new_bits,
                       rates=None):
    """The children's candidate decision (plain version of the kernel
    behind ``ops/cuda_kernels.py:descent_decide``, its arguments but
    ``proxy``, which is ``CAND_RATE_PROXY``'s here): {ZERO, NEW, PARENT},
    NEW at (base * 8 + sub), PARENT (the parent's final MV) scored at its
    entry of the child's SSE map plus src2; with ``rates`` the entropy
    tables' costs (NEW's mvd against PARENT), else SSE + lam * rate with
    NEW's rate ``new_bits[mvd]``; first minimum. Returns (mv_r, mv_c,
    (4K, 2) int16 mv)."""
    dev = sse_zero.device
    nch = sse_zero.shape[0]
    mv_new_r = base_y * 8 + sub_r
    mv_new_c = base_x * 8 + sub_c
    rch = CHILD_R
    dch = 2 * rch + 1
    fy = (((par_r + 4) >> 3) - base_y).clamp(-rch, rch) + rch
    fx = (((par_c + 4) >> 3) - base_x).clamp(-rch, rch) + rch
    sse_par = ssem_c.reshape(nch, dch * dch).gather(
        1, (fy * dch + fx).long()[:, None])[:, 0] + src2

    zero = torch.zeros_like(mv_new_r)
    cand_r = torch.stack([zero, mv_new_r, par_r])
    cand_c = torch.stack([zero, mv_new_c, par_c])
    sads = torch.stack([sse_zero, sse_new, sse_par])
    if rates is not None:
        mc = rates["mode_cost"]
        ones = torch.ones_like(mv_new_r)
        mvd_bits = _mvd_bits(rates, mv_new_r - par_r, mv_new_c - par_c)
        rate = torch.stack([mc[2] * ones, mc[3] + mvd_bits, mc[0] * ones])
        costs = _table_costs(sads, rate, rates["lam_bits"])
    else:
        rz, _, _, _, rs = CAND_RATE_PROXY
        mvd = (mv_new_r - par_r).abs() + (mv_new_c - par_c).abs()
        ones = torch.ones((nch,), dtype=torch.float32, device=dev)
        rate = torch.stack([rz * ones, new_bits[mvd.long()], rs * ones])
        costs = sads.to(torch.float32) + float(lam) * rate
    (mv_r, mv_c), _, _ = _first_min(costs, (cand_r, cand_c))
    return mv_r, mv_c, torch.stack([mv_r, mv_c], dim=-1).to(torch.int16)


def descent_decide(ssem_c, sse_zero, sse_new, sub_r, sub_c, src2, base_y,
                   base_x, par_r, par_c, sc, new_bits, rates=None):
    """The children's candidate decision (contract: ``descent_decide_ref``,
    its lam the word of the step's row ``sc``). Tensors that all lie on
    the CPU take the plain version; anything else goes to the CUDA
    kernel's wrapper, which launches or raises."""
    tabs = () if rates is None else tuple(rates[k] for k in RATE_TENSORS)
    if all(t.device.type == "cpu" for t in (ssem_c, sse_zero, sse_new,
                                            sub_r, sub_c, src2, base_y,
                                            base_x, par_r, par_c, new_bits,
                                            *tabs, sc)):
        return descent_decide_ref(ssem_c, sse_zero, sse_new, sub_r, sub_c,
                                  src2, base_y, base_x, par_r, par_c,
                                  _row_ints(sc)[SC_LAM], new_bits, rates)
    return cuda_kernels.descent_decide(
        ssem_c, sse_zero, sse_new, sub_r, sub_c, src2, base_y, base_x,
        par_r, par_c, sc, new_bits, rates,
        (CAND_RATE_PROXY[0], CAND_RATE_PROXY[4]))


def descent_decide_mc_ref(ssem_c, sse_zero, sse_new, sub_r, sub_c, src2,
                          base_y, base_x, par_r, par_c, lam: int, new_bits,
                          rates, planes, pos_y, pos_x, n: int, mi_rows: int,
                          mi_cols: int, filters, grid, win_idx, org_off_y,
                          org_off_x):
    """The children's decision and their MC (plain version of the kernel
    behind ``ops/cuda_kernels.py:descent_decide_mc``, its arguments but
    ``proxy``, which is ``CAND_RATE_PROXY``'s here): ``descent_decide_ref``,
    then ``mc_predict_planes_ref`` with its MVs in LAST's ``planes`` at
    the zone's grid, by the window index and the offsets. Returns (mv_r,
    mv_c, mv (4K, 2) int16, pred_y, pred_u, pred_v)."""
    mv_r, mv_c, mv = descent_decide_ref(ssem_c, sse_zero, sse_new, sub_r,
                                        sub_c, src2, base_y, base_x, par_r,
                                        par_c, lam, new_bits, rates)
    preds = mc_predict_planes_ref(planes, pos_y, pos_x, mv_r, mv_c, n,
                                  mi_rows, mi_cols, filters, grid,
                                  win_idx=win_idx, org_off_y=org_off_y,
                                  org_off_x=org_off_x)
    return (mv_r, mv_c, mv, *preds)


def descent_decide_mc(ssem_c, sse_zero, sse_new, sub_r, sub_c, src2, base_y,
                      base_x, par_r, par_c, sc, new_bits, rates, planes,
                      pos_y, pos_x, n: int, mi_rows: int, mi_cols: int,
                      filters, grid, win_idx, org_off_y, org_off_x):
    """The children's decision and their MC in one launch (contract:
    ``descent_decide_mc_ref``, its lam the word of the step's row ``sc``;
    the first thirteen arguments are
    ``descent_decide``'s, the rest ``mc_predict``'s but the MVs). Tensors
    that all lie on the CPU take the plain version; anything else goes to
    the CUDA kernel's wrapper with the grid's windows as
    ``mc_window_grid`` places them, which launches or raises (with rates,
    it reads the mode costs and lam_bits from their device row)."""
    tabs = () if rates is None else tuple(rates[k] for k in RATE_TENSORS)
    if all(t.device.type == "cpu" for t in (
            ssem_c, sse_zero, sse_new, sub_r, sub_c, src2, base_y, base_x,
            par_r, par_c, new_bits, *tabs, *planes[0], pos_y, pos_x,
            win_idx, org_off_y, org_off_x, sc)):
        return descent_decide_mc_ref(ssem_c, sse_zero, sse_new, sub_r, sub_c,
                                     src2, base_y, base_x, par_r, par_c,
                                     _row_ints(sc)[SC_LAM], new_bits, rates,
                                     planes, pos_y, pos_x, n, mi_rows,
                                     mi_cols, filters, grid, win_idx,
                                     org_off_y, org_off_x)
    shapes = tuple(tuple(t.shape) for t in planes[0])
    return cuda_kernels.descent_decide_mc(
        ssem_c, sse_zero, sse_new, sub_r, sub_c, src2, base_y, base_x,
        par_r, par_c, sc, new_bits, rates,
        (CAND_RATE_PROXY[0], CAND_RATE_PROXY[4]), planes, pos_y, pos_x, n,
        mi_rows, mi_cols, mc_window_grid(shapes, tuple(grid)), win_idx,
        org_off_y, org_off_x)


def descent_pack_ref(eob_y, eob_u, eob_v, lv_y, lv_u, lv_v, rec_y, rec_u,
                     rec_v, csrc):
    """The children's pack (plain version of the kernel behind
    ``ops/cuda_kernels.py:descent_pack``, same arguments): skip, the
    parents' sums of their children's recon SSE (``rec_y`` against the
    luma source ``csrc``) and nonzero levels, and the children's recon
    merged into the parents' blocks. Returns a dict skip, dist4, rate4,
    rec_y32, rec_u16, rec_v16."""
    k = eob_y.shape[0] // 4
    skip = (eob_y == 0) & (eob_u == 0) & (eob_v == 0)
    d = rec_y.to(torch.int32) - csrc.to(torch.int32)
    dist_c = (d * d).sum(dim=(1, 2))
    rate_c = ((lv_y != 0).sum(dim=(1, 2)) + (lv_u != 0).sum(dim=(1, 2))
              + (lv_v != 0).sum(dim=(1, 2)))
    return {
        "skip": skip,
        "dist4": dist_c.reshape(k, 4).sum(dim=1),
        "rate4": rate_c.reshape(k, 4).sum(dim=1),
        "rec_y32": _merge4(rec_y, k, 16),
        "rec_u16": _merge4(rec_u, k, 8),
        "rec_v16": _merge4(rec_v, k, 8),
    }


def descent_pack(eob_y, eob_u, eob_v, lv_y, lv_u, lv_v, rec_y, rec_u, rec_v,
                 csrc):
    """The children's pack (contract: ``descent_pack_ref``). Tensors that
    all lie on the CPU take the plain version; anything else goes to the
    CUDA kernel's wrapper, which launches or raises."""
    if all(t.device.type == "cpu" for t in (eob_y, eob_u, eob_v, lv_y, lv_u,
                                            lv_v, rec_y, rec_u, rec_v,
                                            csrc)):
        return descent_pack_ref(eob_y, eob_u, eob_v, lv_y, lv_u, lv_v, rec_y,
                                rec_u, rec_v, csrc)
    return cuda_kernels.descent_pack(eob_y, eob_u, eob_v, lv_y, lv_u, lv_v,
                                     rec_y, rec_u, rec_v, csrc)


def encode_children_masked(src_y, src_u, src_v, ref_y, parent_me,
                           parent_mv, sel_idx, geom: Geom, sc, filters,
                           new_bits, rates=None):
    """Masked 32->16 descent: encode the four 16x16 children of the K
    selected parents only (``tpu_vp9/pipeline/tpu_encdec.py:
    encode_children_masked``).

    parent_me: {"wins", "dy", "dx", "planes", "grid"} from the 32 zone: the
    children search +-CHILD_R inside their parent's LAST window
    (``descent_gather``, which takes their ZERO SSE against ``ref_y``, the
    co-located block of LAST's bordered luma) and are compensated out of
    the parent's luma and chroma windows, read in place in LAST's planes
    at the zone's window grid, through per-child origin offsets. parent_mv:
    (B32, 2) int32 final q3 MVs of the parents (the PARENT candidate,
    scored at its entry of the child's SSE map). sel_idx: (K,) raster
    parent indices; sc: the step's row of scalars (``step_scalars``).
    Candidates {ZERO, NEW, PARENT}, first minimum, decided in the
    children's MC launch (``descent_decide_mc``). Child order: k*4 +
    2*i + j for parent
    sel_idx[k], child row i, column j.
    Returns per-child arrays (4K: mv, skip, eob_*, lv_*), sel_idx, and
    per-parent dist4, rate4 and the merged recon blocks rec_y32, rec_u16,
    rec_v16 (``descent_pack``).
    """
    g = geom
    sel = sel_idx.to(torch.int32)
    with _stage("step_children"):
        ga = descent_gather(sel, parent_me["wins"], parent_me["dy"],
                            parent_me["dx"], parent_mv, src_y, src_u, src_v,
                            ref_y, g)
        csrc, cw = ga["csrc"], ga["cw"]
        ddy, ddx, ssem_c = sse_map_search(csrc, cw, 16, CHILD_R)
        sub_r, sub_c, sse_new = subpel_search(cw, csrc, ddy, ddx, 16,
                                              CHILD_R)
        # the decision and MC out of the parent windows, read in place,
        # in one launch (every child candidate is reachable there; org_off
        # = the child's offset inside the parent)
        _, _, mv, pred_y, pred_u, pred_v = descent_decide_mc(
            ssem_c, ga["sse_zero"], sse_new, sub_r, sub_c, ga["src2"],
            ga["base_y"], ga["base_x"], ga["par_r"], ga["par_c"], sc,
            new_bits, rates, [parent_me["planes"]], ga["pos_y"],
            ga["pos_x"], 16, g.mi_rows, g.mi_cols, filters,
            parent_me["grid"], ga["win_idx"], ga["off_y"], ga["off_x"])
        lv_u, eob_u, rec_u = transform_recon(ga["csrc_u"], pred_u, sc, 8)
        lv_v, eob_v, rec_v = transform_recon(ga["csrc_v"], pred_v, sc, 8)
        lv_y, eob_y, rec_y = transform_recon(csrc, pred_y, sc, 16)
        packed = descent_pack(eob_y, eob_u, eob_v, lv_y, lv_u, lv_v, rec_y,
                              rec_u, rec_v, csrc)
    return {
        "mv": mv,
        "skip": packed["skip"],
        "eob_y": eob_y, "eob_u": eob_u, "eob_v": eob_v,
        "lv_y": lv_y, "lv_u": lv_u, "lv_v": lv_v,
        "sel_idx": sel,
        "dist4": packed["dist4"], "rate4": packed["rate4"],
        "rec_y32": packed["rec_y32"], "rec_u16": packed["rec_u16"],
        "rec_v16": packed["rec_v16"],
    }


def descent_parents(score, k: int):
    """Indices of the k largest entries of ``score``, the lower index
    first among equals (what ``lax.top_k`` returns; ``torch.topk``
    promises no order among ties, so this is a stable descending sort).
    The -1 sentinels of non-LAST parents (with GOLDEN) and of the overhang
    row make ties routine."""
    return torch.sort(score, descending=True, stable=True)[1][:k]


def descent_split_ref(sel_idx, dist_b, rate_b, dist4, rate4, rec_y, rec_u,
                      rec_v, rec_y32, rec_u16, rec_v16, lam: int,
                      geom: Geom):
    """The 32-against-4x16 decision and the recon merge (plain version of
    the kernel behind ``ops/cuda_kernels.py:descent_split``, its arguments
    but the split's extra rate): costs dist + lam * rate in float32 (the
    split paying SPLIT_RATE_EXTRA more rate), strict '<' for the split,
    never in the overhang row (mi_rows % 4 == 3); where a parent splits
    its recon blocks become its children's merged ones. Returns (split32
    (rows32, cols32) int32, rec_y, rec_u, rec_v: new planes)."""
    g = geom
    r32, c32, b32 = g.rows32, g.cols32, g.n_blocks32
    sel = sel_idx.long()
    d16 = dist4.to(torch.float32)
    rt16 = rate4.to(torch.float32)
    lam_f = float(lam)
    cost32k = (dist_b[sel].to(torch.float32)
               + lam_f * rate_b[sel].to(torch.float32))
    cost16k = d16 + lam_f * (rt16 + SPLIT_RATE_EXTRA)
    use16 = cost16k < cost32k  # (K,)
    if g.mi_rows % 4 == 3:
        use16 = use16 & (sel < (r32 - 1) * c32)
    split32 = torch.zeros((b32,), dtype=torch.int32, device=sel.device)
    split32[sel] = use16.to(torch.int32)

    def merge(plane, rep, nb):
        blocks = _extract_blocks(plane, 0, r32, c32, nb).clone()
        blocks[sel] = torch.where(use16[:, None, None], rep, blocks[sel])
        return _scatter_blocks(blocks, r32, c32, nb)

    return (split32.reshape(r32, c32), merge(rec_y, rec_y32, 32),
            merge(rec_u, rec_u16, 16), merge(rec_v, rec_v16, 16))


def descent_split(sel_idx, dist_b, rate_b, dist4, rate4, rec_y, rec_u,
                  rec_v, rec_y32, rec_u16, rec_v16, sc, geom: Geom):
    """The split decision and merge (contract: ``descent_split_ref``, its
    lam the word of the step's row ``sc``). Tensors that all lie on the
    CPU take the plain version, which returns
    new planes; anything else goes to the CUDA kernel's wrapper, which
    launches or raises, and which writes the split parents' blocks into
    ``rec_y``, ``rec_u`` and ``rec_v`` in place and returns those planes:
    a caller that still needs the zone's recon clones it first."""
    if all(t.device.type == "cpu" for t in (sel_idx, dist_b, rate_b, dist4,
                                            rate4, rec_y, rec_u, rec_v,
                                            rec_y32, rec_u16, rec_v16, sc)):
        return descent_split_ref(sel_idx, dist_b, rate_b, dist4, rate4,
                                 rec_y, rec_u, rec_v, rec_y32, rec_u16,
                                 rec_v16, _row_ints(sc)[SC_LAM], geom)
    return cuda_kernels.descent_split(sel_idx, dist_b, rate_b, dist4, rate4,
                                      rec_y, rec_u, rec_v, rec_y32, rec_u16,
                                      rec_v16, sc, geom, SPLIT_RATE_EXTRA)


def pframe_step(src_y, src_u, src_v, ref_y, ref_u, ref_v, prev_mv32,
                prev_mv16, geom: Geom, sc, filters, new_bits,
                split16: bool = False, gold=None, alt=None, rates=None,
                descend_frac: int = DESCEND_FRAC, aq: bool = False):
    """One device P-frame encode step (the JAX package's ``pframe_step``).

    src planes: padded (pad_h, pad_w) / (pad_h/2, pad_w/2) uint8 device
    tensors; ref planes: the border-extended previous reconstruction.
    prev_mv32, prev_mv16: (B, 2) int32 q3 MVs of the previous frame, of
    the 32 grid and of the strip's 16x16 blocks (read at a strip geometry
    only). sc: the step's per-frame scalars, the int32 row of
    ``step_scalars`` on the planes' device (dc_q, ac_q, lam, lf_lvl,
    lf_lim, lf_mblim), which every kernel of the step reads on the card.
    split16: descend the B32 // descend_frac parents of the largest
    distortion and decide 32 against 4x16 for each (with GOLDEN, the
    parents that took another reference rank last, as does the overhang
    row, which keeps its 32); a ValueError with a strip geometry, as in
    the JAX package. gold: optional GOLDEN planes; alt: optional ALTREF
    planes (needs ``rates``). rates: optional ``upload_rate_tabs``. aq
    (with ``rates``): the 32 zone and the strip take a per-block rate
    lambda (tune SQ); the children and the split decision keep the
    frame's.
    Returns (outputs dict, new border-extended (ref_y, ref_u, ref_v));
    outputs hold the "m32" zone (with split16 on the card its recon
    planes are the split's, written in place), at a strip geometry the
    strip's "m16",
    with split16 the children "m16f" and "split32", and the loop-filtered
    padded recon planes "rec_y"/"rec_u"/"rec_v". The references are new
    tensors: the inputs are never written.
    """
    g = geom
    if split16 and g.strip:
        raise ValueError("pframe_step: split16 requires a strip-free "
                         "geometry")
    out32 = encode_zone(src_y, src_u, src_v, ref_y, ref_u, ref_v,
                        prev_mv32, g, sc, filters, new_bits, gold=gold,
                        alt=alt, rates=rates, return_me=split16, aq=aq)
    outs = {"m32": out32}
    rec_y, rec_u, rec_v = out32["rec_y"], out32["rec_u"], out32["rec_v"]
    split32 = None
    if split16:
        parent_me = {kk: out32.pop(kk)
                     for kk in ("wins", "dy", "dx", "planes", "grid")}
        with _stage("step_children"):
            score = out32["dist_b"]
            if gold is not None:
                score = torch.where(out32["ref"] > 0, -1, score)
            if g.mi_rows % 4 == 3:
                score = score.clone()
                score[-g.cols32:] = -1
            sel_idx = descent_parents(score,
                                      max(1, g.n_blocks32 // descend_frac))
        out16 = encode_children_masked(
            src_y, src_u, src_v, ref_y, parent_me,
            out32["mv"].to(torch.int32), sel_idx, g, sc, filters, new_bits,
            rates=rates)
        with _stage("step_children"):
            # A parent in the overhang row keeps its 32: its children
            # would need the forced edge partition, which
            # walk_partition_split does not write. The JAX package keeps
            # those parents out through the ranking alone, which selects
            # them once K passes the other parents (always at
            # descend_frac=1).
            split32, rec_y, rec_u, rec_v = descent_split(
                out16["sel_idx"], out32["dist_b"], out32["rate_b"],
                out16.pop("dist4"), out16.pop("rate4"), rec_y, rec_u,
                rec_v, out16.pop("rec_y32"), out16.pop("rec_u16"),
                out16.pop("rec_v16"), sc, g)
        outs["m16f"] = out16
        outs["split32"] = split32
    if g.strip:
        out16 = encode_zone(src_y, src_u, src_v, ref_y, ref_u, ref_v,
                            prev_mv16, g, sc, filters, new_bits, gold=gold,
                            alt=alt, rates=rates, n=16, aq=aq)
        outs["m16"] = out16
        rec_y = torch.cat([rec_y, out16["rec_y"]])
        rec_u = torch.cat([rec_u, out16["rec_u"]])
        rec_v = torch.cat([rec_v, out16["rec_v"]])
    with _stage("step_loop_filter"):
        # pad recon to the full device plane (the coded region is g.width)
        rec_y = _pad_edge(rec_y, g.pad_h, g.pad_w)
        rec_u = _pad_edge(rec_u, g.pad_h // 2, g.pad_w // 2)
        rec_v = _pad_edge(rec_v, g.pad_h // 2, g.pad_w // 2)
        rec_y, rec_u, rec_v = loop_filter_device(rec_y, rec_u, rec_v, g, sc,
                                                 split32=split32)
    outs.update(rec_y=rec_y, rec_u=rec_u, rec_v=rec_v)
    with _stage("step_borders"):
        refs = extend_borders((rec_y, rec_u, rec_v), recon_crops(g))
    return outs, refs


def make_pframe_step(geom: Geom, device, split16: bool = False,
                     golden: bool = False, with_rates: bool = False,
                     altref: bool = False,
                     descend_frac: int = DESCEND_FRAC, aq: bool = False):
    """The step for one geometry on one device, with the filter taps and
    the NEWMV rate-proxy table uploaded once:

        step(src_y, src_u, src_v, ref_y, ref_u, ref_v,
             [gold_y, gold_u, gold_v,]          # golden
             [alt_y, alt_u, alt_v,]             # altref
             prev_mv32, prev_mv16, sc [, rates])  # golden, altref or
                                                  # with_rates

    ``sc`` is the frame's row of scalars, ``step_scalars(dc_q, ac_q, lam,
    lf_lvl, lf_lim, lf_mblim, out=row)``: a caller holds one row on the
    device and refills it before each step, so that no per-frame value is
    a launch argument and every launch of the step is the same from frame
    to frame. ``rates`` is ``upload_rate_tabs(make_rate_tabs(fc, qindex),
    device)``, likewise refilled in place (its ``out``);
    as in the JAX package a GOLDEN or ALTREF step always takes them.
    ``prev_mv16`` is the strip's previous MVs, (cols16, 2), read at a
    strip geometry only (the JAX sessions pass a (1, 2) placeholder
    without a strip). With split16 the descent takes the B32 //
    ``descend_frac`` parents (1: every parent, the random-access
    session's). aq: the adaptive lambda of tune SQ (it takes the rate
    tables). It runs eagerly; there is nothing to compile."""
    device = torch.device(device)
    filters = torch.as_tensor(np.asarray(FILTERS, np.int32), device=device)
    new_bits = new_bits_table(device)
    with_rates = with_rates or golden or altref
    n_refs = 3 * (1 + int(golden) + int(altref))
    n_fixed = 6 + n_refs + (1 if with_rates else 0)

    def step(src_y, src_u, src_v, *rest):
        if len(rest) + 3 != n_fixed:
            raise TypeError(f"step takes {n_fixed} arguments, got "
                            f"{len(rest) + 3}")
        refs = [tuple(rest[i:i + 3]) for i in range(0, n_refs, 3)]
        ref_y, ref_u, ref_v = refs.pop(0)
        gold = refs.pop(0) if golden else None
        alt = refs.pop(0) if altref else None
        rest = rest[n_refs:]
        rates = rest[3] if with_rates else None
        prev_mv32, prev_mv16, sc = rest[:3]
        return pframe_step(src_y, src_u, src_v, ref_y, ref_u, ref_v,
                           prev_mv32, prev_mv16, geom, sc, filters, new_bits,
                           split16=split16, gold=gold, alt=alt, rates=rates,
                           descend_frac=descend_frac, aq=aq)

    return step


# ---------------------------------------------------------------------------
# The device keyframe: the intra wavefront, the loop filter, the borders
# ---------------------------------------------------------------------------


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


def kframe_wave_device(src_y, src_u, src_v, geom: Geom, sc, status=None):
    """The keyframe's intra wavefront (contract: ``kframe_wave_ref``, its
    quantizers and lambda the words of the step's row ``sc``). Planes and
    row that all lie on the CPU take the plain version; anything else
    goes to the CUDA kernel's wrapper, which launches or raises, and which
    appends its launch's error word to the list ``status`` if one is given
    (``cuda_kernels.kframe_wave``; the plain version has none). At a strip
    geometry both encode the 32 zone above the strip."""
    if all(t.device.type == "cpu" for t in (src_y, src_u, src_v, sc)):
        check_kf_args(src_y, src_u, src_v, geom)
        row = _row_ints(sc)
        return kframe_wave_ref(src_y, src_u, src_v, geom, row[SC_DC_Q],
                               row[SC_AC_Q], row[SC_LAM])
    return kframe_wave(src_y, src_u, src_v, geom, sc, status)


# the keyframe strip's candidate modes (above-only: each reads nothing
# but the row above) and their mode prior in lambda units
KF_STRIP_MODES = (T.IntraMode.V_PRED, T.IntraMode.D45_PRED,
                  T.IntraMode.D63_PRED)
KF_STRIP_BIAS = (1, 3, 3)


def _strip_intra_preds(rec, y0: int, nb: int, bs: int, modes):
    """The strip's (nb, len(modes), bs, bs) int32 intra predictions of its
    nb blocks of bs at plane row y0 from the recon plane above them, as
    the JAX package's keyframe strip forms them: above is the recon row
    y0 - 1, above-right repeats above[bs - 1], the above-left is the left
    neighbour's above[bs - 1] (129 for the first block), the left column
    129 and there is no left block."""
    above = rec[y0 - 1, :nb * bs].to(torch.int32).reshape(nb, bs)
    has_left = torch.arange(nb, device=rec.device) >= 1
    al = torch.where(has_left, torch.roll(above[:, -1], 1), 129)
    ref = torch.cat([torch.full((nb, bs), 129, dtype=torch.int32,
                                device=rec.device), al[:, None], above,
                     above[:, -1:].expand(nb, bs)], dim=1)
    preds = predict_intra_all(ref, torch.ones_like(has_left),
                              torch.zeros_like(has_left), bs)
    return preds[:, [int(m) for m in modes]]


@functools.lru_cache(maxsize=None)
def _kf_strip_consts(device):
    """The strip's mode prior (KF_STRIP_BIAS, (3, 1) int32) and its modes'
    IntraMode values (int32) on ``device``, made once (a per-frame host
    tensor would be a copy that waits)."""
    return (torch.tensor(KF_STRIP_BIAS, dtype=torch.int32,
                         device=device)[:, None],
            torch.tensor([int(m) for m in KF_STRIP_MODES], dtype=torch.int32,
                         device=device))


def kframe_strip(src_y, src_u, src_v, rec_y, rec_u, rec_v, geom: Geom, sc):
    """The keyframe's bottom strip of a strip geometry (the JAX package's
    ``kframe_step`` strip branch): every 16x16 block at once, its above
    row the 32 zone's last (unfiltered) recon row. Luma tries V, D45 and
    D63, each through ``transform_recon`` with its mode's transform type
    (ADST_DCT, DCT_DCT, ADST_DCT), and keeps the one of least recon SSE
    (``block_energy``) + KF_STRIP_BIAS * lam, the first on a tie; chroma
    is 8x8 DCT in that mode; the quantizers and lam are the words of the
    step's row ``sc``. Returns ("m16" outputs, the strip's recon rows of
    y, u, v)."""
    g = geom
    sb, y0, y0c = g.cols16, g.strip_y, g.strip_y >> 1
    dev = src_y.device
    src_s = _extract_blocks(src_y, y0, 1, sb, 16)
    preds = _strip_intra_preds(rec_y, y0, sb, 16, KF_STRIP_MODES)
    cands = [transform_recon(src_s, preds[:, i].to(torch.uint8).contiguous(),
                             sc, 16, INTRA_MODE_TO_TX_TYPE[m])
             for i, m in enumerate(KF_STRIP_MODES)]
    k = len(cands)
    recs = torch.cat([c[2] for c in cands])  # candidate-major (k B, 16, 16)
    sse = block_energy(src_s.repeat(k, 1, 1), recs, 16)[0].reshape(k, sb)
    bias, modes = _kf_strip_consts(dev)
    best = torch.argmin(sse + bias * sc[SC_LAM], dim=0)  # the first minimum
    ar = torch.arange(sb, device=dev)

    def pick(i):
        return torch.stack([c[i] for c in cands])[best, ar]

    lv_y, eob_y, recs_y = pick(0), pick(1), pick(2)
    mode = modes[best]
    chroma = []
    for src_c, rec_c in ((src_u, rec_u), (src_v, rec_v)):
        blocks = _extract_blocks(src_c, y0c, 1, sb, 8)
        pc = _strip_intra_preds(rec_c, y0c, sb, 8, KF_STRIP_MODES)
        pred = pc[ar, best].to(torch.uint8)
        chroma.append(transform_recon(blocks, pred, sc, 8))
    (lv_u, eob_u, recs_u), (lv_v, eob_v, recs_v) = chroma
    out = {"mode": mode,
           "skip": (eob_y == 0) & (eob_u == 0) & (eob_v == 0),
           "eob_y": eob_y, "eob_u": eob_u, "eob_v": eob_v,
           "lv_y": lv_y, "lv_u": lv_u, "lv_v": lv_v}
    return out, (_scatter_blocks(recs_y, 1, sb, 16),
                 _scatter_blocks(recs_u, 1, sb, 8),
                 _scatter_blocks(recs_v, 1, sb, 8))


def kframe_step(src_y, src_u, src_v, geom: Geom, sc):
    """The closed-loop intra keyframe encode on the device (the JAX
    package's ``kframe_step``).

    src planes: padded (pad_h, pad_w) / (pad_h/2, pad_w/2) uint8 tensors;
    sc: the frame's row of scalars (``step_scalars``, the keyframe's
    lambda and filter level) on their device. The 32x32 blocks are encoded
    in wave order (``kframe_wave_device``: a
    CUDA kernel for CUDA planes, its plain version for CPU planes); at a
    strip geometry the strip's 16x16 blocks after them
    (``kframe_strip``); the recon is edge-padded to the device planes,
    loop filtered frame-wide at ``lf_lvl`` and border-extended. Returns
    (outputs, new border-extended (ref_y, ref_u, ref_v)); outputs hold
    "m32" (mode, skip, eob_y/u/v, lv_y/u/v in raster block order), at a
    strip geometry "m16" (the same of the strip's blocks), the filtered
    planes "rec_y"/"rec_u"/"rec_v" and "kf_status", the kernel's error
    word (a one-element int32 tensor, zero for the plain version), which
    whoever fetches the outputs checks with
    ``cuda_kernels.kf_check_status``.
    """
    g = geom
    status = []
    (mode, lv_y, lv_u, lv_v, eob_y, eob_u, eob_v, rec_y, rec_u,
     rec_v) = kframe_wave_device(src_y, src_u, src_v, g, sc, status)
    outs = {"m32": {
        "mode": mode, "skip": (eob_y == 0) & (eob_u == 0) & (eob_v == 0),
        "eob_y": eob_y, "eob_u": eob_u, "eob_v": eob_v,
        "lv_y": lv_y, "lv_u": lv_u, "lv_v": lv_v},
        "kf_status": status[0] if status else torch.zeros(
            1, dtype=torch.int32, device=mode.device)}
    if g.strip:
        outs["m16"], strip = kframe_strip(src_y, src_u, src_v, rec_y, rec_u,
                                          rec_v, g, sc)
        rec_y, rec_u, rec_v = (torch.cat([a, b]) for a, b in
                               zip((rec_y, rec_u, rec_v), strip))
    rec_y = _pad_edge(rec_y, g.pad_h, g.pad_w)
    rec_u = _pad_edge(rec_u, g.pad_h // 2, g.pad_w // 2)
    rec_v = _pad_edge(rec_v, g.pad_h // 2, g.pad_w // 2)
    rec_y, rec_u, rec_v = loop_filter_device(rec_y, rec_u, rec_v, g, sc)
    outs.update(rec_y=rec_y, rec_u=rec_u, rec_v=rec_v)
    refs = extend_borders((rec_y, rec_u, rec_v), recon_crops(g))
    return outs, refs


def make_kframe_step(geom: Geom, device):
    """The keyframe step for one geometry on one device:

        step(src_y, src_u, src_v, sc)

    ``sc``: the frame's row of scalars, ``step_scalars(dc_q, ac_q, lam,
    lf_lvl, lf_lim, lf_mblim, out=row)`` refilled in a row the caller
    holds, as the P-frame step takes it (its lambda and filter level the
    keyframe's). Refuses planes that do not lie on ``device``'s kind of
    device."""
    kind = torch.device(device).type

    def step(src_y, src_u, src_v, sc):
        if any(t.device.type != kind for t in (src_y, src_u, src_v)):
            raise ValueError(f"the keyframe step for {kind} was given "
                             "planes on another device")
        return kframe_step(src_y, src_u, src_v, geom, sc)

    return step
