"""Hand-written CUDA kernels: the counterpart of ``tpu_vp9/ops/pallas_kernels.py``.

  tpu_vp9/ops/pallas_kernels.py        here
  sad_full_search (_sad_search_kernel) sad_full_search (csrc/sad_search.cu)
  block_energy (_block_energy_kernel)  block_energy (csrc/block_energy.cu)
  txq_cost (_txq_cost_kernel)          txq_cost (csrc/txq_cost.cu)

so every function there that reaches ``pl.pallas_call`` has its
counterpart here; and two XLA stages of the realtime P-frame step, which
the JAX package writes in jnp:

  tpu_vp9/pipeline/tpu_encdec.py       here
  _full_search_sse_mxu                 sse_map_search (csrc/sse_search.cu)
  hier_search (both levels)            hier_search_fused (the same source)
  _subpel_exhaustive                   subpel_search (csrc/subpel_search.cu)
  transform_recon                      transform_recon
                                       (csrc/transform_recon.cu)
  loop_filter_device                   loop_filter (csrc/loop_filter.cu)
  kframe_step (the intra wavefront)    kframe_wave (csrc/kframe_wave.cu)
  mc_predict_from_wins (and            mc_predict (csrc/mc_predict.cu)
    _clamp_mv_umv)
  encode_children_masked, pframe_step  descent_gather, descent_decide,
    (the split16 descent's gathers,    descent_pack, descent_split
    candidate decision, pack and its   (csrc/descent.cu)
    recon SSE, split merge)
  _ssem_gather, _candidate_decide,     mode_decide (csrc/mode_decide.cu)
    encode_zone's GOLDEN and ALTREF
    decisions
  the decisions, then MC              mode_decide_mc, descent_decide_mc
                                       (csrc/mc_predict.cu's decided
                                       instances; both decisions' device
                                       code is csrc/decide.cuh)
  _extract_search_windows              extract_windows (csrc/windows.cu)
  extend_borders_device                extend_borders (the same source)
  _sb_lambda_scale (tune SQ)           aq_scale (csrc/aq_scale.cu)

and the device stage of the host route's keyframe hints:

  tpu_vp9/pipeline/tpu_intra.py        here
  decide_modes_openloop                openloop_modes
                                       (csrc/openloop_modes.cu)

``block_energy_at`` is ``block_energy`` with the prediction read in place
out of a plane at per-block starts, for several candidate sets at once.

Every kernel has a plain PyTorch version beside it (``*_ref``). The wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises. Each wrapper counts its launches in its
``launches`` attribute, so a run can show that it went through the kernel.
``subpel_search``, ``mc_predict``, ``transform_recon``, ``loop_filter``,
``kframe_wave``, the four ``descent_*``, ``mode_decide``,
``mode_decide_mc``, ``descent_decide_mc``, ``extract_windows``,
``extend_borders`` and ``aq_scale`` take CUDA tensors only: their plain
versions are the steps' own (``pipeline/tpu_encdec.py``:
``subpel_search_ref``, ``mc_predict_ref``, ``transform_recon_ref``,
``loop_filter_ref``, ``kframe_wave_ref``, ``descent_*_ref``,
``mode_decide_ref``, ``mode_decide_mc_ref``, ``descent_decide_mc_ref``,
``_extract_search_windows``, ``extend_borders_device``, ``aq_scale_ref``),
and the steps' dispatches of the same names (``loop_filter_device``,
``kframe_wave_device`` for those two) send CPU tensors there and CUDA
tensors here. The decided MC launches count as ``mc_predict``'s
(``LAUNCH_COUNTERS``). This module imports nothing of
``pipeline``.

The step's per-frame scalars (the quantizers, the lambda, the loop
filter's level and limits) reach the kernels as one int32 device row
(``STEP_SCALARS``), the rate tables' as another (``RATE_SCALARS``): the
wrappers of the step's kernels take the row where they took host numbers,
and pass its pointer, so that a step's launch words are the same from
frame to frame (``LAUNCH_RECORDER`` shows it). The plain versions take
the row's values as ints.
"""

from __future__ import annotations

import array
import ctypes
import functools

import numpy as np
import torch

from tpu_vp9_torch.ops._build import load_library

SAD_BLOCK_SIZES = (8, 16, 32, 64)
SAD_MAX_RANGE = 32
ENERGY_BLOCK_SIZES = (8, 16, 32, 64)
SSE_BLOCK_SIZES = (8, 16, 32)
# dynamic shared memory one search level may use: an H100's
# sharedMemPerBlockOptin (227 KB), less the kernel's static words
# (csrc/sse_search.cu, which opts a level past 48 KB in and checks the
# device's own limit)
SSE_SMEM_BYTES = 227 * 1024 - 512
TXQ_BLOCK_SIZES = (4, 8, 16, 32)
TXQ_BIAS = 0.38  # the dead zone's rounding bias
# the hierarchical search's reaches (pipeline/tpu_encdec.py has the same)
WIN_R, HALF_R, REFINE_R = 40, 18, 4
# the chroma MC windows' reach: 40.75 / 2 pel rounded up (the step imports
# it from here)
CHROMA_WIN_R = 21
HIER_BLOCK_SIZES = (32,)  # the sizes hier_search_fused is built for
# the kinds of CTA of loop_filter, as bits of its ``parts`` argument: a
# luma tile (one superblock column and row of the luma plane), a chroma
# tile (the same of u and v)
LF_PARTS = {"luma tiles": 1, "chroma tiles": 2}
LF_ALL_PARTS = 3
# the largest frame side VP9 codes (16-bit size fields); the loop filter
# refuses planes beyond it
VP9_MAX_SIDE = 1 << 16
# check block_energy_at's starts on the card as well (a device-to-host
# sync per call; the CPU path always checks)
CHECK_STARTS = False
# the step's per-frame scalars: one int32 row on the device, in this order
# (csrc/step_scalars.cuh has the same; ``pipeline/tpu_encdec.py:
# step_scalars`` makes and checks it). The kernels of the step read their
# words from it, so that no per-frame value is a launch argument.
STEP_SCALARS = ("dc_q", "ac_q", "lam", "lf_lvl", "lf_lim", "lf_mblim")

# (library, C function, number of pointer args, of float args, of int
# args), in the C function's argument order; every launcher ends with the
# stream pointer and returns cudaGetLastError()
_LAUNCHERS = {
    "sad_full_search": ("sad_search", "sad_full_search_launch", 5, 0, 3),
    "block_energy": ("block_energy", "block_energy_launch", 4, 0, 2),
    "block_energy_at": ("block_energy", "block_energy_at_launch", 6, 0, 4),
    "sse_map_search": ("sse_search", "sse_map_search_launch", 5, 0, 5),
    "hier_search_fused": ("sse_search", "hier_search_launch", 5, 0, 2),
    "txq_cost": ("txq_cost", "txq_cost_launch", 4, 2, 2),
    "loop_filter": ("loop_filter", "loop_filter_launch", 8, 0, 8),
    "kframe_wave": ("kframe_wave", "kframe_wave_launch", 16, 0, 5),
    "transform_recon": ("transform_recon", "transform_recon_launch", 9, 0,
                        3),
    "subpel_search": ("subpel_search", "subpel_search_launch", 8, 0, 3),
    "mc_predict": ("mc_predict", "mc_predict_launch", 21, 0, 23),
    "openloop_modes": ("openloop_modes", "openloop_modes_launch", 5, 0, 4),
    "descent_gather": ("descent", "descent_gather_launch", 14, 0, 8),
    "descent_decide": ("descent", "descent_decide_launch", 18, 2, 3),
    "descent_pack": ("descent", "descent_pack_launch", 16, 0, 1),
    "descent_split": ("descent", "descent_split_launch", 13, 1, 4),
    "mode_decide": ("mode_decide", "mode_decide_launch", 22, 3, 8),
    "mode_decide_mc": ("mc_predict", "mc_predict_zone_launch", 1, 3, 0),
    "descent_decide_mc": ("mc_predict", "mc_predict_children_launch", 1, 2,
                          0),
    "extract_windows": ("windows", "extract_windows_launch", 1, 0, 3),
    "extend_borders": ("windows", "extend_borders_launch", 6, 0, 2),
    "aq_scale": ("aq_scale", "aq_scale_launch", 4, 0, 2),
}
_fns: dict = {}
# the launchers whose wrapper counts its launches in another wrapper's
# count: the decisions folded into MC are instances of mc_predict's kernel
LAUNCH_COUNTERS = {"mode_decide_mc": "mc_predict",
                   "descent_decide_mc": "mc_predict"}
# None, or a callable (name, words) that ``_launch`` hands every launch's
# non-pointer words: its float and int arguments, then the ints a launcher
# reads out of host arrays (the decided MC's and the windows' words). A
# measurement sets it to show that a step's launches do not change from
# frame to frame; it costs nothing when None.
LAUNCH_RECORDER = None


def _kernel(name: str):
    """The ctypes launcher of a kernel, building its library at first use."""
    lib, sym, n_ptr, n_float, n_int = _LAUNCHERS[name]
    fn = getattr(load_library(lib), sym)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_float] * n_float
                   + [ctypes.c_int] * n_int + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _fns[name] = fn
    return fn


# the current stream's handle without building a Stream object, and the
# current device without torch.cuda's lazy-init check, where this torch
# has the calls (a few microseconds a launch)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
_get_device = getattr(torch._C, "_cuda_getDevice", None)


def _launch(name: str, device, *args, words=None) -> None:
    """Launch a kernel on the current stream of ``device``; raise if the
    launch was refused. The launcher is resolved once; the device is
    switched to only where it is not the current one. ``words``: a
    callable giving the non-pointer ints of the launcher's host arrays,
    called for ``LAUNCH_RECORDER`` only."""
    if LAUNCH_RECORDER is not None:
        LAUNCH_RECORDER(name, (*args[_LAUNCHERS[name][2]:],
                               *(words() if words is not None else ())))
    fn = _fns.get(name) or _kernel(name)
    idx = device.index
    if idx is None or idx == (_get_device or torch.cuda.current_device)():
        if _raw_stream is not None and idx is not None:
            err = fn(*args, _raw_stream(idx))
        else:
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(idx):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _device_kind(name: str, *tensors) -> str:
    """'cpu' or 'cuda' for tensors that share one device; raise otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: inputs on different devices "
                             f"{[str(t.device) for t in tensors]}")
    if dev.type == "cpu":
        return "cpu"
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return "cuda"


def _want_row(name: str, sc, device) -> None:
    """Raise unless ``sc`` is a step's row of scalars: a contiguous
    (len(STEP_SCALARS),) int32 tensor on ``device`` (its values were
    checked where it was filled; reading them here would wait for the
    card)."""
    if (not isinstance(sc, torch.Tensor) or sc.dtype != torch.int32
            or sc.shape != (len(STEP_SCALARS),) or not sc.is_contiguous()
            or sc.device != device):
        got = (f"{tuple(sc.shape)} {sc.dtype} on {sc.device}"
               if isinstance(sc, torch.Tensor) else type(sc).__name__)
        raise TypeError(f"{name}: the step's scalars are a contiguous "
                        f"({len(STEP_SCALARS)},) int32 row on {device} "
                        f"(step_scalars), got {got}")


def _want_blocks(what: str, t, b: int, h: int, w: int) -> None:
    """Raise unless ``t`` ("kernel: argument" in ``what``) has shape
    (b, h, w)."""
    if t.dim() != 3 or t.shape[0] != b or t.shape[1] != h or t.shape[2] != w:
        raise ValueError(f"{what} shape {tuple(t.shape)}, want "
                         f"({b}, {h}, {w})")


def _check_sad_args(src_blocks, regions, n: int, r: int) -> None:
    if n not in SAD_BLOCK_SIZES:
        raise ValueError(f"sad_full_search: n={n} not in {SAD_BLOCK_SIZES}")
    if not 1 <= r <= SAD_MAX_RANGE:
        raise ValueError(f"sad_full_search: r={r} outside [1, "
                         f"{SAD_MAX_RANGE}]")
    win = n + 2 * r
    b = src_blocks.shape[0]
    _want_blocks("sad_full_search: src_blocks", src_blocks, b, n, n)
    _want_blocks("sad_full_search: regions", regions, b, win, win)
    if src_blocks.dtype != torch.uint8 or regions.dtype != torch.uint8:
        raise TypeError("sad_full_search: inputs must be uint8, got "
                        f"{src_blocks.dtype} and {regions.dtype}")


def sad_full_search_ref(src_blocks, regions, n: int, r: int):
    """Plain PyTorch exhaustive full-pel SAD search.

    Same contract as ``sad_full_search``: src_blocks (B, n, n) uint8,
    regions (B, n+2r, n+2r) uint8 with displacement (0, 0) at offset
    (r, r). Returns (dy, dx, sad) int32 of shape (B,); ties go to the
    first candidate in dy-major order.
    """
    b = src_blocks.shape[0]
    d = 2 * r + 1
    src = src_blocks.to(torch.int32)  # widen before subtracting: uint8 wraps
    reg = regions.to(torch.int32)
    sads = torch.empty((b, d, d), dtype=torch.int32, device=src.device)
    for dy in range(d):
        wins = reg[:, dy:dy + n, :].unfold(2, n, 1)  # (B, n, D, n)
        sads[:, dy] = (wins - src[:, :, None, :]).abs().sum(dim=(1, 3),
                                                            dtype=torch.int32)
    flat = sads.reshape(b, d * d)
    idx = torch.argmin(flat, dim=1)  # documented to return the first minimum
    sad = flat.gather(1, idx[:, None])[:, 0]
    dy = (idx // d - r).to(torch.int32)
    dx = (idx % d - r).to(torch.int32)
    return dy, dx, sad


def sad_full_search(src_blocks, regions, n: int, r: int):
    """Exhaustive full-pel SAD search for B blocks at once.

    src_blocks: (B, n, n) uint8; regions: (B, n+2r, n+2r) uint8 with
    displacement (0, 0) at region offset (r, r); n in {8, 16, 32, 64},
    1 <= r <= 32. Returns (dy, dx, sad) int32 tensors of shape (B,) on the
    inputs' device. CUDA inputs run the kernel of ``csrc/sad_search.cu``;
    CPU inputs run ``sad_full_search_ref``.
    """
    _check_sad_args(src_blocks, regions, n, r)
    if _device_kind("sad_full_search", src_blocks, regions) == "cpu":
        return sad_full_search_ref(src_blocks, regions, n, r)
    b = src_blocks.shape[0]
    out = torch.empty((3, b), dtype=torch.int32, device=src_blocks.device)
    if b == 0:
        return out[0], out[1], out[2]
    _launch("sad_full_search", src_blocks.device, src_blocks.data_ptr(),
            regions.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), b, n, r)
    sad_full_search.launches += 1
    return out[0], out[1], out[2]


sad_full_search.launches = 0


def _check_energy_args(src_blocks, pred_blocks, n: int) -> None:
    if n not in ENERGY_BLOCK_SIZES:
        raise ValueError(f"block_energy: n={n} not in {ENERGY_BLOCK_SIZES}")
    b = src_blocks.shape[0]
    _want_blocks("block_energy: src_blocks", src_blocks, b, n, n)
    _want_blocks("block_energy: pred_blocks", pred_blocks, b, n, n)
    if src_blocks.dtype != torch.uint8 or pred_blocks.dtype != torch.uint8:
        raise TypeError(f"block_energy: inputs must be uint8, got "
                        f"{src_blocks.dtype} and {pred_blocks.dtype}")


def block_energy_ref(src_blocks, pred_blocks, n: int):
    """Plain PyTorch per-block (SSE, SAD) of src - pred, int32 (B,) each."""
    d = src_blocks.to(torch.int32) - pred_blocks.to(torch.int32)
    return ((d * d).sum(dim=(1, 2), dtype=torch.int32),
            d.abs().sum(dim=(1, 2), dtype=torch.int32))


def block_energy(src_blocks, pred_blocks, n: int):
    """(SSE, SAD) of src - pred per block: the distortion kernel.

    src_blocks, pred_blocks: (B, n, n) uint8, n in {8, 16, 32, 64}.
    Returns (sse, sad) int32 tensors of shape (B,) on the inputs' device,
    as ``tpu_vp9.ops.pallas_kernels.block_energy``. CUDA inputs run the
    kernel of ``csrc/block_energy.cu``; CPU inputs run
    ``block_energy_ref``.
    """
    _check_energy_args(src_blocks, pred_blocks, n)
    if _device_kind("block_energy", src_blocks, pred_blocks) == "cpu":
        return block_energy_ref(src_blocks, pred_blocks, n)
    src_ptr, pred_ptr = src_blocks.data_ptr(), pred_blocks.data_ptr()
    if src_ptr % 16 or pred_ptr % 16:
        raise ValueError("block_energy: inputs must start on a 16-byte "
                         "boundary")
    b = src_blocks.shape[0]
    out = torch.empty((2, b), dtype=torch.int32, device=src_blocks.device)
    if b > 0:
        out_ptr = out.data_ptr()
        _launch("block_energy", src_blocks.device, src_ptr, pred_ptr,
                out_ptr, out_ptr + 4 * b, b, n)
        block_energy.launches += 1
    return out.unbind(0)


block_energy.launches = 0


def _check_energy_at_args(src_blocks, plane, y0, x0, n: int) -> None:
    if n not in ENERGY_BLOCK_SIZES:
        raise ValueError(f"block_energy_at: n={n} not in "
                         f"{ENERGY_BLOCK_SIZES}")
    b = src_blocks.shape[0]
    _want_blocks("block_energy_at: src_blocks", src_blocks, b, n, n)
    if plane.dim() != 2 or plane.shape[0] < n or plane.shape[1] < n:
        raise ValueError(f"block_energy_at: plane shape "
                         f"{tuple(plane.shape)}, want two dimensions of at "
                         f"least {n}")
    if src_blocks.dtype != torch.uint8 or plane.dtype != torch.uint8:
        raise TypeError(f"block_energy_at: src_blocks and plane must be "
                        f"uint8, got {src_blocks.dtype} and {plane.dtype}")
    if (y0.dim() != 2 or y0.shape[1] != b or y0.shape[0] < 1
            or x0.shape != y0.shape):
        raise ValueError(f"block_energy_at: starts of shape "
                         f"{tuple(y0.shape)} and {tuple(x0.shape)}, want "
                         f"(C, {b}) with C >= 1")
    if y0.dtype != torch.int32 or x0.dtype != torch.int32:
        raise TypeError(f"block_energy_at: starts must be int32, got "
                        f"{y0.dtype} and {x0.dtype}")


def _check_starts(plane, y0, x0, n: int) -> None:
    """Raise unless every start keeps its n x n block inside the plane."""
    if y0.numel() == 0:
        return
    hh, ww = plane.shape
    if (int(y0.min()) < 0 or int(y0.max()) > hh - n or int(x0.min()) < 0
            or int(x0.max()) > ww - n):
        raise ValueError(f"block_energy_at: a {n}x{n} block leaves the "
                         f"{hh}x{ww} plane")


def block_energy_at_ref(src_blocks, plane, y0, x0, n: int):
    """Plain PyTorch ``block_energy_at``: gather each candidate set's
    blocks out of the plane, then ``block_energy_ref``. Returns (sse, sad)
    int32 of shape (C, B)."""
    ar = torch.arange(n, device=plane.device)
    sses, sads = [], []
    for ys, xs in zip(y0, x0):
        rows = (ys.long()[:, None] + ar)[:, :, None]
        cols = (xs.long()[:, None] + ar)[:, None, :]
        sse, sad = block_energy_ref(src_blocks, plane[rows, cols], n)
        sses.append(sse)
        sads.append(sad)
    return torch.stack(sses), torch.stack(sads)


def block_energy_at(src_blocks, plane, y0, x0, n: int):
    """(SSE, SAD) of src against predictions read in place out of a plane.

    src_blocks: (B, n, n) uint8, n in {8, 16, 32, 64}; plane: (H, W) uint8
    with unit column stride (any row pitch); y0, x0: (C, B) int32 starts:
    candidate set c predicts block b by
    ``plane[y0[c, b]:y0[c, b] + n, x0[c, b]:x0[c, b] + n]``. Starts are
    taken as given and must keep the block inside the plane: CPU inputs
    are checked, CUDA inputs only when ``CHECK_STARTS`` is set (the check
    waits for the device). Returns (sse, sad) int32 of shape (C, B). CUDA
    inputs run the positioned kernel of ``csrc/block_energy.cu``; CPU
    inputs run ``block_energy_at_ref``.
    """
    _check_energy_at_args(src_blocks, plane, y0, x0, n)
    if _device_kind("block_energy_at", src_blocks, y0, x0) == "cpu":
        if plane.device.type != "cpu":
            raise ValueError("block_energy_at: inputs on different devices")
        _check_starts(plane, y0, x0, n)
        return block_energy_at_ref(src_blocks, plane, y0, x0, n)
    dev = src_blocks.device
    if plane.device != dev:
        raise ValueError("block_energy_at: inputs on different devices")
    src_ptr, plane_ptr = src_blocks.data_ptr(), plane.data_ptr()
    if plane.stride(1) != 1 or src_ptr % 16 or plane_ptr % 4:
        raise ValueError("block_energy_at: src_blocks must start on a "
                         "16-byte boundary, the plane on a 4-byte one with "
                         "unit column stride")
    if CHECK_STARTS:
        _check_starts(plane, y0, x0, n)
    c, b = y0.shape
    out = torch.empty((2, c, b), dtype=torch.int32, device=dev)
    if b > 0:
        out_ptr = out.data_ptr()
        _launch("block_energy_at", dev, src_ptr, plane_ptr, y0.data_ptr(),
                x0.data_ptr(), out_ptr, out_ptr + 4 * c * b, b, c, n,
                plane.stride(0))
        block_energy_at.launches += 1
    return out.unbind(0)


block_energy_at.launches = 0


def sse_level_smem(n: int, r: int) -> int:
    """Bytes of dynamic shared memory one search level takes in
    ``csrc/sse_search.cu``: the source and the area (odd pitch, 16 words
    of pad) as float32, the row sums and the map as int32."""
    w, d = n + 2 * r, 2 * r + 1
    return 4 * (n * n + w * (w + 1) + 16 + w * d + d * d)


def _check_sse_args(src_blocks, wins, n: int, r: int) -> None:
    if n not in SSE_BLOCK_SIZES:
        raise ValueError(f"sse_map_search: n={n} not in {SSE_BLOCK_SIZES}")
    if r < 1 or sse_level_smem(n, r) > SSE_SMEM_BYTES:
        raise ValueError(f"sse_map_search: r={r} at n={n} outside the "
                         f"kernel's {SSE_SMEM_BYTES} bytes of shared memory")
    b = src_blocks.shape[0]
    sw = n + 2 * r + 8
    _want_blocks("sse_map_search: src_blocks", src_blocks, b, n, n)
    _want_blocks("sse_map_search: wins", wins, b, sw, sw)
    if src_blocks.dtype != wins.dtype or wins.dtype not in (torch.uint8,
                                                            torch.int16):
        raise TypeError("sse_map_search: inputs must both be uint8 or both "
                        f"int16, got {src_blocks.dtype} and {wins.dtype}")


def sse_map_search_ref(src_blocks, wins, n: int, r: int,
                       want_map: bool = True):
    """Plain PyTorch exhaustive full-pel SSE search.

    Same contract as ``sse_map_search``. It computes the relative-SSE map
    the way the TPU package does, sum(reg^2) - 2 * sum(src * reg) over the
    search area ``wins[:, 4:4+w, 4:4+w]`` (w = n + 2r), and takes the
    first minimum with ``torch.argmin``, which returns the first index of
    the minimum.
    """
    b = src_blocks.shape[0]
    d = 2 * r + 1
    w = n + 2 * r
    area = wins[:, 4:4 + w, 4:4 + w].to(torch.int32)
    src = src_blocks.to(torch.int32)
    rel = torch.empty((b, d, d), dtype=torch.int32, device=src.device)
    for dy in range(d):
        rows = area[:, dy:dy + n, :].unfold(2, n, 1)  # (B, n, D, n)
        e2 = (rows * rows).sum(dim=(1, 3), dtype=torch.int32)
        corr = (rows * src[:, :, None, :]).sum(dim=(1, 3), dtype=torch.int32)
        rel[:, dy] = e2 - 2 * corr
    idx = torch.argmin(rel.reshape(b, d * d), dim=1)
    dy = (idx // d - r).to(torch.int32)
    dx = (idx % d - r).to(torch.int32)
    return dy, dx, (rel if want_map else None)


def sse_map_search(src_blocks, wins, n: int, r: int, want_map: bool = True):
    """Exhaustive +-r full-pel SSE search for B blocks at once.

    src_blocks: (B, n, n); wins: (B, n+2r+8, n+2r+8) with the search area
    at offset (4, 4), so displacement (0, 0) sits at (r+4, r+4). Both
    uint8, or both int16 holding values in [0, 1020] (2x2 sums of pixels).
    n in {8, 16, 32}; the area must fit the kernel's shared memory
    (``sse_level_smem(n, r)`` at most ``SSE_SMEM_BYTES``: the strip zone's
    +-40 level of 16x16 blocks, 95,684 bytes, opts in to more than the 48
    KB a kernel has without asking).
    Returns (dy, dx, rel_map): the winner int32 (B,) in [-r, r], the first
    minimum in dy-major order, and the (B, 2r+1, 2r+1) int32 relative-SSE
    map (true SSE minus sum(src^2)), or None when ``want_map`` is False.
    CUDA inputs run the kernel of ``csrc/sse_search.cu``; CPU inputs run
    ``sse_map_search_ref``.
    """
    _check_sse_args(src_blocks, wins, n, r)
    if _device_kind("sse_map_search", src_blocks, wins) == "cpu":
        return sse_map_search_ref(src_blocks, wins, n, r, want_map)
    b = src_blocks.shape[0]
    d = 2 * r + 1
    dev = src_blocks.device
    out = torch.empty((2, b), dtype=torch.int32, device=dev)
    rel = (torch.empty((b, d, d), dtype=torch.int32, device=dev)
           if want_map else None)
    if b > 0:
        out_ptr = out.data_ptr()
        _launch("sse_map_search", dev, src_blocks.data_ptr(),
                wins.data_ptr(), out_ptr, out_ptr + 4 * b,
                rel.data_ptr() if want_map else None, b, n, r,
                n + 2 * r + 8, src_blocks.element_size())
        sse_map_search.launches += 1
    dy, dx = out.unbind(0)
    return dy, dx, rel


sse_map_search.launches = 0


def sse_map_search_occupancy(n: int, r: int, device=None):
    """(resident CTAs per SM, dynamic shared memory in bytes, threads of
    a CTA) of ``sse_map_search``'s uint8 level of block size n (16) and
    reach r on ``device`` (the current CUDA device if None), its shared
    memory opted in as a launch would (the CUDA runtime's occupancy
    query)."""
    fn = load_library("sse_search").sse_search_occupancy
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = fn(n, r, *(ctypes.byref(v) for v in out))
    if err != 0:
        raise RuntimeError(f"sse_map_search: the occupancy query failed with "
                           f"CUDA error {err}")
    return tuple(v.value for v in out)


def take_windows(wins, ys, xs, m: int):
    """out[b] = wins[b, ys[b]:ys[b]+m, xs[b]:xs[b]+m]; the starts must lie
    in [0, SW - m]."""
    b = wins.shape[0]
    ar = torch.arange(m, device=wins.device)
    rows = ys.long()[:, None] + ar
    cols = xs.long()[:, None] + ar
    bi = torch.arange(b, device=wins.device)[:, None, None]
    return wins[bi, rows[:, :, None], cols[:, None, :]]


def _check_hier_args(src_blocks, wins, n: int) -> None:
    if n % 2 or n < 2:
        raise ValueError(f"hier_search: n={n} must be even")
    b = src_blocks.shape[0]
    sw = n + 2 * WIN_R + 8
    _want_blocks("hier_search: src_blocks", src_blocks, b, n, n)
    _want_blocks("hier_search: wins", wins, b, sw, sw)
    if src_blocks.dtype != torch.uint8 or wins.dtype != torch.uint8:
        raise TypeError("hier_search: inputs must be uint8, got "
                        f"{src_blocks.dtype} and {wins.dtype}")


def hier_search_ref(src_blocks, wins, n: int):
    """Plain PyTorch two-level full-pel search: the 2x2 decimation,
    ``sse_map_search_ref`` at +-HALF_R, the clamped and doubled centre,
    the gathered refine windows and ``sse_map_search_ref`` at +-REFINE_R.
    Same contract as ``hier_search_fused``."""
    b = src_blocks.shape[0]
    nh = n // 2
    sw = wins.shape[-1]
    wh = wins.to(torch.int32).reshape(b, sw // 2, 2, sw // 2, 2) \
        .sum(dim=(2, 4), dtype=torch.int32).to(torch.int16)
    sh = src_blocks.to(torch.int32).reshape(b, nh, 2, nh, 2) \
        .sum(dim=(2, 4), dtype=torch.int32)
    dyh, dxh, ssem_h = sse_map_search_ref(sh.to(torch.int16), wh, nh, HALF_R)
    src2_h = (sh * sh).sum(dim=(1, 2), dtype=torch.int32)
    reach = WIN_R - REFINE_R
    c_y = (dyh * 2).clamp(-reach, reach)
    c_x = (dxh * 2).clamp(-reach, reach)
    loc = take_windows(wins, c_y + reach, c_x + reach, n + 2 * REFINE_R + 8)
    dyr, dxr, _ = sse_map_search_ref(src_blocks, loc, n, REFINE_R,
                                     want_map=False)
    return c_y, c_x, dyr, dxr, loc, ssem_h, src2_h


def hier_search_fused(src_blocks, wins, n: int):
    """Two-level full-pel search of B blocks in one launch: exhaustive
    +-HALF_R on 2x2 sums, then exhaustive +-REFINE_R at full resolution
    around the doubled winner.

    src_blocks: (B, n, n) uint8; wins: (B, n+2*WIN_R+8, ...) uint8 search
    windows whose origin is the block minus (WIN_R + 4). Returns
    (c_y, c_x, dyr, dxr, loc, ssem_h, src2_h):
      c_y/c_x  int32 (B,) refine centre: twice the half-res winner,
               clamped to +-(WIN_R - REFINE_R) so that the refine window
               stays inside the search window
      dyr/dxr  int32 (B,) refine winner relative to the centre
      loc      (B, n+2*REFINE_R+8, ...) uint8 refine windows whose origin
               is block + centre - (REFINE_R + 4)
      ssem_h   (B, 2*HALF_R+1, ...) int32 half-res relative-SSE map
      src2_h   (B,) int32 half-res sum(src_h^2)
    Both winners are first minima in dy-major order. CUDA inputs (n = 32)
    run the fused kernel of ``csrc/sse_search.cu``; CPU inputs run
    ``hier_search_ref``.
    """
    _check_hier_args(src_blocks, wins, n)
    if _device_kind("hier_search_fused", src_blocks, wins) == "cpu":
        return hier_search_ref(src_blocks, wins, n)
    if n not in HIER_BLOCK_SIZES:
        raise ValueError(f"hier_search_fused: n={n} not in "
                         f"{HIER_BLOCK_SIZES} on a CUDA device")
    src_ptr, wins_ptr = src_blocks.data_ptr(), wins.data_ptr()
    if src_ptr % 16 or wins_ptr % 16:
        raise ValueError("hier_search_fused: inputs must start on a "
                         "16-byte boundary")
    b = src_blocks.shape[0]
    dev = src_blocks.device
    dh = 2 * HALF_R + 1
    ln = n + 2 * REFINE_R + 8
    out = torch.empty((5, b), dtype=torch.int32, device=dev)
    loc = torch.empty((b, ln, ln), dtype=torch.uint8, device=dev)
    ssem_h = torch.empty((b, dh, dh), dtype=torch.int32, device=dev)
    if b > 0:
        _launch("hier_search_fused", dev, src_ptr, wins_ptr, out.data_ptr(),
                loc.data_ptr(), ssem_h.data_ptr(), b, n)
        hier_search_fused.launches += 1
    c_y, c_x, dyr, dxr, src2_h = out.unbind(0)
    return c_y, c_x, dyr, dxr, loc, ssem_h, src2_h


hier_search_fused.launches = 0


def dct_matrix(n: int) -> np.ndarray:
    """The orthonormal DCT-II matrix of ``txq_cost`` (not VP9's integer
    transform), float32, computed in float64 as the JAX package's
    ``_dct_matrix`` computes it."""
    k = np.arange(n)
    mat = np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    mat *= np.sqrt(2.0 / n)
    mat[0] *= 1.0 / np.sqrt(2.0)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dct_matrix_on(n: int, device: torch.device):
    return torch.from_numpy(dct_matrix(n)).to(device)


def _check_txq_args(resid_blocks, n: int) -> None:
    if n not in TXQ_BLOCK_SIZES:
        raise ValueError(f"txq_cost: n={n} not in {TXQ_BLOCK_SIZES}")
    b = resid_blocks.shape[0]
    if tuple(resid_blocks.shape) != (b, n, n):
        raise ValueError(f"txq_cost: resid_blocks shape "
                         f"{tuple(resid_blocks.shape)}, want ({b}, {n}, {n})")
    if resid_blocks.dtype != torch.float32:
        raise TypeError("txq_cost: resid_blocks must be float32, got "
                        f"{resid_blocks.dtype}")


def txq_cost_ref(resid_blocks, dc_q: float, ac_q: float, n: int):
    """Plain PyTorch transform + quantizer cost proxy (``torch.matmul``
    for the two products). Same contract as ``txq_cost``."""
    dmat = _dct_matrix_on(n, resid_blocks.device)
    coeffs = torch.matmul(torch.matmul(dmat, resid_blocks), dmat.T)
    q = torch.full((n, n), float(ac_q), dtype=torch.float32,
                   device=resid_blocks.device)
    q[0, 0] = float(dc_q)
    levels = torch.trunc(coeffs / q + torch.sign(coeffs) * TXQ_BIAS)
    err = coeffs - levels * q
    mags = levels.abs()
    rate = torch.where(mags > 0, 1.5 + torch.log2(1.0 + mags), 0.0)
    return (err * err).sum(dim=(1, 2)), rate.sum(dim=(1, 2))


def txq_cost(resid_blocks, dc_q: float, ac_q: float, n: int):
    """Transform + quantizer cost proxy per block: (distortion, rate).

    resid_blocks: (B, n, n) float32, n in {4, 8, 16, 32}; dc_q, ac_q: the
    quantizer steps of coefficient (0, 0) and of the others. Per block:
    the orthonormal float DCT-II on both axes, the dead-zone quantizer
    ``trunc(c / q + sign(c) * 0.38)``, distortion sum((c - level * q)^2)
    and the rate proxy sum over nonzero levels of 1.5 + log2(1 + |level|).
    Returns (dist, rate) float32 tensors of shape (B,) on the inputs'
    device, as ``tpu_vp9.ops.pallas_kernels.txq_cost``. CUDA inputs run
    the kernel of ``csrc/txq_cost.cu``; CPU inputs run ``txq_cost_ref``.

    It is float throughout, so two implementations agree to a tolerance,
    not to bits: 1e-4 relative plus 1e-3 absolute on both outputs for a
    block none of whose coefficients has ``|c| / q + 0.38`` within 1e-3 of
    an integer. Such a coefficient may land on either side of ``trunc``
    when the products are summed in another order, which moves ``dist`` by
    up to about q^2 and ``rate`` by 1.5 or more.
    """
    _check_txq_args(resid_blocks, n)
    if _device_kind("txq_cost", resid_blocks) == "cpu":
        return txq_cost_ref(resid_blocks, dc_q, ac_q, n)
    b = resid_blocks.shape[0]
    dev = resid_blocks.device
    if resid_blocks.data_ptr() % 16:
        raise ValueError("txq_cost: resid_blocks must start on a 16-byte "
                         "boundary")
    out = torch.empty((2, b), dtype=torch.float32, device=dev)
    if b == 0:
        return out[0], out[1]
    _launch("txq_cost", dev, resid_blocks.data_ptr(),
            _dct_matrix_on(n, dev).data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), float(dc_q), float(ac_q), b, n)
    txq_cost.launches += 1
    return out[0], out[1]


txq_cost.launches = 0


def _check_lf_args(y, u, v, geom, split32) -> None:
    g = geom
    if split32 is not None and g.strip:
        raise ValueError("loop_filter: a split mask with a strip geometry "
                         "(its blocks are 16x16 already)")
    if g.height > VP9_MAX_SIDE or g.width > VP9_MAX_SIDE:
        raise ValueError(f"loop_filter: a {g.width}x{g.height} picture is "
                         f"larger than VP9 codes ({VP9_MAX_SIDE} a side)")
    rows = 32 * g.rows32 + (16 if g.strip else 0)
    if (g.pad_h % 64 or g.pad_w % 64 or not 0 < g.h_mi <= g.pad_h
            or g.h_mi > rows or (g.strip and g.h_mi != rows)
            or not g.pad_w - 64 < g.w_mi <= g.pad_w):
        raise ValueError(f"loop_filter: a {g.pad_h}x{g.pad_w} plane does "
                         f"not pad a coded size of {g.h_mi}x{g.w_mi} to "
                         "whole superblocks")
    for name, t, shape in (("y", y, (g.pad_h, g.pad_w)),
                           ("u", u, (g.pad_h // 2, g.pad_w // 2)),
                           ("v", v, (g.pad_h // 2, g.pad_w // 2))):
        if tuple(t.shape) != shape:
            raise ValueError(f"loop_filter: plane {name} of shape "
                             f"{tuple(t.shape)}, want {shape}")
        if t.dtype != torch.uint8:
            raise TypeError(f"loop_filter: plane {name} must be uint8, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"loop_filter: plane {name} must be contiguous")
    if split32 is not None:
        if tuple(split32.shape) != (g.rows32, g.cols32):
            raise ValueError(f"loop_filter: split32 of shape "
                             f"{tuple(split32.shape)}, want "
                             f"({g.rows32}, {g.cols32})")
        if split32.is_floating_point() or split32.is_complex():
            raise TypeError("loop_filter: split32 must be an integer or "
                            f"bool 0/1 mask, got {split32.dtype}")


def loop_filter(y, u, v, geom, sc, split32=None, parts: int = LF_ALL_PARTS):
    """The exact VP9 loop filter of the 32 grid and its bottom strip, on
    the card, all three planes in one launch.

    y: (pad_h, pad_w) uint8, u and v: (pad_h/2, pad_w/2) uint8, contiguous
    CUDA tensors of one device, each starting on a 16-byte boundary; geom:
    the step's geometry (``strip``, ``strip_y``, ``pad_h``, ``pad_w``,
    ``h_mi``, ``w_mi``, ``rows32``, ``cols32``); sc: the step's row
    (``STEP_SCALARS``) on the planes' device, whose lf_lvl (in [0, 63], 0
    copies), lf_lim and lf_mblim the kernel reads; split32: optional
    (rows32, cols32)
    0/1 mask (integer or bool, contiguous, on the planes' device) of the
    32-blocks coded as four 16x16 blocks, refused with a strip geometry.
    Returns new (y, u, v) planes, bit for bit what
    ``pipeline/tpu_encdec.py:loop_filter_ref`` returns; the inputs are not
    modified. It runs the kernel of ``csrc/loop_filter.cu`` or raises: CPU
    tensors go to ``loop_filter_ref`` through the step's
    ``loop_filter_device``, not through here.

    parts: for measurements only: the kinds of CTA (bits of ``LF_PARTS``)
    that work; with fewer than all, the other kinds' planes of the outputs
    are left unwritten.
    """
    _check_lf_args(y, u, v, geom, split32)
    tensors = (y, u, v) if split32 is None else (y, u, v, split32)
    if _device_kind("loop_filter", *tensors) != "cuda":
        raise ValueError("loop_filter: the kernel takes CUDA tensors; CPU "
                         "tensors go through loop_filter_device")
    dev = y.device
    _want_row("loop_filter", sc, dev)
    if split32 is not None and split32.dtype != torch.int32:
        split32 = split32.to(torch.int32)
    g = geom
    out = (torch.empty_like(y), torch.empty_like(u), torch.empty_like(v))
    if any(t.data_ptr() % 16 for t in (y, u, v, *out)):
        raise ValueError("loop_filter: planes must start on a 16-byte "
                         "boundary")
    _launch("loop_filter", dev, y.data_ptr(), u.data_ptr(), v.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            None if split32 is None else split32.data_ptr(), sc.data_ptr(),
            g.pad_h, g.pad_w, g.h_mi, g.w_mi,
            g.strip_y if g.strip else g.pad_h, g.rows32, g.cols32,
            int(parts))
    loop_filter.launches += 1
    return out


loop_filter.launches = 0


# ---------------------------------------------------------------------------
# The keyframe's intra wavefront (csrc/kframe_wave.cu)
# ---------------------------------------------------------------------------

# the keyframe's mode prior in lambda units, in IntraMode order (DC, V, H,
# D45, D135, D117, D153, D207, D63, TM): DC, V, H and TM are cheaper in
# the keyframe's mode trees
KF_MODE_BIAS = (0, 1, 1, 3, 3, 3, 3, 3, 3, 1)
# keeps a block's cost, sse + bias * lam, inside int32 (sse < 2^27)
KF_MAX_LAM = 1 << 24
# a wait of one block row for the row above gives up after this many
# polls (each a read of the L2 cache, with a 64 ns sleep every 32) and
# sets the launch's error word
KF_MAX_POLLS = 1 << 22
# 64-bit words of a block's bottom recon rows in the kernel's edge buffer
# (luma's 32 bytes, u's 16 and v's 16, four a word beside a tag)
KF_EDGE_WORDS = 16


def kf_diagonal(d: int, rows: int, cols: int):
    """(first block row, number of blocks) of anti-diagonal ``d`` of a
    rows x cols grid: the blocks (r, d - r) that lie in the grid (the plain
    version's batches)."""
    r0 = max(0, d - cols + 1)
    return r0, min(rows - 1, d) - r0 + 1


def _kf_dir_words(bs: int) -> np.ndarray:
    """(8, bs*bs) int32: ``ops/intra.stacked_dir_maps(bs)`` packed one
    word per mode and pixel: the three taps' indices into the reference
    vector in bits 0-6, 7-13, 14-20, their weights in bits 21-23, 24-26,
    27-29."""
    from tpu_vp9_torch.ops.intra import stacked_dir_maps

    idx, w = stacked_dir_maps(bs)  # (8, 3, bs, bs) each
    idx = idx.reshape(8, 3, -1).astype(np.int64)
    w = w.reshape(8, 3, -1).astype(np.int64)
    if idx.max() >= 128 or w.max() >= 8 or idx.min() < 0 or w.min() < 0:
        raise AssertionError("intra maps do not fit the packed words")
    word = (idx[:, 0] | idx[:, 1] << 7 | idx[:, 2] << 14 | w[:, 0] << 21
            | w[:, 1] << 24 | w[:, 2] << 27)
    return word.astype(np.int32)


# distinct packed words a directional mode has at most, at 32 and 16 (its
# list is padded to this length)
KF_UNIQ = {32: 96, 16: 48}


def _kf_mode_lists(bs: int):
    """The directional maps as lists: (8, KF_UNIQ[bs]) int32, each mode's
    distinct packed words (``_kf_dir_words``), padded with 0 (weights 0),
    and (bs*bs, 8) uint8, each pixel's index into its mode's list."""
    words = _kf_dir_words(bs)
    uniq = np.zeros((8, KF_UNIQ[bs]), np.int32)
    idx = np.zeros((bs * bs, 8), np.uint8)
    for m in range(8):
        u, inv = np.unique(words[m], return_inverse=True)
        if len(u) > KF_UNIQ[bs]:
            raise AssertionError(f"{len(u)} distinct words of mode {m} at "
                                 f"{bs}, want at most {KF_UNIQ[bs]}")
        uniq[m, :len(u)] = u
        idx[:, m] = inv
    return uniq, idx


@functools.lru_cache(maxsize=None)
def _kf_tables_on(device: torch.device):
    """The kernel's constant tables on ``device``: float64 (f_col32,
    f_col16), the port's forward column matrices (``txfm._fwd_matrices64``,
    the float32 ones widened; the kernel reads F_row^T as F_col^T / 2^6,
    which ``tests/test_torch_transform_recon.py`` holds to the row matrix
    bit for bit), and int32 words: the directional maps as lists
    (``_kf_mode_lists``: the words of 32, of 16, then the pixels' index
    bytes of 32, of 16) and each raster place's place in the DCT_DCT scan
    order (32, 16)."""
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.ops import txfm

    cpu = torch.device("cpu")
    mats = [txfm._fwd_matrices64(n, cpu)[0].reshape(-1) for n in (32, 16)]
    lists = [_kf_mode_lists(n) for n in (32, 16)]
    tabs = [u.reshape(-1) for u, _ in lists]
    tabs += [np.ascontiguousarray(i).view(np.int32).reshape(-1)
             for _, i in lists]
    for n in (32, 16):
        scan = np.asarray(T.scan_order(txfm.TX_SIZE[n], T.TxType.DCT_DCT)[0])
        tabs.append(np.argsort(scan).astype(np.int32))
    return (torch.cat(mats).to(device),
            torch.from_numpy(np.concatenate(tabs)).to(device))


def check_kf_args(src_y, src_u, src_v, geom) -> None:
    g = geom
    for name, t, shape in (("src_y", src_y, (g.pad_h, g.pad_w)),
                           ("src_u", src_u, (g.pad_h // 2, g.pad_w // 2)),
                           ("src_v", src_v, (g.pad_h // 2, g.pad_w // 2))):
        if tuple(t.shape) != shape:
            raise ValueError(f"kframe_wave: {name} of shape "
                             f"{tuple(t.shape)}, want {shape}")
        if t.dtype != torch.uint8:
            raise TypeError(f"kframe_wave: {name} must be uint8, got "
                            f"{t.dtype}")
    if g.rows32 * 32 > g.pad_h or g.cols32 * 32 > g.pad_w:
        raise ValueError(f"kframe_wave: a {g.rows32}x{g.cols32} grid of "
                         f"32-blocks does not fit a {g.pad_h}x{g.pad_w} "
                         "plane")


def kf_outputs(geom, device):
    """The wavefront's outputs, unfilled, on ``device``: mode int32 (B,),
    [lv_y int16 (B, 32, 32), lv_u, lv_v (B, 16, 16)], eob int32 (3, B),
    [rec_y uint8 (rows32*32, cols32*32), rec_u, rec_v (rows32*16,
    cols32*16)]."""
    rows, cols = geom.rows32, geom.cols32
    b = rows * cols
    mode = torch.empty(b, dtype=torch.int32, device=device)
    lvs = [torch.empty((b, n, n), dtype=torch.int16, device=device)
           for n in (32, 16, 16)]
    eob = torch.empty((3, b), dtype=torch.int32, device=device)
    recs = [torch.empty((rows * n, cols * n), dtype=torch.uint8,
                        device=device) for n in (32, 16, 16)]
    return mode, lvs, eob, recs


def kf_check_status(word) -> None:
    """Raise if a ``kframe_wave`` launch's error word (a one-element int32
    tensor or array) is set: a block row's wait for the row above gave up,
    and the keyframe's outputs are incomplete. Reading a CUDA tensor waits
    for the launch."""
    v = int(torch.as_tensor(word).reshape(-1)[0])
    if v != 0:
        raise RuntimeError(f"kframe_wave: block row {v - 1} gave up waiting "
                           "for the row above; the keyframe's outputs are "
                           "incomplete")


def kframe_wave(src_y, src_u, src_v, geom, sc, status=None):
    """The keyframe's closed-loop intra encode of the 32 grid.

    src_y: (pad_h, pad_w), src_u and src_v: (pad_h/2, pad_w/2) uint8
    padded source planes; geom: the step's geometry (at a strip geometry
    its 32 zone, above the strip); sc: the step's row (``STEP_SCALARS``)
    on the planes' device, whose dc_q, ac_q (the quantizer steps) and lam
    (the mode prior's lambda) the kernel reads. Every 32x32 block
    (r, c), after (r-1, c) and (r, c-1): the 10 intra predictions from
    their recon (127 above the frame, 129 left of it, above-right repeating
    above[31], the left column clamped to the last visible row), the mode
    of least ``sse + KF_MODE_BIAS[m] * lam`` (the first on a tie), then luma
    at 32 and both chroma planes at 16 with that mode: float64 forward
    DCT, quantizer, exact integer inverse, recon and eob. Returns (mode
    int32 (B,), lv_y int16 (B, 32, 32), lv_u, lv_v int16 (B, 16, 16),
    eob_y, eob_u, eob_v int32 (B,), rec_y uint8 (rows32*32, cols32*32),
    rec_u, rec_v (rows32*16, cols32*16)), blocks in raster order, the recon
    unfiltered.

    It runs the kernel of ``csrc/kframe_wave.cu``, one launch on the
    current stream (a CTA per block row), or raises: CPU tensors go to the
    plain version ``pipeline/tpu_encdec.py:kframe_wave_ref`` through the
    step's ``kframe_wave_device``, not through here. The two agree bit for
    bit unless a coefficient's ``|c| / q + 0.38`` lies within about 1e-12 of
    an integer (the float64 forward transform sums in another order).

    The launch's error word is set if a block row gave up waiting for the
    row above (``KF_MAX_POLLS``). With ``status`` None the wrapper reads it
    at once (a wait for the device) and raises if it is set
    (``kf_check_status``); otherwise it appends the word, a one-element
    int32 CUDA tensor, to the list ``status`` and the caller checks it
    with ``kf_check_status`` when it fetches the outputs.
    """
    check_kf_args(src_y, src_u, src_v, geom)
    if _device_kind("kframe_wave", src_y, src_u, src_v) != "cuda":
        raise ValueError("kframe_wave: the kernel takes CUDA tensors; CPU "
                         "tensors go through kframe_wave_device")
    g = geom
    rows, cols = g.rows32, g.cols32
    dev = src_y.device
    _want_row("kframe_wave", sc, dev)
    mode, lvs, eob, recs = kf_outputs(g, dev)
    mats, tabs = _kf_tables_on(dev)
    # scratch, zeroed for every keyframe: the ticket and the error word
    # (int32), then each block's bottom rows in tagged words
    scratch = torch.zeros(1 + rows * cols * KF_EDGE_WORDS, dtype=torch.int64,
                          device=dev)
    ptrs = [t.data_ptr() for t in (src_y, src_u, src_v, *recs, mode, *lvs,
                                   eob, mats, tabs)]
    _launch("kframe_wave", dev, *ptrs, scratch.data_ptr() + 8,
            scratch.data_ptr(), sc.data_ptr(), g.pad_w, g.height, rows, cols,
            KF_MAX_POLLS)
    kframe_wave.launches += 1
    word = scratch.view(torch.int32)[1:2]
    if status is None:
        kf_check_status(word)
    else:
        status.append(word)
    return (mode, *lvs, *eob.unbind(0), *recs)


kframe_wave.launches = 0


# ---------------------------------------------------------------------------
# The open-loop keyframe hints (csrc/openloop_modes.cu)
# ---------------------------------------------------------------------------

OPENLOOP_BLOCK_SIZES = (32,)  # the size the kernel is built for
# blocks whose (chunk, 10, n, n) predictions the plain version holds at once
OPENLOOP_CHUNK = 256
# the kernel's 16 folds a lane (csrc/openloop_modes.cu), in its order: the
# classes a lane holds there, by mode
OL_SLOTS = ("D117 done by column 15", "D63 done by column 15", "D45 lower",
            "D45 upper", "D135 lower", "D135 upper", "D117 lower",
            "D117 upper", "D63 lower", "D63 upper and held pixels",
            "D153 even lower", "D153 odd lower", "D207 even lower",
            "D207 odd lower", "D153 (lanes 0-15) or D207 even upper",
            "D153 (lanes 0-15) or D207 odd upper")


def _ol_sweep(n: int = 32):
    """The classes of the kernel's sweeps, as it forms them: for each slot
    of ``OL_SLOTS`` and lane (row), (mode in IntraMode order, the pixels
    (y, x) whose source sum the lane holds there, none where it holds no
    class). A lane adds its
    pixel of column k to each accumulator; D45, D135, D117 and D63 then
    move by -1, +1, +2, -2 lanes (lane r takes lane r - shift's) but after
    the last column, D153 and D207 one register per column parity by +1
    and -1 but after that parity's last column; a class coming in at the
    edge goes to the upper half. D117 and D63's upper halves are folded
    after column 15. D63's pixels (0, 31) and (1, 31), whose words differ
    from their lines', go to lanes 0 and 1's empty upper halves; D153's
    upper halves (lanes 0-15) and D207's (lanes 16-31) share a fold."""
    def ring():
        return [[[] for _ in range(n)], [[] for _ in range(n)]]

    def move(acc, shift):
        lo = [acc[0][(r - shift) % n] for r in range(n)]
        hi = [acc[1][(r - shift) % n] for r in range(n)]
        for r in (range(shift) if shift > 0 else range(n + shift, n)):
            if hi[r]:
                raise AssertionError("a completed class meets another")
            hi[r], lo[r] = lo[r], []
        acc[0], acc[1] = lo, hi

    shifts = {3: -1, 4: 1, 5: 2, 8: -2}
    accs = {m: ring() for m in shifts}
    par = {6: [ring(), ring()], 7: [ring(), ring()]}
    held = [[] for _ in range(n)]
    mid = {}
    for k in range(n):
        for m, shift in shifts.items():
            for r in range(n):
                if m == 8 and k == n - 1 and r < 2:
                    held[r].append((r, k))
                else:
                    accs[m][0][r].append((r, k))
            if k < n - 1:
                move(accs[m], shift)
            if m in (5, 8) and k == 15:
                mid[m], accs[m][1] = accs[m][1], [[] for _ in range(n)]
        for m, shift in ((6, 1), (7, -1)):
            for r in range(n):
                par[m][k & 1][0][r].append((r, k))
            if k + 2 < n:
                move(par[m][k & 1], shift)
    for r in range(2):
        if accs[8][1][r]:
            raise AssertionError("D63's upper half is taken where the held "
                                 "pixel goes")
        accs[8][1][r] = held[r]
    uppers = []
    for q in (0, 1):
        if any(par[6][q][1][16:]) or any(par[7][q][1][:16]):
            raise AssertionError("D153's and D207's upper halves overlap")
        uppers.append([(6, par[6][q][1][r]) if r < 16 else
                       (7, par[7][q][1][r]) for r in range(n)])

    def tag(m, lanes):
        return [(m, px) for px in lanes]

    return [tag(5, mid[5]), tag(8, mid[8]), tag(3, accs[3][0]),
            tag(3, accs[3][1]), tag(4, accs[4][0]), tag(4, accs[4][1]),
            tag(5, accs[5][0]), tag(5, accs[5][1]), tag(8, accs[8][0]),
            tag(8, accs[8][1]), tag(6, par[6][0][0]), tag(6, par[6][1][0]),
            tag(7, par[7][0][0]), tag(7, par[7][1][0]), *uppers]


def _ol_ref_index(k: int, n: int = 32) -> int:
    """Where the kernel keeps entry k of the reference vector
    [left n, above-left, above 2n]: the left column reversed (so that
    every directional filter's taps lie within four neighbouring bytes),
    the rest in place."""
    return n - 1 - k if k < n else k


@functools.lru_cache(maxsize=None)
def _ol_slot_tables():
    """(weights, places, words, modes), each (len(OL_SLOTS), 32) int32,
    of the kernel's folds: for slot k and lane l, the mode and packed word
    (``_kf_dir_words``) that predict every pixel of the class the lane
    holds there; the word's filter as the four weights (bytes) of four
    neighbouring bytes of the kernel's reference (``_ol_ref_index``), from
    the first one's index o, and ``places = o | count << 8`` with the
    class's pixel count. The value is (sum of weights times bytes + 2) >>
    2. An empty slot has weights, count, word and mode 0."""
    n = 32
    words = _kf_dir_words(n).reshape(8, n, n)
    classes = _ol_sweep(n)
    if len(classes) != len(OL_SLOTS):
        raise AssertionError("the sweep and OL_SLOTS disagree")
    shape = (len(OL_SLOTS), n)
    wts, places, wd, modes = (np.zeros(shape, np.int64) for _ in range(4))
    for k, lanes in enumerate(classes):
        for lane, (mode, pixels) in enumerate(lanes):
            if not pixels:
                continue
            found = {int(words[mode - 1, y, x]) for y, x in pixels}
            if len(found) != 1:
                raise AssertionError(f"slot {k} lane {lane}: the class has "
                                     f"{len(found)} words")
            word = found.pop()
            taps = [(_ol_ref_index(word >> (7 * t) & 127),
                     word >> (21 + 3 * t) & 7) for t in range(3)]
            taps = [(i, c) for i, c in taps if c]
            o = min(i for i, _ in taps)
            if max(i for i, _ in taps) > o + 3 or sum(c for _, c in taps) != 4:
                raise AssertionError(f"word {word:#x} is not four weights "
                                     "of four neighbouring bytes")
            wts[k, lane] = sum(c << (8 * (i - o)) for i, c in taps)
            places[k, lane] = o | len(pixels) << 8
            wd[k, lane], modes[k, lane] = word, mode
    return tuple(a.astype(np.int32) for a in (wts, places, wd, modes))


@functools.lru_cache(maxsize=None)
def _ol_tables_on(device: torch.device):
    """The open-loop kernel's table on ``device``: int32 (len(OL_SLOTS),
    32, 2), each lane's weights and places (``_ol_slot_tables``)."""
    wts, places, _, _ = _ol_slot_tables()
    return torch.from_numpy(np.stack([wts, places], axis=-1).copy()).to(
        device)


@functools.lru_cache(maxsize=None)
def _intra_maps_on(bs: int, device):
    from tpu_vp9_torch.ops.intra import stacked_dir_maps

    idx, w = stacked_dir_maps(bs)
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


def openloop_lam(qindex: int) -> int:
    """The hints' lambda, qindex^2 // 64 + 1 (the JAX function's)."""
    return int(qindex) ** 2 // 64 + 1


def _check_openloop_args(plane, qindex: int, n: int) -> None:
    if n not in OPENLOOP_BLOCK_SIZES:
        raise ValueError(f"openloop_modes: n={n} not in "
                         f"{OPENLOOP_BLOCK_SIZES}")
    if plane.dim() != 2 or plane.dtype != torch.uint8:
        raise TypeError(f"openloop_modes: want an (H, W) uint8 plane, got "
                        f"{plane.dtype} of shape {tuple(plane.shape)}")
    h, w = plane.shape
    if h < n or w < n or h % n or w % n:
        raise ValueError(f"openloop_modes: a {h}x{w} plane is not a grid "
                         f"of {n}x{n} blocks")
    if not 0 <= qindex <= 255:
        raise ValueError(f"openloop_modes: qindex {qindex} outside [0, 255]")


def _openloop_ref_vectors(p, n: int):
    """(ref (B, 3n+1) int32 in ``ops/intra.py``'s layout, have_above (B,),
    have_left (B,)) of every n x n block of the int32 plane ``p``, in
    raster order, from the plane itself: the row above (127 above the
    frame), the column to the left (129 left of it), the corner (127
    without a row above, else 129 without a column to the left), above-right
    repeating above[n-1]."""
    h, w = p.shape
    rows, cols = h // n, w // n
    dev = p.device
    rr = torch.arange(rows, device=dev).repeat_interleave(cols)
    cc = torch.arange(cols, device=dev).repeat(rows)
    ha, hl = rr > 0, cc > 0
    ar = torch.arange(n, device=dev)
    ya, xl = (rr * n - 1).clamp(min=0), (cc * n - 1).clamp(min=0)
    above = torch.where(ha[:, None], p[ya[:, None], (cc * n)[:, None] + ar],
                        127)
    left = torch.where(hl[:, None], p[(rr * n)[:, None] + ar, xl[:, None]],
                       129)
    al = torch.where(ha, torch.where(hl, p[ya, xl], 129), 127)
    ref = torch.cat([left, al[:, None], above,
                     above[:, -1:].expand(-1, n)], dim=1)
    return ref.to(torch.int32), ha, hl


def openloop_modes_ref(plane, qindex: int, n: int = 32):
    """Plain PyTorch version of ``openloop_modes`` (same contract)."""
    h, w = plane.shape
    rows, cols = h // n, w // n
    b = rows * cols
    p = plane.to(torch.int32)
    ref, ha, hl = _openloop_ref_vectors(p, n)
    src = p.reshape(rows, n, cols, n).permute(0, 2, 1, 3).reshape(b, n, n)
    sse = torch.empty((b, 10), dtype=torch.int32, device=plane.device)
    for s in range(0, b, OPENLOOP_CHUNK):
        e = min(b, s + OPENLOOP_CHUNK)
        d = predict_intra_all(ref[s:e], ha[s:e], hl[s:e], n) - src[s:e, None]
        sse[s:e] = (d * d).sum(dim=(2, 3), dtype=torch.int32)
    bias = torch.tensor(KF_MODE_BIAS, dtype=torch.int32, device=plane.device)
    cost = sse + bias * openloop_lam(qindex)
    modes = torch.argmin(cost, dim=1)  # the first minimum
    best = cost.gather(1, modes[:, None])[:, 0]
    return (modes.to(torch.int32).reshape(rows, cols),
            sse.reshape(rows, cols, 10), best.reshape(rows, cols))


def openloop_tm_exact(plane, n: int = 32):
    """(R, C) bool: the blocks whose TM prediction never clamps (min L +
    min A - al >= 0 and max L + max A - al <= 255 over the block's
    reference vector), where ``openloop_modes``' kernel takes TM's SSE in
    closed form; elsewhere it predicts TM pixel by pixel."""
    h, w = plane.shape
    ref, _, _ = _openloop_ref_vectors(plane.to(torch.int32), n)
    left, al, above = ref[:, :n], ref[:, n], ref[:, n + 1:2 * n + 1]
    lo = left.min(dim=1).values + above.min(dim=1).values - al
    hi = left.max(dim=1).values + above.max(dim=1).values - al
    return ((lo >= 0) & (hi <= 255)).reshape(h // n, w // n)


def openloop_modes(plane, qindex: int, n: int = 32):
    """Open-loop intra mode decision of every n x n block of a plane: the
    keyframe mode hints (``tpu_vp9/pipeline/tpu_intra.py:
    decide_modes_openloop``).

    plane: (H, W) uint8 source plane, H and W multiples of n (n = 32);
    qindex in [0, 255]. For each block: the 10 intra predictions from the
    *source* samples around it (127 above the frame, 129 left of it,
    above-right repeating above[n-1]), their SSE in int32, the cost
    ``sse + KF_MODE_BIAS[m] * lam`` with ``lam = openloop_lam(qindex)``,
    and the first mode of least cost. Returns (modes (R, C) int32, sse (R,
    C, 10) int32, best (R, C) int32, the least cost). CUDA inputs run the
    kernel of ``csrc/openloop_modes.cu`` (one launch, a warp per block,
    four blocks a CTA; a plane that does not start on 16 bytes is copied
    first, one not contiguous refused as by every wrapper); CPU inputs run
    ``openloop_modes_ref``. The two agree bit for bit.
    """
    qindex = int(qindex)
    _check_openloop_args(plane, qindex, n)
    if _device_kind("openloop_modes", plane) == "cpu":
        return openloop_modes_ref(plane, qindex, n)
    if plane.data_ptr() % 16:
        # the kernel reads rows as 16-byte vectors
        plane = plane.clone()
    h, w = plane.shape
    rows, cols = h // n, w // n
    b = rows * cols
    dev = plane.device
    out = torch.empty(12 * b, dtype=torch.int32, device=dev)
    tabs = _ol_tables_on(dev)
    ptr = out.data_ptr()
    _launch("openloop_modes", dev, plane.data_ptr(), tabs.data_ptr(), ptr,
            ptr + 8 * b, ptr + 4 * b, w, rows, cols, openloop_lam(qindex))
    openloop_modes.launches += 1
    return (out[:b].reshape(rows, cols), out[2 * b:].reshape(rows, cols, 10),
            out[b:2 * b].reshape(rows, cols))


openloop_modes.launches = 0


# ---------------------------------------------------------------------------
# The P-frame step's transform stage (csrc/transform_recon.cu)
# ---------------------------------------------------------------------------

TXFM_BLOCK_SIZES = (8, 16, 32)
# keeps |level| * q (levels clip at 8191) inside int32
TXFM_MAX_Q = (1 << 16) - 1
# the transform types (bitstream.tables.TxType values) the kernel has an
# instance of, by block size: DCT_DCT (0) at every size, and ADST_DCT (1,
# the keyframe strip's V and D63 luma) at 16
TXFM_TYPES = {8: (0,), 16: (0, 1), 32: (0,)}


@functools.lru_cache(maxsize=None)
def _txfm_tables_on(n: int, device: torch.device, tx_type: int = 0):
    """The kernel's constant tables of block size n and transform type
    ``tx_type`` on ``device``: the float64 forward column matrix F_col of
    the type (``txfm._fwd_matrices64``, the float32 one widened), the
    DCT's F_col, whose transpose over 2^5 at n=8 and 2^6 above the kernel
    reads as F_row^T (every type here has DCT rows;
    ``tests/test_torch_transform_recon.py``, and for ADST_DCT
    ``tests/test_torch_strip.py``, hold that to the row matrix bit for
    bit), and the int32 inverse scan of the type, each raster place's
    place in ``T.scan_order``."""
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.ops import txfm

    tt = T.TxType(tx_type)
    f_col = txfm._fwd_matrices64(n, device, tt)[0]
    f_dct = txfm._fwd_matrices64(n, device)[0]
    scan = np.asarray(T.scan_order(txfm.TX_SIZE[n], tt)[0])
    iscan = torch.from_numpy(np.argsort(scan).astype(np.int32)).to(device)
    return f_col.contiguous(), f_dct.contiguous(), iscan


def check_step_scalars(dc_q: int, ac_q: int, lam: int, lvl: int, lim: int,
                       mblim: int) -> None:
    """The step's scalars (``STEP_SCALARS``) as the kernels that read them
    take them: the quantizers in [1, TXFM_MAX_Q] (the transform's and the
    keyframe's), lam in [0, KF_MAX_LAM) (the keyframe's costs stay inside
    int32), the loop filter's level in [0, 63] and its limits not
    negative."""
    if not (0 < dc_q <= TXFM_MAX_Q and 0 < ac_q <= TXFM_MAX_Q):
        raise ValueError(f"step scalars: quantizers ({dc_q}, {ac_q}) "
                         f"outside [1, {TXFM_MAX_Q}]")
    if not 0 <= lam < KF_MAX_LAM:
        raise ValueError(f"step scalars: lam={lam} outside [0, "
                         f"{KF_MAX_LAM})")
    if not 0 <= lvl <= 63:
        raise ValueError(f"step scalars: loop filter lvl={lvl} outside "
                         "[0, 63]")
    if lim < 0 or mblim < 0:
        raise ValueError(f"step scalars: the loop filter's negative limits "
                         f"({lim}, {mblim})")


def _check_txfm_args(src_blocks, pred_blocks, n: int,
                     tx_type: int = 0) -> None:
    if n not in TXFM_BLOCK_SIZES:
        raise ValueError(f"transform_recon: n={n} not in {TXFM_BLOCK_SIZES}")
    if tx_type not in TXFM_TYPES[n]:
        raise ValueError(f"transform_recon: tx_type={tx_type} at n={n} not "
                         f"in {TXFM_TYPES[n]}")
    b = src_blocks.shape[0]
    _want_blocks("transform_recon: src_blocks", src_blocks, b, n, n)
    _want_blocks("transform_recon: pred_blocks", pred_blocks, b, n, n)
    if src_blocks.dtype != torch.uint8 or pred_blocks.dtype != torch.uint8:
        raise TypeError("transform_recon: blocks must be uint8, got "
                        f"{src_blocks.dtype} and {pred_blocks.dtype}")


def transform_recon(src_blocks, pred_blocks, sc, n: int, tx_type: int = 0):
    """Forward transform, quantizer, dequantizer, exact integer inverse,
    recon and eob of B blocks at once, on the card.

    src_blocks, pred_blocks: (B, n, n) uint8 contiguous CUDA tensors of
    one device, n in {8, 16, 32}; sc: the step's row (``STEP_SCALARS``)
    on their device, whose dc_q and ac_q (the quantizer steps, in [1,
    65535]) the kernel reads; tx_type: a ``TxType`` of ``TXFM_TYPES[n]``
    (DCT_DCT, or ADST_DCT at n=16). Returns (levels int16 (B, n, n), eob
    int32 (B,), recon uint8 (B, n, n)): the levels of the float64 forward
    transform and the dead-zone quantizer, one past the last nonzero level
    in the type's scan order (0 if none), and the decoder's
    reconstruction. It runs
    the kernel of ``csrc/transform_recon.cu`` or raises: CPU tensors go to
    the plain version ``pipeline/tpu_encdec.py:transform_recon_ref``
    through the step's ``transform_recon``, not through here. The two
    agree bit for bit unless a coefficient's ``|c| / q + 0.38`` lies within
    about 1e-12 of an integer (the float64 products sum in another order).
    """
    tx_type = int(tx_type)
    _check_txfm_args(src_blocks, pred_blocks, n, tx_type)
    if _device_kind("transform_recon", src_blocks, pred_blocks) != "cuda":
        raise ValueError("transform_recon: the kernel takes CUDA tensors; "
                         "CPU tensors go through the step's transform_recon")
    b = src_blocks.shape[0]
    dev = src_blocks.device
    _want_row("transform_recon", sc, dev)
    levels = torch.empty((b, n, n), dtype=torch.int16, device=dev)
    eob = torch.empty((b,), dtype=torch.int32, device=dev)
    recon = torch.empty((b, n, n), dtype=torch.uint8, device=dev)
    if b > 0:
        f_col, f_dct, iscan = _txfm_tables_on(n, dev, tx_type)
        _launch("transform_recon", dev, src_blocks.data_ptr(),
                pred_blocks.data_ptr(), f_col.data_ptr(), f_dct.data_ptr(),
                iscan.data_ptr(), levels.data_ptr(), eob.data_ptr(),
                recon.data_ptr(), sc.data_ptr(), tx_type, b, n)
        transform_recon.launches += 1
    return levels, eob, recon


transform_recon.launches = 0


def _occupancy(name: str, sizes, n, device, *more):
    """(CTAs of kernel ``name``'s instance of block size n an SM holds at
    once, the dynamic shared memory each asks for in bytes) on ``device``
    (the current CUDA device if None), from the CUDA runtime's occupancy
    query (the library's ``<name>_occupancy``, which takes n and then the
    ints ``more``); ``sizes`` None for a kernel of one instance (n
    None)."""
    fn = getattr(load_library(name), f"{name}_occupancy")
    ptrs = [ctypes.POINTER(ctypes.c_int)] * 2
    if sizes is None:
        args = ()
    else:
        if n not in sizes:
            raise ValueError(f"{name}: n={n} not in {sizes}")
        args = (n, *more)
    fn.argtypes = [ctypes.c_int] * len(args) + ptrs
    fn.restype = ctypes.c_int
    ctas, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(*args, ctypes.byref(ctas), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"{name}: the occupancy query failed with CUDA "
                           f"error {err}")
    return ctas.value, smem.value


def loop_filter_occupancy(split: int, device=None):
    """(CTAs of 256 threads an SM holds at once, the dynamic shared memory
    each asks for in bytes) of ``loop_filter``'s kernel with (split 1) or
    without (0) a split mask (``_occupancy``)."""
    return _occupancy("loop_filter", (0, 1), split, device)


def kframe_wave_occupancy(device=None):
    """(CTAs of 256 threads an SM holds at once, the dynamic shared memory
    each asks for in bytes) of ``kframe_wave``'s kernel (``_occupancy``)."""
    return _occupancy("kframe_wave", None, None, device)


def openloop_modes_occupancy(device=None):
    """(CTAs of 128 threads an SM holds at once, the dynamic shared memory
    each asks for in bytes) of ``openloop_modes``'s kernel
    (``_occupancy``)."""
    return _occupancy("openloop_modes", None, None, device)


def transform_recon_occupancy(n: int, device=None, tx_type: int = 0):
    """transform_recon's (resident CTAs per SM, dynamic shared memory in
    bytes) at block size n and transform type ``tx_type``
    (``_occupancy``)."""
    if tx_type not in TXFM_TYPES.get(n, ()):
        raise ValueError(f"transform_recon: tx_type={tx_type} at n={n} not "
                         f"in {TXFM_TYPES.get(n, ())}")
    return _occupancy("transform_recon", TXFM_BLOCK_SIZES, n, device,
                      tx_type)


# ---------------------------------------------------------------------------
# The P-frame step's quarter-pel search (csrc/subpel_search.cu)
# ---------------------------------------------------------------------------

SUBPEL_BLOCK_SIZES = (16, 32)  # the children's and the zone's
SUBPEL_MAX_R = 64  # keeps a window's offsets well inside int32


def _eighttap_taps(kernel: str, phases):
    """The (16, 8) int32 EIGHTTAP filter table, checked for what ``kernel``
    takes as given: phase 0 is the identity (it reads the pixel under tap 3
    and filters nothing) and every tap of ``phases`` is a signed byte (it
    packs a phase's taps four to a word for dp4a)."""
    from tpu_vp9_torch.bitstream import tables as T

    taps = np.asarray(T.subpel_filters(T.InterpFilter.EIGHTTAP), np.int32)
    if taps.shape != (16, 8) or taps[0].tolist() != [0, 0, 0, 128, 0, 0,
                                                     0, 0]:
        raise ValueError(f"{kernel}: the EIGHTTAP table's phase 0 is not "
                         "the identity")
    rows = taps[list(phases)]
    if not np.all((rows >= -128) & (rows <= 127)):
        raise ValueError(f"{kernel}: a tap of the phases "
                         f"{', '.join(map(str, phases))} is no signed byte")
    return np.ascontiguousarray(taps)


def _subpel_taps():
    """The table of ``subpel_search``, which filters at the phases 4, 8
    and 12 only (``_eighttap_taps``)."""
    return _eighttap_taps("subpel_search", (4, 8, 12))


@functools.lru_cache(maxsize=None)
def _subpel_taps_on(device: torch.device):
    """The (16, 8) int32 EIGHTTAP filter table on ``device``."""
    return torch.from_numpy(_subpel_taps()).to(device)


def _check_subpel_args(wins, src_blocks, dy, dx, n: int, r: int) -> None:
    if n not in SUBPEL_BLOCK_SIZES:
        raise ValueError(f"subpel_search: n={n} not in {SUBPEL_BLOCK_SIZES}")
    if not 0 <= r <= SUBPEL_MAX_R:
        raise ValueError(f"subpel_search: r={r} outside [0, {SUBPEL_MAX_R}]")
    b = src_blocks.shape[0]
    sw = n + 2 * r + 8
    _want_blocks("subpel_search: src_blocks", src_blocks, b, n, n)
    _want_blocks("subpel_search: wins", wins, b, sw, sw)
    if src_blocks.dtype != torch.uint8 or wins.dtype != torch.uint8:
        raise TypeError("subpel_search: wins and src_blocks must be uint8, "
                        f"got {wins.dtype} and {src_blocks.dtype}")
    if tuple(dy.shape) != (b,) or tuple(dx.shape) != (b,):
        raise ValueError(f"subpel_search: dy, dx of shapes "
                         f"{tuple(dy.shape)}, {tuple(dx.shape)}, want ({b},)")
    if dy.dtype != torch.int32 or dx.dtype != torch.int32:
        raise TypeError(f"subpel_search: dy, dx must be int32, got "
                        f"{dy.dtype} and {dx.dtype}")


def subpel_search(wins, src_blocks, dy, dx, n: int, r: int):
    """Exhaustive quarter-pel search of B blocks around their full-pel
    winners, on the card.

    wins: (B, n+2r+8, n+2r+8) uint8 windows whose origin is the block
    minus (r + 4); src_blocks: (B, n, n) uint8; dy, dx: (B,) int32
    full-pel winners in [-r, r] (taken as given: out-of-range values give
    undefined results, not reads outside the window); all contiguous CUDA
    tensors of one device; n in {16, 32}. Scores the 7 x 7 q3 offsets
    in +-6/8 pel by SSE over 16 phase planes (8-tap H then V, libvpx
    rounding) and keeps the first minimum in oy-major order. Returns
    (mv_r_q3, mv_c_q3, sse) int32 (B,): dy * 8 + oy, dx * 8 + ox and that
    offset's SSE, bit for bit what ``pipeline/tpu_encdec.py:
    subpel_search_ref`` returns. It runs the kernel of
    ``csrc/subpel_search.cu`` or raises: CPU tensors go to that plain
    version through the step's ``subpel_search``, not through here.
    """
    _check_subpel_args(wins, src_blocks, dy, dx, n, r)
    if _device_kind("subpel_search", wins, src_blocks, dy, dx) != "cuda":
        raise ValueError("subpel_search: the kernel takes CUDA tensors; CPU "
                         "tensors go through the step's subpel_search")
    b = src_blocks.shape[0]
    dev = src_blocks.device
    out = torch.empty((3, b), dtype=torch.int32, device=dev)
    if b > 0:
        _launch("subpel_search", dev, wins.data_ptr(), src_blocks.data_ptr(),
                dy.data_ptr(), dx.data_ptr(), _subpel_taps_on(dev).data_ptr(),
                out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), b, n,
                r)
        subpel_search.launches += 1
    mv_r, mv_c, sse = out.unbind(0)
    return mv_r, mv_c, sse


subpel_search.launches = 0


def subpel_search_occupancy(n: int, device=None):
    """subpel_search's (resident CTAs per SM, dynamic shared memory in
    bytes) at block size n (``_occupancy``)."""
    return _occupancy("subpel_search", SUBPEL_BLOCK_SIZES, n, device)


# ---------------------------------------------------------------------------
# The P-frame step's motion compensation (csrc/mc_predict.cu)
# ---------------------------------------------------------------------------

MC_BLOCK_SIZES = (16, 32)  # luma: the children's and the strip's, the zone's


def _mc_taps():
    """The table of ``mc_predict``, whose blocks take every phase
    (``_eighttap_taps``): chroma MVs reach all sixteen."""
    return _eighttap_taps("mc_predict", range(1, 16))


@functools.lru_cache(maxsize=None)
def _mc_taps_on(device: torch.device):
    """``mc_predict``'s checked (16, 8) int32 EIGHTTAP table on
    ``device``."""
    return torch.from_numpy(_mc_taps()).to(device)


@functools.lru_cache(maxsize=64)
def _mc_grid_check(shapes, grid, n: int) -> None:
    """Raise unless every window of ``mc_predict``'s grid (rows, cols, then
    each plane's (step, SW, y0, x0)) lies inside its plane of ``shapes``
    (Y, U, V) and holds a region of the plane's block size (checked once a
    shape)."""
    rows, cols, *specs = grid
    if rows < 1 or cols < 1 or len(specs) != 3:
        raise ValueError(f"mc_predict: a grid of {rows}x{cols} windows and "
                         f"{len(specs)} planes' windows")
    for p, ((h, w), (step, sw, y0, x0)) in enumerate(zip(shapes, specs)):
        if step < 1 or sw < (n >> min(p, 1)) + 7:
            raise ValueError(f"mc_predict: windows of side {sw} hold no "
                             f"region of block size {n >> min(p, 1)}")
        if (y0 < 0 or x0 < 0 or y0 + (rows - 1) * step + sw > h
                or x0 + (cols - 1) * step + sw > w):
            raise ValueError(f"mc_predict: the windows of {rows}x{cols} "
                             f"blocks of {step} at ({y0}, {x0}) leave the "
                             f"{(h, w)} plane {p}")


def _mc_sigs(name: str, plane_sigs, n: int, grid) -> None:
    """MC's checks of its block size n, its planes and its grid:
    ``plane_sigs`` the (shape, dtype, ...) of three references' three
    planes each (None where a reference is absent), LAST's first."""
    if n not in MC_BLOCK_SIZES:
        raise ValueError(f"{name}: n={n} not in {MC_BLOCK_SIZES}")
    last = plane_sigs[:3]
    for i, sig in enumerate(plane_sigs):
        if sig is None:
            continue
        p = i % 3
        if sig[1] != torch.uint8 or len(sig[0]) != 2:
            raise TypeError(f"{name}: plane {p} must be a uint8 plane, got "
                            f"{tuple(sig[0])} {sig[1]}")
        if sig[0] != last[p][0]:
            raise ValueError(f"{name}: plane {p} of every reference must be "
                             f"{tuple(last[p][0])}, got {tuple(sig[0])}")
    _mc_grid_check(tuple(tuple(sig[0]) for sig in last), grid, n)


def _planes_flat(name: str, planes, refs: int):
    """The (y, u, v) planes of up to ``refs`` references, LAST's first, as
    nine entries (None where a reference is absent)."""
    if not 1 <= len(planes) <= refs or planes[0] is None:
        raise ValueError(f"{name}: planes holds LAST's (y, u, v) planes "
                         f"and at most {refs - 1} more references")
    flat = []
    for ref in list(planes) + [None] * (3 - len(planes)):
        if ref is not None and len(ref) != 3:
            raise ValueError(f"{name}: a reference's planes are a (y, u, "
                             "v) triple")
        flat.extend((None, None, None) if ref is None else ref)
    return flat


def _check_mc_args(planes, pos_y, pos_x, mv_r, mv_c, n: int, grid,
                   ref_sel, win_idx, org_off_y, org_off_x):
    """Raise unless the arguments are what ``mc_predict`` takes; returns
    the tensors it reads, LAST's planes first."""
    flat = _planes_flat("mc_predict", planes, 3)
    _mc_sigs("mc_predict", [None if t is None else (t.shape, t.dtype)
                            for t in flat], n, tuple(grid))
    given = [t for t in flat if t is not None]
    b = pos_y.shape[0]
    rows, cols = grid[:2]
    for name, t in (("pos_y", pos_y), ("pos_x", pos_x), ("mv_r", mv_r),
                    ("mv_c", mv_c), ("win_idx", win_idx),
                    ("org_off_y", org_off_y), ("org_off_x", org_off_x)):
        if t is None:
            continue
        if tuple(t.shape) != (b,) or t.dtype != torch.int32:
            raise TypeError(f"mc_predict: {name} must be ({b},) int32, got "
                            f"{tuple(t.shape)} {t.dtype}")
        given.append(t)
    if ref_sel is not None:
        if tuple(ref_sel.shape) != (b,) or ref_sel.dtype != torch.int8:
            raise TypeError(f"mc_predict: ref_sel must be ({b},) int8, got "
                            f"{tuple(ref_sel.shape)} {ref_sel.dtype}")
        given.append(ref_sel)
    if (org_off_y is None) != (org_off_x is None):
        raise ValueError("mc_predict: org_off_y and org_off_x come together")
    if win_idx is None and rows * cols != b:
        raise ValueError(f"mc_predict: {rows * cols} windows for {b} blocks "
                         "without a window index")
    if not all(t.is_contiguous() for t in given):
        raise ValueError("mc_predict: inputs must be contiguous")
    return given


def mc_predict(planes, pos_y, pos_x, mv_r, mv_c, n: int, mi_rows: int,
               mi_cols: int, grid, ref_sel=None, win_idx=None,
               org_off_y=None, org_off_x=None):
    """Motion compensation of B blocks' Y, U and V read in place out of
    the border-extended reference planes, on the card, in one launch.

    planes: LAST's (y, u, v) planes, then optionally GOLDEN's and
    ALTREF's (None where absent): uint8, every reference's plane p of
    LAST's shape, border-extended. grid: (rows, cols, then Y's, U's and
    V's (step, SW, y0, x0)), the zone's grid of windows as ``pipeline/
    tpu_encdec.py:mc_window_grid`` gives it: window (row, col) of plane p
    is the SW x SW square at (y0 + step row, x0 + step col), which
    ``_extract_search_windows`` cuts at reach r = WIN_R for Y and
    CHROMA_WIN_R for U and V; a window that leaves its plane is refused
    (checked once a shape). pos_y, pos_x: (B,)
    int32 luma positions; mv_r, mv_c: (B,) int32 q3 MVs; ref_sel: (B,)
    int8 reference per block (0 LAST, 1 GOLDEN, 2 ALTREF; one without
    planes reads LAST) or None (LAST); win_idx: (B,) int32 window per
    block (a child reading its parent's) or None (window b; then the grid
    has B windows; an index past the grid traps); org_off_y, org_off_x:
    (B,) int32 luma offsets inside the window or None; all contiguous
    CUDA tensors of one device, planes of any start and pitch; n in {16,
    32}, the chroma planes at n / 2. Returns (pred_y (B, n, n), pred_u,
    pred_v (B, n/2, n/2)) uint8, bit for bit what ``pipeline/
    tpu_encdec.py:mc_predict_planes_ref`` returns with the EIGHTTAP
    table. It runs the kernel of ``csrc/mc_predict.cu`` or raises: CPU
    tensors go to that plain version through the step's ``mc_predict``,
    not through here.
    """
    given = _check_mc_args(planes, pos_y, pos_x, mv_r, mv_c, n, grid,
                           ref_sel, win_idx, org_off_y, org_off_x)
    dev = planes[0][0].device
    taps = _mc_taps_on(dev)
    if _device_kind("mc_predict", *given) != "cuda":
        raise ValueError("mc_predict: the kernel takes CUDA tensors; CPU "
                         "tensors go through the step's mc_predict")
    b = pos_y.shape[0]
    nc = n // 2
    pred_y = torch.empty((b, n, n), dtype=torch.uint8, device=dev)
    pred_u = torch.empty((b, nc, nc), dtype=torch.uint8, device=dev)
    pred_v = torch.empty((b, nc, nc), dtype=torch.uint8, device=dev)
    if b > 0:
        refs = list(planes) + [None] * (3 - len(planes))
        ptrs = [None if ref is None else ref[p].data_ptr()
                for p in range(3) for ref in refs]
        rows, cols, *specs = grid
        _launch("mc_predict", dev, *ptrs,
                *[None if t is None else t.data_ptr()
                  for t in (ref_sel, win_idx)],
                pos_y.data_ptr(), pos_x.data_ptr(), mv_r.data_ptr(),
                mv_c.data_ptr(),
                *[None if t is None else t.data_ptr()
                  for t in (org_off_y, org_off_x)],
                taps.data_ptr(), pred_y.data_ptr(), pred_u.data_ptr(),
                pred_v.data_ptr(), b, n, rows, cols,
                *(v for spec in specs for v in spec), WIN_R, CHROMA_WIN_R,
                *(planes[0][p].shape[1] for p in range(3)), int(mi_rows),
                int(mi_cols))
        mc_predict.launches += 1
    return pred_y, pred_u, pred_v


mc_predict.launches = 0


# what an instance of mc_predict's kernel decides before its MC: nothing
# (mc_predict), the zone's decision (mode_decide_mc) or the children's
# (descent_decide_mc, n = 16 only)
MC_DECIDED = {"plain": 0, "zone": 1, "children": 2}


def mc_predict_occupancy(n: int, device=None, decided: str = "plain"):
    """mc_predict's (resident CTAs of 128 threads per SM, dynamic shared
    memory in bytes) at luma block size n, for the instance that decides
    ``decided`` first (``MC_DECIDED``; ``_occupancy``)."""
    return _occupancy("mc_predict", MC_BLOCK_SIZES, n, device,
                      MC_DECIDED[decided])


# ---------------------------------------------------------------------------
# The decisions' argument checks, made once a shape (the descent's decision,
# the zone's, and both folded into MC)
# ---------------------------------------------------------------------------


def _sig_words(tensors):
    """A launch's tensors (None where absent) in one pass each: their key
    for the checks made once a key, each one's (shape, dtype, device,
    contiguity), and the launcher's words, each one's address (0 where
    absent)."""
    sig = tuple([None if t is None else
                 (t.shape, t.dtype, t.device, t.is_contiguous())
                 for t in tensors])
    return sig, [0 if t is None else t.data_ptr() for t in tensors]


def _one_device(name: str, sigs) -> None:
    """Raise unless the tensors of ``sigs`` (``_sig_words``) lie on one
    device and are contiguous."""
    given = [sig for sig in sigs if sig is not None]
    if any(sig[2] != given[0][2] for sig in given):
        raise ValueError(f"{name}: inputs on different devices "
                         f"{sorted({str(sig[2]) for sig in given})}")
    if not all(sig[3] for sig in given):
        raise ValueError(f"{name}: inputs must be contiguous")


def _want_sig(name: str, what: str, sig, shape, dtype) -> None:
    """Raise unless ``sig`` is (``shape``, ``dtype``)."""
    if tuple(sig[0]) != tuple(shape) or sig[1] != dtype:
        raise TypeError(f"{name}: {what} must be {tuple(shape)} {dtype}, "
                        f"got {tuple(sig[0])} {sig[1]}")


def _rate_tables(rates):
    """A decision's rate tables as its launcher takes them: (the device row
    "scalars", the three LUTs, the per-block lam_bits or None), and the
    LUTs' reach; all None without tables."""
    if rates is None:
        return (None,) * 5, None
    lam = rates["lam_bits"]
    return ((rates["scalars"], rates["joint_cost"], rates["nmv_row"],
             rates["nmv_col"],
             lam if isinstance(lam, torch.Tensor) else None),
            int(rates["mv_cost_max"]))


def _rates_sigs(name: str, sigs, m, b: int, per_block: bool) -> None:
    """The rate tables' checks: ``sigs`` the scalars row's (skipped where
    None: a launcher that does not read it), the three LUTs' and a
    per-block lam_bits' (None where it is a host number; refused unless
    ``per_block``)."""
    for what, sig, size in zip(("scalars", "joint_cost", "nmv_row",
                                "nmv_col"), sigs[:4],
                               (len(RATE_SCALARS), 4, 2 * m + 1, 2 * m + 1)):
        if sig is not None or what != "scalars":
            _want_sig(name, what, sig, (size,), torch.int32)
    if sigs[4] is not None:
        if not per_block:
            raise TypeError(f"{name}: the children take the frame's "
                            "lam_bits, a host number")
        _want_sig(name, "lam_bits", sigs[4], (b,), torch.float32)


def _new_bits_sig(name: str, sig) -> None:
    if len(sig[0]) != 1 or sig[1] != torch.float32:
        raise TypeError(f"{name}: new_bits must be 1-D float32, got "
                        f"{tuple(sig[0])} {sig[1]}")


def _zone_sigs(name: str, sigs, rows: int, cols: int, r_map: int,
               m) -> None:
    """The zone's decision's checks on ``sigs`` (``_sig_words``) of ssem,
    src2m, sse_zero, sse_new, new_r, new_c, prev_mv, left_edge, gold_sse,
    ALTREF's four, the rate tables (``_rate_tables``) and new_bits; ``m``
    the LUTs' reach (None without rate tables)."""
    b = rows * cols
    if sigs[4] is None or tuple(sigs[4][0]) != (b,):
        got = None if sigs[4] is None else tuple(sigs[4][0])
        raise ValueError(f"{name}: {got} blocks in a {rows}x{cols} zone")
    d = 2 * r_map + 1
    _want_sig(name, "ssem", sigs[0], (b, d, d), torch.int32)
    for what, sig in zip(("src2m", "sse_zero", "sse_new", "new_r", "new_c"),
                         sigs[1:6]):
        _want_sig(name, what, sig, (b,), torch.int32)
    _want_sig(name, "prev_mv", sigs[6], (b, 2), torch.int32)
    if sigs[7] is not None:
        _want_sig(name, "left_edge", sigs[7], (rows, 2), torch.int32)
    if sigs[8] is not None:
        _want_sig(name, "gold_sse", sigs[8], (2, b), torch.int32)
    alt = sigs[9:13]
    if any(sig is not None for sig in alt):
        if m is None:
            raise ValueError(f"{name}: ALTREF takes the frame's rate tables")
        for what, sig in zip(("sse_zero", "sse_new", "new_r", "new_c"), alt):
            if sig is None:
                raise ValueError(f"{name}: alt is ALTREF's (sse_zero, "
                                 "sse_new, new_r, new_c)")
            _want_sig(name, f"ALTREF's {what}", sig, (b,), torch.int32)
    if m is not None:
        _rates_sigs(name, sigs[13:18], m, b, True)
    _new_bits_sig(name, sigs[18])


def _children_sigs(name: str, sigs, m) -> int:
    """The children's decision's checks on ``sigs`` (``_sig_words``) of
    ssem, sse_zero, sse_new, sub_r, sub_c, src2, base_y, base_x, par_r,
    par_c, new_bits and the rate tables (``_rate_tables``; the scalars row
    read, a per-block lam_bits refused); ``m`` the LUTs' reach (None
    without rate tables). Returns the children's count."""
    nch = sigs[1][0][0] if len(sigs[1][0]) else 0
    d = 2 * DESCENT_R + 1
    _want_sig(name, "ssem", sigs[0], (nch, d, d), torch.int32)
    for what, sig in zip(("sse_zero", "sse_new", "sub_r", "sub_c", "src2",
                          "base_y", "base_x", "par_r", "par_c"), sigs[1:10]):
        _want_sig(name, what, sig, (nch,), torch.int32)
    _new_bits_sig(name, sigs[10])
    if m is not None:
        if sigs[11] is None:
            raise TypeError(f"{name}: scalars must be given")
        _rates_sigs(name, sigs[11:16], m, nch, False)
    return nch


@functools.lru_cache(maxsize=64)
def _zone_spec(key, rows: int, cols: int, r_map: int, m):
    """mode_decide's checks, once per key (``_sig_words``)."""
    _one_device("mode_decide", key)
    _zone_sigs("mode_decide", key, rows, cols, r_map, m)


@functools.lru_cache(maxsize=64)
def _children_spec(key, m):
    """descent_decide's checks, once per key (``_sig_words``); returns the
    children's count."""
    _one_device("descent_decide", key)
    return _children_sigs("descent_decide", key, m)


# ---------------------------------------------------------------------------
# The P-frame step's split16 descent (csrc/descent.cu)
# ---------------------------------------------------------------------------

# the kernels' compiled shapes: the children's full-pel reach (the step's
# CHILD_R) and the side of a parent's union slice
DESCENT_R = 8
DESCENT_UNION = 64
# descent_gather's int32 rows, each (4K,): sum(src^2), the ZERO SSE (the
# co-located block of LAST's bordered luma), the map centre's
# displacement, the child's position, its offset in the parent's window,
# the parent's window index and final MV
GATHER_INTS = ("src2", "sse_zero", "base_y", "base_x", "pos_y", "pos_x",
               "off_y", "off_x", "win_idx", "par_r", "par_c")
# descent_occupancy's kernels, by their index in the source
DESCENT_KERNELS = ("gather", "decide", "pack", "split")


def _want(name: str, what: str, t, shape, dtype) -> None:
    """Raise unless ``t`` has ``shape`` and ``dtype`` and is contiguous."""
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {tuple(shape)} {dtype}, "
                        f"got {tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _want_plane(name: str, what: str, t, rows: int, cols: int) -> None:
    """Raise unless ``t`` is a contiguous uint8 plane of at least ``rows``
    x ``cols``."""
    if t.dim() != 2 or t.dtype != torch.uint8:
        raise TypeError(f"{name}: {what} must be a uint8 plane, got "
                        f"{tuple(t.shape)} {t.dtype}")
    if t.shape[0] < rows or t.shape[1] < cols:
        raise ValueError(f"{name}: {what} of {tuple(t.shape)} holds no "
                         f"{rows}x{cols} grid")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _cuda_only(name: str, *tensors) -> torch.device:
    """The one CUDA device of ``tensors``; raise for CPU tensors (they take
    the plain version through the step's dispatch)."""
    if _device_kind(name, *tensors) != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors; CPU "
                         f"tensors go through the step's {name}")
    return tensors[0].device


def _contiguous(name: str, tensors) -> None:
    """Raise unless every tensor is contiguous."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def _aligned(name: str, what: str, t, to: int) -> None:
    """Raise unless ``t``'s first byte lies on a ``to``-byte boundary (the
    kernel's word loads and stores need it)."""
    if t.data_ptr() % to:
        raise ValueError(f"{name}: {what} must start on a {to}-byte "
                         f"boundary (the kernel reads and writes it in "
                         f"{to}-byte words)")


@functools.lru_cache(maxsize=None)
def _gather_spec(k: int, shapes, dtypes, rows32: int, cols32: int,
                 border: int):
    """descent_gather's checks of its arguments' shapes and dtypes (sel,
    wins, dy, dx, parent_mv, src_y, src_u, src_v, ref_y), once per
    shape: raise where one is refused, else return the launcher's ints
    after K (B32, SW, cols32, the three pitches, the border) and the
    output's byte offsets (cw, csrc_u, csrc_v, ints; csrc at 0)."""
    name = "descent_gather"
    b32 = rows32 * cols32
    sel, wins, dy, dx, pmv, sy, su, sv, ry = shapes
    want = (((k,), torch.int32, "sel"), ((b32,), torch.int32, "dy"),
            ((b32,), torch.int32, "dx"), ((b32, 2), torch.int32,
                                           "parent_mv"))
    for (shape, dtype, what), got, gdt in zip(
            want, (sel, dy, dx, pmv), (dtypes[0], *dtypes[2:5])):
        if got != shape or gdt != dtype:
            raise TypeError(f"{name}: {what} must be {shape} {dtype}, got "
                            f"{got} {gdt}")
    if dtypes[1] != torch.uint8:
        raise TypeError(f"{name}: wins must be uint8, got {dtypes[1]}")
    if len(wins) != 3 or wins[0] != b32 or wins[1] != wins[2] or \
            wins[1] < DESCENT_UNION:
        raise ValueError(f"{name}: wins of {wins}, want ({b32}, SW, SW) "
                         f"with SW >= {DESCENT_UNION}")
    if wins[1] % 8:
        raise ValueError(f"{name}: wins' side {wins[1]} is not a multiple "
                         "of 8 (each row must start on an 8-byte boundary)")
    for what, shp, dtype, n in (("src_y", sy, dtypes[5], 32),
                                ("src_u", su, dtypes[6], 16),
                                ("src_v", sv, dtypes[7], 16)):
        if len(shp) != 2 or dtype != torch.uint8:
            raise TypeError(f"{name}: {what} must be a uint8 plane, got "
                            f"{shp} {dtype}")
        if shp[0] < rows32 * n or shp[1] < cols32 * n:
            raise ValueError(f"{name}: {what} of {shp} holds no "
                             f"{rows32 * n}x{cols32 * n} grid")
    if su != sv:
        raise ValueError(f"{name}: src_u {su} and src_v {sv} differ")
    if len(ry) != 2 or dtypes[8] != torch.uint8:
        raise TypeError(f"{name}: ref_y must be a uint8 plane, got {ry} "
                        f"{dtypes[8]}")
    if ry[0] < rows32 * 32 + border or ry[1] < cols32 * 32 + border:
        raise ValueError(f"{name}: ref_y of {ry} holds no "
                         f"{rows32 * 32}x{cols32 * 32} grid at border "
                         f"{border}")
    for what, pitch, to in (("src_y", sy[1], 16), ("src_u", su[1], 8),
                            ("ref_y", ry[1], 16), ("the border", border,
                                                   16)):
        if pitch % to:
            raise ValueError(f"{name}: {what} of {pitch} bytes is not a "
                             f"multiple of {to} (each row must start on a "
                             f"{to}-byte boundary)")
    nch = 4 * k
    cw_side = 16 + 2 * DESCENT_R + 8
    offs = (nch * 256, nch * (256 + cw_side * cw_side),
            nch * (320 + cw_side * cw_side),
            nch * (384 + cw_side * cw_side))
    return (b32, wins[1], cols32, sy[1], su[1], ry[1], border), offs


def descent_gather(sel, wins, dy, dx, parent_mv, src_y, src_u, src_v, ref_y,
                   geom, border: int):
    """The descent's gathers and the children's ZERO SSE for the 4K
    children of the K parents ``sel``, on the card, in one launch: a CTA
    of four warps per parent.

    sel: (K,) int32 parent indices in [0, B32) (raster order of the 32
    grid; outside it the kernel traps); wins: (B32, SW, SW) uint8, the
    parents' LAST search windows, read in place (8-byte aligned, SW a
    multiple of 8); dy, dx: (B32,) int32 the parents' full-pel winners;
    parent_mv: (B32, 2) int32 their final q3 MVs; src_y, src_u, src_v: the
    padded source planes (uint8, holding the rows32 x cols32 grid at 32
    and 16; rows 16-byte aligned for Y, 8 for U and V); ref_y: LAST's
    luma bordered by ``border`` (rows 16-byte aligned, the border a
    multiple of 16); all contiguous CUDA tensors of one device; ``geom``
    the step's Geom. A refused alignment raises ValueError. Returns a
    dict: "cw" (4K, 40, 40) the children's search windows, "csrc" (4K, 16,
    16), "csrc_u", "csrc_v" (4K, 8, 8) their source blocks (uint8), and
    the (4K,) int32 rows of ``GATHER_INTS``, views of one allocation: bit
    for bit what ``pipeline/tpu_encdec.py:descent_gather_ref`` returns. It
    runs the kernel of ``csrc/descent.cu`` or raises."""
    name = "descent_gather"
    ins = (sel, wins, dy, dx, parent_mv, src_y, src_u, src_v, ref_y)
    k = sel.shape[0]
    ints, (o_cw, o_u, o_v, o_i) = _gather_spec(
        k, tuple(tuple(t.shape) for t in ins), tuple(t.dtype for t in ins),
        geom.rows32, geom.cols32, int(border))
    dev = _cuda_only(name, *ins)
    _contiguous(name, ins)
    for what, t, to in (("wins", wins, 8), ("src_y", src_y, 16),
                        ("src_u", src_u, 8), ("src_v", src_v, 8),
                        ("ref_y", ref_y, 16)):
        _aligned(name, what, t, to)
    nch = 4 * k
    buf = torch.empty(o_i + 4 * len(GATHER_INTS) * nch, dtype=torch.uint8,
                      device=dev)
    if k > 0:
        at = buf.data_ptr()
        _launch(name, dev, *(t.data_ptr() for t in ins), at + o_cw, at,
                at + o_u, at + o_v, at + o_i, k, *ints)
        descent_gather.launches += 1
    side = 16 + 2 * DESCENT_R + 8
    out = {"cw": buf[o_cw:o_u].view(nch, side, side),
           "csrc": buf[:o_cw].view(nch, 16, 16),
           "csrc_u": buf[o_u:o_v].view(nch, 8, 8),
           "csrc_v": buf[o_v:o_i].view(nch, 8, 8)}
    out.update(zip(GATHER_INTS,
                   buf[o_i:].view(torch.int32).view(len(GATHER_INTS), nch)
                   .unbind(0)))
    return out


descent_gather.launches = 0


def descent_decide(ssem, sse_zero, sse_new, sub_r, sub_c, src2, base_y,
                   base_x, par_r, par_c, sc, new_bits, rates, proxy):
    """The children's candidate decision, {ZERO, NEW, PARENT}, on the
    card: a thread per child, one launch (the step makes this decision
    inside the children's MC launch, ``descent_decide_mc``).

    ssem: (4K, 17, 17) int32 the children's relative-SSE maps; sse_zero,
    sse_new, sub_r, sub_c (the quarter-pel winner in the window, q3),
    src2, base_y, base_x (the map centre's displacement), par_r, par_c
    (the parent's final MV): (4K,) int32; all contiguous CUDA tensors of
    one device. rates: ``upload_rate_tabs``' dict, whose device row
    "scalars" (the frame's lam_bits, the mode costs) and three LUTs the
    kernel reads, or None; then the lam of ``sc`` (the step's row,
    ``STEP_SCALARS``, read on the card) and ``proxy`` = (ZERO's, PARENT's
    rate) weigh the costs and NEW's rate is ``new_bits`` (float32, indexed
    by the mvd, which must stay inside it: past it the kernel traps).
    Returns (mv_r, mv_c (4K,) int32, mv (4K, 2) int16), bit for bit what
    ``pipeline/tpu_encdec.py:descent_decide_ref`` returns. It runs the
    kernel of ``csrc/descent.cu`` or raises."""
    name = "descent_decide"
    tabs, m = _rate_tables(rates)
    key, ptrs = _sig_words((ssem, sse_zero, sse_new, sub_r, sub_c, src2,
                            base_y, base_x, par_r, par_c, new_bits, *tabs))
    nch = _children_spec(key, m)
    dev = ssem.device
    if _device_kind(name, ssem) != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors; CPU "
                         f"tensors go through the step's {name}")
    _want_row(name, sc, dev)
    mv = torch.empty((2, nch), dtype=torch.int32, device=dev)
    mv16 = torch.empty((nch, 2), dtype=torch.int16, device=dev)
    if nch > 0:
        # ssem .. new_bits, the scalars row and the three LUTs, the step's
        # row
        _launch(name, dev, *ptrs[:15], sc.data_ptr(), mv.data_ptr(),
                mv16.data_ptr(), float(proxy[0]), float(proxy[1]), nch,
                int(rates is not None), new_bits.shape[0])
        descent_decide.launches += 1
    mv_r, mv_c = mv.unbind(0)
    return mv_r, mv_c, mv16


descent_decide.launches = 0


@functools.lru_cache(maxsize=None)
def _pack_spec(shapes, dtypes):
    """descent_pack's checks of its arguments' shapes and dtypes (``_PACK_
    ARGS``), once per shape: raise where one is refused, else return K."""
    name = "descent_pack"
    nch = shapes[0][0] if shapes[0] else 0
    if nch % 4:
        raise ValueError(f"{name}: {nch} children, not four a parent")
    want = ((nch,), torch.int32), ((nch, 16, 16), torch.int16), \
        ((nch, 8, 8), torch.int16), ((nch, 16, 16), torch.uint8), \
        ((nch, 8, 8), torch.uint8)
    kinds = (0, 0, 0, 1, 2, 2, 3, 4, 4, 3)
    for what, kind, got, gdt in zip(_PACK_ARGS, kinds, shapes, dtypes):
        shape, dtype = want[kind]
        if got != shape or gdt != dtype:
            raise TypeError(f"{name}: {what} must be {shape} {dtype}, got "
                            f"{got} {gdt}")
    return nch // 4


_PACK_ARGS = ("eob_y", "eob_u", "eob_v", "lv_y", "lv_u", "lv_v", "rec_y",
              "rec_u", "rec_v", "csrc")


def descent_pack(eob_y, eob_u, eob_v, lv_y, lv_u, lv_v, rec_y, rec_u, rec_v,
                 csrc):
    """The children's pack and recon SSE, on the card: a CTA per parent,
    one launch.

    eob_y, eob_u, eob_v: (4K,) int32; lv_y (4K, 16, 16), lv_u, lv_v (4K, 8,
    8) int16; rec_y (4K, 16, 16), rec_u, rec_v (4K, 8, 8) uint8; csrc (4K,
    16, 16) uint8, the children's luma source; all contiguous CUDA tensors
    of one device, the levels, rec_y and csrc 16-byte aligned, rec_u and
    rec_v 8-byte aligned (a refused alignment raises ValueError). Returns a
    dict: "skip" (4K,) bool, "dist4", "rate4" (K,) int64 (the parent's sums
    of its children's recon SSE and nonzero levels), "rec_y32" (K, 32, 32),
    "rec_u16", "rec_v16" (K, 16, 16) uint8 (the children's recon merged),
    views of one allocation, bit for bit what ``pipeline/tpu_encdec.py:
    descent_pack_ref`` returns. It runs the kernel of ``csrc/descent.cu``
    or raises."""
    name = "descent_pack"
    ins = (eob_y, eob_u, eob_v, lv_y, lv_u, lv_v, rec_y, rec_u, rec_v, csrc)
    k = _pack_spec(tuple(tuple(t.shape) for t in ins),
                   tuple(t.dtype for t in ins))
    dev = _cuda_only(name, *ins)
    if (lv_y.data_ptr() | lv_u.data_ptr() | lv_v.data_ptr()
            | rec_y.data_ptr() | csrc.data_ptr()) % 16 \
            or (rec_u.data_ptr() | rec_v.data_ptr()) % 8:
        for what, t, to in (("lv_y", lv_y, 16), ("lv_u", lv_u, 16),
                            ("lv_v", lv_v, 16), ("rec_y", rec_y, 16),
                            ("csrc", csrc, 16), ("rec_u", rec_u, 8),
                            ("rec_v", rec_v, 8)):
            _aligned(name, what, t, to)
    # one allocation, per parent: dist4 and rate4 (16 bytes), rec_y32
    # (1,024), rec_u16 and rec_v16 (256 each), skip (4); each part starts
    # on a 16-byte boundary
    o_y, o_u, o_v, o_s = 16 * k, 1040 * k, 1296 * k, 1552 * k
    buf = torch.empty(o_s + 4 * k, dtype=torch.uint8, device=dev)
    at = buf.data_ptr()
    if k > 0:
        _launch(name, dev, *(t.data_ptr() for t in ins), at + o_s, at,
                at + 8 * k, at + o_y, at + o_u, at + o_v, k)
        descent_pack.launches += 1
    sums = buf[:o_y].view(torch.int64)
    return {"skip": buf[o_s:].view(torch.bool), "dist4": sums[:k],
            "rate4": sums[k:], "rec_y32": buf[o_y:o_u].view(k, 32, 32),
            "rec_u16": buf[o_u:o_v].view(k, 16, 16),
            "rec_v16": buf[o_v:o_s].view(k, 16, 16)}


descent_pack.launches = 0


@functools.lru_cache(maxsize=None)
def _split_spec(k: int, shapes, dtypes, rows32: int, cols32: int):
    """descent_split's checks of its arguments' shapes and dtypes (sel,
    dist_b, rate_b, dist4, rate4, rec_y, rec_u, rec_v, rec_y32, rec_u16,
    rec_v16), once per shape: raise where one is refused."""
    name = "descent_split"
    b32 = rows32 * cols32
    want = (((k,), torch.int32), ((b32,), torch.int32),
            ((b32,), torch.int64), ((k,), torch.int64),
            ((k,), torch.int64), ((rows32 * 32, cols32 * 32), torch.uint8),
            ((rows32 * 16, cols32 * 16), torch.uint8),
            ((rows32 * 16, cols32 * 16), torch.uint8),
            ((k, 32, 32), torch.uint8), ((k, 16, 16), torch.uint8),
            ((k, 16, 16), torch.uint8))
    for what, (shape, dtype), got, gdt in zip(_SPLIT_ARGS, want, shapes,
                                              dtypes):
        if got != shape or gdt != dtype:
            raise TypeError(f"{name}: {what} must be {shape} {dtype}, got "
                            f"{got} {gdt}")


_SPLIT_ARGS = ("sel", "dist_b", "rate_b", "dist4", "rate4", "rec_y", "rec_u",
               "rec_v", "rec_y32", "rec_u16", "rec_v16")


def descent_split(sel, dist_b, rate_b, dist4, rate4, rec_y, rec_u, rec_v,
                  rec_y32, rec_u16, rec_v16, sc, geom, extra: float):
    """The 32-against-4x16 decision and the recon merge, on the card, in
    one launch: a warp per selected parent, split32 zeroed by a memset on
    the stream first.

    sel: (K,) int32 distinct parent indices in [0, B32) (outside it the
    kernel traps); dist_b (B32,) int32 and rate_b (B32,) int64 the zone's
    distortion and nonzero levels; dist4, rate4 (K,) int64 the children's;
    rec_y (rows32 * 32, cols32 * 32), rec_u, rec_v (rows32 * 16, cols32 *
    16) uint8 the zone's recon planes, written in place: a parent that
    splits takes its children's merged blocks rec_y32 (K, 32, 32), rec_u16,
    rec_v16 (K, 16, 16) uint8, every other block stays as it was; the six
    byte tensors 16-byte aligned (a refused alignment raises ValueError);
    all contiguous CUDA tensors of one device. sc: the step's row
    (``STEP_SCALARS``), whose lam the kernel reads; ``extra``: the split's
    extra rate; at mi_rows % 4 == 3 the overhang row never splits. Returns
    (split32 (rows32, cols32) int32, rec_y, rec_u, rec_v: the planes
    given), the values ``pipeline/tpu_encdec.py:descent_split_ref``
    returns bit for bit. It runs the kernel of ``csrc/descent.cu`` or
    raises."""
    name = "descent_split"
    r32, c32 = geom.rows32, geom.cols32
    ins = (sel, dist_b, rate_b, dist4, rate4, rec_y, rec_u, rec_v, rec_y32,
           rec_u16, rec_v16)
    k = sel.shape[0]
    _split_spec(k, tuple(tuple(t.shape) for t in ins),
                tuple(t.dtype for t in ins), r32, c32)
    dev = _cuda_only(name, *ins)
    _contiguous(name, ins)
    for what, t in zip(_SPLIT_ARGS[5:], ins[5:]):
        _aligned(name, what, t, 16)
    _want_row(name, sc, dev)
    b32 = r32 * c32
    split32 = torch.empty((r32, c32), dtype=torch.int32, device=dev)
    limit = (r32 - 1) * c32 if geom.mi_rows % 4 == 3 else b32
    if b32 > 0:
        _launch(name, dev, *(t.data_ptr() for t in ins[:5]),
                rec_y32.data_ptr(), rec_u16.data_ptr(), rec_v16.data_ptr(),
                split32.data_ptr(), rec_y.data_ptr(), rec_u.data_ptr(),
                rec_v.data_ptr(), sc.data_ptr(), float(extra), k, b32, c32,
                limit)
        if k > 0:
            descent_split.launches += 1
    return split32, rec_y, rec_u, rec_v


descent_split.launches = 0


def descent_occupancy(kernel: str, device=None):
    """(resident CTAs per SM, dynamic shared memory in bytes) of the
    descent's kernel ``kernel`` (one of ``DESCENT_KERNELS``;
    ``_occupancy``)."""
    if kernel not in DESCENT_KERNELS:
        raise ValueError(f"descent: no kernel {kernel!r} in "
                         f"{DESCENT_KERNELS}")
    return _occupancy("descent", range(len(DESCENT_KERNELS)),
                      DESCENT_KERNELS.index(kernel), device)


# ---------------------------------------------------------------------------
# The P-frame step's mode decision (csrc/mode_decide.cu)
# ---------------------------------------------------------------------------

# the rate tables' scalars as the kernel reads them from the device (the
# row ``pipeline/tpu_encdec.py:upload_rate_tabs`` uploads): the four
# mode-tree costs, the three references' signalling costs, mv_cost_max,
# lam_bits' float32 bits
RATE_SCALARS = ("mode_cost0", "mode_cost1", "mode_cost2", "mode_cost3",
                "ref_last", "ref_golden", "ref_altref", "mv_cost_max",
                "lam_bits")


def rate_scalars(tabs) -> np.ndarray:
    """The rate tables' scalars (``make_rate_tabs``' dict) as one int32
    row in the order of ``RATE_SCALARS``, lam_bits as its float32 bits."""
    lam = np.asarray(np.float32(tabs["lam_bits"])).reshape(1)
    return np.concatenate([np.asarray(tabs["mode_cost"], np.int32)[:4],
                           np.asarray(tabs["ref_cost"], np.int32)[:3],
                           np.asarray([tabs["mv_cost_max"]], np.int32),
                           lam.view(np.int32)]).astype(np.int32)


def mode_decide(ssem, src2m, sse_zero, sse_new, new_r, new_c, prev_mv,
                rows: int, cols: int, r_map: int, q3_shift: int,
                sse_scale: int, sc, new_bits, rates, left_edge, gold_sse,
                alt, proxy):
    """The zone's mode decision, LAST's five candidates, GOLDEN's two,
    ALTREF's two and the reference choice, on the card: a warp per
    block, its candidates spread over the lanes, one launch (the step
    makes this decision inside its MC launch, ``mode_decide_mc``).

    ssem: (B, 2 r_map + 1, 2 r_map + 1) int32 the search's relative-SSE
    maps; src2m, sse_zero, sse_new, new_r, new_c: (B,) int32; prev_mv:
    (B, 2) int32; B = rows x cols in raster order; left_edge: (rows, 2)
    int32 LEFT at column 0 or None (zeros); gold_sse: (2, B) int32
    GOLDEN's ZERO and previous-MV SSEs or None; alt: ALTREF's (sse_zero,
    sse_new, new_r, new_c), (B,) int32 each, or None (with ``rates``
    only); rates: ``upload_rate_tabs``' dict, whose device row "scalars"
    (``RATE_SCALARS``) and three LUTs the kernel reads (its host numbers
    are not read: the same upload made both), its "lam_bits" the frame's
    host number or (tune SQ) a (B,) float32 tensor the kernel reads
    instead; or None: then the lam of ``sc`` (the step's row,
    ``STEP_SCALARS``, read on the card) and ``proxy`` (``CAND_RATE_PROXY``)
    weigh the costs and NEW's rate is ``new_bits`` (float32, indexed by
    the mvd, which must stay inside it: past it the kernel traps); all
    contiguous CUDA tensors of one device. Returns (mv_r, mv_c (B,) int32,
    ref_sel (B,) int8), bit for bit what ``pipeline/tpu_encdec.py:
    mode_decide_ref`` returns. It runs the kernel of
    ``csrc/mode_decide.cu`` or raises."""
    name = "mode_decide"
    if alt is not None and len(alt) != 4:
        raise ValueError(f"{name}: alt is ALTREF's (sse_zero, sse_new, "
                         "new_r, new_c)")
    tabs, m = _rate_tables(rates)
    key, ptrs = _sig_words((ssem, src2m, sse_zero, sse_new, new_r, new_c,
                            prev_mv, left_edge, gold_sse,
                            *(alt or (None,) * 4), *tabs, new_bits))
    _zone_spec(key, rows, cols, r_map, m)
    dev = ssem.device
    if _device_kind(name, ssem) != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors; CPU "
                         f"tensors go through the step's {name}")
    _want_row(name, sc, dev)
    b = rows * cols
    mv = torch.empty((2, b), dtype=torch.int32, device=dev)
    ref_sel = torch.empty((b,), dtype=torch.int8, device=dev)
    if b > 0:
        rz, _, _, rp, rs = (float(v) for v in proxy)
        _launch(name, dev, *ptrs, sc.data_ptr(), mv.data_ptr(),
                ref_sel.data_ptr(), rz, rp, rs, b, rows, cols, r_map,
                q3_shift, sse_scale, int(rates is not None),
                new_bits.shape[0])
        mode_decide.launches += 1
    mv_r, mv_c = mv.unbind(0)
    return mv_r, mv_c, ref_sel


mode_decide.launches = 0


def mode_decide_occupancy(device=None):
    """(resident CTAs of 128 threads per SM, dynamic shared memory in
    bytes) of ``mode_decide``'s kernel (``_occupancy``)."""
    return _occupancy("mode_decide", None, None, device)


# ---------------------------------------------------------------------------
# The decisions folded into MC (csrc/mc_predict.cu's decided instances)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _zone_mc_spec(key, rows: int, cols: int, r_map: int, n: int, grid,
                  m):
    """mode_decide_mc's checks of its arguments' shapes, dtypes, device
    and contiguity, once per key: ``key`` (``_sig_words``) of the nine
    planes plane by plane, pos_y, pos_x, ssem, src2m, sse_zero, sse_new,
    new_r, new_c, prev_mv, left_edge, gold_sse, ALTREF's four, the rate
    tables' scalars, three LUTs and per-block lam_bits, new_bits; ``m``
    the LUTs' reach (None without rate tables). The refusals of
    mode_decide and of mc_predict."""
    name = "mode_decide_mc"
    _one_device(name, key)
    _zone_sigs(name, key[11:30], rows, cols, r_map, m)
    # the planes reference by reference
    _mc_sigs(name, [key[3 * p + r] for r in range(3) for p in range(3)], n,
             grid)
    if tuple(grid[:2]) != (rows, cols):
        raise ValueError(f"{name}: the grid's {grid[0]}x{grid[1]} windows "
                         f"are not the zone's {rows}x{cols} blocks")
    for what, sig in zip(("pos_y", "pos_x"), key[9:11]):
        _want_sig(name, what, sig, (rows * cols,), torch.int32)


# the pointer words that start the decided launchers' word arrays: the
# zone's nine planes, pos_y, pos_x, the taps, three predictions, the
# decision's nineteen inputs, the step's row and three outputs; the
# children's three planes, five index rows, the taps, three predictions,
# fifteen inputs, the step's row and two outputs
MC_ZONE_PTR_WORDS = 38
MC_CHILDREN_PTR_WORDS = 30


def _decided_outputs(b: int, n: int, dev, with_ref: bool):
    """A decided launch's outputs: mv (2, B) int32, ref_sel (B,) int8
    (``with_ref``; else None), mv16 (B, 2) int16, pred_y (B, n, n), pred_u,
    pred_v (B, n/2, n/2) uint8."""
    nc = n // 2
    return (torch.empty((2, b), dtype=torch.int32, device=dev),
            torch.empty((b,), dtype=torch.int8, device=dev) if with_ref
            else None,
            torch.empty((b, 2), dtype=torch.int16, device=dev),
            torch.empty((b, n, n), dtype=torch.uint8, device=dev),
            torch.empty((b, nc, nc), dtype=torch.uint8, device=dev),
            torch.empty((b, nc, nc), dtype=torch.uint8, device=dev))


def mode_decide_mc(ssem, src2m, sse_zero, sse_new, new_r, new_c, prev_mv,
                   rows: int, cols: int, r_map: int, q3_shift: int,
                   sse_scale: int, sc, new_bits, rates, left_edge,
                   gold_sse, alt, proxy, planes, pos_y, pos_x, n: int,
                   mi_rows: int, mi_cols: int, grid):
    """The zone's mode decision and its motion compensation in one launch
    of mc_predict's kernel (its zone instance: every warp decides its own
    block, then predicts its plane of it).

    The decision's arguments are ``mode_decide``'s (the rate tables'
    scalars read from their device row, tune SQ's per-block lam_bits, an
    mvd past ``new_bits`` without tables traps); MC's are
    ``mc_predict``'s (planes: LAST's (y, u, v), then optionally GOLDEN's
    and ALTREF's; ``grid`` as ``pipeline/tpu_encdec.py:mc_window_grid``
    gives it), less the MVs and ref_sel, which the decision gives, and the
    window index and offsets: block b reads window b. Every refusal of the
    two wrappers holds; the shapes are checked once a shape, and the
    launcher takes one int64 array of words, whose ints (after its
    ``MC_ZONE_PTR_WORDS`` pointers) are the same from frame to frame: the
    lam of ``sc`` is read on the card. Returns (mv_r, mv_c (B,)
    int32, ref_sel (B,) int8, mv16 (B, 2) int16, pred_y (B, n, n), pred_u,
    pred_v (B, n/2, n/2) uint8), bit for bit what ``pipeline/tpu_encdec.py:
    mode_decide_mc_ref`` returns. It runs the kernel of
    ``csrc/mc_predict.cu`` or raises; its launch counts as mc_predict's."""
    name = "mode_decide_mc"
    flat = _planes_flat(name, planes, 3)
    tabs, m = _rate_tables(rates)
    if alt is not None and len(alt) != 4:
        raise ValueError(f"{name}: alt is ALTREF's (sse_zero, sse_new, "
                         "new_r, new_c)")
    # the planes plane by plane (LAST's, GOLDEN's and ALTREF's Y, then
    # their U, then their V), as the launcher takes them
    ins = (*(flat[p + 3 * r] for p in range(3) for r in range(3)), pos_y,
           pos_x, ssem, src2m, sse_zero, sse_new, new_r, new_c, prev_mv,
           left_edge, gold_sse, *(alt or (None,) * 4), *tabs, new_bits)
    sigs, ptrs = _sig_words(ins)
    _zone_mc_spec(sigs, rows, cols, r_map, n, tuple(grid), m)
    dev = pos_y.device
    if _device_kind(name, pos_y) != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors; CPU "
                         f"tensors go through the step's {name}")
    _want_row(name, sc, dev)
    b = rows * cols
    mv, ref_sel, mv16, pred_y, pred_u, pred_v = _decided_outputs(b, n, dev,
                                                                 True)
    # the launcher's words (int64; the array lives through the call)
    words = array.array("q", (
        *ptrs[:11], _mc_taps_on(dev).data_ptr(), pred_y.data_ptr(),
        pred_u.data_ptr(), pred_v.data_ptr(), *ptrs[11:], sc.data_ptr(),
        mv.data_ptr(), ref_sel.data_ptr(), mv16.data_ptr(), b, n, rows,
        cols, *(v for spec in grid[2:] for v in spec), WIN_R, CHROMA_WIN_R,
        *(t.shape[1] for t in flat[:3]), int(mi_rows), int(mi_cols), r_map,
        q3_shift, sse_scale, int(rates is not None), new_bits.shape[0]))
    _launch(name, dev, words.buffer_info()[0], float(proxy[0]),
            float(proxy[3]), float(proxy[4]),
            words=lambda: words[MC_ZONE_PTR_WORDS:])
    mc_predict.launches += 1
    mv_r, mv_c = mv.unbind(0)
    return mv_r, mv_c, ref_sel, mv16, pred_y, pred_u, pred_v


@functools.lru_cache(maxsize=64)
def _children_mc_spec(key, n: int, grid, m):
    """descent_decide_mc's checks of its arguments' shapes, dtypes, device
    and contiguity, once per key: ``key`` (``_sig_words``) of LAST's three
    planes, win_idx, pos_y, pos_x, off_y, off_x, ssem, sse_zero, sse_new,
    sub_r, sub_c, src2, base_y, base_x, par_r, par_c, new_bits, the rate
    tables' scalars, three LUTs and lam_bits (None unless a tensor); ``m``
    the LUTs' reach (None without rate tables). The refusals of
    descent_decide and of mc_predict."""
    name = "descent_decide_mc"
    _one_device(name, key)
    nch = _children_sigs(name, key[8:24], m)
    if n != 16:
        raise ValueError(f"{name}: the children are n=16 blocks, not n={n}")
    _mc_sigs(name, (*key[0:3], *(None,) * 6), n, grid)
    for what, sig in zip(("win_idx", "pos_y", "pos_x", "org_off_y",
                          "org_off_x"), key[3:8]):
        _want_sig(name, what, sig, (nch,), torch.int32)


def descent_decide_mc(ssem, sse_zero, sse_new, sub_r, sub_c, src2, base_y,
                      base_x, par_r, par_c, sc, new_bits, rates, proxy,
                      planes, pos_y, pos_x, n: int, mi_rows: int,
                      mi_cols: int, grid, win_idx, org_off_y, org_off_x):
    """The children's candidate decision and their motion compensation in
    one launch of mc_predict's kernel (its children's instance: every warp
    decides its own child, then predicts its plane of it).

    The decision's arguments are ``descent_decide``'s, but with ``rates``
    the kernel reads the mode costs and the frame's lam_bits from the
    tables' device row "scalars" (a per-block lam_bits is refused); MC's
    are ``mc_predict``'s for the children (planes: LAST's (y, u, v) alone;
    the parents' windows by ``win_idx``, the children's offsets inside
    them), less the MVs, which the decision gives. Every refusal of the two
    wrappers holds; the shapes are checked once a shape, and the launcher
    takes one int64 array of words, whose ints (after its
    ``MC_CHILDREN_PTR_WORDS`` pointers) are the same from frame to frame.
    Returns (mv_r, mv_c (4K,) int32, mv16
    (4K, 2) int16, pred_y (4K, 16, 16), pred_u, pred_v (4K, 8, 8) uint8),
    bit for bit what ``pipeline/tpu_encdec.py:descent_decide_mc_ref``
    returns. It runs the
    kernel of ``csrc/mc_predict.cu`` or raises; its launch counts as
    mc_predict's."""
    name = "descent_decide_mc"
    flat = _planes_flat(name, planes, 1)[:3]
    tabs, m = _rate_tables(rates)
    ins = (*flat, win_idx, pos_y, pos_x, org_off_y, org_off_x, ssem,
           sse_zero, sse_new, sub_r, sub_c, src2, base_y, base_x, par_r,
           par_c, new_bits, *tabs)
    sigs, ptrs = _sig_words(ins)
    _children_mc_spec(sigs, n, tuple(grid), m)
    dev = pos_y.device
    if _device_kind(name, pos_y) != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors; CPU "
                         f"tensors go through the step's {name}")
    _want_row(name, sc, dev)
    nch = sse_zero.shape[0]
    mv, _, mv16, pred_y, pred_u, pred_v = _decided_outputs(nch, n, dev,
                                                           False)
    if nch > 0:
        rows, cols = grid[:2]
        words = array.array("q", (
            *ptrs[:8], _mc_taps_on(dev).data_ptr(), pred_y.data_ptr(),
            pred_u.data_ptr(), pred_v.data_ptr(), *ptrs[8:23],
            sc.data_ptr(), mv.data_ptr(), mv16.data_ptr(), nch, n, rows,
            cols, *(v for spec in grid[2:] for v in spec), WIN_R,
            CHROMA_WIN_R, *(t.shape[1] for t in flat), int(mi_rows),
            int(mi_cols), int(rates is not None), new_bits.shape[0]))
        _launch(name, dev, words.buffer_info()[0], float(proxy[0]),
                float(proxy[1]),
                words=lambda: words[MC_CHILDREN_PTR_WORDS:])
        mc_predict.launches += 1
    mv_r, mv_c = mv.unbind(0)
    return mv_r, mv_c, mv16, pred_y, pred_u, pred_v


# ---------------------------------------------------------------------------
# Tune SQ's adaptive lambda (csrc/aq_scale.cu)
# ---------------------------------------------------------------------------


def aq_scale(src_sum, src2, n: int, scalars):
    """A zone's per-block rate lambda at tune SQ, on the card, one launch
    of one CTA: the frame's lam_bits times each block's variance-adaptive
    scale (``pipeline/tpu_encdec.py:_sb_lambda_scale``'s float32 chain).

    src_sum, src2: (B,) int32 the exact sums of the pixels and of their
    squares of the zone's n x n blocks (``block_energy`` against zero
    blocks), contiguous CUDA tensors of one device; scalars: the rate
    tables' device row (``RATE_SCALARS``), whose lam_bits word the kernel
    reads. Returns (B,) float32, bit for bit what ``pipeline/tpu_encdec.py:
    aq_scale_ref`` returns but where a float64 log or exp of the card and
    of the host straddle a float32 rounding boundary. It runs the kernel
    of ``csrc/aq_scale.cu`` or raises."""
    name = "aq_scale"
    b = src_sum.shape[0]
    for what, t, shape in (("src_sum", src_sum, (b,)), ("src2", src2, (b,)),
                           ("scalars", scalars, (len(RATE_SCALARS),))):
        _want(name, what, t, shape, torch.int32)
    if n < 1:
        raise ValueError(f"{name}: n={n}")
    dev = _cuda_only(name, src_sum, src2, scalars)
    out = torch.empty((b,), dtype=torch.float32, device=dev)
    if b > 0:
        _launch(name, dev, src_sum.data_ptr(), src2.data_ptr(),
                scalars.data_ptr() + 4 * RATE_SCALARS.index("lam_bits"),
                out.data_ptr(), b, n)
        aq_scale.launches += 1
    return out


aq_scale.launches = 0


def aq_scale_occupancy(device=None):
    """(resident CTAs of 1024 threads per SM, dynamic shared memory in
    bytes) of ``aq_scale``'s kernel (``_occupancy``)."""
    return _occupancy("aq_scale", None, None, device)


# ---------------------------------------------------------------------------
# The P-frame step's windows and borders (csrc/windows.cu)
# ---------------------------------------------------------------------------

# the window sets or planes one launch takes
WINDOW_JOBS = 8
# extract_windows' job words for k sets: eight int64 a set
_JOB_WORDS = [ctypes.c_int64 * (8 * k) for k in range(WINDOW_JOBS + 1)]


def _host_ints(values):
    """A ctypes int32 array of ``values`` (kept alive by the caller)."""
    return (ctypes.c_int * len(values))(*values)


def _host_ptrs(values):
    """A ctypes array of device pointers (kept alive by the caller)."""
    return (ctypes.c_void_p * len(values))(*values)


def _aligned_outputs(sizes, device):
    """Uninitialised uint8 buffers of ``sizes`` bytes out of one
    allocation, each starting on a 16-byte boundary (the kernels store
    whole 16-byte words)."""
    starts, total = [], 0
    for size in sizes:
        starts.append(total)
        total += (size + 15) // 16 * 16
    buf = torch.empty(max(total, 1), dtype=torch.uint8, device=device)
    return [buf[s:s + size] for s, size in zip(starts, sizes)]


def extract_windows(specs, rows: int, cols: int):
    """Search windows of one zone of rows x cols blocks out of up to
    ``WINDOW_JOBS`` planes, on the card, in one launch.

    specs: (plane, n, sw, y0, x0) each: a contiguous uint8 border-extended
    plane (any start, any width), the block size, the window side and
    where the zone's first window starts in the plane (``pipeline/
    tpu_encdec.py:window_specs``). Returns a list of (B, sw, sw) uint8
    tensors, B = rows x cols, window (row, col) at (y0 + n row, x0 + n
    col), bit for bit what ``_extract_search_windows`` returns. It runs
    the kernel of ``csrc/windows.cu`` or raises; the launcher refuses a
    set whose windows leave their plane. The host path is one output
    allocation a set and one ctypes array of eight int64 a set (the
    kernel's jobs)."""
    name = "extract_windows"
    if not 1 <= len(specs) <= WINDOW_JOBS:
        raise ValueError(f"{name}: 1 to {WINDOW_JOBS} window sets, got "
                         f"{len(specs)}")
    b = rows * cols
    words = []  # per set: plane, output, pitch, height, n, sw, y0, x0
    dev = specs[0][0].device
    for plane, n, sw, y0, x0 in specs:
        if plane.dtype != torch.uint8 or plane.dim() != 2:
            raise TypeError(f"{name}: a plane must be a uint8 plane, got "
                            f"{tuple(plane.shape)} {plane.dtype}")
        if not plane.is_contiguous():
            raise ValueError(f"{name}: a plane must be contiguous")
        if plane.device != dev or dev.type != "cuda":
            dev = _cuda_only(name, *(sp[0] for sp in specs))
        h, w = plane.shape
        words += (plane.data_ptr(), 0, w, h, n, sw, y0, x0)
    outs = [torch.empty((b, sp[2], sp[2]), dtype=torch.uint8, device=dev)
            for sp in specs]
    words[1::8] = [out.data_ptr() for out in outs]
    if b > 0:
        jobs = _JOB_WORDS[len(specs)](*words)
        _launch(name, dev, ctypes.addressof(jobs), len(specs), rows, cols,
                words=lambda: [v for i, v in enumerate(words) if i % 8 > 1])
        extract_windows.launches += 1
    return outs


extract_windows.launches = 0


def extend_borders(planes, crops, border: int):
    """The border extension of up to ``WINDOW_JOBS`` planes, on the card,
    in one launch: plane (H, W) into (H + 2 border, W + 2 border), its
    visible crop (crop_w, crop_h) of ``crops`` (1 <= crop <= the plane's
    side) replicated outward. planes: contiguous uint8 CUDA tensors of one
    device. Returns a tuple of new planes, bit for bit what
    ``pipeline/tpu_encdec.py:extend_borders_device`` returns for each. It
    runs the kernel of ``csrc/windows.cu`` or raises."""
    name = "extend_borders"
    if not 1 <= len(planes) <= WINDOW_JOBS or len(crops) != len(planes):
        raise ValueError(f"{name}: 1 to {WINDOW_JOBS} planes, each with its "
                         f"crop, got {len(planes)} and {len(crops)}")
    if border < 0:
        raise ValueError(f"{name}: border {border}")
    for plane, (cw, ch) in zip(planes, crops):
        _want_plane(name, "a plane", plane, 1, 1)
        if not (1 <= cw <= plane.shape[1] and 1 <= ch <= plane.shape[0]):
            raise ValueError(f"{name}: crop {cw}x{ch} of a "
                             f"{tuple(plane.shape)} plane")
    dev = _cuda_only(name, *planes)
    shapes = [(p.shape[0] + 2 * border, p.shape[1] + 2 * border)
              for p in planes]
    outs = _aligned_outputs([h * w for h, w in shapes], dev)
    srcs = _host_ptrs([p.data_ptr() for p in planes])
    dsts = _host_ptrs([o.data_ptr() for o in outs])
    ints = [_host_ints(v) for v in ([p.shape[0] for p in planes],
                                    [p.shape[1] for p in planes],
                                    [int(c[0]) for c in crops],
                                    [int(c[1]) for c in crops])]
    _launch(name, dev, ctypes.addressof(srcs), ctypes.addressof(dsts),
            *(ctypes.addressof(a) for a in ints), len(planes), int(border),
            words=lambda: [v for a in ints for v in a])
    extend_borders.launches += 1
    return tuple(o.view(h, w) for o, (h, w) in zip(outs, shapes))


extend_borders.launches = 0

# windows_occupancy's kernels, by their index in the source
WINDOW_KERNELS = ("extract_windows", "extend_borders")


def windows_occupancy(kernel: str, device=None):
    """(resident CTAs of 256 threads per SM, dynamic shared memory in
    bytes) of ``csrc/windows.cu``'s kernel ``kernel`` (one of
    ``WINDOW_KERNELS``; ``_occupancy``)."""
    if kernel not in WINDOW_KERNELS:
        raise ValueError(f"windows: no kernel {kernel!r} in "
                         f"{WINDOW_KERNELS}")
    return _occupancy("windows", range(len(WINDOW_KERNELS)),
                      WINDOW_KERNELS.index(kernel), device)
