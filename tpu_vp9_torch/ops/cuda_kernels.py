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
``subpel_search``, ``transform_recon``, ``loop_filter`` and ``kframe_wave``
take CUDA tensors only: their plain versions are the steps' own
(``pipeline/tpu_encdec.py``: ``subpel_search_ref``, ``transform_recon_ref``,
``loop_filter_ref``, ``kframe_wave_ref``), and the steps' dispatches
(``subpel_search``, ``transform_recon``, ``loop_filter_device``,
``kframe_wave_device``) send CPU tensors there and CUDA tensors here. This
module imports nothing of ``pipeline``.
"""

from __future__ import annotations

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
    "loop_filter": ("loop_filter", "loop_filter_launch", 7, 0, 11),
    "kframe_wave": ("kframe_wave", "kframe_wave_launch", 15, 0, 8),
    "transform_recon": ("transform_recon", "transform_recon_launch", 8, 0,
                        5),
    "subpel_search": ("subpel_search", "subpel_search_launch", 8, 0, 3),
    "openloop_modes": ("openloop_modes", "openloop_modes_launch", 5, 0, 4),
}
_fns: dict = {}


def _kernel(name: str):
    """The ctypes launcher of a kernel, building its library at first use."""
    lib, sym, n_ptr, n_float, n_int = _LAUNCHERS[name]
    fn = getattr(load_library(lib), sym)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_float] * n_float
                   + [ctypes.c_int] * n_int + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _fns[name] = fn
    return fn


# the current stream's handle without building a Stream object, where
# this torch has the call (a few microseconds a launch)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _launch(name: str, device, *args) -> None:
    """Launch a kernel on the current stream of ``device``; raise if the
    launch was refused. The launcher is resolved once; the device is
    switched to only where it is not the current one."""
    fn = _fns.get(name) or _kernel(name)
    idx = device.index
    if idx is None or idx == torch.cuda.current_device():
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


def _check_lf_args(y, u, v, geom, lvl: int, lim: int, mblim: int,
                   split32) -> None:
    g = geom
    if split32 is not None and g.strip:
        raise ValueError("loop_filter: a split mask with a strip geometry "
                         "(its blocks are 16x16 already)")
    if not 0 <= lvl <= 63:
        raise ValueError(f"loop_filter: lvl={lvl} outside [0, 63]")
    if lim < 0 or mblim < 0:
        raise ValueError(f"loop_filter: negative limits ({lim}, {mblim})")
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


def loop_filter(y, u, v, geom, lvl: int, lim: int, mblim: int,
                split32=None, parts: int = LF_ALL_PARTS):
    """The exact VP9 loop filter of the 32 grid and its bottom strip, on
    the card, all three planes in one launch.

    y: (pad_h, pad_w) uint8, u and v: (pad_h/2, pad_w/2) uint8, contiguous
    CUDA tensors of one device, each starting on a 16-byte boundary; geom:
    the step's geometry (``strip``, ``strip_y``, ``pad_h``, ``pad_w``,
    ``h_mi``, ``w_mi``, ``rows32``, ``cols32``); lvl in [0, 63] (0
    copies), lim and mblim: host ints; split32: optional (rows32, cols32)
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
    lvl, lim, mblim = int(lvl), int(lim), int(mblim)
    _check_lf_args(y, u, v, geom, lvl, lim, mblim, split32)
    tensors = (y, u, v) if split32 is None else (y, u, v, split32)
    if _device_kind("loop_filter", *tensors) != "cuda":
        raise ValueError("loop_filter: the kernel takes CUDA tensors; CPU "
                         "tensors go through loop_filter_device")
    dev = y.device
    if split32 is not None and split32.dtype != torch.int32:
        split32 = split32.to(torch.int32)
    g = geom
    out = (torch.empty_like(y), torch.empty_like(u), torch.empty_like(v))
    if any(t.data_ptr() % 16 for t in (y, u, v, *out)):
        raise ValueError("loop_filter: planes must start on a 16-byte "
                         "boundary")
    _launch("loop_filter", dev, y.data_ptr(), u.data_ptr(), v.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            None if split32 is None else split32.data_ptr(), g.pad_h,
            g.pad_w, g.h_mi, g.w_mi, g.strip_y if g.strip else g.pad_h,
            g.rows32, g.cols32, lvl, lim, mblim, int(parts))
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


def check_kf_args(src_y, src_u, src_v, geom, dc_q: int, ac_q: int,
                   lam: int) -> None:
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
    if not (0 < dc_q < 1 << 16 and 0 < ac_q < 1 << 16):
        raise ValueError(f"kframe_wave: quantizers ({dc_q}, {ac_q}) outside "
                         "[1, 65535]")
    if not 0 <= lam < KF_MAX_LAM:
        raise ValueError(f"kframe_wave: lam={lam} outside [0, {KF_MAX_LAM})")


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


def kframe_wave(src_y, src_u, src_v, geom, dc_q: int, ac_q: int, lam: int,
                status=None):
    """The keyframe's closed-loop intra encode of the 32 grid.

    src_y: (pad_h, pad_w), src_u and src_v: (pad_h/2, pad_w/2) uint8
    padded source planes; geom: the step's geometry (at a strip geometry
    its 32 zone, above the strip); dc_q, ac_q: the quantizer steps; lam:
    the mode prior's lambda. Every 32x32 block
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
    dc_q, ac_q, lam = int(dc_q), int(ac_q), int(lam)
    check_kf_args(src_y, src_u, src_v, geom, dc_q, ac_q, lam)
    if _device_kind("kframe_wave", src_y, src_u, src_v) != "cuda":
        raise ValueError("kframe_wave: the kernel takes CUDA tensors; CPU "
                         "tensors go through kframe_wave_device")
    g = geom
    rows, cols = g.rows32, g.cols32
    dev = src_y.device
    mode, lvs, eob, recs = kf_outputs(g, dev)
    mats, tabs = _kf_tables_on(dev)
    # scratch, zeroed for every keyframe: the ticket and the error word
    # (int32), then each block's bottom rows in tagged words
    scratch = torch.zeros(1 + rows * cols * KF_EDGE_WORDS, dtype=torch.int64,
                          device=dev)
    ptrs = [t.data_ptr() for t in (src_y, src_u, src_v, *recs, mode, *lvs,
                                   eob, mats, tabs)]
    _launch("kframe_wave", dev, *ptrs, scratch.data_ptr() + 8,
            scratch.data_ptr(), g.pad_w, g.height, rows, cols, dc_q, ac_q,
            lam, KF_MAX_POLLS)
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
    kernel of ``csrc/openloop_modes.cu`` (one launch, a CTA per block);
    CPU inputs run ``openloop_modes_ref``. The two agree bit for bit.
    """
    qindex = int(qindex)
    _check_openloop_args(plane, qindex, n)
    if _device_kind("openloop_modes", plane) == "cpu":
        return openloop_modes_ref(plane, qindex, n)
    h, w = plane.shape
    rows, cols = h // n, w // n
    b = rows * cols
    dev = plane.device
    out = torch.empty(12 * b, dtype=torch.int32, device=dev)
    _, tabs = _kf_tables_on(dev)
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


def _check_txfm_args(src_blocks, pred_blocks, dc_q: int, ac_q: int,
                     n: int, tx_type: int = 0) -> None:
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
    if not (0 < dc_q <= TXFM_MAX_Q and 0 < ac_q <= TXFM_MAX_Q):
        raise ValueError(f"transform_recon: quantizers ({dc_q}, {ac_q}) "
                         f"outside [1, {TXFM_MAX_Q}]")


def transform_recon(src_blocks, pred_blocks, dc_q: int, ac_q: int, n: int,
                    tx_type: int = 0):
    """Forward transform, quantizer, dequantizer, exact integer inverse,
    recon and eob of B blocks at once, on the card.

    src_blocks, pred_blocks: (B, n, n) uint8 contiguous CUDA tensors of
    one device, n in {8, 16, 32}; dc_q, ac_q: the quantizer steps (host
    ints in [1, 65535]); tx_type: a ``TxType`` of ``TXFM_TYPES[n]``
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
    dc_q, ac_q, tx_type = int(dc_q), int(ac_q), int(tx_type)
    _check_txfm_args(src_blocks, pred_blocks, dc_q, ac_q, n, tx_type)
    if _device_kind("transform_recon", src_blocks, pred_blocks) != "cuda":
        raise ValueError("transform_recon: the kernel takes CUDA tensors; "
                         "CPU tensors go through the step's transform_recon")
    b = src_blocks.shape[0]
    dev = src_blocks.device
    levels = torch.empty((b, n, n), dtype=torch.int16, device=dev)
    eob = torch.empty((b,), dtype=torch.int32, device=dev)
    recon = torch.empty((b, n, n), dtype=torch.uint8, device=dev)
    if b > 0:
        f_col, f_dct, iscan = _txfm_tables_on(n, dev, tx_type)
        _launch("transform_recon", dev, src_blocks.data_ptr(),
                pred_blocks.data_ptr(), f_col.data_ptr(), f_dct.data_ptr(),
                iscan.data_ptr(), levels.data_ptr(), eob.data_ptr(),
                recon.data_ptr(), tx_type, b, n, dc_q, ac_q)
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
    """(CTAs of 256 threads an SM holds at once, the dynamic shared memory
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


def _subpel_taps():
    """The (16, 8) int32 EIGHTTAP filter table, checked for what the
    kernel takes as given: phase 0 is the identity (it reads the pixel
    under tap 3 and filters nothing) and the taps of the phases 4, 8 and 12
    are signed bytes (it packs them four to a word for dp4a)."""
    from tpu_vp9_torch.bitstream import tables as T

    taps = np.asarray(T.subpel_filters(T.InterpFilter.EIGHTTAP), np.int32)
    if taps.shape != (16, 8) or taps[0].tolist() != [0, 0, 0, 128, 0, 0,
                                                     0, 0]:
        raise ValueError("subpel_search: the EIGHTTAP table's phase 0 is "
                         "not the identity")
    if not np.all((taps[4::4] >= -128) & (taps[4::4] <= 127)):
        raise ValueError("subpel_search: a tap of the phases 4, 8, 12 is "
                         "no signed byte")
    return np.ascontiguousarray(taps)


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
