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
# dynamic shared memory one search level may use: the 48 KB a kernel has
# without asking, less the kernel's static words (csrc/sse_search.cu)
SSE_SMEM_BYTES = 48 * 1024 - 512
TXQ_BLOCK_SIZES = (4, 8, 16, 32)
TXQ_BIAS = 0.38  # the dead zone's rounding bias
# the hierarchical search's reaches (pipeline/tpu_encdec.py has the same)
WIN_R, HALF_R, REFINE_R = 40, 18, 4
HIER_BLOCK_SIZES = (32,)  # the sizes hier_search_fused is built for
# dynamic shared memory a CTA of loop_filter may ask for (a Hopper SM's
# most) and what it takes per luma row (csrc/loop_filter.cu keeps a
# 16-column band of the whole height at a pitch of 20 bytes)
LF_SMEM_BYTES, LF_BYTES_PER_ROW = 227 * 1024, 20
# the kinds of CTA of loop_filter, as bits of its ``parts`` argument
LF_PARTS = {"luma bands": 1, "chroma bands": 2, "chroma strips": 4,
            "luma tiles": 8}
LF_ALL_PARTS = 15
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
    "loop_filter": ("loop_filter", "loop_filter_launch", 7, 0, 10),
    "kframe_wave": ("kframe_wave", "kframe_wave_launch", 13, 0, 10),
    "transform_recon": ("transform_recon", "transform_recon_launch", 7, 0,
                        4),
    "subpel_search": ("subpel_search", "subpel_search_launch", 8, 0, 3),
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
    n in {8, 16, 32}; the area must fit the kernel's shared memory.
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
    if g.strip:
        raise NotImplementedError("loop_filter: strip geometries are not "
                                  "ported yet (ROADMAP.md Queue A item 5)")
    if not 0 <= lvl <= 63:
        raise ValueError(f"loop_filter: lvl={lvl} outside [0, 63]")
    if lim < 0 or mblim < 0:
        raise ValueError(f"loop_filter: negative limits ({lim}, {mblim})")
    if (g.pad_h % 64 or g.pad_w % 64 or not 0 < g.h_mi <= g.pad_h
            or g.h_mi > 32 * g.rows32
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
    if 2 * g.rows32 + 16 + g.pad_h * LF_BYTES_PER_ROW > LF_SMEM_BYTES:
        raise ValueError(f"loop_filter: a plane of {g.pad_h} rows does not "
                         f"fit the kernel's {LF_SMEM_BYTES} bytes of shared "
                         "memory")


def loop_filter(y, u, v, geom, lvl: int, lim: int, mblim: int,
                split32=None, parts: int = LF_ALL_PARTS):
    """The exact VP9 loop filter of the 32 grid without a strip, on the
    card, all three planes in one launch.

    y: (pad_h, pad_w) uint8, u and v: (pad_h/2, pad_w/2) uint8, contiguous
    CUDA tensors of one device; geom: the step's geometry (``strip``,
    ``pad_h``, ``pad_w``, ``h_mi``, ``w_mi``, ``rows32``, ``cols32``);
    lvl in [0, 63] (0 copies), lim and mblim: host ints; split32: optional
    (rows32, cols32) 0/1 mask (integer or bool, contiguous, on the planes'
    device) of the 32-blocks coded as four 16x16 blocks. Returns new (y, u, v) planes, bit for bit what
    ``pipeline/tpu_encdec.py:loop_filter_ref`` returns; the inputs are not
    modified. It runs the kernel of ``csrc/loop_filter.cu`` or raises: CPU
    tensors go to ``loop_filter_ref`` through the step's
    ``loop_filter_device``, not through here.

    parts: for measurements only: the kinds of CTA (bits of ``LF_PARTS``)
    that work; with fewer than all, the other kinds' columns of the
    outputs are left unwritten.
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
    if any(t.data_ptr() % 4 for t in (y, u, v)):
        raise ValueError("loop_filter: planes must start on a 4-byte "
                         "boundary")
    g = geom
    out = (torch.empty_like(y), torch.empty_like(u), torch.empty_like(v))
    _launch("loop_filter", dev, y.data_ptr(), u.data_ptr(), v.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
            None if split32 is None else split32.data_ptr(), g.pad_h,
            g.pad_w, g.h_mi, g.w_mi, g.rows32, g.cols32, lvl, lim, mblim,
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
KF_STRIP = ("strip geometries (mi_rows % 4 == 2: the bottom 16-pixel "
            "strip's above-only modes, ADST at TX16) are not ported yet "
            "(ROADMAP.md Queue A item 5)")


def kf_diagonal(d: int, rows: int, cols: int):
    """(first block row, number of blocks) of anti-diagonal ``d`` of a
    rows x cols grid: the blocks (r, d - r) that lie in the grid."""
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


@functools.lru_cache(maxsize=None)
def _kf_tables_on(device: torch.device):
    """The kernel's constant tables on ``device``: float64 (f_col32,
    f_row_t32, f_col16, f_row_t16), the port's forward matrices (the
    float32 ones widened), and int32 (dir32, dir16, iscan32, iscan16), the
    packed directional maps and each raster place's place in the DCT_DCT
    scan order."""
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.ops import txfm

    mats = []
    for n in (32, 16):
        mats += [m.astype(np.float64).reshape(-1) for m in
                 txfm.fwd_matrices(txfm.TX_SIZE[n], T.TxType.DCT_DCT)]
    tabs = [_kf_dir_words(32).reshape(-1), _kf_dir_words(16).reshape(-1)]
    for n in (32, 16):
        scan = np.asarray(T.scan_order(txfm.TX_SIZE[n], T.TxType.DCT_DCT)[0])
        tabs.append(np.argsort(scan).astype(np.int32))
    return (torch.from_numpy(np.concatenate(mats)).to(device),
            torch.from_numpy(np.concatenate(tabs)).to(device))


def check_kf_args(src_y, src_u, src_v, geom, dc_q: int, ac_q: int,
                   lam: int) -> None:
    g = geom
    if g.strip:
        raise NotImplementedError(f"kframe_wave: {KF_STRIP}")
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


def kframe_wave(src_y, src_u, src_v, geom, dc_q: int, ac_q: int, lam: int):
    """The keyframe's closed-loop intra encode of the 32 grid.

    src_y: (pad_h, pad_w), src_u and src_v: (pad_h/2, pad_w/2) uint8
    padded source planes; geom: the step's geometry (no strip); dc_q, ac_q:
    the quantizer steps; lam: the mode prior's lambda. Over the
    anti-diagonals d = 0 .. rows32 + cols32 - 2 in order, every 32x32 block
    (r, d - r): the 10 intra predictions from the recon of earlier
    diagonals (127 above the frame, 129 left of it, above-right repeating
    above[31], the left column clamped to the last visible row), the mode of
    least ``sse + KF_MODE_BIAS[m] * lam`` (the first on a tie), then luma at
    32 and both chroma planes at 16 with that mode: float64 forward DCT,
    quantizer, exact integer inverse, recon and eob. Returns (mode int32
    (B,), lv_y int16 (B, 32, 32), lv_u, lv_v int16 (B, 16, 16), eob_y, eob_u,
    eob_v int32 (B,), rec_y uint8 (rows32*32, cols32*32), rec_u, rec_v
    (rows32*16, cols32*16)), blocks in raster order, the recon unfiltered.

    It runs the kernel of ``csrc/kframe_wave.cu``, one launch per
    anti-diagonal on the current stream, or raises: CPU tensors go to the
    plain version ``pipeline/tpu_encdec.py:kframe_wave_ref`` through the
    step's ``kframe_wave_device``, not through here. The two agree bit for
    bit unless a coefficient's ``|c| / q + 0.38`` lies within about 1e-12 of
    an integer (the float64 forward transform sums in another order).
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
    ptrs = [t.data_ptr() for t in (src_y, src_u, src_v, *recs, mode, *lvs,
                                   eob, mats, tabs)]
    for d in range(rows + cols - 1):
        r0, nb = kf_diagonal(d, rows, cols)
        _launch("kframe_wave", dev, *ptrs, g.pad_w, g.height, rows, cols,
                d, r0, nb, dc_q, ac_q, lam)
        kframe_wave.launches += 1
    return (mode, *lvs, *eob.unbind(0), *recs)


kframe_wave.launches = 0


# ---------------------------------------------------------------------------
# The P-frame step's transform stage (csrc/transform_recon.cu)
# ---------------------------------------------------------------------------

TXFM_BLOCK_SIZES = (8, 16, 32)
# keeps |level| * q (levels clip at 8191) inside int32
TXFM_MAX_Q = (1 << 16) - 1


@functools.lru_cache(maxsize=None)
def _txfm_tables_on(n: int, device: torch.device):
    """The kernel's constant tables of block size n on ``device``: the
    float64 forward column matrix F_col (``txfm._fwd_matrices64``, the
    float32 one widened; the kernel reads F_row^T as F_col^T / 2^5 at n=8
    and / 2^6 above, which ``tests/test_torch_transform_recon.py`` holds
    to the row matrix bit for bit) and the int32 inverse DCT_DCT scan, each
    raster place's place in ``T.scan_order``."""
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.ops import txfm

    f_col = txfm._fwd_matrices64(n, device)[0]
    scan = np.asarray(T.scan_order(txfm.TX_SIZE[n], T.TxType.DCT_DCT)[0])
    iscan = torch.from_numpy(np.argsort(scan).astype(np.int32)).to(device)
    return f_col.contiguous(), iscan


def _check_txfm_args(src_blocks, pred_blocks, dc_q: int, ac_q: int,
                     n: int) -> None:
    if n not in TXFM_BLOCK_SIZES:
        raise ValueError(f"transform_recon: n={n} not in {TXFM_BLOCK_SIZES}")
    b = src_blocks.shape[0]
    _want_blocks("transform_recon: src_blocks", src_blocks, b, n, n)
    _want_blocks("transform_recon: pred_blocks", pred_blocks, b, n, n)
    if src_blocks.dtype != torch.uint8 or pred_blocks.dtype != torch.uint8:
        raise TypeError("transform_recon: blocks must be uint8, got "
                        f"{src_blocks.dtype} and {pred_blocks.dtype}")
    if not (0 < dc_q <= TXFM_MAX_Q and 0 < ac_q <= TXFM_MAX_Q):
        raise ValueError(f"transform_recon: quantizers ({dc_q}, {ac_q}) "
                         f"outside [1, {TXFM_MAX_Q}]")


def transform_recon(src_blocks, pred_blocks, dc_q: int, ac_q: int, n: int):
    """Forward DCT, quantizer, dequantizer, exact integer inverse, recon
    and eob of B blocks at once, on the card.

    src_blocks, pred_blocks: (B, n, n) uint8 contiguous CUDA tensors of
    one device, n in {8, 16, 32}; dc_q, ac_q: the quantizer steps (host
    ints in [1, 65535]). Returns (levels int16 (B, n, n), eob int32 (B,),
    recon uint8 (B, n, n)): the DCT_DCT levels of the float64 forward
    transform and the dead-zone quantizer, one past the last nonzero level
    in scan order (0 if none), and the decoder's reconstruction. It runs
    the kernel of ``csrc/transform_recon.cu`` or raises: CPU tensors go to
    the plain version ``pipeline/tpu_encdec.py:transform_recon_ref``
    through the step's ``transform_recon``, not through here. The two
    agree bit for bit unless a coefficient's ``|c| / q + 0.38`` lies within
    about 1e-12 of an integer (the float64 products sum in another order).
    """
    dc_q, ac_q = int(dc_q), int(ac_q)
    _check_txfm_args(src_blocks, pred_blocks, dc_q, ac_q, n)
    if _device_kind("transform_recon", src_blocks, pred_blocks) != "cuda":
        raise ValueError("transform_recon: the kernel takes CUDA tensors; "
                         "CPU tensors go through the step's transform_recon")
    b = src_blocks.shape[0]
    dev = src_blocks.device
    levels = torch.empty((b, n, n), dtype=torch.int16, device=dev)
    eob = torch.empty((b,), dtype=torch.int32, device=dev)
    recon = torch.empty((b, n, n), dtype=torch.uint8, device=dev)
    if b > 0:
        f_col, iscan = _txfm_tables_on(n, dev)
        _launch("transform_recon", dev, src_blocks.data_ptr(),
                pred_blocks.data_ptr(), f_col.data_ptr(), iscan.data_ptr(),
                levels.data_ptr(), eob.data_ptr(), recon.data_ptr(), b, n,
                dc_q, ac_q)
        transform_recon.launches += 1
    return levels, eob, recon


transform_recon.launches = 0


def transform_recon_occupancy(n: int, device=None):
    """(CTAs of the kernel of block size n an SM holds at once, the dynamic
    shared memory each asks for in bytes) on ``device`` (the current CUDA
    device if None), from the CUDA runtime's occupancy query."""
    if n not in TXFM_BLOCK_SIZES:
        raise ValueError(f"transform_recon: n={n} not in {TXFM_BLOCK_SIZES}")
    fn = load_library("transform_recon").transform_recon_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    ctas, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(n, ctypes.byref(ctas), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"transform_recon: the occupancy query failed "
                           f"with CUDA error {err}")
    return ctas.value, smem.value


# ---------------------------------------------------------------------------
# The P-frame step's quarter-pel search (csrc/subpel_search.cu)
# ---------------------------------------------------------------------------

SUBPEL_BLOCK_SIZES = (16, 32)  # the children's and the zone's
SUBPEL_MAX_R = 64  # keeps a window's offsets well inside int32


@functools.lru_cache(maxsize=None)
def _subpel_taps_on(device: torch.device):
    """The (16, 8) int32 EIGHTTAP filter table on ``device``."""
    from tpu_vp9_torch.bitstream import tables as T

    taps = np.asarray(T.subpel_filters(T.InterpFilter.EIGHTTAP), np.int32)
    return torch.from_numpy(np.ascontiguousarray(taps)).to(device)


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
