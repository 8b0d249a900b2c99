"""Hand-written CUDA kernels: the counterpart of ``tpu_vp9/ops/pallas_kernels.py``.

  tpu_vp9/ops/pallas_kernels.py        here
  sad_full_search (_sad_search_kernel) sad_full_search (csrc/sad_search.cu)
  block_energy                         not ported yet (ROADMAP.md, Queue B)
  txq_cost                             not ported yet (ROADMAP.md, Queue B)

Every kernel has a plain PyTorch version beside it (``*_ref``). The wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises. Each wrapper counts its launches in its
``launches`` attribute, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_vp9_torch.ops._build import load_library

SAD_BLOCK_SIZES = (8, 16, 32, 64)
SAD_MAX_RANGE = 32

_sad_fn = None


def _sad_kernel():
    global _sad_fn
    if _sad_fn is None:
        fn = load_library("sad_search").sad_full_search_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _sad_fn = fn
    return _sad_fn


def _check_sad_args(src_blocks, regions, n: int, r: int) -> None:
    if n not in SAD_BLOCK_SIZES:
        raise ValueError(f"sad_full_search: n={n} not in {SAD_BLOCK_SIZES}")
    if not 1 <= r <= SAD_MAX_RANGE:
        raise ValueError(f"sad_full_search: r={r} outside [1, "
                         f"{SAD_MAX_RANGE}]")
    win = n + 2 * r
    b = src_blocks.shape[0]
    if tuple(src_blocks.shape) != (b, n, n):
        raise ValueError(f"sad_full_search: src_blocks shape "
                         f"{tuple(src_blocks.shape)}, want ({b}, {n}, {n})")
    if tuple(regions.shape) != (b, win, win):
        raise ValueError(f"sad_full_search: regions shape "
                         f"{tuple(regions.shape)}, want ({b}, {win}, {win})")
    if src_blocks.dtype != torch.uint8 or regions.dtype != torch.uint8:
        raise TypeError("sad_full_search: inputs must be uint8, got "
                        f"{src_blocks.dtype} and {regions.dtype}")
    if src_blocks.device != regions.device:
        raise ValueError("sad_full_search: inputs on different devices "
                         f"({src_blocks.device}, {regions.device})")


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
    if src_blocks.device.type == "cpu":
        return sad_full_search_ref(src_blocks, regions, n, r)
    if src_blocks.device.type != "cuda":
        raise ValueError("sad_full_search: unsupported device "
                         f"{src_blocks.device}")
    if not (src_blocks.is_contiguous() and regions.is_contiguous()):
        raise ValueError("sad_full_search: inputs must be contiguous")
    b = src_blocks.shape[0]
    out = torch.empty((3, b), dtype=torch.int32, device=src_blocks.device)
    if b == 0:
        return out[0], out[1], out[2]
    launch = _sad_kernel()
    with torch.cuda.device(src_blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(src_blocks.data_ptr(), regions.data_ptr(),
                     out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                     b, n, r, stream)
    if err != 0:
        raise RuntimeError(f"sad_full_search: CUDA launch failed with error "
                           f"{err}")
    sad_full_search.launches += 1
    return out[0], out[1], out[2]


sad_full_search.launches = 0
