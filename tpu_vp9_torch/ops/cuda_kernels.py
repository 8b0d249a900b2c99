"""Hand-written CUDA kernels: the counterpart of ``tpu_vp9/ops/pallas_kernels.py``.

  tpu_vp9/ops/pallas_kernels.py        here
  sad_full_search (_sad_search_kernel) sad_full_search (csrc/sad_search.cu)
  block_energy (_block_energy_kernel)  block_energy (csrc/block_energy.cu)
  txq_cost (_txq_cost_kernel)          txq_cost (csrc/txq_cost.cu)

so every function there that reaches ``pl.pallas_call`` has its
counterpart here; and one XLA stage of the realtime P-frame step, which
the JAX package writes in jnp:

  tpu_vp9/pipeline/tpu_encdec.py       here
  _full_search_sse_mxu                 sse_map_search (csrc/sse_search.cu)

Every kernel has a plain PyTorch version beside it (``*_ref``). The wrapper
takes the plain version only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises. Each wrapper counts its launches in its
``launches`` attribute, so a run can show that it went through the kernel.
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
SSE_SMEM_BYTES = 48 * 1024  # the kernel keeps src and area in shared memory
TXQ_BLOCK_SIZES = (4, 8, 16, 32)
TXQ_BIAS = 0.38  # the dead zone's rounding bias

# (library, C function, number of pointer args, of float args, of int
# args), in the C function's argument order; every launcher ends with the
# stream pointer and returns cudaGetLastError()
_LAUNCHERS = {
    "sad_full_search": ("sad_search", "sad_full_search_launch", 5, 0, 3),
    "block_energy": ("block_energy", "block_energy_launch", 4, 0, 2),
    "sse_map_search": ("sse_search", "sse_map_search_launch", 5, 0, 5),
    "txq_cost": ("txq_cost", "txq_cost_launch", 4, 2, 2),
}
_fns: dict = {}


def _kernel(name: str):
    """The ctypes launcher of a kernel, building its library at first use."""
    fn = _fns.get(name)
    if fn is None:
        lib, sym, n_ptr, n_float, n_int = _LAUNCHERS[name]
        fn = getattr(load_library(lib), sym)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_float] * n_float
                       + [ctypes.c_int] * n_int + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name: str, device, *args) -> None:
    """Launch a kernel on the current stream of ``device``; raise if the
    launch was refused."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def _device_kind(name: str, *tensors) -> str:
    """'cpu' or 'cuda' for tensors that share one device; raise otherwise."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: inputs on different devices "
                         f"{[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    return dev.type


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
    for t in (src_blocks, pred_blocks):
        if tuple(t.shape) != (b, n, n):
            raise ValueError(f"block_energy: input shape {tuple(t.shape)}, "
                             f"want ({b}, {n}, {n})")
        if t.dtype != torch.uint8:
            raise TypeError(f"block_energy: inputs must be uint8, got "
                            f"{t.dtype}")


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
    if src_blocks.data_ptr() % 16 or pred_blocks.data_ptr() % 16:
        raise ValueError("block_energy: inputs must start on a 16-byte "
                         "boundary")
    b = src_blocks.shape[0]
    out = torch.empty((2, b), dtype=torch.int32, device=src_blocks.device)
    if b == 0:
        return out[0], out[1]
    _launch("block_energy", src_blocks.device, src_blocks.data_ptr(),
            pred_blocks.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), b,
            n)
    block_energy.launches += 1
    return out[0], out[1]


block_energy.launches = 0


def _check_sse_args(src_blocks, wins, n: int, r: int) -> None:
    if n not in SSE_BLOCK_SIZES:
        raise ValueError(f"sse_map_search: n={n} not in {SSE_BLOCK_SIZES}")
    area = n + 2 * r
    if r < 1 or 4 * (n * n + area * area) > SSE_SMEM_BYTES:
        raise ValueError(f"sse_map_search: r={r} at n={n} outside the "
                         f"kernel's {SSE_SMEM_BYTES}-byte shared memory")
    b = src_blocks.shape[0]
    sw = area + 8
    if tuple(src_blocks.shape) != (b, n, n):
        raise ValueError(f"sse_map_search: src_blocks shape "
                         f"{tuple(src_blocks.shape)}, want ({b}, {n}, {n})")
    if tuple(wins.shape) != (b, sw, sw):
        raise ValueError(f"sse_map_search: wins shape {tuple(wins.shape)}, "
                         f"want ({b}, {sw}, {sw})")
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
    if b == 0:
        return out[0], out[1], rel
    _launch("sse_map_search", dev, src_blocks.data_ptr(), wins.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(),
            rel.data_ptr() if want_map else None, b, n, r, n + 2 * r + 8,
            src_blocks.element_size())
    sse_map_search.launches += 1
    return out[0], out[1], rel


sse_map_search.launches = 0


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
    out = torch.empty((2, b), dtype=torch.float32, device=dev)
    if b == 0:
        return out[0], out[1]
    _launch("txq_cost", dev, resid_blocks.data_ptr(),
            _dct_matrix_on(n, dev).data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), float(dc_q), float(ac_q), b, n)
    txq_cost.launches += 1
    return out[0], out[1]


txq_cost.launches = 0
