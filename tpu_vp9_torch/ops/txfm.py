"""Forward transform, quantizer and exact inverse on torch tensors.

The counterpart of the parts of ``tpu_vp9/ops/txfm.py`` that the realtime
P-frame step runs under ``xp=jnp`` (``fwd_txfm2d``, ``inv_txfm_add``) and
of the step's quantizer (``tpu_vp9/pipeline/tpu_encdec.py:_quantize``,
``_dequantize``).

The forward transform and the quantizer run in float64. The TPU package
runs them in float32, where the sum order of the two matrix products
(XLA on the CPU, cuBLAS, MKL) moves a coefficient by up to about 1e-3 and
so flips quantized levels that lie near a rounding boundary. In float64
the CPU and the card agree unless ``|c|/q + 0.38`` lies within about
1e-12 of an integer, so one encode gives one bitstream on both. The
matrices are the float32 ones of ``fwd_matrices``, widened, not
recomputed. The inverse transform is the normative integer one: the
butterflies of ``tpu_vp9.ops.txfm.inv_txfm2d`` run unchanged on int32
torch tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_vp9.bitstream.tables import TxSize, TxType
from tpu_vp9.ops import txfm as _txfm

TX_SIZE = {4: TxSize.TX_4X4, 8: TxSize.TX_8X8, 16: TxSize.TX_16X16,
           32: TxSize.TX_32X32}
MAX_LEVEL = (1 << 13) - 1
# the TPU package adds its 0.38 dead-zone bias in float32; the float64
# quantizer adds that same float32 value, so both share one threshold
QBIAS = float(np.float32(0.38))


@functools.lru_cache(maxsize=None)
def _fwd_matrices64(n: int, device: torch.device):
    f_col, f_row_t = _txfm.fwd_matrices(TX_SIZE[n], TxType.DCT_DCT)
    return (torch.from_numpy(f_col).to(device=device, dtype=torch.float64),
            torch.from_numpy(f_row_t).to(device=device, dtype=torch.float64))


def fwd_txfm2d(resid):
    """(B, n, n) int32 residual -> float64 DCT_DCT coefficients."""
    f_col, f_row_t = _fwd_matrices64(resid.shape[-1], resid.device)
    return torch.matmul(torch.matmul(f_col, resid.to(torch.float64)),
                        f_row_t)


def _q_plane(coeffs, dc_q: int, ac_q: int, dtype):
    q = torch.full(coeffs.shape[-2:], ac_q, dtype=dtype,
                   device=coeffs.device)
    q[0, 0] = dc_q
    return q


def quantize(coeffs, dc_q: int, ac_q: int, n: int, bias: float = QBIAS):
    """``floor(|c| / q + bias)``, q halved at n=32, levels clipped to
    2^13 - 1, sign restored; int32. Float64 throughout."""
    q = _q_plane(coeffs, dc_q, ac_q, torch.float64)
    if n == 32:
        q = q * 0.5
    levels = torch.floor(coeffs.abs() / q + bias).clamp(0, MAX_LEVEL)
    levels = levels.to(torch.int32)
    return torch.where(coeffs < 0, -levels, levels)


def dequantize(levels, dc_q: int, ac_q: int, n: int):
    """Normative dequantization (|level| * q, >> 1 at n=32), int32."""
    mag = levels.abs() * _q_plane(levels, dc_q, ac_q, torch.int32)
    if n == 32:
        mag = mag >> 1
    return torch.where(levels < 0, -mag, mag)


def inv_txfm_add(coeffs, pred, n: int):
    """clip(pred + round(inverse DCT_DCT)) as a decoder does; uint8.

    coeffs: (B, n, n) int32 dequantized coefficients; pred: (B, n, n)."""
    res = _txfm.inv_txfm2d(coeffs, TX_SIZE[n], TxType.DCT_DCT, xp=torch)
    res = _txfm._rpot(res, _txfm.FINAL_SHIFT[n])
    return (pred.to(torch.int32) + res).clamp(0, 255).to(torch.uint8)
