"""VP9 transforms: exact integer inverses + matched forward transforms.

Inverse transforms are bit-exact realizations of the VP9 spec (8.7.1
inverse DCT/ADST butterflies; parity reference: vendored libvpx
``inv_txfm.c`` in SVT-VP9).  They operate on arrays of shape ``(..., N)``
(1-D) / ``(..., N, N)`` (2-D) so the same code is batch-vectorized under
numpy (int64, host oracle) and torch (int32, the device step).  The
encoder's reconstruction MUST use these to match any conformant decoder.

Forward transforms are an encoder-side free choice: we use float32
matrices derived numerically as the exact inverse of the integer inverse
pipeline, which (a) are plain matmuls and (b) are slightly more accurate
than libvpx's integer forward DCT.

The functions of the JAX package's module keep their names and take
``xp=np`` (or ``xp=torch`` where the device step needs them: the
butterflies, ``inv_txfm2d``, ``inv_txfm_add``, ``dequant_block``); its
``xp=jnp`` branches are gone.  The device step's forward transform and
quantizer are ``fwd_txfm2d_f64`` and ``quantize_f64`` at the end of the
module: float64 on torch tensors.  The JAX package runs them in float32,
where the sum order of the two matrix products (XLA on the CPU, cuBLAS,
MKL) moves a coefficient by up to about 1e-3 and so flips quantized
levels that lie near a rounding boundary; in float64 the CPU and the card
agree unless ``|c|/q + 0.38`` lies within about 1e-12 of an integer, so
one encode gives one bitstream on both.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_vp9_torch.bitstream.tables import TxSize, TxType

# cospi_k_64 = round(16384 * cos(k*pi/64)) — spec constants.
COSPI = [
    16384, 16364, 16305, 16207, 16069, 15893, 15679, 15426, 15137, 14811,
    14449, 14053, 13623, 13160, 12665, 12140, 11585, 11003, 10394, 9760,
    9102, 8423, 7723, 7005, 6270, 5520, 4756, 3981, 3196, 2404, 1606, 804,
]
SINPI = [0, 5283, 9929, 13377, 15212]  # sinpi_k_9

TX_N = {TxSize.TX_4X4: 4, TxSize.TX_8X8: 8, TxSize.TX_16X16: 16,
        TxSize.TX_32X32: 32}
FINAL_SHIFT = {4: 4, 8: 5, 16: 6, 32: 6}


def _rs(x):
    """dct_const_round_shift: (x + 2^13) >> 14 (arithmetic)."""
    return (x + 8192) >> 14


def _rpot(x, n):
    """ROUND_POWER_OF_TWO with signed rounding toward +inf at .5."""
    return (x + (1 << (n - 1))) >> n


# ---------------------------------------------------------------------------
# 1-D inverse transforms.  x has shape (..., N); index with x[..., k].
# ---------------------------------------------------------------------------


def idct4_1d(x, xp):
    c = COSPI
    s0 = _rs((x[..., 0] + x[..., 2]) * c[16])
    s1 = _rs((x[..., 0] - x[..., 2]) * c[16])
    s2 = _rs(x[..., 1] * c[24] - x[..., 3] * c[8])
    s3 = _rs(x[..., 1] * c[8] + x[..., 3] * c[24])
    return xp.stack([s0 + s3, s1 + s2, s1 - s2, s0 - s3], axis=-1)


def iadst4_1d(x, xp):
    sp = SINPI
    x0, x1, x2, x3 = (x[..., k] for k in range(4))
    s0 = sp[1] * x0 + sp[4] * x2 + sp[2] * x3
    s1 = sp[2] * x0 - sp[1] * x2 - sp[4] * x3
    s3 = sp[3] * x1
    s2 = sp[3] * (x0 - x2 + x3)
    return xp.stack(
        [_rs(s0 + s3), _rs(s1 + s3), _rs(s2), _rs(s0 + s1 - s3)], axis=-1
    )


def idct8_1d(x, xp):
    c = COSPI
    # stage 1 (odd part rotations)
    s4 = _rs(x[..., 1] * c[28] - x[..., 7] * c[4])
    s7 = _rs(x[..., 1] * c[4] + x[..., 7] * c[28])
    s5 = _rs(x[..., 5] * c[12] - x[..., 3] * c[20])
    s6 = _rs(x[..., 5] * c[20] + x[..., 3] * c[12])
    # stage 2: even part = idct4 of even inputs
    even = idct4_1d(xp.stack([x[..., 0], x[..., 2], x[..., 4], x[..., 6]],
                             axis=-1), xp)
    t4 = s4 + s5
    t5 = s4 - s5
    t6 = -s6 + s7
    t7 = s6 + s7
    # stage 3
    u5 = _rs((t6 - t5) * c[16])
    u6 = _rs((t5 + t6) * c[16])
    e0, e1, e2, e3 = (even[..., k] for k in range(4))
    return xp.stack(
        [e0 + t7, e1 + u6, e2 + u5, e3 + t4,
         e3 - t4, e2 - u5, e1 - u6, e0 - t7], axis=-1)


def iadst8_1d(x, xp):
    c = COSPI
    x0, x1, x2, x3 = x[..., 7], x[..., 0], x[..., 5], x[..., 2]
    x4, x5, x6, x7 = x[..., 3], x[..., 4], x[..., 1], x[..., 6]
    # stage 1
    s0 = c[2] * x0 + c[30] * x1
    s1 = c[30] * x0 - c[2] * x1
    s2 = c[10] * x2 + c[22] * x3
    s3 = c[22] * x2 - c[10] * x3
    s4 = c[18] * x4 + c[14] * x5
    s5 = c[14] * x4 - c[18] * x5
    s6 = c[26] * x6 + c[6] * x7
    s7 = c[6] * x6 - c[26] * x7
    x0, x1, x2, x3 = _rs(s0 + s4), _rs(s1 + s5), _rs(s2 + s6), _rs(s3 + s7)
    x4, x5, x6, x7 = _rs(s0 - s4), _rs(s1 - s5), _rs(s2 - s6), _rs(s3 - s7)
    # stage 2
    s4 = c[8] * x4 + c[24] * x5
    s5 = c[24] * x4 - c[8] * x5
    s6 = -c[24] * x6 + c[8] * x7
    s7 = c[8] * x6 + c[24] * x7
    x0, x1, x2, x3 = x0 + x2, x1 + x3, x0 - x2, x1 - x3
    x4n, x5n = _rs(s4 + s6), _rs(s5 + s7)
    x6n, x7n = _rs(s4 - s6), _rs(s5 - s7)
    x4, x5, x6, x7 = x4n, x5n, x6n, x7n
    # stage 3
    x2n = _rs(c[16] * (x2 + x3))
    x3n = _rs(c[16] * (x2 - x3))
    x6n = _rs(c[16] * (x6 + x7))
    x7n = _rs(c[16] * (x6 - x7))
    return xp.stack(
        [x0, -x4, x6n, -x2n, x3n, -x7n, x5, -x1], axis=-1)


def idct16_1d(x, xp):
    c = COSPI
    # stage 2 (odd rotations on inputs 1,9,5,13,3,11,7,15)
    s8 = _rs(x[..., 1] * c[30] - x[..., 15] * c[2])
    s15 = _rs(x[..., 1] * c[2] + x[..., 15] * c[30])
    s9 = _rs(x[..., 9] * c[14] - x[..., 7] * c[18])
    s14 = _rs(x[..., 9] * c[18] + x[..., 7] * c[14])
    s10 = _rs(x[..., 5] * c[22] - x[..., 11] * c[10])
    s13 = _rs(x[..., 5] * c[10] + x[..., 11] * c[22])
    s11 = _rs(x[..., 13] * c[6] - x[..., 3] * c[26])
    s12 = _rs(x[..., 13] * c[26] + x[..., 3] * c[6])
    # stage 3
    t8 = s8 + s9
    t9 = s8 - s9
    t10 = -s10 + s11
    t11 = s10 + s11
    t12 = s12 + s13
    t13 = s12 - s13
    t14 = -s14 + s15
    t15 = s14 + s15
    # even part = idct8 of even inputs
    even = idct8_1d(
        xp.stack([x[..., 2 * k] for k in range(8)], axis=-1), xp)
    # stage 4 (odd)
    u9 = _rs(-t9 * c[8] + t14 * c[24])
    u14 = _rs(t9 * c[24] + t14 * c[8])
    u10 = _rs(-t10 * c[24] - t13 * c[8])
    u13 = _rs(-t10 * c[8] + t13 * c[24])
    # stage 5 (odd)
    v8 = t8 + t11
    v9 = u9 + u10
    v10 = u9 - u10
    v11 = t8 - t11
    v12 = -t12 + t15
    v13 = -u13 + u14
    v14 = u13 + u14
    v15 = t12 + t15
    # stage 6 (odd)
    w10 = _rs((-v10 + v13) * c[16])
    w13 = _rs((v10 + v13) * c[16])
    w11 = _rs((-v11 + v12) * c[16])
    w12 = _rs((v11 + v12) * c[16])
    e = [even[..., k] for k in range(8)]
    odd = [v8, v9, w10, w11, w12, w13, v14, v15]
    outs = [e[k] + odd[7 - k] for k in range(8)] + \
           [e[7 - k] - odd[k] for k in range(8)]
    return xp.stack(outs, axis=-1)


def iadst16_1d(x, xp):
    c = COSPI
    xs = [x[..., 15], x[..., 0], x[..., 13], x[..., 2], x[..., 11], x[..., 4],
          x[..., 9], x[..., 6], x[..., 7], x[..., 8], x[..., 5], x[..., 10],
          x[..., 3], x[..., 12], x[..., 1], x[..., 14]]
    (x0, x1, x2, x3, x4, x5, x6, x7,
     x8, x9, x10, x11, x12, x13, x14, x15) = xs
    # stage 1
    s0 = x0 * c[1] + x1 * c[31]
    s1 = x0 * c[31] - x1 * c[1]
    s2 = x2 * c[5] + x3 * c[27]
    s3 = x2 * c[27] - x3 * c[5]
    s4 = x4 * c[9] + x5 * c[23]
    s5 = x4 * c[23] - x5 * c[9]
    s6 = x6 * c[13] + x7 * c[19]
    s7 = x6 * c[19] - x7 * c[13]
    s8 = x8 * c[17] + x9 * c[15]
    s9 = x8 * c[15] - x9 * c[17]
    s10 = x10 * c[21] + x11 * c[11]
    s11 = x10 * c[11] - x11 * c[21]
    s12 = x12 * c[25] + x13 * c[7]
    s13 = x12 * c[7] - x13 * c[25]
    s14 = x14 * c[29] + x15 * c[3]
    s15 = x14 * c[3] - x15 * c[29]
    x0, x8 = _rs(s0 + s8), _rs(s0 - s8)
    x1, x9 = _rs(s1 + s9), _rs(s1 - s9)
    x2, x10 = _rs(s2 + s10), _rs(s2 - s10)
    x3, x11 = _rs(s3 + s11), _rs(s3 - s11)
    x4, x12 = _rs(s4 + s12), _rs(s4 - s12)
    x5, x13 = _rs(s5 + s13), _rs(s5 - s13)
    x6, x14 = _rs(s6 + s14), _rs(s6 - s14)
    x7, x15 = _rs(s7 + s15), _rs(s7 - s15)
    # stage 2
    s8 = x8 * c[4] + x9 * c[28]
    s9 = x8 * c[28] - x9 * c[4]
    s10 = x10 * c[20] + x11 * c[12]
    s11 = x10 * c[12] - x11 * c[20]
    s12 = -x12 * c[28] + x13 * c[4]
    s13 = x12 * c[4] + x13 * c[28]
    s14 = -x14 * c[12] + x15 * c[20]
    s15 = x14 * c[20] + x15 * c[12]
    x0, x4 = x0 + x4, x0 - x4
    x1, x5 = x1 + x5, x1 - x5
    x2, x6 = x2 + x6, x2 - x6
    x3, x7 = x3 + x7, x3 - x7
    x8, x12 = _rs(s8 + s12), _rs(s8 - s12)
    x9, x13 = _rs(s9 + s13), _rs(s9 - s13)
    x10, x14 = _rs(s10 + s14), _rs(s10 - s14)
    x11, x15 = _rs(s11 + s15), _rs(s11 - s15)
    # stage 3
    s4 = x4 * c[8] + x5 * c[24]
    s5 = x4 * c[24] - x5 * c[8]
    s6 = -x6 * c[24] + x7 * c[8]
    s7 = x6 * c[8] + x7 * c[24]
    s12 = x12 * c[8] + x13 * c[24]
    s13 = x12 * c[24] - x13 * c[8]
    s14 = -x14 * c[24] + x15 * c[8]
    s15 = x14 * c[8] + x15 * c[24]
    x0, x2 = x0 + x2, x0 - x2
    x1, x3 = x1 + x3, x1 - x3
    x4, x6 = _rs(s4 + s6), _rs(s4 - s6)
    x5, x7 = _rs(s5 + s7), _rs(s5 - s7)
    x8, x10 = x8 + x10, x8 - x10
    x9, x11 = x9 + x11, x9 - x11
    x12, x14 = _rs(s12 + s14), _rs(s12 - s14)
    x13, x15 = _rs(s13 + s15), _rs(s13 - s15)
    # stage 4
    x2n = _rs(-c[16] * (x2 + x3))
    x3n = _rs(c[16] * (x2 - x3))
    x6n = _rs(c[16] * (x6 + x7))
    x7n = _rs(c[16] * (-x6 + x7))
    x10n = _rs(c[16] * (x10 + x11))
    x11n = _rs(c[16] * (-x10 + x11))
    x14n = _rs(-c[16] * (x14 + x15))
    x15n = _rs(c[16] * (x14 - x15))
    return xp.stack(
        [x0, -x8, x12, -x4, x6n, x14n, x10n, x2n,
         x3n, x11n, x15n, x7n, x5, -x13, x9, -x1], axis=-1)


def idct32_1d(x, xp):
    c = COSPI
    # stage 1: odd-half rotations (inputs 1,17,9,25,5,21,13,29,3,19,11,27,
    # 7,23,15,31 producing s16..s31)
    s16 = _rs(x[..., 1] * c[31] - x[..., 31] * c[1])
    s31 = _rs(x[..., 1] * c[1] + x[..., 31] * c[31])
    s17 = _rs(x[..., 17] * c[15] - x[..., 15] * c[17])
    s30 = _rs(x[..., 17] * c[17] + x[..., 15] * c[15])
    s18 = _rs(x[..., 9] * c[23] - x[..., 23] * c[9])
    s29 = _rs(x[..., 9] * c[9] + x[..., 23] * c[23])
    s19 = _rs(x[..., 25] * c[7] - x[..., 7] * c[25])
    s28 = _rs(x[..., 25] * c[25] + x[..., 7] * c[7])
    s20 = _rs(x[..., 5] * c[27] - x[..., 27] * c[5])
    s27 = _rs(x[..., 5] * c[5] + x[..., 27] * c[27])
    s21 = _rs(x[..., 21] * c[11] - x[..., 11] * c[21])
    s26 = _rs(x[..., 21] * c[21] + x[..., 11] * c[11])
    s22 = _rs(x[..., 13] * c[19] - x[..., 19] * c[13])
    s25 = _rs(x[..., 13] * c[13] + x[..., 19] * c[19])
    s23 = _rs(x[..., 29] * c[3] - x[..., 3] * c[29])
    s24 = _rs(x[..., 29] * c[29] + x[..., 3] * c[3])
    # stage 2 (odd half butterflies)
    t16 = s16 + s17
    t17 = s16 - s17
    t18 = -s18 + s19
    t19 = s18 + s19
    t20 = s20 + s21
    t21 = s20 - s21
    t22 = -s22 + s23
    t23 = s22 + s23
    t24 = s24 + s25
    t25 = s24 - s25
    t26 = -s26 + s27
    t27 = s26 + s27
    t28 = s28 + s29
    t29 = s28 - s29
    t30 = -s30 + s31
    t31 = s30 + s31
    # stage 3 (odd rotations)
    u17 = _rs(-t17 * c[4] + t30 * c[28])
    u30 = _rs(t17 * c[28] + t30 * c[4])
    u18 = _rs(-t18 * c[28] - t29 * c[4])
    u29 = _rs(-t18 * c[4] + t29 * c[28])
    u21 = _rs(-t21 * c[20] + t26 * c[12])
    u26 = _rs(t21 * c[12] + t26 * c[20])
    u22 = _rs(-t22 * c[12] - t25 * c[20])
    u25 = _rs(-t22 * c[20] + t25 * c[12])
    # stage 4 (odd butterflies)
    v16 = t16 + t19
    v17 = u17 + u18
    v18 = u17 - u18
    v19 = t16 - t19
    v20 = -t20 + t23
    v21 = -u21 + u22
    v22 = u21 + u22
    v23 = t20 + t23
    v24 = t24 + t27
    v25 = u25 + u26
    v26 = u25 - u26
    v27 = t24 - t27
    v28 = -t28 + t31
    v29 = -u29 + u30
    v30 = u29 + u30
    v31 = t28 + t31
    # stage 5 (odd rotations)
    w18 = _rs(-v18 * c[8] + v29 * c[24])
    w29 = _rs(v18 * c[24] + v29 * c[8])
    w19 = _rs(-v19 * c[8] + v28 * c[24])
    w28 = _rs(v19 * c[24] + v28 * c[8])
    w20 = _rs(-v20 * c[24] - v27 * c[8])
    w27 = _rs(-v20 * c[8] + v27 * c[24])
    w21 = _rs(-v21 * c[24] - v26 * c[8])
    w26 = _rs(-v21 * c[8] + v26 * c[24])
    # stage 6 (odd butterflies)
    a16 = v16 + v23
    a17 = v17 + v22
    a18 = w18 + w21
    a19 = w19 + w20
    a20 = w19 - w20
    a21 = w18 - w21
    a22 = v17 - v22
    a23 = v16 - v23
    a24 = -v24 + v31
    a25 = -v25 + v30
    a26 = -w26 + w29
    a27 = -w27 + w28
    a28 = w27 + w28
    a29 = w26 + w29
    a30 = v25 + v30
    a31 = v24 + v31
    # stage 7 (odd rotations)
    b20 = _rs((-a20 + a27) * c[16])
    b27 = _rs((a20 + a27) * c[16])
    b21 = _rs((-a21 + a26) * c[16])
    b26 = _rs((a21 + a26) * c[16])
    b22 = _rs((-a22 + a25) * c[16])
    b25 = _rs((a22 + a25) * c[16])
    b23 = _rs((-a23 + a24) * c[16])
    b24 = _rs((a23 + a24) * c[16])
    odd = [a16, a17, a18, a19, b20, b21, b22, b23,
           b24, b25, b26, b27, a28, a29, a30, a31]
    # even half = idct16 of even inputs
    even = idct16_1d(
        xp.stack([x[..., 2 * k] for k in range(16)], axis=-1), xp)
    e = [even[..., k] for k in range(16)]
    outs = [e[k] + odd[15 - k] for k in range(16)] + \
           [e[15 - k] - odd[k] for k in range(16)]
    return xp.stack(outs, axis=-1)


def iwht4_1d(x, xp):
    """Inverse Walsh-Hadamard rows pass (lossless mode), input pre-shifted."""
    a = x[..., 0] + x[..., 1]
    d = x[..., 2] - x[..., 3]
    e = (a - d) >> 1
    b = e - x[..., 3]
    cc = e - x[..., 1]
    return xp.stack([a - b, b, cc, d + cc], axis=-1)


def fwht4_1d(x, xp):
    """Forward Walsh-Hadamard 1-D (lossless mode; exact inverse of iwht)."""
    a = x[..., 0] + x[..., 1]
    d = x[..., 3] - x[..., 2]
    e = (a - d) >> 1
    b = e - x[..., 1]
    cc = e - x[..., 2]
    a = a - cc
    d = d + b
    # output order: a, c, d, b
    return xp.stack([a, cc, d, b], axis=-1)


def fwht4x4(residual, xp=np):
    """Exact integer forward WHT (vp9_dct.c eb_vp9_fwht4x4): columns pass,
    rows pass, then <<2 (UNIT_QUANT_FACTOR)."""
    r = residual.astype(xp.int32)
    y = fwht4_1d(xp.swapaxes(r, -1, -2), xp)   # columns
    y = fwht4_1d(xp.swapaxes(y, -1, -2), xp)   # rows
    return y * 4


_IDCT_1D = {4: idct4_1d, 8: idct8_1d, 16: idct16_1d, 32: idct32_1d}
_IADST_1D = {4: iadst4_1d, 8: iadst8_1d, 16: iadst16_1d}


def _numpy_only(name: str, xp) -> None:
    if xp is not np:
        raise NotImplementedError(
            f"tpu_vp9_torch.ops.txfm.{name}: only xp=np is carried over "
            "from the JAX package; the device step has its own float64 "
            "version in this module")


def _1d_for(n: int, adst: bool):
    return _IADST_1D[n] if adst else _IDCT_1D[n]


def inv_txfm2d(coeffs, tx_size: TxSize, tx_type: TxType, xp=np):
    """Exact integer 2-D inverse transform (no pred add, no final shift).

    coeffs: (..., N, N) integer array in natural (row, col) layout.
    Returns residual*2^shift as (..., N, N); caller applies
    ``_rpot(x, FINAL_SHIFT[N])`` and adds prediction.
    """
    n = TX_N[TxSize(tx_size)]
    tt = TxType(tx_type)
    row_adst = tt in (TxType.ADST_ADST, TxType.DCT_ADST) and n <= 16
    col_adst = tt in (TxType.ADST_ADST, TxType.ADST_DCT) and n <= 16
    row_fn = _1d_for(n, row_adst)
    col_fn = _1d_for(n, col_adst)
    y = row_fn(coeffs, xp)  # transform each row (last axis)
    y = xp.swapaxes(y, -1, -2)
    y = col_fn(y, xp)  # transform each column
    return xp.swapaxes(y, -1, -2)


def inv_txfm_add(coeffs, pred, tx_size: TxSize, tx_type: TxType, xp=np):
    """Reconstruct: clip(pred + round(inv_txfm)) exactly as a decoder."""
    n = TX_N[TxSize(tx_size)]
    if xp is np:
        # native butterflies (bit-identical; the Python per-block
        # butterflies were the top wall-time of the M0-M4 host encode)
        from tpu_vp9_torch.native import native_inv_txfm_add

        out = native_inv_txfm_add(coeffs, pred, n, int(TxType(tx_type)))
        if out is not None:
            return out
    res = inv_txfm2d(coeffs, tx_size, tx_type, xp)
    res = _rpot(res, FINAL_SHIFT[n])
    if xp is torch:
        return (pred.to(res.dtype) + res).clamp(0, 255).to(torch.uint8)
    out = pred.astype(res.dtype) + res
    return xp.clip(out, 0, 255).astype(xp.uint8)


def iwht4x4_add(coeffs, pred, xp=np):
    """Lossless 4x4 inverse WHT reconstruction (qindex 0 path)."""
    x = coeffs >> 2  # UNIT_QUANT_SHIFT
    y = iwht4_1d(x, xp)
    y = xp.swapaxes(y, -1, -2)
    y = iwht4_1d(y, xp)
    y = xp.swapaxes(y, -1, -2)
    out = pred.astype(y.dtype) + y
    return xp.clip(out, 0, 255).astype(xp.uint8)


# ---------------------------------------------------------------------------
# Forward transforms: float matrices matched to the integer inverse.
# ---------------------------------------------------------------------------


@functools.cache
def _inv_matrix(n: int, adst: bool) -> np.ndarray:
    """Effective 1-D inverse transform matrix A (y = A @ x), measured from
    the integer implementation at high amplitude."""
    amp = 4096
    fn = _1d_for(n, adst)
    eye = np.eye(n, dtype=np.int64) * amp
    cols = fn(eye, np)  # row k = response to impulse at k
    return (cols.T / amp).astype(np.float64)


@functools.cache
def fwd_matrices(tx_size: TxSize, tx_type: TxType):
    """(F_col, F_rowT) float32 matrices with X = F_col @ R @ F_rowT matching
    the integer inverse pipeline R = (A_col @ X @ A_row.T) >> shift."""
    n = TX_N[TxSize(tx_size)]
    tt = TxType(tx_type)
    row_adst = tt in (TxType.ADST_ADST, TxType.DCT_ADST) and n <= 16
    col_adst = tt in (TxType.ADST_ADST, TxType.ADST_DCT) and n <= 16
    a_row = _inv_matrix(n, row_adst)
    a_col = _inv_matrix(n, col_adst)
    shift = FINAL_SHIFT[n]
    f_col = (2.0**shift) * np.linalg.inv(a_col)
    f_row_t = np.linalg.inv(a_row).T
    return f_col.astype(np.float32), f_row_t.astype(np.float32)


def fwd_txfm2d(residual, tx_size: TxSize, tx_type: TxType, xp=np):
    """Forward transform residual (..., N, N) -> float coefficients.

    The result, when rounded, dequantized by 1 and run through
    ``inv_txfm_add``, reproduces the residual to within rounding error.
    numpy only: the device step uses ``fwd_txfm2d_f64``.
    """
    _numpy_only("fwd_txfm2d", xp)
    f_col, f_row_t = fwd_matrices(tx_size, tx_type)
    r = residual.astype(np.float32)
    return np.matmul(np.matmul(f_col, r), f_row_t)


# ---------------------------------------------------------------------------
# Quantization (encoder-side choice; dequant is normative)
# ---------------------------------------------------------------------------


def dequant_block(levels, dc_q: int, ac_q: int, tx_size: TxSize, xp=np):
    """Normative dequantization: |coeff| = |level| * q, >>1 for 32x32
    (spec 8.6.3), sign reapplied; dc_q applies to coefficient (0,0)."""
    n = TX_N[TxSize(tx_size)]
    if xp is torch:
        q = torch.full(levels.shape[-2:], ac_q, dtype=torch.int32,
                       device=levels.device)
        q[0, 0] = dc_q
        mag = levels.abs() * q
    else:
        q = xp.full(levels.shape, ac_q, dtype=xp.int32)
        q[..., 0, 0] = dc_q
        mag = xp.abs(levels).astype(xp.int32) * q
    if n == 32:
        mag = mag >> 1
    return xp.where(levels < 0, -mag, mag)


def quantize_block(coeffs, dc_q: int, ac_q: int, tx_size: TxSize, xp=np,
                   bias: float = 0.38):
    """Encoder quantization: round(|c| / q_eff - bias-complement).

    q_eff is q/2 for 32x32 (matching the normative >>1 dequant).  `bias`
    < 0.5 biases toward zero (standard deadzone), improving rate at
    negligible distortion cost.
    """
    _numpy_only("quantize_block", xp)
    n = TX_N[TxSize(tx_size)]
    q = xp.full(coeffs.shape, float(ac_q), dtype=xp.float32)
    q[..., 0, 0] = float(dc_q)
    if n == 32:
        q = q * 0.5
    mag = xp.abs(coeffs) / q + bias
    levels = xp.floor(mag).astype(xp.int32)
    # clamp to the token range the bitstream can carry comfortably
    levels = xp.clip(levels, 0, (1 << 13) - 1)
    return xp.where(coeffs < 0, -levels, levels)


# ---------------------------------------------------------------------------
# The device step's forward transform and quantizer: float64 on torch
# ---------------------------------------------------------------------------

TX_SIZE = {4: TxSize.TX_4X4, 8: TxSize.TX_8X8, 16: TxSize.TX_16X16,
           32: TxSize.TX_32X32}
MAX_LEVEL = (1 << 13) - 1
# the JAX package adds its 0.38 dead-zone bias in float32; the float64
# quantizer adds that same float32 value, so both share one threshold
QBIAS = float(np.float32(0.38))


@functools.lru_cache(maxsize=None)
def _fwd_matrices64(n: int, device: torch.device):
    """The float32 matrices of ``fwd_matrices``, widened, not recomputed."""
    f_col, f_row_t = fwd_matrices(TX_SIZE[n], TxType.DCT_DCT)
    return (torch.from_numpy(f_col).to(device=device, dtype=torch.float64),
            torch.from_numpy(f_row_t).to(device=device, dtype=torch.float64))


def fwd_txfm2d_f64(resid):
    """(B, n, n) int32 torch residual -> float64 DCT_DCT coefficients."""
    f_col, f_row_t = _fwd_matrices64(resid.shape[-1], resid.device)
    return torch.matmul(torch.matmul(f_col, resid.to(torch.float64)),
                        f_row_t)


def quantize_f64(coeffs, dc_q: int, ac_q: int, n: int, bias: float = QBIAS):
    """``floor(|c| / q + bias)``, q halved at n=32, levels clipped to
    2^13 - 1, sign restored; int32. Float64 torch throughout."""
    q = torch.full(coeffs.shape[-2:], ac_q, dtype=torch.float64,
                   device=coeffs.device)
    q[0, 0] = dc_q
    if n == 32:
        q = q * 0.5
    levels = torch.floor(coeffs.abs() / q + bias).clamp(0, MAX_LEVEL)
    levels = levels.to(torch.int32)
    return torch.where(coeffs < 0, -levels, levels)
