"""The P-frame step's transform stage: the port's plain version
``transform_recon_ref`` (what CPU tensors run, and what ``chip_smoke.py``
holds the CUDA kernel ``csrc/transform_recon.cu`` against on the card)
against the JAX package's ``transform_recon``, and the step's dispatch.

Inputs are made from a seed with numpy: prediction errors of every size
the path takes (zone luma 32, chroma 16; children 16 and 8), blocks of
+-255 residuals, all-zero residuals, at four qindex values; at qindex 0
the 32x32 levels reach the 8191 clip. The JAX forward transform is
float32 and the port's float64, so a level may differ only where JAX's
float32 ``|c| / q + 0.38`` lies within 1e-3 of an integer, by one, counted
at the differing levels only; eob and recon are equal in every block whose
levels are.

Two premises of the CUDA kernel ``csrc/transform_recon.cu`` are held here
too: its first forward product F_col @ R is exact in float64 in any order
of summation, and its quantizer (``txfm_common.cuh:quantize_rcp``, a
reciprocal multiply that falls back to the rounded quotient near a floor
boundary), mirrored step for step in numpy, gives ``txfm.quantize_f64``'s
levels bit for bit.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vp9.bitstream import tables as T
from tpu_vp9.bitstream.tables import TxType
from tpu_vp9.ops import txfm as jtxfm
from tpu_vp9.pipeline import tpu_encdec as J

from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.ops import txfm as ptxfm
from tpu_vp9_torch.pipeline import tpu_encdec as P

torch.set_num_threads(1)

QINDICES = (0, 10, 100, 255)
BOUNDARY_BAND = 1e-3  # JAX's float32 quantizer input near an integer


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _blocks(n, seed):
    """(src, pred) uint8 (B, n, n): 24 prediction errors (smooth source,
    prediction within +-60), 6 blocks of +-255 residuals (constant, and
    0/255 at random pixels), 4 of zero residual."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:n, 0:n]
    phase = rng.uniform(0, 6, (24, 1, 1))
    src = np.clip(128 + 90 * np.sin(0.2 * yy + 0.3 * xx + phase)
                  + rng.normal(0, 8, (24, n, n)), 0, 255).astype(np.uint8)
    pred = np.clip(src.astype(int) + rng.integers(-60, 61, src.shape), 0,
                   255).astype(np.uint8)
    ext = rng.choice([0, 255], (6, n, n)).astype(np.uint8)
    ext[0], ext[1] = 255, 0
    same = rng.integers(0, 256, (4, n, n), dtype=np.uint8)
    return (np.concatenate([src, ext, same]),
            np.concatenate([pred, 255 - ext, same]))


def _jax_float_mag(src, pred, dc_q, ac_q, n):
    """JAX's own float32 quantizer input |c| / q + 0.38."""
    resid = (src.astype(np.int32) - pred).astype(np.float32)
    coeffs = np.asarray(jtxfm.fwd_txfm2d(jnp.asarray(resid), J._TS[n],
                                         TxType.DCT_DCT, jnp))
    q = np.full((n, n), ac_q, np.float32)
    q[0, 0] = dc_q
    if n == 32:
        q = q * np.float32(0.5)
    return np.abs(coeffs) / q + np.float32(0.38)


@pytest.mark.parametrize("qindex", QINDICES)
@pytest.mark.parametrize("n", [8, 16, 32])
def test_transform_recon_ref_matches_jax_but_for_boundary_flips(n, qindex):
    src, pred = _blocks(n, seed=n)
    dc_q, ac_q = T.dc_quant(qindex), T.ac_quant(qindex)
    lv_j, eob_j, rec_j = (np.asarray(a) for a in J.transform_recon(
        jnp.asarray(src), jnp.asarray(pred), jnp.int32(dc_q),
        jnp.int32(ac_q), n))
    lv_p, eob_p, rec_p = P.transform_recon_ref(_t(src), _t(pred), dc_q, ac_q,
                                               n)
    assert (lv_p.dtype, eob_p.dtype, rec_p.dtype) == (
        torch.int16, torch.int32, torch.uint8)
    flips = np.argwhere(lv_p.numpy() != lv_j)
    if len(flips):
        mag = _jax_float_mag(src, pred, dc_q, ac_q, n)
        for b, i, j in flips:
            assert abs(int(lv_p[b, i, j]) - int(lv_j[b, i, j])) == 1
            assert abs(mag[b, i, j] - np.round(mag[b, i, j])) < BOUNDARY_BAND
    same = ~(lv_p.numpy() != lv_j).reshape(len(src), -1).any(axis=1)
    np.testing.assert_array_equal(eob_p.numpy()[same], eob_j[same])
    np.testing.assert_array_equal(rec_p.numpy()[same], rec_j[same])
    # the zero residuals: no level, eob 0, the prediction back
    assert not lv_j[-4:].any() and not eob_j[-4:].any()
    np.testing.assert_array_equal(rec_p.numpy()[-4:], pred[-4:])
    if n == 32 and qindex == 0:
        assert int(np.abs(lv_j).max()) == 8191  # the level clip is reached
        assert int(lv_p.abs().max()) == 8191


@pytest.mark.parametrize("n", [8, 16, 32])
def test_recon_from_levels_matches_jax_at_every_eob(n):
    """One nonzero level at each scan place in turn (every eob value), and
    the largest levels: the integer half equals JAX's bit for bit."""
    nn = n * n
    dc_q, ac_q = T.dc_quant(60), T.ac_quant(60)
    scan = np.asarray(T.scan_order(J._TS[n], TxType.DCT_DCT)[0])
    levels = np.zeros((nn + 2, nn), np.int32)
    levels[np.arange(nn), scan] = np.where(np.arange(nn) % 2, 20, -3)
    levels[nn] = 8191
    levels[nn + 1] = -8191
    levels = levels.reshape(-1, n, n)
    pred = np.random.default_rng(n).integers(0, 256, levels.shape,
                                             dtype=np.uint8)
    eob_p, rec_p = P.recon_from_levels(_t(levels), _t(pred), dc_q, ac_q, n)
    deq = J._dequantize(jnp.asarray(levels), jnp.int32(dc_q),
                        jnp.int32(ac_q), n)
    rec_j = jtxfm.inv_txfm_add(deq, jnp.asarray(pred).astype(jnp.int32),
                               J._TS[n], TxType.DCT_DCT, jnp)
    np.testing.assert_array_equal(rec_p.numpy(), np.asarray(rec_j))
    np.testing.assert_array_equal(eob_p.numpy()[:nn], np.arange(1, nn + 1))
    assert int(eob_p[nn]) == int(eob_p[nn + 1]) == nn


def test_dispatch_takes_the_plain_version_for_cpu_blocks(monkeypatch):
    src, pred = _blocks(16, seed=3)
    want = P.transform_recon_ref(_t(src), _t(pred), 40, 48, 16)
    calls = []
    real = P.transform_recon_ref
    monkeypatch.setattr(P, "transform_recon_ref",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(K, "_launch", lambda *a: pytest.fail("launched"))
    got = P.transform_recon(_t(src), _t(pred),
                            P.step_scalars(40, 48, 0, 0, 0, 0), 16)
    assert calls == [1]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_dispatch_refuses_blocks_on_two_devices():
    src = torch.zeros((2, 8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="different devices"):
        P.transform_recon(src, src.to("meta"),
                          P.step_scalars(40, 48, 0, 0, 0, 0), 8)


def test_kframe_wave_ref_runs_the_plain_transform(monkeypatch):
    """The keyframe's plain version calls transform_recon_ref for each
    plane of each anti-diagonal, never the step's dispatch."""
    g = P.make_geom(64, 64)
    rng = np.random.default_rng(9)
    planes = [_t(rng.integers(0, 256, shp, dtype=np.uint8)) for shp in
              ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
               (g.pad_h // 2, g.pad_w // 2))]
    want = P.kframe_wave_ref(*planes, g, 93, 112, 196)
    calls = []
    real = P.transform_recon_ref
    monkeypatch.setattr(P, "transform_recon_ref",
                        lambda *a: calls.append(a[-1]) or real(*a))
    monkeypatch.setattr(P, "transform_recon",
                        lambda *a: pytest.fail("reached the dispatch"))
    got = P.kframe_wave_ref(*planes, g, 93, 112, 196)
    assert calls == [32, 16, 16] * (g.rows32 + g.cols32 - 1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad,err", [
    (dict(n=4), "n=4"),
    (dict(pred_shape=(3, 16, 16)), "pred_blocks shape"),
    (dict(dtype=torch.int32), "uint8"),
    (dict(dc_q=0), "quantizers"),
    (dict(ac_q=1 << 16), "quantizers"),
], ids=["size", "shape", "dtype", "dc_q", "ac_q"])
def test_kernel_wrapper_refuses_bad_arguments(bad, err):
    n = bad.get("n", 16)
    src = torch.zeros((2, n, n), dtype=bad.get("dtype", torch.uint8))
    pred = torch.zeros(bad.get("pred_shape", (2, n, n)), dtype=src.dtype)
    with pytest.raises((ValueError, TypeError), match=err):
        K.transform_recon(src, pred, P.step_scalars(
            bad.get("dc_q", 40), bad.get("ac_q", 48), 0, 0, 0, 0), n)


# ---------------------------------------------------------------------------
# the kernel's premises
# ---------------------------------------------------------------------------

# F_col's float32 entries lie on a grid of 2^-23, 2^-24 and 2^-26 at n = 8,
# 16 and 32; with |R| <= 255 every partial sum of F_col @ R is an integer
# multiple of that grid step of at most 37, 39 and 41 bits
F_COL_GRID = {8: 23, 16: 24, 32: 26}
F_COL_BITS = {8: 37, 16: 39, 32: 41}


@pytest.mark.parametrize("kind", ["random", "+-255"])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_first_forward_product_is_exact_in_any_order(n, kind):
    """F_col @ R in float64 (torch's matmul, and a loop summing the terms
    in reverse order) equals the int64 product of F_col scaled to integers,
    scaled back, bit for bit."""
    f_col = ptxfm._fwd_matrices64(n, torch.device("cpu"))[0].numpy()
    scale = 2.0 ** F_COL_GRID[n]
    f_int = f_col * scale
    assert np.array_equal(f_int, np.round(f_int))
    f_int = f_int.astype(np.int64)
    assert int(np.abs(f_int).sum(axis=1).max()) * 255 < 2 ** F_COL_BITS[n]
    rng = np.random.default_rng(100 + n)
    if kind == "random":
        r = rng.integers(-255, 256, (200, n, n))
    else:
        r = rng.choice([-255, 255], (200, n, n))
    exact = (f_int @ r).astype(np.float64) / scale  # < 2^53: exact
    got = torch.matmul(torch.from_numpy(f_col),
                       torch.from_numpy(r).to(torch.float64)).numpy()
    rev = np.zeros(r.shape)
    for k in reversed(range(n)):
        rev = rev + f_col[None, :, k, None] * r[:, None, k, :]
    np.testing.assert_array_equal(got, exact)
    np.testing.assert_array_equal(rev, exact)


@pytest.mark.parametrize("n,shift", [(8, 5), (16, 6), (32, 6)])
def test_row_matrix_is_the_column_matrix_transposed_and_scaled(n, shift):
    """The kernel stages F_col alone and reads F_row^T as F_col^T / 2^shift
    (both are the inverse's DCT matrix inverted, F_col scaled by the
    inverse's final shift): the two are equal bit for bit."""
    f_col, f_row_t = (m.numpy() for m in ptxfm._fwd_matrices64(
        n, torch.device("cpu")))
    np.testing.assert_array_equal(f_row_t, f_col.T * 2.0 ** -shift)


def _fma_rn(x, y, z):
    """x * y + z rounded once to float64 (the card's fma)."""
    return float(Fraction(x) * Fraction(y) + Fraction(z))


def _div_rn_from_rcp(a, qe, d):
    """txfm_common.cuh:div_rn_from_rcp: of d and its two neighbours on
    either side, the one whose fma residual a - t * qe is least in
    magnitude (the first such, in the order -2, -1, +1, +2)."""
    best, err = d, abs(_fma_rn(-d, qe, a))
    bits = int(np.float64(d).view(np.int64))
    for k in (-2, -1, 1, 2):
        t = float(np.int64(bits + k).view(np.float64))
        if not np.isfinite(t):
            continue  # the card's comparison with a NaN residual is false
        e = abs(_fma_rn(-t, qe, a))
        if e < err:
            best, err = t, e
    return best


def _quantize_rcp_mirror(coeffs, dc_q, ac_q, n):
    """txfm_common.cuh:quantize_rcp on (B, n, n) float64 coefficients, step
    for step in numpy float64 (each multiply and add rounded once, as the
    kernel's __dmul_rn and __dadd_rn). Returns (int32 levels, how many
    coefficients took the rounded quotient)."""
    q = np.full((n, n), float(ac_q))
    q[0, 0] = float(dc_q)
    if n == 32:
        q = q * 0.5
    qe = np.broadcast_to(q, coeffs.shape)
    a = np.abs(coeffs)
    d = a * (1.0 / qe)
    v = d + ptxfm.QBIAS
    near = (v < 8192.0) & (np.abs(v - np.rint(v)) < 2.0 ** -20)
    for idx in zip(*np.nonzero(near)):
        v[idx] = _div_rn_from_rcp(a[idx], qe[idx], d[idx]) + ptxfm.QBIAS
    levels = np.minimum(np.floor(v), ptxfm.MAX_LEVEL).astype(np.int32)
    return np.where(coeffs < 0, -levels, levels), int(near.sum())


QUANT_STEPS = {"small": (1, 2, 3, 4, 5, 7, 8, 9, 13, 16),
               "path": (4, 8, 17, 52, 112, 305, 1336, 1828),
               "large": (4096, 8191, 10000, 32768, 40001, 65534, 65535)}


@pytest.mark.parametrize("steps", list(QUANT_STEPS))
@pytest.mark.parametrize("n", [8, 16, 32])
def test_reciprocal_quantizer_keeps_the_division_bits(n, steps):
    """Coefficients within 1e-12 of every floor boundary |c| / q + 0.38 =
    k (k up to the 8191 clip and past it) and a few ulps either side of
    it, at each step q (halved at n = 32), signs mixed: the mirror of the
    kernel's quantizer equals quantize_f64 everywhere, and the rounded
    quotient was needed."""
    rng = np.random.default_rng(7 * n + len(steps))
    ks = np.concatenate([np.arange(0, 40), rng.integers(40, 8191, 60),
                         np.arange(8186, 8196)]).astype(np.float64)
    used = 0
    for q in QUANT_STEPS[steps]:
        qe = q * 0.5 if n == 32 else float(q)
        bound = (ks - ptxfm.QBIAS) * qe
        near = np.concatenate([
            (ks - ptxfm.QBIAS + rng.uniform(-1e-12, 1e-12, ks.shape)) * qe,
            *(np.nextafter(bound, np.inf * j) if j else bound
              for j in (-1, 0, 1)),
            bound * (1 + 4e-16), bound * (1 - 4e-16)])
        near = np.abs(near) * rng.choice([-1.0, 1.0], near.shape)
        pad = (-len(near)) % (n * n)
        coeffs = np.concatenate([near, np.zeros(pad)]).reshape(-1, n, n)
        got, fell_back = _quantize_rcp_mirror(coeffs, q, q, n)
        want = ptxfm.quantize_f64(torch.from_numpy(coeffs), q, q, n).numpy()
        np.testing.assert_array_equal(got, want)
        used += fell_back
    assert used > 0


@pytest.mark.parametrize("n", [8, 16, 32])
def test_reciprocal_quantizer_on_random_coefficients(n):
    """Coefficients of every magnitude from 1e-6 to 1e6, DC and AC steps
    apart: the mirror equals quantize_f64, the clip included."""
    rng = np.random.default_rng(300 + n)
    coeffs = (10.0 ** rng.uniform(-6, 6, (64, n, n))
              * rng.choice([-1.0, 1.0], (64, n, n)))
    top = []
    for dc_q, ac_q in ((1, 1), (8, 9), (1336, 1828), (65535, 65535)):
        got, _ = _quantize_rcp_mirror(coeffs, dc_q, ac_q, n)
        want = ptxfm.quantize_f64(torch.from_numpy(coeffs), dc_q, ac_q, n)
        np.testing.assert_array_equal(got, want.numpy())
        top.append(int(np.abs(got).max()))
    assert top[0] == ptxfm.MAX_LEVEL
