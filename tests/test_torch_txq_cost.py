"""``txq_cost`` of the port against the Pallas kernel of the JAX package.

The port's plain version (what a CPU tensor runs; the CUDA kernel is held
against it on the card by ``chip_smoke.py``) against
``tpu_vp9.ops.pallas_kernels.txq_cost(..., interpret=True)`` on the same
residuals, made from a seed with numpy.

The function is float throughout, so the two are held to a tolerance: for
a block none of whose coefficients has ``|c| / q + 0.38`` within 1e-3 of
an integer (found here in float64), ``dist`` and ``rate`` agree within
1e-4 relative plus 1e-3 absolute. A coefficient inside that band may land
on either side of ``trunc`` when the two matrix products are summed in
another order; one flip moves ``dist`` by up to about q^2 and ``rate`` by
1.5 or more. Blocks that disagree are counted: each must hold such a
coefficient, and they must stay under 1% of the blocks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vp9.ops import pallas_kernels as JK

from tpu_vp9_torch.ops import cuda_kernels as K

torch.set_num_threads(1)

RTOL, ATOL, BAND, MAX_FLIPPED = 1e-4, 1e-3, 1e-3, 0.01


def _residuals(n, seed, b=200):
    rng = np.random.default_rng(seed)
    resid = rng.integers(-64, 64, (b, n, n)).astype(np.float32)
    resid[0] = 0.0                      # all-zero block: (0, 0)
    resid[1] = 37.0                     # DC only
    resid[2] = -5.0                     # DC only, negative, a small level
    resid[3] *= 0.05                    # every level in the dead zone
    return resid


def exposed_blocks(resid, dc_q, ac_q, n, band=BAND):
    """Blocks with a coefficient whose |c|/q + 0.38 lies within ``band``
    of an integer, from float64 products of the float32 DCT matrix."""
    d = K.dct_matrix(n).astype(np.float64)
    c = d @ resid.astype(np.float64) @ d.T
    q = np.full((n, n), float(ac_q))
    q[0, 0] = float(dc_q)
    v = np.abs(c) / q + float(np.float32(K.TXQ_BIAS))
    return (np.abs(v - np.round(v)) < band).any(axis=(1, 2))


def held_to_tolerance(got, want, exposed):
    """Assert the stated tolerance; returns the number of blocks that
    disagree (all of them exposed)."""
    bad = np.zeros(exposed.shape, bool)
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape == exposed.shape
        assert np.isfinite(g).all()
        bad |= np.abs(g - w) > ATOL + RTOL * np.abs(w)
    assert not (bad & ~exposed).any(), np.nonzero(bad & ~exposed)[0]
    assert bad.sum() < MAX_FLIPPED * bad.size, int(bad.sum())
    return int(bad.sum())


@pytest.mark.parametrize("dc_q,ac_q", [(32.0, 40.0), (128.0, 160.0)],
                         ids=["q32_40", "q128_160"])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_txq_cost_matches_pallas(n, dc_q, ac_q):
    resid = _residuals(n, seed=n)
    want = JK.txq_cost(jnp.asarray(resid), dc_q, ac_q, n, interpret=True)
    before = K.txq_cost.launches
    got = K.txq_cost(torch.from_numpy(resid), dc_q, ac_q, n)
    assert K.txq_cost.launches == before  # a CPU tensor launches nothing
    for g in got:
        assert g.dtype == torch.float32 and tuple(g.shape) == (len(resid),)
    flipped = held_to_tolerance([g.numpy() for g in got], want,
                                exposed_blocks(resid, dc_q, ac_q, n))
    print(f"n={n} q=({dc_q}, {ac_q}): {flipped} of {len(resid)} blocks "
          "outside the tolerance")
    dist, rate = (g.numpy() for g in got)
    assert dist[0] == 0.0 and rate[0] == 0.0
    # DC-only blocks: one coefficient, n * value
    for i, val in ((1, 37.0), (2, -5.0)):
        c = n * val
        lvl = np.trunc(c / dc_q + np.sign(c) * 0.38)
        assert abs(dist[i] - (c - lvl * dc_q) ** 2) <= 1e-2 + 1e-4 * dist[i]
        want_rate = 1.5 + np.log2(1 + abs(lvl)) if lvl else 0.0
        assert abs(rate[i] - want_rate) <= 1e-3
    assert rate[3] == 0.0 and dist[3] > 0.0
    assert (dist >= 0).all() and (rate >= 0).all()


def test_txq_cost_coarser_quantizer_trades_rate_for_distortion():
    resid = torch.from_numpy(_residuals(16, seed=2))
    d1, r1 = K.txq_cost(resid, 32.0, 40.0, 16)
    d2, r2 = K.txq_cost(resid, 128.0, 160.0, 16)
    assert d2.sum() > d1.sum() and r2.sum() < r1.sum()


@pytest.mark.parametrize("n", K.TXQ_BLOCK_SIZES)
def test_dct_matrix_is_the_jax_package_s(n):
    np.testing.assert_array_equal(K.dct_matrix(n), JK._dct_matrix(n))
    d = K.dct_matrix(n).astype(np.float64)
    np.testing.assert_allclose(d @ d.T, np.eye(n), atol=1e-6)


def test_txq_cost_n4_runs():
    resid = _residuals(4, seed=4, b=16)
    want = JK.txq_cost(jnp.asarray(resid), 20.0, 24.0, 4, interpret=True)
    got = K.txq_cost(torch.from_numpy(resid), 20.0, 24.0, 4)
    held_to_tolerance([g.numpy() for g in got], want,
                      exposed_blocks(resid, 20.0, 24.0, 4))


def test_exposed_blocks_finds_a_coefficient_on_the_boundary():
    # a DC-only block whose level sits exactly on trunc's boundary
    n, q = 8, 32.0
    resid = np.zeros((2, n, n), np.float32)
    resid[0] = (2 - float(np.float32(0.38))) * q / n
    resid[1] = 1.3 * q / n
    assert exposed_blocks(resid, q, q, n).tolist() == [True, False]


@pytest.mark.parametrize("bad,exc", [
    (dict(n=64), ValueError),
    (dict(n=12), ValueError),
    (dict(dtype=torch.float64), TypeError),
    (dict(dtype=torch.int32), TypeError),
    (dict(shape=(3, 16, 8)), ValueError),
], ids=["n64", "n12", "float64", "int32", "shape"])
def test_txq_cost_refuses(bad, exc):
    n = bad.get("n", 16)
    shape = bad.get("shape", (3, n, n))
    x = torch.zeros(shape, dtype=bad.get("dtype", torch.float32))
    with pytest.raises(exc, match="txq_cost"):
        K.txq_cost(x, 32.0, 40.0, n)
