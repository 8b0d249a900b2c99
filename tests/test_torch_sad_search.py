"""The port's full-pel SAD search against the TPU package's.

The same seeded numpy inputs go through the JAX functions (the Pallas
kernel in interpret mode, and the XLA ``full_search_sse`` that the TPU
package runs off the TPU) and through the port (the kernel's plain PyTorch
version, which is what a CPU tensor runs). Tolerance 0: dy, dx and sad are
integers and must be bit-equal, ties included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_vp9.ops.pallas_kernels import sad_full_search as jax_sad_pallas
from tpu_vp9.pipeline import tpu_me as jax_me

from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.pipeline import tpu_me as port_me

torch.set_num_threads(1)


def _inputs(n, r, seed=0, b=6):
    """Random blocks and windows, with ties planted. Block 0 has an exact
    match at (2 - r, 3 - r). Blocks 1 and 2 tie: block 1's rows are all
    one random row, found in every row of its window at dx = 3 - r, so all
    dy tie and dy = -r must win; block 2 is constant, so every candidate
    ties and (-r, -r) must win. Block 3 is constant but for one bright
    window pixel at (r, r): the candidates that cover it lose."""
    rng = np.random.default_rng(seed)
    win = n + 2 * r
    blocks = rng.integers(0, 256, (b, n, n), dtype=np.uint8)
    regions = rng.integers(0, 256, (b, win, win), dtype=np.uint8)
    regions[0, 2:2 + n, 3:3 + n] = blocks[0]
    regions[1] = regions[1, :1]
    blocks[1] = regions[1, 0, 3:3 + n]
    blocks[2] = 77
    regions[2] = 77
    blocks[3] = 10
    regions[3] = 10
    regions[3, r, r] = 200
    return blocks, regions


def _port(blocks, regions, n, r):
    out = K.sad_full_search(torch.from_numpy(blocks),
                            torch.from_numpy(regions), n, r)
    return [t.numpy() for t in out]


def _assert_same(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,r", [(16, 4), (32, 8)])
def test_sad_search_matches_pallas_interpret(n, r):
    blocks, regions = _inputs(n, r)
    want = jax_sad_pallas(jnp.asarray(blocks), jnp.asarray(regions), n, r,
                          interpret=True)
    got = _port(blocks, regions, n, r)
    _assert_same(got, want)
    assert (got[0][0], got[1][0], got[2][0]) == (2 - r, 3 - r, 0)
    assert (got[0][1], got[1][1], got[2][1]) == (-r, 3 - r, 0)
    assert (got[0][2], got[1][2], got[2][2]) == (-r, -r, 0)


@pytest.mark.parametrize("n,r", [(16, 4), (32, 8), (32, 16)])
def test_sad_search_matches_full_search_sse(n, r):
    blocks, regions = _inputs(n, r, seed=n + r, b=8)
    want = jax_me.full_search_sse(jnp.asarray(blocks), jnp.asarray(regions),
                                  n, r)
    _assert_same(_port(blocks, regions, n, r), want)


def test_cpu_tensors_take_plain_version_without_counting():
    blocks, regions = _inputs(16, 4)
    before = K.sad_full_search.launches
    got = _port(blocks, regions, 16, 4)
    want = K.sad_full_search_ref(torch.from_numpy(blocks),
                                 torch.from_numpy(regions), 16, 4)
    _assert_same(got, [t.numpy() for t in want])
    assert K.sad_full_search.launches == before


@pytest.mark.parametrize("n,r,shape,dtype,err", [
    (12, 4, None, torch.uint8, ValueError),
    (16, 0, None, torch.uint8, ValueError),
    (16, 33, None, torch.uint8, ValueError),
    (16, 4, (3, 16, 16), torch.int32, TypeError),
    (16, 4, (3, 16, 8), torch.uint8, ValueError),
])
def test_sad_search_rejects_what_the_kernel_does_not_take(n, r, shape, dtype,
                                                          err):
    win = n + 2 * r
    src = torch.zeros(shape or (3, n, n), dtype=dtype)
    reg = torch.zeros((3, win, win), dtype=dtype)
    with pytest.raises(err):
        K.sad_full_search(src, reg, n, r)


def _plane_and_ref(h, w, border, seed=3):
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, (h + 2 * border, w + 2 * border),
                       dtype=np.uint8)
    # source = reference shifted by (3, -5), so the search has a real answer
    src = np.ascontiguousarray(ref[border + 3:border + 3 + h,
                                   border - 5:border - 5 + w])
    return src, ref


def test_prep_blocks_regions_matches_jax():
    n, r, h, w = 32, 16, 192, 256
    src, ref = _plane_and_ref(h, w, 80)
    region = np.ascontiguousarray(ref[80 - r:80 + h + r, 80 - r:80 + w + r])
    jb, jr = jax_me._prep_blocks_regions(jnp.asarray(src),
                                         jnp.asarray(region), n, r)
    pb, pr = port_me._prep_blocks_regions(torch.from_numpy(src),
                                          torch.from_numpy(region), n, r)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))


def test_tpu_block_motion_matches_jax():
    n, r, h, w, border = 32, 16, 192, 256, 80
    src, ref = _plane_and_ref(h, w, border)
    want = jax_me.tpu_block_motion(src, ref, border, n, r)
    got = port_me.tpu_block_motion(src, ref, border, n, r, "cpu")
    assert got.shape == (h // n, w // n, 2)
    np.testing.assert_array_equal(got, want)
    assert (got == np.array([3, -5])).all(axis=-1).sum() > 0
    # second call hits the upload cache and answers the same
    np.testing.assert_array_equal(
        port_me.tpu_block_motion(src, ref, border, n, r, "cpu"), want)

