"""The P-frame step's quarter-pel search: the port's plain version
``subpel_search_ref`` (what CPU tensors run, and what ``chip_smoke.py``
holds the CUDA kernel ``csrc/subpel_search.cu`` against on the card)
against the JAX package's ``_subpel_exhaustive``, bit for bit, and the
step's dispatch.

The two shapes of the M8 path: the 32 zone's refine windows (n = 32,
r = REFINE_R = 4) and the children's (n = 16, r = CHILD_R = 8). Inputs
are made from a seed with numpy: random windows, smooth windows with the
source cut out of them at a seeded place, windows where all 49 offsets
tie (the first, (-6, -6), must win), the largest SSE, 0/255
checkerboards, and full-pel winners at the corners of +-r.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vp9.bitstream import tables as T
from tpu_vp9.pipeline import tpu_encdec as J

from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.pipeline import tpu_encdec as P

torch.set_num_threads(1)

FILTERS = T.subpel_filters(T.InterpFilter.EIGHTTAP)
SHAPES = [(32, P.REFINE_R), (16, P.CHILD_R)]
# blocks of the batch, by kind
KINDS = {"random": 8, "smooth": 8, "tie": 3, "max_sse": 1, "checker": 2,
         "corners": 4}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(n, r, seed):
    """(wins, src, dy, dx) of one batch with the blocks of KINDS in that
    order."""
    rng = np.random.default_rng(seed)
    sw = n + 2 * r + 8
    b = sum(KINDS.values())
    dy = rng.integers(-r, r + 1, b).astype(np.int32)
    dx = rng.integers(-r, r + 1, b).astype(np.int32)
    wins = rng.integers(0, 256, (b, sw, sw), dtype=np.uint8)
    src = rng.integers(0, 256, (b, n, n), dtype=np.uint8)
    i = KINDS["random"]
    yy, xx = np.mgrid[0:sw, 0:sw]
    for k in range(KINDS["smooth"]):
        w = 128 + 100 * np.sin(0.31 * yy + 0.17 * xx + rng.uniform(0, 6))
        wins[i] = np.clip(w + rng.normal(0, 2, w.shape), 0, 255)
        oy, ox = 4 + r + dy[i] + rng.integers(-1, 2, 2)
        src[i] = wins[i, oy:oy + n, ox:ox + n]
        i += 1
    for k in range(KINDS["tie"]):
        wins[i], src[i] = 40 * k + 7, 40 * k + 7
        i += 1
    wins[i], src[i] = 0, 255  # every offset at the largest SSE
    i += 1
    cb = ((yy + xx) % 2 * 255).astype(np.uint8)
    for k in range(KINDS["checker"]):
        wins[i] = cb if k == 0 else 255 - cb
        src[i] = 255 - cb[:n, :n]
        i += 1
    for cy, cx in ((-r, -r), (-r, r), (r, -r), (r, r)):
        dy[i], dx[i] = cy, cx
        i += 1
    return wins, src, dy, dx


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("n,r", SHAPES, ids=["zone_n32_r4", "children_n16_r8"])
def test_subpel_search_ref_matches_jax(n, r, seed):
    wins, src, dy, dx = _inputs(n, r, seed)
    want = J._subpel_exhaustive(jnp.asarray(wins), jnp.asarray(src),
                                jnp.asarray(dy), jnp.asarray(dx), n, FILTERS,
                                r=r)
    got = P.subpel_search_ref(_t(wins), _t(src), _t(dy), _t(dx), n, r)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mv_r, mv_c, sse = (g.numpy() for g in got)
    tie = slice(KINDS["random"] + KINDS["smooth"],
                KINDS["random"] + KINDS["smooth"] + KINDS["tie"])
    # all 49 offsets tie at SSE 0: the first in oy-major order, (-6, -6)
    np.testing.assert_array_equal(mv_r[tie], dy[tie] * 8 - 6)
    np.testing.assert_array_equal(mv_c[tie], dx[tie] * 8 - 6)
    assert not sse[tie].any()
    top = tie.stop
    assert sse[top] == n * n * 255 * 255
    assert (mv_r[top], mv_c[top]) == (dy[top] * 8 - 6, dx[top] * 8 - 6)
    # the smooth blocks were cut out of their window: a close match
    smooth = slice(KINDS["random"], tie.start)
    assert np.all(np.abs(mv_r[smooth] - dy[smooth] * 8) <= 6)
    assert np.median(sse[smooth]) < np.median(sse[:KINDS["random"]])


def test_dispatch_takes_the_plain_version_for_cpu_tensors(monkeypatch):
    n, r = SHAPES[1]
    wins, src, dy, dx = (_t(a) for a in _inputs(n, r, seed=3))
    want = P.subpel_search_ref(wins, src, dy, dx, n, r)
    calls = []
    real = P.subpel_search_ref
    monkeypatch.setattr(P, "subpel_search_ref",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(K, "_launch", lambda *a: pytest.fail("launched"))
    got = P.subpel_search(wins, src, dy, dx, n, r)
    assert calls == [1]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bad,err", [
    (dict(n=4), "n=4"),
    (dict(r=-1), "r=-1"),
    (dict(sw=47), "wins shape"),
    (dict(dy_dtype=torch.int64), "int32"),
    (dict(dy_len=5), r"want \(6,\)"),
], ids=["size", "reach", "window", "dtype", "count"])
def test_kernel_wrapper_refuses_bad_arguments(bad, err):
    n, r = bad.get("n", 32), bad.get("r", 4)
    sw = bad.get("sw", n + 2 * r + 8)
    wins = torch.zeros((6, max(sw, 0), max(sw, 0)), dtype=torch.uint8)
    src = torch.zeros((6, n, n), dtype=torch.uint8)
    dy = torch.zeros(bad.get("dy_len", 6), dtype=bad.get("dy_dtype",
                                                          torch.int32))
    with pytest.raises((ValueError, TypeError), match=err):
        K.subpel_search(wins, src, dy, torch.zeros(6, dtype=torch.int32), n,
                        r)
