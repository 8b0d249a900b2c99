"""The port's positioned distortion (``block_energy_at``) and two-level
search (``hier_search`` / ``hier_search_fused``) against the JAX package.

Inputs are made from a seed with numpy; JAX runs on the CPU and the port
runs its plain versions, which is what CPU tensors run (on a card the same
wrappers launch the kernels of ``csrc/block_energy.cu`` and
``csrc/sse_search.cu``, which ``chip_smoke.py`` holds to these plain
versions). Everything here is integer arithmetic: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vp9.pipeline import tpu_encdec as J

from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.pipeline import tpu_encdec as P

torch.set_num_threads(1)

DIMS = [(64, 64), (128, 96), (160, 120)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _eq(port, ref):
    np.testing.assert_array_equal(
        port.numpy() if isinstance(port, torch.Tensor) else port,
        np.asarray(ref))


# ---------------------------------------------------------------------------
# block_energy_at
# ---------------------------------------------------------------------------


def _plane_and_blocks(dims, n, seed):
    """A border-extended reference plane of the geometry, source blocks of
    its n-grid, the grid's positions and q3 MVs: ordinary ones, and MVs
    that push a block out of the plane on every side (and both ways
    round the wrap of a negative start)."""
    rng = np.random.default_rng(seed)
    g = P.make_geom(*dims)
    ref = rng.integers(0, 256, (g.pad_h + 2 * P.BORDER,
                                g.pad_w + 2 * P.BORDER), dtype=np.uint8)
    rows, cols = g.rows32 * 32 // n, g.cols32 * 32 // n
    b = rows * cols
    pos_y = (np.arange(b) // cols * n).astype(np.int32)
    pos_x = (np.arange(b) % cols * n).astype(np.int32)
    src = rng.integers(0, 256, (b, n, n), dtype=np.uint8)
    mv = rng.integers(-326, 327, (b, 2)).astype(np.int32)
    outside = [(-4000, -4000), (4000, 4000), (-2000, 3000), (3000, -2500),
               (-900, 7), (5, -900), (900, 0), (0, 900)]
    for i, m in enumerate(outside[:b]):
        mv[i] = m
    mv[b - 1] = (3000, 100)
    return g, ref, src, pos_y, pos_x, mv, rows, cols


@pytest.mark.parametrize("n", [32, 16])
@pytest.mark.parametrize("dims", DIMS, ids=lambda d: f"{d[0]}x{d[1]}")
def test_block_energy_at_matches_zero_and_fullpel_sse(dims, n):
    """C = 2 in one call: the grid's co-located blocks (``_zero_sse``) and
    the blocks at rounded full-pel MVs (``_fullpel_sse``), whose starts
    have any alignment and are wrapped and clamped as ``lax.dynamic_slice``
    does."""
    g, ref, src, pos_y, pos_x, mv, rows, cols = _plane_and_blocks(
        dims, n, seed=sum(dims) + n)
    want0 = J._zero_sse(jnp.asarray(ref), jnp.asarray(src), 0, 0, rows,
                        cols, n)
    want1 = J._fullpel_sse(jnp.asarray(ref), jnp.asarray(src),
                           jnp.asarray(pos_y), jnp.asarray(pos_x),
                           jnp.asarray(mv[:, 0]), jnp.asarray(mv[:, 1]), n)
    zy, zx = P._grid_starts(rows, cols, n, torch.device("cpu"))
    py, px = P._fullpel_starts(ref.shape, _t(pos_y), _t(pos_x),
                               _t(mv[:, 0]), _t(mv[:, 1]), n)
    y0, x0 = torch.cat([zy, py[None]]), torch.cat([zx, px[None]])
    assert int((px % 4 != 0).sum()) > 0  # unaligned starts
    sse, sad = K.block_energy_at(_t(src), _t(ref), y0, x0, n)
    assert sse.dtype == sad.dtype == torch.int32
    assert tuple(sse.shape) == tuple(sad.shape) == (2, src.shape[0])
    _eq(sse[0], want0)
    _eq(sse[1], want1)
    # the SAD, which the JAX stages do not compute, against numpy
    for c in range(2):
        for i in (0, src.shape[0] - 1):
            ys, xs = int(y0[c, i]), int(x0[c, i])
            d = src[i].astype(np.int64) - ref[ys:ys + n, xs:xs + n]
            assert int(sad[c, i]) == int(np.abs(d).sum())
    # the step's own functions go through the same entry point
    _eq(P._zero_sse(_t(ref), _t(src), rows, cols, n), want0)
    _eq(P._fullpel_sse(_t(ref), _t(src), _t(pos_y), _t(pos_x),
                       _t(mv[:, 0]), _t(mv[:, 1]), n), want1)


@pytest.mark.parametrize("n", [8, 16, 32, 64])
def test_block_energy_at_is_gather_then_block_energy(n):
    """Any C, starts at every corner and edge of the plane, a view whose
    row pitch is not its width."""
    rng = np.random.default_rng(n)
    hh, ww = 150, 170
    wide = rng.integers(0, 256, (hh, ww + 13), dtype=np.uint8)
    plane = _t(wide)[:, :ww]
    b, c = 9, 3
    src = rng.integers(0, 256, (b, n, n), dtype=np.uint8)
    y0 = rng.integers(0, hh - n + 1, (c, b)).astype(np.int32)
    x0 = rng.integers(0, ww - n + 1, (c, b)).astype(np.int32)
    y0[0, :4], x0[0, :4] = (0, 0, hh - n, hh - n), (0, ww - n, 0, ww - n)
    y0[1, 0], x0[1, 0] = 3, 5
    src[0] = wide[3:3 + n, 5:5 + n]
    sse, sad = K.block_energy_at(_t(src), plane, _t(y0), _t(x0), n)
    assert int(sse[1, 0]) == 0 and int(sad[1, 0]) == 0
    for ci in range(c):
        pred = np.stack([wide[y:y + n, x:x + n]
                         for y, x in zip(y0[ci], x0[ci])])
        want = K.block_energy(_t(src), _t(pred), n)
        _eq(sse[ci], want[0])
        _eq(sad[ci], want[1])


def test_block_energy_at_refuses_bad_inputs():
    src = torch.zeros((4, 16, 16), dtype=torch.uint8)
    plane = torch.zeros((64, 80), dtype=torch.uint8)
    ok = torch.zeros((1, 4), dtype=torch.int32)
    K.block_energy_at(src, plane, ok, ok, 16)
    with pytest.raises(ValueError, match="leaves"):
        K.block_energy_at(src, plane, ok + 49, ok, 16)
    with pytest.raises(ValueError, match="leaves"):
        K.block_energy_at(src, plane, ok, ok - 1, 16)
    with pytest.raises(ValueError, match="starts of shape"):
        K.block_energy_at(src, plane, ok[:, :3], ok[:, :3], 16)
    with pytest.raises(TypeError, match="int32"):
        K.block_energy_at(src, plane, ok.long(), ok.long(), 16)
    with pytest.raises(TypeError, match="uint8"):
        K.block_energy_at(src, plane.to(torch.int16), ok, ok, 16)
    with pytest.raises(ValueError, match="n=4"):
        K.block_energy_at(src[:, :4, :4], plane, ok, ok, 4)
    with pytest.raises(ValueError, match="plane shape"):
        K.block_energy_at(src, plane[None], ok, ok, 16)
    empty = torch.zeros((2, 0), dtype=torch.int32)
    sse, sad = K.block_energy_at(src[:0], plane, empty, empty, 16)
    assert tuple(sse.shape) == tuple(sad.shape) == (2, 0)


@pytest.mark.parametrize("seed", [0, 1])
def test_golden_decide_scores_both_candidates_in_one_call(seed):
    """``_golden_decide`` (ZERO and the previous MV as C = 2) picks the
    first minimum of the costs the JAX step forms from ``_zero_sse`` and
    ``_fullpel_sse`` (rate proxies)."""
    n = 32
    g, ref, src, pos_y, pos_x, mv, rows, cols = _plane_and_blocks(
        (160, 120), n, seed=seed)
    if seed:  # make ZERO win somewhere: a block equal to its reference
        src[3] = ref[P.BORDER + pos_y[3]:P.BORDER + pos_y[3] + n,
                     P.BORDER + pos_x[3]:P.BORDER + pos_x[3] + n]
    lam = 7
    sses = jnp.stack([
        J._zero_sse(jnp.asarray(ref), jnp.asarray(src), 0, 0, rows, cols, n),
        J._fullpel_sse(jnp.asarray(ref), jnp.asarray(src),
                       jnp.asarray(pos_y), jnp.asarray(pos_x),
                       jnp.asarray(mv[:, 0]), jnp.asarray(mv[:, 1]), n)])
    rz, _, _, rp, _ = P.CAND_RATE_PROXY
    costs = np.asarray(sses).astype(np.float32) + np.float32(lam) * \
        np.array([[rz], [rp]], np.float32)
    best = costs.argmin(axis=0)
    mv_r, mv_c, cost = P._golden_decide(
        _t(ref), _t(src), _t(pos_y), _t(pos_x), _t(mv), rows, cols, n, lam,
        None)
    _eq(mv_r, np.where(best == 1, mv[:, 0], 0))
    _eq(mv_c, np.where(best == 1, mv[:, 1], 0))
    _eq(cost, costs[best, np.arange(costs.shape[1])])
    if seed:
        assert best[3] == 0 and (best == 1).any()


# ---------------------------------------------------------------------------
# hier_search
# ---------------------------------------------------------------------------


def _hier_case(case, seed):
    """(src, wins) of B blocks of 32 with (B, 120, 120) windows.

    "shifted": smooth windows, the sources noisy copies at seeded
    displacements (block 0 an exact copy at an even displacement, so its
    half-res minimum is -sum(src_h^2) < 0). "corners": bowl-shaped
    windows with exact copies at the four corners of the +-40 reach (the
    refine centre at +-36, its clamp) and along its sides.
    "ties": constant blocks (every candidate ties at both levels), a
    window repeating one row (every dy ties), the largest operands
    (window 255 against sources 0 and 255). "noise": white noise."""
    rng = np.random.default_rng(seed)
    if case == "corners":
        yy, xx = np.mgrid[0:120, 0:120]
        bowl = (((yy - 60) ** 2 + (xx - 60) ** 2) * 255 // 7200)
        disp = [(-40, -40), (-40, 40), (40, -40), (40, 40), (-40, 0),
                (40, 0), (0, -40), (0, 40), (-39, 37)]
        wins = np.repeat(bowl[None].astype(np.uint8), len(disp), axis=0)
        src = np.stack([wins[i, 44 + dy:76 + dy, 44 + dx:76 + dx]
                        for i, (dy, dx) in enumerate(disp)])
        return src, wins, disp
    if case == "ties":
        wins = rng.integers(0, 256, (6, 120, 120), dtype=np.uint8)
        src = rng.integers(0, 256, (6, 32, 32), dtype=np.uint8)
        src[0], wins[0] = 90, 90
        src[1], wins[1] = 0, 0
        wins[2] = wins[2, :1]
        src[2] = wins[2, 0, 44 + 6:76 + 6]
        src[3], wins[3] = 0, 255
        src[4], wins[4] = 255, 255
        return src, wins, None
    if case == "noise":
        return (rng.integers(0, 256, (8, 32, 32), dtype=np.uint8),
                rng.integers(0, 256, (8, 120, 120), dtype=np.uint8), None)
    b = 12
    coarse = rng.uniform(0, 255, (b, 7, 7))
    field = np.stack([np.kron(c, np.ones((20, 20)))[:120, :120]
                      for c in coarse])
    k = np.ones(9) / 9  # a box blur along both axes
    for ax in (1, 2):
        field = np.apply_along_axis(
            lambda v: np.convolve(v, k, mode="same"), ax, field)
    wins = np.clip(field + rng.integers(-3, 4, field.shape), 0,
                   255).astype(np.uint8)
    disp = rng.integers(-40, 41, (b, 2))
    disp[0] = (-12, 22)
    src = np.empty((b, 32, 32), np.uint8)
    for i, (dy, dx) in enumerate(disp):
        blk = wins[i, 44 + dy:76 + dy, 44 + dx:76 + dx].astype(np.int32)
        if i:
            blk = blk + rng.integers(-4, 5, (32, 32))
        src[i] = np.clip(blk, 0, 255)
    return src, wins, [tuple(d) for d in disp]


@pytest.mark.parametrize("case,seed", [("shifted", 0), ("shifted", 1),
                                       ("corners", 0), ("ties", 0),
                                       ("noise", 0)])
def test_hier_search_matches_jax_on_hard_cases(case, seed):
    """All seven outputs of the plain composition, which the fused kernel
    is held to on a card, against JAX's ``hier_search``."""
    src, wins, disp = _hier_case(case, seed)
    want = J.hier_search(jnp.asarray(src), jnp.asarray(wins), 32)
    got = P.hier_search(_t(src), _t(wins), 32)
    assert len(got) == len(want) == 7
    for gp, w in zip(got, want):
        _eq(gp.to(torch.int32), np.asarray(w).astype(np.int32))
    c_y, c_x, dyr, dxr, loc, ssem_h, src2_h = got
    assert loc.dtype == torch.uint8 and tuple(loc.shape[1:]) == (48, 48)
    assert ssem_h.dtype == torch.int32 and tuple(ssem_h.shape[1:]) == (37, 37)
    if case == "shifted":
        assert int(ssem_h[0].min()) == -int(src2_h[0]) < 0
        assert (int(c_y[0] + dyr[0]), int(c_x[0] + dxr[0])) == disp[0]
    if case == "corners":
        for i, (dy, dx) in enumerate(disp[:4]):
            assert (int(c_y[i] + dyr[i]), int(c_x[i] + dxr[i])) == (dy, dx)
        assert [int(v) for v in c_y[:4]] == [-36, -36, 36, 36]
        assert [int(v) for v in c_x[:4]] == [-36, 36, -36, 36]
    if case == "ties":
        for i in (0, 1):  # the first candidate of both levels
            assert [int(t[i]) for t in (c_y, c_x, dyr, dxr)] == [-36, -36,
                                                                -4, -4]
        assert int(c_y[2]) == -36 and int(dyr[2]) == -4  # every dy ties
        assert int(c_x[2] + dxr[2]) == 6
        assert int(ssem_h[3, 0, 0]) == 256 * 1020 ** 2
        assert int(ssem_h[4, 0, 0]) == -256 * 1020 ** 2


def test_hier_search_is_the_plain_composition_on_cpu_tensors():
    src, wins, _ = _hier_case("noise", 3)
    for gp, w in zip(P.hier_search(_t(src), _t(wins), 32),
                     K.hier_search_ref(_t(src), _t(wins), 32)):
        _eq(gp, w)
    # another block size, which only the plain version takes
    rng = np.random.default_rng(4)
    src16 = rng.integers(0, 256, (3, 16, 16), dtype=np.uint8)
    wins16 = rng.integers(0, 256, (3, 104, 104), dtype=np.uint8)
    want = J.hier_search(jnp.asarray(src16), jnp.asarray(wins16), 16)
    for gp, w in zip(K.hier_search_fused(_t(src16), _t(wins16), 16), want):
        _eq(gp.to(torch.int32), np.asarray(w).astype(np.int32))


def test_hier_search_fused_refuses_bad_inputs():
    src = torch.zeros((2, 32, 32), dtype=torch.uint8)
    wins = torch.zeros((2, 120, 120), dtype=torch.uint8)
    with pytest.raises(ValueError, match="wins shape"):
        K.hier_search_fused(src, wins[:, :118, :118], 32)
    with pytest.raises(ValueError, match="src_blocks shape"):
        K.hier_search_fused(src[:, :16], wins, 32)
    with pytest.raises(TypeError, match="uint8"):
        K.hier_search_fused(src.to(torch.int16), wins.to(torch.int16), 32)
    out = K.hier_search_fused(src[:0], wins[:0], 32)
    assert [tuple(t.shape) for t in out] == [(0,)] * 4 + [
        (0, 48, 48), (0, 37, 37), (0,)]


@pytest.mark.parametrize("n,r", [(16, 18), (32, 4), (16, 8), (8, 3),
                                 (32, 12)])
def test_sse_level_shapes_fit_the_kernel(n, r):
    """The shapes the step gives ``sse_map_search`` fit the shared memory
    its kernel asks for, and the wrapper's limit is that formula."""
    w, d = n + 2 * r, 2 * r + 1
    need = K.sse_level_smem(n, r)
    assert need == 4 * (n * n + w * (w + 1) + 16 + w * d + d * d)
    assert need <= K.SSE_SMEM_BYTES < 48 * 1024
    src = torch.zeros((1, n, n), dtype=torch.uint8)
    wins = torch.zeros((1, w + 8, w + 8), dtype=torch.uint8)
    dy, dx, rel = K.sse_map_search(src, wins, n, r)
    assert (int(dy), int(dx)) == (-r, -r) and int(rel.abs().max()) == 0
