"""The split16 descent's four plain versions (``pipeline/tpu_encdec.py``:
``descent_gather_ref``, ``descent_decide_ref``, ``descent_pack_ref``,
``descent_split_ref``, the contracts of the kernels of
``csrc/descent.cu``) against the JAX lines they replace in
``tpu_vp9/pipeline/tpu_encdec.py``, computed with jnp and the JAX
package's own helpers, op by op (eagerly), on the same numpy-seeded
inputs; then ``encode_children_masked`` and ``pframe_step`` on the new
dispatches against the JAX functions, jitted.

The lines: the union and ``cw`` (``encode_children_masked:1933-1941``),
``csrc`` and ``src2_c`` (``:1946-1952``), the children's ZERO SSE out of
one whole-frame difference (``:1960-1968``), the chroma blocks
(``:2040-2043``), the PARENT lookup (``:1973-1980``), the costs and the
argmin (``:1982-2009``), ``skip``, ``rate_c``, the sums and the merged
blocks (``:2052-2064``), and ``pframe_step``'s split decision and merge
(``:2134-2160``). Tolerance 0 everywhere, with two stated exceptions:

- without rate tables NEW's rate is ``rn0 + rnb * log2(1 + mvd)``: the
  port reads it out of the host's float32 table (``new_bits_table``),
  while XLA's float32 log2 on the CPU is not correctly rounded (about 250
  of the table's 1,305 entries differ in the last bit). The plain version
  is held bit for bit to the JAX lines with that table gathered in jnp,
  and to the JAX lines as written with the choices equal but at near-ties
  (the two best costs within 1e-5 relative);
- a parent of the overhang row (mi_rows % 4 == 3) never splits in the
  port (a repair of the JAX package, whose descent keeps those parents out
  by its ranking alone): the split is held to the JAX lines with that
  guard applied, and the JAX lines as written split such a parent here.

Geometries 128x96 and 128x88 (the overhang row); parents out of raster
order and at every frame edge; full-pel winners that clamp the union at 0
and at SW - 64; PARENT MVs beyond +-8 of the map centre; both cost forms;
all-tie costs (the first candidate wins); a lam that flips the split.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vp9.pipeline import tpu_encdec as J

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.pipeline import realtime as port_realtime
from tpu_vp9_torch.pipeline import tpu_encdec as P
from tpu_vp9_torch.utils.yuv import panning_frames

torch.set_num_threads(1)

GEOMS = {"128x96": (128, 96), "128x88": (128, 88)}
SW = 32 + 2 * P.WIN_R + 8  # the parents' windows
EDGE = 8 * P.WIN_R + 6  # the largest parent MV, q3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def _edge_sel(g, rng):
    """Every parent of the frame's edges (corners, first and last row and
    column), then some inner ones, in a shuffled order."""
    r32, c32 = g.rows32, g.cols32
    idx = np.arange(r32 * c32).reshape(r32, c32)
    edges = np.unique(np.concatenate([idx[0], idx[-1], idx[:, 0],
                                      idx[:, -1]]))
    inner = np.setdiff1d(idx, edges)
    sel = np.concatenate([edges, inner[:2]])
    rng.shuffle(sel)
    return sel.astype(np.int32)


def gather_case(w, h, seed):
    """descent_gather's arguments as numpy: random windows, planes and
    MVs; full-pel winners at -WIN_R and WIN_R (the union clamped at 0 and
    at SW - 64) and inside."""
    rng = np.random.default_rng(seed)
    g = P.make_geom(w, h)
    b32 = g.n_blocks32
    dy = rng.integers(-P.WIN_R, P.WIN_R + 1, b32).astype(np.int32)
    dx = rng.integers(-P.WIN_R, P.WIN_R + 1, b32).astype(np.int32)
    dy[::3], dx[1::3] = -P.WIN_R, P.WIN_R
    dx[::4], dy[2::4] = -P.WIN_R, P.WIN_R
    return g, dict(
        sel=_edge_sel(g, rng),
        wins=rng.integers(0, 256, (b32, SW, SW), np.uint8),
        dy=dy, dx=dx,
        parent_mv=rng.integers(-EDGE, EDGE + 1, (b32, 2)).astype(np.int32),
        src_y=rng.integers(0, 256, (g.pad_h, g.pad_w), np.uint8),
        src_u=rng.integers(0, 256, (g.pad_h // 2, g.pad_w // 2), np.uint8),
        src_v=rng.integers(0, 256, (g.pad_h // 2, g.pad_w // 2), np.uint8),
        ref_y=rng.integers(0, 256, (g.pad_h + 2 * P.BORDER,
                                    g.pad_w + 2 * P.BORDER), np.uint8))


def jax_gather(a, w, h):
    """The JAX lines of the gathers (``encode_children_masked:1919-1952,
    2040-2043``, the positions and offsets of ``:2016-2019``) and of the
    children's ZERO SSE (``:1960-1968``), on jnp arrays; the window index
    is the parent index each child's window was repeated from."""
    g = J.make_geom(w, h)
    sel_idx = jnp.asarray(a["sel"])
    k = sel_idx.shape[0]
    cols32, rows32 = g.cols32, g.rows32
    cols16 = cols32 * 2
    pr = sel_idx // cols32
    pc = sel_idx % cols32
    wins = jnp.asarray(a["wins"])
    wk = jnp.take(wins, sel_idx, axis=0)
    dyk = jnp.take(jnp.asarray(a["dy"]), sel_idx, axis=0)
    dxk = jnp.take(jnp.asarray(a["dx"]), sel_idx, axis=0)
    sw = wins.shape[-1]
    s_y = jnp.clip(dyk + 36, 0, sw - 64)
    s_x = jnp.clip(dxk + 36, 0, sw - 64)
    union = J._oh_take_cols(J._oh_take_rows(wk.astype(jnp.float32), s_y, 64),
                            s_x, 64)
    base_y = s_y - 32
    base_x = s_x - 32
    cw = jnp.stack([union[:, 16 * i:16 * i + 40, 16 * j:16 * j + 40]
                    for i in (0, 1) for j in (0, 1)], axis=1) \
        .reshape(k * 4, 40, 40)

    def rep4(v):
        return jnp.repeat(v, 4, axis=0)

    ii = jnp.asarray([0, 0, 1, 1], jnp.int32)
    jj = jnp.asarray([0, 1, 0, 1], jnp.int32)
    c_row = (2 * pr)[:, None] + ii[None]
    c_col = (2 * pc)[:, None] + jj[None]
    cidx = (c_row * cols16 + c_col).reshape(-1)
    src16 = J._extract_blocks(jnp.asarray(a["src_y"]), 0, rows32 * 2,
                              cols16, 16)
    csrc = jnp.take(src16, cidx, axis=0)
    pmv = jnp.asarray(a["parent_mv"])
    pos_y = (c_row * 16).reshape(-1)
    pos_x = (c_col * 16).reshape(-1)
    # exact ZERO SSE for every 16-block from one whole-frame diff
    core = jax.lax.slice(
        jnp.asarray(a["ref_y"]), (J.BORDER, J.BORDER),
        (J.BORDER + rows32 * 32, J.BORDER + cols32 * 32))
    df = jnp.asarray(a["src_y"])[: rows32 * 32, : cols32 * 32] \
        .astype(jnp.float32) - core.astype(jnp.float32)
    d2 = (df * df).reshape(rows32 * 2, 16, cols16, 16) \
        .sum(axis=3).astype(jnp.int32).sum(axis=1).reshape(-1)
    out = {"cw": cw, "csrc": csrc, "src2": J._block_sq_sum(csrc),
           "sse_zero": jnp.take(d2, cidx, axis=0),
           "base_y": rep4(base_y), "base_x": rep4(base_x),
           "pos_y": pos_y, "pos_x": pos_x,
           "off_y": jnp.tile(ii * 16, k), "off_x": jnp.tile(jj * 16, k),
           "win_idx": rep4(sel_idx),
           "par_r": rep4(jnp.take(pmv[:, 0], sel_idx, axis=0)),
           "par_c": rep4(jnp.take(pmv[:, 1], sel_idx, axis=0))}
    for key, plane in (("csrc_u", a["src_u"]), ("csrc_v", a["src_v"])):
        src8 = J._extract_blocks(jnp.asarray(plane), 0, rows32 * 2, cols16, 8)
        out[key] = jnp.take(src8, cidx, axis=0)
    return out


def port_gather(g, a, fn=None):
    fn = fn or P.descent_gather_ref
    return fn(*(_t(a[k]) for k in ("sel", "wins", "dy", "dx", "parent_mv",
                                   "src_y", "src_u", "src_v", "ref_y")), g)


@pytest.mark.parametrize("geom", GEOMS)
def test_gather_ref_matches_jax(geom):
    w, h = GEOMS[geom]
    g, a = gather_case(w, h, seed=1)
    got = port_gather(g, a)
    want = jax_gather(a, w, h)
    assert set(got) == set(want)
    for key, v in want.items():
        assert got[key].shape == v.shape, key
        _eq(got[key], v, key)
    for key in ("cw", "csrc", "csrc_u", "csrc_v"):
        assert got[key].dtype == torch.uint8
    for key in set(got) - {"cw", "csrc", "csrc_u", "csrc_v"}:
        assert got[key].dtype == torch.int32, key
    # the union clamps at both ends and the edges are all there
    base = got["base_y"].numpy()
    assert base.min() == -32 and base.max() == SW - 64 - 32
    rows = got["pos_y"].numpy() // 16
    assert rows.min() == 0 and rows.max() == 2 * g.rows32 - 1


@pytest.mark.parametrize("geom", GEOMS)
def test_gather_ref_zero_sse_matches_block_energy_at(geom):
    """The children's ZERO SSE that the gather now takes is what the step
    took before with one ``block_energy_at`` call at the bordered starts
    (position + BORDER); on a reference equal to the source around a
    child it is 0, at 255 against 0 everywhere 256 * 255^2."""
    g, a = gather_case(*GEOMS[geom], seed=2)
    got = port_gather(g, a)
    starts = (got["pos_y"] + P.BORDER, got["pos_x"] + P.BORDER)
    sse, _ = K.block_energy_at_ref(
        got["csrc"], _t(a["ref_y"]), starts[0][None], starts[1][None], 16)
    _eq(got["sse_zero"], sse[0])
    y, x = int(got["pos_y"][0]), int(got["pos_x"][0])
    a["src_y"][:] = 255
    a["ref_y"][:P.BORDER + g.rows32 * 32] = 0
    a["ref_y"][P.BORDER + y:P.BORDER + y + 16,
               P.BORDER + x:P.BORDER + x + 16] = 255
    got = port_gather(g, a)["sse_zero"].numpy()
    assert got[0] == 0 and np.all(got[1:] == 256 * 255 ** 2)


def decide_case(n, seed, kind="random"):
    """descent_decide's arguments as numpy (without the rate tables): the
    quarter-pel winner inside the child's window, PARENT MVs anywhere in
    the parents' reach (most of them beyond +-8 of the map centre)."""
    rng = np.random.default_rng(seed)
    d = 2 * P.CHILD_R + 1
    src2 = rng.integers(0, 4_000_000, n).astype(np.int32)
    ssem = (rng.integers(0, 4_000_000, (n, d, d))
            - src2[:, None, None]).astype(np.int32)
    a = dict(ssem=ssem,
             sse_zero=rng.integers(0, 4_000_000, n).astype(np.int32),
             sse_new=rng.integers(0, 4_000_000, n).astype(np.int32),
             sub_r=rng.integers(-70, 71, n).astype(np.int32),
             sub_c=rng.integers(-70, 71, n).astype(np.int32), src2=src2,
             base_y=rng.integers(-32, 25, n).astype(np.int32),
             base_x=rng.integers(-32, 25, n).astype(np.int32),
             par_r=rng.integers(-EDGE, EDGE + 1, n).astype(np.int32),
             par_c=rng.integers(-EDGE, EDGE + 1, n).astype(np.int32))
    a["sse_new"][::5] = a["sse_zero"][::5]  # ties between ZERO and NEW
    if kind == "parent_new":
        # NEW's MV is PARENT's: mvd 0
        a["par_r"] = a["base_y"] * 8 + a["sub_r"]
        a["par_c"] = a["base_x"] * 8 + a["sub_c"]
    return a


DECIDE_KEYS = ("ssem", "sse_zero", "sse_new", "sub_r", "sub_c", "src2",
               "base_y", "base_x", "par_r", "par_c")


def jax_decide(a, lam, rates=None, nb=None):
    """The JAX lines of the PARENT lookup, the costs and the argmin
    (``encode_children_masked:1973-2009``), on per-child inputs; ``nb``
    (without rates) replaces XLA's log2 with the table's entries."""
    j = {k: jnp.asarray(a[k]) for k in DECIDE_KEYS}
    mv_new_r = j["base_y"] * 8 + j["sub_r"]
    mv_new_c = j["base_x"] * 8 + j["sub_c"]
    par_r, par_c = j["par_r"], j["par_c"]
    n = par_r.shape[0]
    rch = J.CHILD_R
    dch = 2 * rch + 1
    fy = jnp.clip(((par_r + 4) >> 3) - j["base_y"], -rch, rch) + rch
    fx = jnp.clip(((par_c + 4) >> 3) - j["base_x"], -rch, rch) + rch
    sse_par = jnp.take_along_axis(
        j["ssem"].reshape(n, dch * dch), (fy * dch + fx)[:, None],
        axis=1)[:, 0] + j["src2"]
    zero = jnp.zeros_like(mv_new_r)
    cand_r = jnp.stack([zero, mv_new_r, par_r])
    cand_c = jnp.stack([zero, mv_new_c, par_c])
    sads = jnp.stack([j["sse_zero"], j["sse_new"], sse_par])
    if rates is not None:
        mc_ = rates["mode_cost"]
        m = int(rates["mv_cost_max"])
        dr = mv_new_r - par_r
        dc = mv_new_c - par_c
        jt = 2 * (dr != 0).astype(jnp.int32) + (dc != 0).astype(jnp.int32)
        mvd_bits = (jnp.asarray(rates["joint_cost"])[jt]
                    + jnp.asarray(rates["nmv_row"])[jnp.clip(dr, -m, m) + m]
                    + jnp.asarray(rates["nmv_col"])[jnp.clip(dc, -m, m) + m])
        ones = jnp.ones_like(mvd_bits)
        rate = jnp.stack([mc_[2] * ones, mc_[3] + mvd_bits, mc_[0] * ones])
        costs = (sads.astype(jnp.float32)
                 + rates["lam_bits"] * rate.astype(jnp.float32) / 256.0)
    else:
        rz, rn0, rnb, _, rs = J.CAND_RATE_PROXY
        mvd = (jnp.abs(mv_new_r - par_r)
               + jnp.abs(mv_new_c - par_c)).astype(jnp.float32)
        new_bits = (rn0 + rnb * jnp.log2(1.0 + mvd) if nb is None else
                    jnp.take(jnp.asarray(nb), mvd.astype(jnp.int32)))
        rate = jnp.stack([rz * jnp.ones_like(mvd), new_bits,
                          rs * jnp.ones_like(mvd)])
        costs = sads.astype(jnp.float32) + jnp.asarray(
            lam, jnp.int32).astype(jnp.float32) * rate
    best = jnp.argmin(costs, axis=0)
    bidx = (best, jnp.arange(n))
    return cand_r[bidx], cand_c[bidx], costs


def rate_tabs(seed):
    """The frame's rate tables from an adapted frame context."""
    rng = np.random.default_rng(seed)
    fc = T.default_frame_context()
    fc.inter_mode_probs = rng.integers(
        1, 256, fc.inter_mode_probs.shape).astype(fc.inter_mode_probs.dtype)
    fc.nmv.joints = rng.integers(1, 256, np.shape(fc.nmv.joints)).astype(
        np.asarray(fc.nmv.joints).dtype)
    return P.make_rate_tabs(fc, 120)


def port_decide(a, lam, rates=None, fn=None):
    fn = fn or P.descent_decide_ref
    return fn(*(_t(a[k]) for k in DECIDE_KEYS), lam, P.new_bits_table("cpu"),
              None if rates is None else P.upload_rate_tabs(rates, "cpu"))


@pytest.mark.parametrize("kind", ["random", "parent_new"])
def test_decide_ref_with_rates_matches_jax(kind):
    n = 512
    a = decide_case(n, seed=3, kind=kind)
    tabs = rate_tabs(4)
    mv_r, mv_c, mv = port_decide(a, 300, tabs)
    jr, jc, _ = jax_decide(a, 300, tabs)
    _eq(mv_r, jr)
    _eq(mv_c, jc)
    assert mv.dtype == torch.int16 and mv.shape == (n, 2)
    _eq(mv, np.stack([np.asarray(jr), np.asarray(jc)], -1).astype(np.int16))
    if kind != "random":
        return
    # every candidate wins somewhere, PARENT from beyond the map's reach
    best = {(int(r), int(c)) == (0, 0) for r, c in zip(mv_r, mv_c)}
    assert best == {True, False}
    far = np.abs(((a["par_r"] + 4) >> 3) - a["base_y"]) > P.CHILD_R
    assert far.mean() > 0.5
    picked_par = (mv_r.numpy() == a["par_r"]) & (mv_c.numpy() == a["par_c"])
    assert (picked_par & far).any()


def test_decide_ref_without_rates_matches_jax():
    """Bit for bit against the JAX lines with the table's entries; against
    XLA's own log2 the choices differ only at near-ties."""
    n = 512
    a = decide_case(n, seed=5)
    lam = 40_000  # the rate term decides about half the children
    mv_r, mv_c, _ = port_decide(a, lam)
    jr, jc, _ = jax_decide(a, lam, nb=P.new_bits_table("cpu").numpy())
    _eq(mv_r, jr)
    _eq(mv_c, jc)
    xr, xc, xcost = jax_decide(a, lam)
    diff = (mv_r.numpy() != np.asarray(xr)) | (mv_c.numpy() != np.asarray(xc))
    assert diff.sum() <= 0.01 * n
    top2 = np.sort(np.asarray(xcost), axis=0)[:2]
    assert np.all(np.abs(top2[1] - top2[0])[diff] <= 1e-5 * top2[0][diff])


@pytest.mark.parametrize("with_rates", [True, False],
                         ids=["rates", "proxies"])
def test_decide_ref_all_ties_take_the_first(with_rates):
    """Costs equal for all three candidates: ZERO wins; ZERO out of the
    running and NEW tied with PARENT: NEW wins (the JAX lines agree)."""
    n = 64
    a = decide_case(n, seed=7, kind="parent_new")
    tabs = rate_tabs(8) if with_rates else None
    if with_rates:
        tabs["lam_bits"] = np.float32(256.0)  # cost = sse + rate
        mc = tabs["mode_cost"]
        rates = P.upload_rate_tabs(tabs, "cpu")
        m = rates["mv_cost_max"]
        bits = int(rates["joint_cost"][0] + rates["nmv_row"][m]
                   + rates["nmv_col"][m])
        rate = (int(mc[2]), int(mc[3]) + bits, int(mc[0]))
        lam = 1
    else:
        lam = 1
        rate = (2, 10, 4)  # ZERO's, NEW's at mvd 0, PARENT's proxies
    top = 3_000_000
    a["sse_zero"][:] = top - rate[0]
    a["sse_new"][:] = top - rate[1]
    # PARENT's map entry: it sits at (par >> 3) - base, here the centre
    par_sse = top - rate[2]
    fy = np.clip(((a["par_r"] + 4) >> 3) - a["base_y"], -8, 8) + 8
    fx = np.clip(((a["par_c"] + 4) >> 3) - a["base_x"], -8, 8) + 8
    a["ssem"][np.arange(n), fy, fx] = par_sse - a["src2"]
    mv_r, mv_c, _ = port_decide(a, lam, tabs)
    jr, jc, jcost = jax_decide(a, lam, tabs, nb=P.new_bits_table("cpu")
                               .numpy())
    assert np.all(np.asarray(jcost) == np.asarray(jcost)[0])
    assert not mv_r.any() and not mv_c.any()
    _eq(mv_r, jr)
    a["sse_zero"][:] += 1
    mv_r, mv_c, _ = port_decide(a, lam, tabs)
    jr, jc, _ = jax_decide(a, lam, tabs, nb=P.new_bits_table("cpu").numpy())
    _eq(mv_r, a["base_y"] * 8 + a["sub_r"])
    _eq(mv_r, jr)
    _eq(mv_c, jc)


def test_decide_ref_raises_past_mvd_max():
    """Without rate tables an mvd past MVD_MAX has no NEW rate: the plain
    version's indexing raises (the kernel traps there)."""
    a = decide_case(8, seed=9)
    a["par_r"][3] = a["base_y"][3] * 8 + a["sub_r"][3] - P.MVD_MAX - 1
    a["par_c"][3] = a["base_x"][3] * 8 + a["sub_c"][3]
    with pytest.raises(IndexError):
        port_decide(a, 100)
    a["par_r"][3] += 1  # mvd MVD_MAX: the table's last entry
    port_decide(a, 100)


def pack_case(k, seed, case="random"):
    """descent_pack's arguments as numpy; ``case`` "extremes": the first
    parents' children every level zero, then every level nonzero, recon
    all 255 against a source of 0 and 0 against 255 (the SSE at its
    most), then equal."""
    rng = np.random.default_rng(seed)
    n = 4 * k

    def levels(m):
        lv = rng.integers(-40, 41, (n, m, m))
        lv[rng.random((n, m, m)) < 0.8] = 0
        lv[::3] = 0
        if case == "extremes":
            lv[:4] = 0
            lv[4:8] = rng.choice([-1, 1, 7, -300], (4, m, m))
        return lv.astype(np.int16)

    eob = [rng.integers(0, 3, n).astype(np.int32) for _ in range(3)]
    for e in eob:
        e[::2] = 0
    rec = rng.integers(0, 256, (n, 16, 16), np.uint8)
    src = rng.integers(0, 256, (n, 16, 16), np.uint8)
    if case == "extremes":
        rec[:4], src[:4] = 255, 0
        rec[4:8], src[4:8] = 0, 255
        src[8:12] = rec[8:12]
    return dict(eob_y=eob[0], eob_u=eob[1], eob_v=eob[2],
                lv_y=levels(16), lv_u=levels(8), lv_v=levels(8),
                rec_y=rec, rec_u=rng.integers(0, 256, (n, 8, 8), np.uint8),
                rec_v=rng.integers(0, 256, (n, 8, 8), np.uint8), csrc=src)


PACK_KEYS = ("eob_y", "eob_u", "eob_v", "lv_y", "lv_u", "lv_v", "rec_y",
             "rec_u", "rec_v", "csrc")


def jax_pack(a):
    """The JAX lines of ``skip``, ``dist_c``, ``rate_c``, the sums and the
    merged blocks (``encode_children_masked:2044-2064``)."""
    j = {key: jnp.asarray(a[key]) for key in PACK_KEYS}
    k = j["eob_y"].shape[0] // 4
    skip = (j["eob_y"] == 0) & (j["eob_u"] == 0) & (j["eob_v"] == 0)
    dist_c = ((j["rec_y"].astype(jnp.int32)
               - j["csrc"].astype(jnp.int32)) ** 2).sum(axis=(1, 2))
    rate_c = ((j["lv_y"] != 0).sum(axis=(1, 2))
              + (j["lv_u"] != 0).sum(axis=(1, 2))
              + (j["lv_v"] != 0).sum(axis=(1, 2)))
    return {
        "skip": skip,
        "dist4": dist_c.reshape(k, 4).sum(axis=1),
        "rate4": rate_c.reshape(k, 4).sum(axis=1),
        "rec_y32": j["rec_y"].reshape(k, 2, 2, 16, 16)
        .transpose(0, 1, 3, 2, 4).reshape(k, 32, 32),
        "rec_u16": j["rec_u"].reshape(k, 2, 2, 8, 8)
        .transpose(0, 1, 3, 2, 4).reshape(k, 16, 16),
        "rec_v16": j["rec_v"].reshape(k, 2, 2, 8, 8)
        .transpose(0, 1, 3, 2, 4).reshape(k, 16, 16),
    }


def port_pack(a, fn=None):
    return (fn or P.descent_pack_ref)(*(_t(a[key]) for key in PACK_KEYS))


@pytest.mark.parametrize("case", ["random", "extremes"])
def test_pack_ref_matches_jax(case):
    """The pack's plain version, its children's recon SSE included, against
    the JAX lines; the extremes reach the SSE's most, 256 * 255^2 a
    child."""
    a = pack_case(9, seed=11, case=case)
    got, want = port_pack(a), jax_pack(a)
    assert set(got) == set(want)
    for key, v in want.items():
        _eq(got[key], v, key)
    assert got["skip"].dtype == torch.bool
    assert got["dist4"].dtype == got["rate4"].dtype == torch.int64
    assert got["skip"].any() and not got["skip"].all()
    if case == "extremes":
        assert got["dist4"][:3].tolist() == [4 * 256 * 255 ** 2] * 2 + [0]


def split_case(w, h, seed, overhang_wins=False):
    """descent_split's arguments as numpy: the children beat their parent
    on distortion by a little in about half the parents and pay for it in
    rate, so a small lam splits some and a large one none;
    ``overhang_wins`` puts the overhang row's parents in sel with children
    far better than their parent."""
    rng = np.random.default_rng(seed)
    g = P.make_geom(w, h)
    b32 = g.n_blocks32
    sel = rng.permutation(b32)[:max(1, (2 * b32) // 3)]
    if overhang_wins:
        last = np.arange(b32 - g.cols32, b32)
        sel = np.concatenate([last, np.setdiff1d(sel, last)[:4]])
        rng.shuffle(sel)
    sel = sel.astype(np.int32)
    k = sel.size
    dist_b = rng.integers(10_000, 200_000, b32).astype(np.int32)
    rate_b = rng.integers(0, 40, b32).astype(np.int64)
    gain = rng.integers(-5_000, 20_000, k)
    dist4 = (dist_b[sel] - gain).astype(np.int64)
    rate4 = (rate_b[sel] + rng.integers(0, 30, k)).astype(np.int64)
    if overhang_wins:
        over = sel >= b32 - g.cols32
        dist4[over] = dist_b[sel[over]] // 10
        rate4[over] = 0
    return g, dict(
        sel=sel, dist_b=dist_b, rate_b=rate_b, dist4=dist4, rate4=rate4,
        rec_y=rng.integers(0, 256, (g.rows32 * 32, g.cols32 * 32), np.uint8),
        rec_u=rng.integers(0, 256, (g.rows32 * 16, g.cols32 * 16), np.uint8),
        rec_v=rng.integers(0, 256, (g.rows32 * 16, g.cols32 * 16), np.uint8),
        rec_y32=rng.integers(0, 256, (k, 32, 32), np.uint8),
        rec_u16=rng.integers(0, 256, (k, 16, 16), np.uint8),
        rec_v16=rng.integers(0, 256, (k, 16, 16), np.uint8))


SPLIT_KEYS = ("sel", "dist_b", "rate_b", "dist4", "rate4", "rec_y", "rec_u",
              "rec_v", "rec_y32", "rec_u16", "rec_v16")


def jax_split(a, g, lam, guard):
    """The JAX lines of the split decision and the merge (``pframe_step:
    2134-2160``); ``guard`` adds the port's overhang-row guard to
    ``use16``."""
    j = {key: jnp.asarray(a[key]) for key in SPLIT_KEYS}
    sel_idx = j["sel"]
    r32, c32, b32 = g.rows32, g.cols32, g.n_blocks32
    d16 = j["dist4"].astype(jnp.float32)
    rt16 = j["rate4"].astype(jnp.float32)
    lam_f = jnp.asarray(lam, jnp.int32).astype(jnp.float32)
    cost32k = (jnp.take(j["dist_b"], sel_idx).astype(jnp.float32)
               + lam_f * jnp.take(j["rate_b"], sel_idx).astype(jnp.float32))
    cost16k = d16 + lam_f * (rt16 + J.SPLIT_RATE_EXTRA)
    use16 = cost16k < cost32k
    if guard and g.mi_rows % 4 == 3:
        use16 = use16 & (sel_idx < (r32 - 1) * c32)
    split32 = jnp.zeros((b32,), jnp.int32) \
        .at[sel_idx].set(use16.astype(jnp.int32)).reshape(r32, c32)

    def merge(plane, rep, nb):
        blocks = plane.reshape(r32, nb, c32, nb) \
            .transpose(0, 2, 1, 3).reshape(b32, nb, nb)
        cur = jnp.take(blocks, sel_idx, axis=0)
        new = jnp.where(use16[:, None, None], rep, cur)
        blocks = blocks.at[sel_idx].set(new)
        return blocks.reshape(r32, c32, nb, nb) \
            .transpose(0, 2, 1, 3).reshape(r32 * nb, c32 * nb)

    return (split32, merge(j["rec_y"], j["rec_y32"], 32),
            merge(j["rec_u"], j["rec_u16"], 16),
            merge(j["rec_v"], j["rec_v16"], 16))


def port_split(a, g, lam, fn=None):
    return (fn or P.descent_split_ref)(*(_t(a[key]) for key in SPLIT_KEYS),
                                       lam, g)


@pytest.mark.parametrize("geom", GEOMS)
def test_split_ref_matches_jax_and_lam_flips_it(geom):
    g, a = split_case(*GEOMS[geom], seed=13)
    splits = []
    for lam in (1, 500, 100_000):
        got = port_split(a, g, lam)
        want = jax_split(a, g, lam, guard=True)
        for part, (x, y) in enumerate(zip(got, want)):
            _eq(x, y, f"lam {lam} output {part}")
        splits.append(got[0].numpy())
    assert splits[0].sum() > splits[1].sum() > 0
    assert splits[2].sum() == 0


def test_split_ref_keeps_the_overhang_row():
    """At 128x88 the overhang row's parents are selected with children far
    better than them: the JAX lines as written split them, the port (and
    the JAX lines with the guard) does not, and nothing else differs."""
    g, a = split_case(*GEOMS["128x88"], seed=17, overhang_wins=True)
    assert g.mi_rows % 4 == 3
    got = port_split(a, g, 5)
    for x, y in zip(got, jax_split(a, g, 5, guard=True)):
        _eq(x, y)
    raw = np.asarray(jax_split(a, g, 5, guard=False)[0])
    split = got[0].numpy()
    assert raw[-1].all() and not split[-1].any()
    np.testing.assert_array_equal(raw[:-1], split[:-1])


# ---------------------------------------------------------------------------
# the whole paths
# ---------------------------------------------------------------------------


def _step_inputs(w, h, seed):
    """Source planes and LAST's border-extended planes of a P-frame of a
    panning clip, previous MVs and rate tables, as numpy."""
    rng = np.random.default_rng(seed)
    g = P.make_geom(w, h)
    frames = list(panning_frames(w, h, 3, seed=seed))
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))
    cur = [np.asarray(p) for p in (frames[2].y, frames[2].u, frames[2].v)]
    before = [np.asarray(p) for p in (frames[1].y, frames[1].u, frames[1].v)]
    # a quadrant of two parents moves its own way: splitting pays
    for y0, x0 in ((16, 32), (48, 80)):
        cur[0][y0:y0 + 16, x0:x0 + 16] = before[0][y0 + 5:y0 + 21,
                                                   x0 - 6:x0 + 10]
    src = [P.pad_plane(p, *shp) for p, shp in zip(cur, shapes)]
    last = [t.numpy() for t in port_realtime.upload_refs(before, g, "cpu")]
    prev = rng.integers(-64, 65, (g.n_blocks32, 2)).astype(np.int32)
    return g, src, last, prev, rate_tabs(seed)


@pytest.mark.parametrize("geom,with_rates", [("128x88", True),
                                             ("128x96", False)],
                         ids=["128x88-rates", "128x96-proxies"])
def test_encode_children_masked_matches_jax(geom, with_rates):
    """Every output of ``encode_children_masked`` (the four dispatches,
    the searches, MC and transforms between them) against the JAX
    function's, on every parent of the frame's edges out of raster order
    (the overhang row's included at 128x88)."""
    w, h = GEOMS[geom]
    g, src, last, prev, tabs = _step_inputs(w, h, 19)
    qidx = 120
    dc_q, ac_q = T.dc_quant(qidx), T.ac_quant(qidx)
    lam = max(1, (ac_q ** 2) >> 6)
    filt = torch.as_tensor(np.asarray(P.FILTERS, np.int32))
    nb = P.new_bits_table("cpu")
    rates = P.upload_rate_tabs(tabs, "cpu") if with_rates else None
    tsrc = [_t(a) for a in src]
    tlast = [_t(a) for a in last]
    sc = P.step_scalars(dc_q, ac_q, lam, 0, 0, 0)
    z = P.encode_zone(*tsrc, *tlast, _t(prev), g, sc, filt, nb, rates=rates,
                      return_me=True)
    me = {k: z[k] for k in ("wins", "dy", "dx", "planes", "grid")}
    # the JAX children read LAST's chroma MC windows, which the port's
    # MC reads in place in LAST's planes at the zone's grid
    jme = {k: z[k] for k in ("wins", "dy", "dx")}
    jme["wu"], jme["wv"] = (P._extract_search_windows(
        pl, 16, g.rows32, g.cols32, 0, P.CHROMA_WIN_R) for pl in tlast[1:])
    assert me["grid"] == (32, 0, g.rows32, g.cols32)
    assert all(a is b for a, b in zip(me["planes"], tlast))
    sel = _edge_sel(g, np.random.default_rng(23))
    got = P.encode_children_masked(
        *tsrc, tlast[0], me, z["mv"].to(torch.int32), _t(sel), g, sc, filt,
        nb, rates=rates)
    jrates = None if tabs is None or not with_rates else {
        k: (jnp.asarray(v) if k != "mv_cost_max" else v)
        for k, v in tabs.items()}
    fn = jax.jit(lambda sy, su, sv, ry, pme, pmv, si: J.encode_children_masked(
        sy, su, sv, ry, pme, pmv, si, J.make_geom(w, h),
        jnp.asarray(dc_q, jnp.int32), jnp.asarray(ac_q, jnp.int32),
        jnp.asarray(lam, jnp.int32), P.FILTERS, rates=jrates))
    want = fn(*(jnp.asarray(a) for a in src), jnp.asarray(last[0]),
              {k: jnp.asarray(v.numpy()) for k, v in jme.items()},
              jnp.asarray(z["mv"].numpy().astype(np.int32)),
              jnp.asarray(sel))
    assert set(got) <= set(want)
    assert set(got) == {"mv", "skip", "eob_y", "eob_u", "eob_v", "lv_y",
                        "lv_u", "lv_v", "sel_idx", "dist4", "rate4",
                        "rec_y32", "rec_u16", "rec_v16"}
    for k in got:
        _eq(got[k], want[k], k)
    assert got["mv"].dtype == torch.int16
    assert got["dist4"].dtype == got["rate4"].dtype == torch.int64
    # the children took more than one candidate
    assert len({tuple(m) for m in got["mv"].numpy().tolist()}) > 1


def test_pframe_step_matches_jax_at_the_overhang_geometry():
    """One step with the descent at 128x88 (LAST and the rate tables, half
    the parents descended): every output of the children, the split mask,
    the filtered recon and the new references equal the JAX step's."""
    w, h = GEOMS["128x88"]
    g, src, last, prev, tabs = _step_inputs(w, h, 29)
    qidx = 120
    lvl = 20
    scalars = (T.dc_quant(qidx), T.ac_quant(qidx),
               max(1, (T.ac_quant(qidx) ** 2) >> 6), lvl, 3, 40)
    jstep = J.make_pframe_step(J.make_geom(w, h), split16=True,
                               with_rates=True, descend_frac=2)
    jouts, jrefs = jstep(
        *(jnp.asarray(a) for a in src + last), jnp.asarray(prev),
        jnp.zeros((1, 2), jnp.int32),
        *(jnp.asarray(v, jnp.int32) for v in scalars),
        *(jnp.asarray(tabs[k]) for k in ("mode_cost", "joint_cost",
                                         "nmv_row", "nmv_col", "ref_cost",
                                         "lam_bits")))
    pstep = P.make_pframe_step(g, "cpu", split16=True, with_rates=True,
                               descend_frac=2)
    pouts, prefs = pstep(*(_t(a) for a in src + last), _t(prev),
                         torch.zeros((1, 2), dtype=torch.int32),
                         P.step_scalars(*scalars),
                         P.upload_rate_tabs(tabs, "cpu"))
    for k in ("sel_idx", "mv", "skip", "eob_y", "eob_u", "eob_v", "lv_y",
              "lv_u", "lv_v"):
        _eq(pouts["m16f"][k], jouts["m16f"][k], f"m16f {k}")
    _eq(pouts["split32"], jouts["split32"], "split32")
    for k in ("rec_y", "rec_u", "rec_v"):
        _eq(pouts[k], jouts[k], k)
    for a, b in zip(prefs, jrefs):
        _eq(a, b, "new reference")
    split = pouts["split32"].numpy()
    assert split.sum() > 0 and not split[-1].any()
