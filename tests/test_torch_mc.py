"""The P-frame step's motion compensation: the port's plain versions
``mc_predict_planes_ref`` (what CPU tensors run, and what ``chip_smoke.py``
holds the CUDA kernel ``csrc/mc_predict.cu``, which reads the reference
planes in place, against on the card) and its building block on windows,
``mc_predict_ref``, against the JAX package, bit for bit, and the step's
calls of its dispatch.

- ``mc_predict_planes_ref`` on the bordered planes and the zone's window
  grid against ``mc_predict_from_wins`` on the windows JAX's
  ``_extract_search_windows`` cuts from the same planes, taken by window
  index and merged by ``jnp.where`` over the block's reference: the 32
  zone, the strip zone (its ``y_base``), the children (window index and
  offsets), a column shard's plane (a view of the frame's columns, global
  positions), every phase pair, the frame's edges and past the windows'
  reach.
- ``mc_predict_ref`` against ``mc_predict_from_wins``, fed the windows as
  the JAX step builds them: merged by ``jnp.where`` over the block's
  reference (the zones), or its parents' windows taken and repeated four
  times (the children).
- Against ``mc_predict_batch`` on the bordered planes the windows were cut
  from (the yardstick that MC from windows equals), where every clamped MV
  stays inside the windows' reach.
- ``zone_code`` and ``encode_children_masked`` against the windowed
  formulation of their MC: the windows cut from the planes the call
  hands over, merged per plane, and the children's parent windows
  repeated, each predicted by ``mc_predict_from_wins``; the zone cuts no
  MC windows.

The cases, made from numpy seeds: the 32 zone with LAST, GOLDEN and ALTREF
per block, the strip zone (n = 16), the children (LAST parents: the JAX
children read their parents' merged chroma, the port LAST's, on purpose),
every chroma q4 phase pair and the luma even ones with MVs of either sign,
+-(WIN_R + 0.75) pel at every edge of a geometry whose 32 grid overhangs
the picture (mi_rows % 4 == 3, as at 1080p), and MVs past the windows'
reach (the window clamp; against ``mc_predict_from_wins`` only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vp9.pipeline import tpu_encdec as J

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.pipeline import realtime as port_realtime
from tpu_vp9_torch.pipeline import tpu_encdec as P
from tpu_vp9_torch.utils.yuv import synthetic_frames

torch.set_num_threads(1)

FILTERS = np.asarray(P.FILTERS, np.int32)
FILTERS_T = torch.as_tensor(FILTERS)
EDGE = P.WIN_R * 8 + 6  # +-(WIN_R + 0.75) pel in q3
KINDS = ("zone", "strip", "children", "phases", "edges", "clamp")
PLANE_KINDS = KINDS + ("shard",)
QINDEX = 120


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _windows(plane, pos_y, pos_x, sw, r):
    """(B, sw, sw) windows of a bordered plane whose origin is each
    position minus (r + 4), as ``_extract_search_windows`` cuts them."""
    return np.stack([plane[P.BORDER + y - r - 4:P.BORDER + y - r - 4 + sw,
                           P.BORDER + x - r - 4:P.BORDER + x - r - 4 + sw]
                     for y, x in zip(pos_y, pos_x)])


def _case(kind, seed):
    """(keyword arguments of ``mc_predict_ref`` on CPU tensors, the
    bordered (y, u, v) planes of each reference the windows were cut
    from, the children's parent indices or None)."""
    rng = np.random.default_rng(seed)
    w, h = {"strip": (128, 112), "edges": (128, 88), "clamp": (512, 288),
            "phases": (512, 192)}.get(kind, (128, 96))
    g = P.make_geom(w, h)
    n = 16 if kind == "strip" else 32
    if kind == "strip":
        pos_y = np.full(g.cols16, g.strip_y)
        pos_x = np.arange(g.cols16) * 16
    elif kind == "phases":
        # 256 blocks inside a wider frame, where no MV of the case clamps
        pos_y = np.tile([64, 96], 128)
        pos_x = np.repeat(64 + np.arange(8) * 32, 32)
    else:
        pos_y = np.repeat(np.arange(g.rows32) * 32, g.cols32)
        pos_x = np.tile(np.arange(g.cols32) * 32, g.rows32)
    b = pos_y.size
    n_refs = 1 if kind in ("children", "edges") else 3
    planes = [tuple(rng.integers(0, 256, (hh + 2 * P.BORDER,
                                          ww + 2 * P.BORDER), np.uint8)
                    for hh, ww in ((g.pad_h, g.pad_w),
                                   (g.pad_h // 2, g.pad_w // 2),
                                   (g.pad_h // 2, g.pad_w // 2)))
              for _ in range(n_refs)]
    geo = ((0, n + 2 * P.WIN_R + 8, P.WIN_R),
           (1, n // 2 + 2 * P.CHROMA_WIN_R + 8, P.CHROMA_WIN_R),
           (1, n // 2 + 2 * P.CHROMA_WIN_R + 8, P.CHROMA_WIN_R))
    wins = [tuple(_t(_windows(pl, pos_y >> s, pos_x >> s, sw, r))
                  for pl, (s, sw, r) in zip(ref, geo)) for ref in planes]
    extra, sel = {}, None
    if kind == "children":
        # K = 3 parents descend, four children each, in their windows
        sel = np.sort(rng.choice(b, 3, replace=False)).astype(np.int32)
        ii, jj = np.array([0, 0, 1, 1]), np.array([0, 1, 0, 1])
        pos_y = (pos_y[sel][:, None] + 16 * ii).reshape(-1)
        pos_x = (pos_x[sel][:, None] + 16 * jj).reshape(-1)
        b, n = pos_y.size, 16
        mv = rng.integers(-EDGE + 16 * 8, EDGE - 16 * 8 + 1, (2, b))
        extra = {"win_idx": _t(np.repeat(sel, 4)),
                 "org_off_y": _t(np.tile(16 * ii, 3).astype(np.int32)),
                 "org_off_x": _t(np.tile(16 * jj, 3).astype(np.int32))}
    elif kind == "phases":
        pr, pc = np.repeat(np.arange(16), 16), np.tile(np.arange(16), 16)
        sign = rng.choice([-1, 1], (2, b))
        mv = np.stack([pr, pc]) + 16 * rng.integers(0, 13, (2, b)) * sign
    elif kind == "edges":
        combos = np.array([(r, c) for r in (-EDGE, 0, EDGE)
                           for c in (-EDGE, 0, EDGE)])
        mv = combos[np.arange(b) % 9].T
    elif kind == "clamp":
        mv = rng.choice([-1, 1], (2, b)) * rng.integers(
            EDGE + 8, EDGE + 400, (2, b))
    else:
        mv = rng.integers(-EDGE, EDGE + 1, (2, b))
    if n_refs == 3:
        extra["ref_sel"] = _t(rng.integers(0, 3, b).astype(np.int8))
    case = dict(wins=wins, pos_y=_t(pos_y.astype(np.int32)),
                pos_x=_t(pos_x.astype(np.int32)),
                mv_r=_t(mv[0].astype(np.int32)),
                mv_c=_t(mv[1].astype(np.int32)), n=n, mi_rows=g.mi_rows,
                mi_cols=g.mi_cols, **extra)
    return case, planes, sel


def _jax_from_wins(case, sel):
    """The JAX step's MC of the case: per plane, the windows merged by
    ``jnp.where`` over ref_sel (the zones) or its parents' taken and
    repeated (the children), then ``mc_predict_from_wins``."""
    def j(t):
        return None if t is None else jnp.asarray(t.numpy())

    out = []
    for p in range(3):
        ss = min(p, 1)
        w = j(case["wins"][0][p])
        if sel is not None:
            w = jnp.repeat(jnp.take(w, jnp.asarray(sel), axis=0), 4, axis=0)
        for ref_id in (1, 2):
            if ref_id < len(case["wins"]):
                msel = (j(case["ref_sel"]) == ref_id)[:, None, None]
                w = jnp.where(msel, j(case["wins"][ref_id][p]), w)
        off = ({} if sel is None else
               {"org_off_y": j(case["org_off_y"]) // (1 + ss),
                "org_off_x": j(case["org_off_x"]) // (1 + ss)})
        out.append(np.asarray(J.mc_predict_from_wins(
            w, j(case["pos_y"]) // (1 + ss), j(case["pos_x"]) // (1 + ss),
            j(case["mv_r"]), j(case["mv_c"]), case["n"] >> ss, ss,
            case["mi_rows"], case["mi_cols"], FILTERS,
            (P.WIN_R, P.CHROMA_WIN_R)[ss], **off)))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_mc_predict_ref_matches_jax_from_wins(kind):
    case, _, sel = _case(kind, seed=KINDS.index(kind))
    got = P.mc_predict_ref(filters=FILTERS_T, **case)
    for g, w in zip(got, _jax_from_wins(case, sel)):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("kind", [k for k in KINDS if k != "clamp"])
def test_mc_predict_ref_matches_jax_on_the_plane(kind):
    """MC from the windows equals MC from the bordered plane
    (``mc_predict_batch``, per reference, the block's taken)."""
    case, planes, _ = _case(kind, seed=KINDS.index(kind))
    got = P.mc_predict_ref(filters=FILTERS_T, **case)
    ref_sel = case.get("ref_sel")
    for p in range(3):
        ss = min(p, 1)
        per_ref = [np.asarray(J.mc_predict_batch(
            jnp.asarray(ref[p]), jnp.asarray(case["pos_y"].numpy() >> ss),
            jnp.asarray(case["pos_x"].numpy() >> ss),
            jnp.asarray(case["mv_r"].numpy()),
            jnp.asarray(case["mv_c"].numpy()), case["n"] >> ss, ss,
            case["mi_rows"], case["mi_cols"], FILTERS)) for ref in planes]
        want = per_ref[0]
        if ref_sel is not None:
            pick = ref_sel.numpy().astype(np.int64)
            want = np.stack(per_ref)[pick, np.arange(pick.size)]
        np.testing.assert_array_equal(got[p].numpy(), want,
                                      err_msg=f"plane {p}")


def _grid_case(kind, seed):
    """(keyword arguments of ``mc_predict_planes_ref`` on CPU tensors, the
    bordered numpy (y, u, v) planes of each reference the frame has, the
    grid's first column in them): ``_case``'s blocks and MVs with the
    windows' grid in place of the windows, a window index where blocks do
    not read window b. "shard": the 32 zone of columns 4-7 of a 256 x 96
    frame, its planes the columns of those blocks and their border on
    either side (a view), positions global, MVs at every edge."""
    if kind == "shard":
        case, planes, _ = _case("edges", seed)
        g = P.make_geom(256, 96)
        c0, ncols = 4, 4
        rng = np.random.default_rng(seed)
        planes = [tuple(rng.integers(0, 256, (hh + 2 * P.BORDER,
                                              ww + 2 * P.BORDER), np.uint8)
                        for hh, ww in ((g.pad_h, g.pad_w),
                                       (g.pad_h // 2, g.pad_w // 2),
                                       (g.pad_h // 2, g.pad_w // 2)))
                  for _ in range(3)]
        pos_y = np.repeat(np.arange(g.rows32) * 32, ncols)
        pos_x = np.tile((c0 + np.arange(ncols)) * 32, g.rows32)
        b = pos_y.size
        combos = np.array([(r, c) for r in (-EDGE, 0, EDGE)
                           for c in (-EDGE, 0, EDGE)])
        mv = combos[np.arange(b) % 9].T
        views = [tuple(_t(pl)[:, (c0 * 32 >> s):(c0 * 32 >> s)
                             + (ncols * 32 >> s) + 2 * P.BORDER]
                       for pl, s in zip(ref, (0, 1, 1))) for ref in planes]
        kw = dict(planes=views, pos_y=_t(pos_y.astype(np.int32)),
                  pos_x=_t(pos_x.astype(np.int32)),
                  mv_r=_t(mv[0].astype(np.int32)),
                  mv_c=_t(mv[1].astype(np.int32)), n=32, mi_rows=g.mi_rows,
                  mi_cols=g.mi_cols, grid=(32, 0, g.rows32, ncols),
                  ref_sel=_t(rng.integers(0, 3, b).astype(np.int8)))
        return kw, planes, c0 * 32
    case, planes, sel = _case(kind, seed)
    g = P.make_geom(*{"strip": (128, 112), "edges": (128, 88),
                      "clamp": (512, 288), "phases": (512, 192)}.get(
                          kind, (128, 96)))
    kw = {k: v for k, v in case.items() if k != "wins"}
    kw["planes"] = [tuple(_t(pl) for pl in ref) for ref in planes]
    if kind == "strip":
        kw["grid"] = (16, g.strip_y, 1, g.cols16)
    else:
        kw["grid"] = (32, 0, g.rows32, g.cols32)
    if kind == "phases":
        kw["win_idx"] = (case["pos_y"] // 32 * g.cols32
                         + case["pos_x"] // 32).to(torch.int32)
    return kw, planes, 0


def _jax_from_planes(kw, planes, col0):
    """The JAX step's MC of a grid case: each reference's windows cut by
    ``_extract_search_windows`` at the grid (columns from ``col0``),
    taken by window index, merged by ``jnp.where`` over ref_sel, then
    ``mc_predict_from_wins``."""
    step, y_base, rows, cols = kw["grid"]
    b = kw["pos_y"].shape[0]
    idx = jnp.asarray(np.arange(b) if kw.get("win_idx") is None
                      else kw["win_idx"].numpy())
    out = []
    for p in range(3):
        ss = min(p, 1)
        st, r = step >> ss, (P.WIN_R, P.CHROMA_WIN_R)[ss]
        cut = [jnp.take(J._extract_search_windows(
            jnp.asarray(ref[p]), st, rows, cols, y_base >> ss,
            (col0 >> ss) + np.arange(cols, dtype=np.int64) * st, r=r),
            idx, axis=0) for ref in planes]
        w = cut[0]
        if kw.get("ref_sel") is not None:
            for ref_id in range(1, len(cut)):
                msel = (jnp.asarray(kw["ref_sel"].numpy()) == ref_id)
                w = jnp.where(msel[:, None, None], cut[ref_id], w)
        off = {}
        if kw.get("org_off_y") is not None:
            off = {k: jnp.asarray(kw[k].numpy()) // (1 + ss)
                   for k in ("org_off_y", "org_off_x")}
        out.append(np.asarray(J.mc_predict_from_wins(
            w, jnp.asarray(kw["pos_y"].numpy()) // (1 + ss),
            jnp.asarray(kw["pos_x"].numpy()) // (1 + ss),
            jnp.asarray(kw["mv_r"].numpy()), jnp.asarray(kw["mv_c"].numpy()),
            kw["n"] >> ss, ss, kw["mi_rows"], kw["mi_cols"], FILTERS, r,
            **off)))
    return out


@pytest.mark.parametrize("kind", PLANE_KINDS)
def test_mc_predict_planes_ref_matches_jax_windows(kind):
    """The plane-based plain version against MC from JAX's own windows:
    the 32 zone by ref_sel, the strip (``y_base``), the children's window
    index and offsets, a shard's plane view, the phases, the edges and the
    window clamp."""
    kw, planes, col0 = _grid_case(kind, seed=PLANE_KINDS.index(kind))
    got = P.mc_predict_planes_ref(filters=FILTERS_T, **kw)
    want = _jax_from_planes(kw, planes, col0)
    for p, (gp, wp) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gp.numpy(), wp, err_msg=f"plane {p}")
    # the step's dispatch takes the plain version for CPU tensors
    for gp, dp in zip(got, P.mc_predict(filters=FILTERS_T, **kw)):
        assert torch.equal(gp, dp)
    if kind == "shard":
        assert not kw["planes"][0][0].is_contiguous()


def test_cases_cover_every_phase_pair_and_the_edges():
    """The phases case's chroma MVs take all 256 q4 phase pairs (no MV of
    it clamps) and its luma ones every pair of even phases, phase 0 in
    either axis, both and neither; the edge case clamps at every edge."""
    case, _, _ = _case("phases", seed=KINDS.index("phases"))
    pairs = set()
    for ss in (0, 1):
        m = case["n"] >> ss
        py, px = case["pos_y"] >> ss, case["pos_x"] >> ss
        row, col = P._clamp_mv_umv(case["mv_r"], case["mv_c"],
                                   (py << ss) // 8, (px << ss) // 8, m, m,
                                   ss, case["mi_rows"], case["mi_cols"])
        assert torch.equal(row, case["mv_r"] << (1 - ss))
        assert torch.equal(col, case["mv_c"] << (1 - ss))
        pairs = {(int(r) & 15, int(c) & 15) for r, c in zip(row, col)}
        assert len(pairs) == (64 if ss == 0 else 256)
    assert bool((case["mv_r"] < 0).any()) and bool((case["mv_r"] > 0).any())
    case, _, _ = _case("edges", seed=KINDS.index("edges"))
    row, col = P._clamp_mv_umv(case["mv_r"], case["mv_c"],
                               case["pos_y"] // 8, case["pos_x"] // 8, 32,
                               32, 0, case["mi_rows"], case["mi_cols"])
    moved = (row != case["mv_r"] * 2) | (col != case["mv_c"] * 2)
    top, left = case["pos_y"] == 0, case["pos_x"] == 0
    bottom = case["pos_y"] == case["pos_y"].max()
    right = case["pos_x"] == case["pos_x"].max()
    for edge in (top, left, bottom, right):
        assert bool((moved & edge).any())
    assert case["mi_rows"] % 4 == 3


def _zone_inputs(seed, w=128, h=96, last_noise=3):
    """Border-extended planes of a source and its LAST, GOLDEN and ALTREF
    references, and the rate tables: LAST is the frame before with noise
    of +-``last_noise``, GOLDEN an older one holding the source in its right
    half, ALTREF a later one holding the source moved by (-4, 6) in its
    left half, so blocks take all three references."""
    rng = np.random.default_rng(seed)
    g = P.make_geom(w, h)
    frames = list(synthetic_frames(w, h, 6, seed=seed, motion=True))
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))

    def planes(fr):
        return [np.asarray(p).copy() for p in (fr.y, fr.u, fr.v)]

    cur, last, gold, alt = (planes(frames[i]) for i in (3, 2, 0, 5))
    for k, sp in enumerate(cur):
        s, half = int(k > 0), sp.shape[1] // 2
        last[k], gold[k] = (np.clip(p.astype(np.int16) + rng.integers(
            -a, a + 1, sp.shape), 0, 255).astype(np.uint8)
                            for p, a in ((last[k], last_noise), (gold[k], 20)))
        gold[k][:, half:] = sp[:, half:]
        alt[k][:, :half] = np.roll(sp, (-4 >> s, 6 >> s), axis=(0, 1))[
            :, :half]
    src = tuple(_t(P.pad_plane(p, *shp)) for p, shp in zip(cur, shapes))

    def refs(pl):
        return tuple(port_realtime.upload_refs(pl, g, "cpu"))

    fc = T.default_frame_context()
    return (g, src, refs(last), refs(gold), refs(alt),
            P.upload_rate_tabs(P.make_rate_tabs(fc, QINDEX), "cpu"))


def _recording(monkeypatch):
    """The step's MC on the CPU (``mc_predict_planes_ref``, which the
    dispatches of the decision and MC reach there after the decision),
    recording each call's arguments and result."""
    calls = []
    real = P.mc_predict_planes_ref

    def record(*args, **kw):
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out

    monkeypatch.setattr(P, "mc_predict_planes_ref", record)
    return calls


def _today(args, kw):
    """The windowed formulation of the recorded MC call: the windows of
    the planes it hands over cut at its grid, merged (or the parents'
    repeated) per plane, each through ``mc_predict_from_wins``."""
    planes, pos_y, pos_x, mv_r, mv_c, n, mi_rows, mi_cols, filters, grid = \
        args
    step, y_base, rows, cols = grid
    ref_sel, win_idx = kw.get("ref_sel"), kw.get("win_idx")
    out = []
    for p in range(3):
        ss = min(p, 1)
        r = (P.WIN_R, P.CHROMA_WIN_R)[ss]
        wins = [None if ref is None else P._extract_search_windows(
            ref[p], step >> ss, rows, cols, y_base >> ss, r)
            for ref in planes]
        w = wins[0]
        if win_idx is not None:
            # the parents' windows, taken, then repeated for the children
            w = w[win_idx.long()[::4]].repeat_interleave(4, dim=0)
        for ref_id in (1, 2):
            if ref_id < len(wins) and wins[ref_id] is not None:
                w = torch.where((ref_sel == ref_id)[:, None, None],
                                wins[ref_id], w)
        off = {k: kw[k] // (1 + ss) for k in ("org_off_y", "org_off_x")
               if kw.get(k) is not None}
        out.append(P.mc_predict_from_wins(
            w, pos_y // (1 + ss), pos_x // (1 + ss), mv_r, mv_c, n >> ss,
            ss, mi_rows, mi_cols, filters, r, **off))
    return out


@pytest.mark.parametrize("n,with_gold", [(32, True), (32, False),
                                         (16, True)],
                         ids=["n32_gold_alt", "n32_alt", "n16_gold_alt"])
def test_zone_code_mc_is_todays(monkeypatch, n, with_gold):
    """One MC call a zone, with LAST's, GOLDEN's and ALTREF's planes (the
    very reference tensors of the step) at the zone's window grid and
    ref_sel, equal to the merged windows' MC; blocks take every reference
    present (the strip's LAST noisier, or LAST would take no block). The
    zone cuts its search windows (LAST's, ALTREF's) and no MC windows."""
    g, src, last, gold, alt, rates = _zone_inputs(
        7, 128, 96 if n == 32 else 112, 3 if n == 32 else 10)
    calls = _recording(monkeypatch)
    cuts = []
    real_cut = P.extract_windows

    def record_cut(jobs, rows, cols):
        cuts.append([(job[1], job[3]) for job in jobs])
        return real_cut(jobs, rows, cols)

    monkeypatch.setattr(P, "extract_windows", record_cut)
    b = g.n_blocks32 if n == 32 else g.cols16
    out = P.encode_zone(*src, *last, torch.zeros((b, 2), dtype=torch.int32),
                        g, P.step_scalars(T.dc_quant(QINDEX),
                                          T.ac_quant(QINDEX), 300, 0, 0, 0),
                        FILTERS_T, P.new_bits_table("cpu"),
                        gold=gold if with_gold else None, alt=alt,
                        rates=rates, n=n)
    assert len(calls) == 1
    args, kw, got = calls[0]
    assert kw["ref_sel"] is out["ref"]
    assert (args[0][1] is not None) == with_gold and args[0][2] is not None
    refs = [last, gold if with_gold else None, alt]
    for given, ref in zip(args[0], refs):
        assert (given is None) == (ref is None)
        if ref is not None:
            assert all(a is b for a, b in zip(given, ref))
    y0 = 0 if n == 32 else g.strip_y
    assert args[9] == (n, y0, b // (g.cols32 if n == 32 else g.cols16),
                       g.cols32 if n == 32 else g.cols16)
    assert cuts == [[(n, P.WIN_R)], [(n, P.WIN_R)]]  # LAST's, ALTREF's
    used = set(out["ref"].tolist())
    assert used == ({0, 1, 2} if with_gold else {0, 2}), used
    for gp, wp in zip(got, _today(args, kw)):
        assert torch.equal(gp, wp)


def test_children_mc_reads_parent_windows_by_index(monkeypatch):
    """The descent's MC is one call on the 32 zone's LAST planes at the
    zone's window grid with the window index sel.repeat_interleave(4) (no
    window cut or copied), equal to MC from the repeated parent windows;
    with every parent LAST it equals the JAX children's MC too."""
    g, src, last, gold, alt, rates = _zone_inputs(9)
    calls = _recording(monkeypatch)
    step = P.make_pframe_step(g, "cpu", split16=True, golden=False,
                              with_rates=True, descend_frac=2)
    outs, _ = step(*src, *last, torch.zeros((g.n_blocks32, 2),
                                            dtype=torch.int32),
                   torch.zeros((1, 2), dtype=torch.int32),
                   P.step_scalars(T.dc_quant(QINDEX), T.ac_quant(QINDEX), 300,
                                  20, 3, 40), rates)
    assert len(calls) == 2  # the zone's, then the children's
    zone_args, _, _ = calls[0]
    args, kw, got = calls[1]
    assert len(args[0]) == 1
    for zone_p, child_p, ref_p in zip(zone_args[0][0], args[0][0], last):
        assert child_p is zone_p is ref_p  # LAST's planes, not a copy
    assert args[9] == zone_args[9] == (32, 0, g.rows32, g.cols32)
    sel = outs["m16f"]["sel_idx"]
    assert torch.equal(kw["win_idx"], sel.repeat_interleave(4))
    assert kw["win_idx"].dtype == torch.int32
    for gp, wp in zip(got, _today(args, kw)):
        assert torch.equal(gp, wp)
    wins = [tuple(P._extract_search_windows(
        pl, 32 >> ss, g.rows32, g.cols32, 0, r) for pl, ss, r in zip(
            args[0][0], (0, 1, 1),
            (P.WIN_R, P.CHROMA_WIN_R, P.CHROMA_WIN_R)))]
    case = dict(wins=wins, pos_y=args[1], pos_x=args[2], mv_r=args[3],
                mv_c=args[4], n=16, mi_rows=g.mi_rows, mi_cols=g.mi_cols,
                org_off_y=kw["org_off_y"], org_off_x=kw["org_off_x"])
    for gp, wp in zip(got, _jax_from_wins(case, sel.numpy())):
        np.testing.assert_array_equal(gp.numpy(), wp)
