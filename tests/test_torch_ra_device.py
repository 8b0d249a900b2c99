"""The port's device random-access session against the JAX package's.

``tpu_vp9_torch.pipeline.ra_device.DeviceRaSession(device="cpu")`` (the
kernels' plain versions) and the P-frame step it drives, with the ALTREF
reference and the descent over every parent (``descend_frac=1``), against
``tpu_vp9.pipeline.ra_device.DeviceRaSession`` on CPU-JAX:
  - ``encode_zone`` with ALTREF (and GOLDEN) at n=32 and n=16: every
    output equal;
  - the step with ALTREF at ``descend_frac=1`` on the session's own
    inputs: on a frame where no parent that took GOLDEN or ALTREF splits,
    every output equal; on a frame where one does, every output equal but
    those parents' children's chroma (levels, eobs, skips) and the chroma
    recon around them. The JAX step predicts those children's chroma from
    the parent's reference while the stream codes them as LAST blocks;
    the port takes LAST's chroma;
  - the sessions at 128x96 (seed 3, 10 frames, mini-GOPs of 4): every
    coded frame before poc 6 in decode order identical (poc 8, which
    splits a GOLDEN parent whose chroma agrees, among them), poc 6 not;
    the port's stream decodes to its kept references at every poc, the
    JAX package's not at poc 6 (54 U and 138 V pixels);
  - the overhang geometry 128x88: no parent of the overhang row splits.
The strip geometry's sessions, where the descent is off, are held byte
for byte in ``tests/test_torch_ra_strip.py``.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vp9.pipeline import tpu_encdec as J
from tpu_vp9.pipeline.ra_device import DeviceRaSession as JaxRaSession

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream.headers import split_superframe
from tpu_vp9_torch.bitstream.ivf import write_ivf_frame, write_ivf_header
from tpu_vp9_torch.decoder.decoder import decode_ivf
from tpu_vp9_torch.pipeline import realtime as port_realtime
from tpu_vp9_torch.pipeline import tpu_encdec as P
from tpu_vp9_torch.pipeline.gop import plan_minigop
from tpu_vp9_torch.pipeline.ra_device import DeviceRaSession as PortRaSession
from tpu_vp9_torch.utils.yuv import synthetic_frames

torch.set_num_threads(1)

QINDEX = 120
ZONE_KEYS = ("mv", "ref", "skip", "eob_y", "eob_u", "eob_v", "lv_y", "lv_u",
             "lv_v", "rec_y", "rec_u", "rec_v", "dist_b", "rate_b")
CHILD_LUMA = ("mv", "eob_y", "lv_y", "sel_idx")
CHILD_CHROMA = ("skip", "eob_u", "eob_v", "lv_u", "lv_v")
# the clip where the JAX step's children of a non-LAST parent take
# another reference's chroma: its decode differs at poc 6
CLIP = dict(w=128, h=96, n=10, seed=3, gop=4)
DEFECT_POC, DEFECT_PIXELS = 6, (0, 54, 138)


def _crop(planes, w, h):
    """The visible picture of border-extended planes, as numpy."""
    b = P.BORDER
    return [np.asarray(p)[b:b + (h >> (k > 0)), b:b + (w >> (k > 0))].copy()
            for k, p in enumerate(planes)]


def _decode(pkts, w, h):
    buf = io.BytesIO()
    write_ivf_header(buf, w, h, 30, 1, len(pkts))
    for p in pkts:
        write_ivf_frame(buf, p.data, p.pts)
    buf.seek(0)
    return list(decode_ivf(buf))


def _snapshot(args):
    """Step arguments with copies of their tensors and of the rate tables'
    dict."""
    def copy(a):
        if isinstance(a, torch.Tensor):
            return a.clone()
        if isinstance(a, dict):
            return {k: copy(v) for k, v in a.items()}
        return a
    return tuple(copy(a) for a in args)


def _run(sess, frames, w, h, on_step=None):
    """Encode ``frames``; returns (packets, {poc: coded frame}, {poc: kept
    reference picture}, decode order of the coded P-frames). ``on_step``
    (poc, (golden, altref), step arguments, outputs) sees every step."""
    coded, kept, order = {}, {}, []
    encode_key, encode_frame = sess._encode_key, sess._encode_frame
    step_for = sess._step_for

    def key_spy(frame, poc, staticness=None):
        pkts = encode_key(frame, poc, staticness=staticness)
        coded[poc] = pkts[0].data
        kept[poc] = _crop(sess.planes_of[poc], w, h)
        return pkts

    def frame_spy(gf, n_layers):
        order.append(gf.poc)
        payload, qidx = encode_frame(gf, n_layers)
        coded[gf.poc] = payload
        if gf.is_ref:
            kept[gf.poc] = _crop(sess.planes_of[gf.poc], w, h)
        return payload, qidx

    def step_spy(golden, altref):
        step = step_for(golden, altref)

        def call(*args):
            outs, refs = step(*args)
            # the session refills its row of scalars and its rate tables
            # in place for the next frame: the step's own are kept
            on_step(order[-1], (golden, altref), _snapshot(args), outs)
            return outs, refs
        return call

    sess._encode_key, sess._encode_frame = key_spy, frame_spy
    if on_step is not None:
        sess._step_for = step_spy
    pkts = []
    for f in frames:
        pkts += sess.push(f)
    pkts += sess.flush()
    assert [p.pts for p in pkts] == list(range(len(frames)))
    # every coded frame rides a packet, in the session's decode order;
    # the others are one-byte show_existing frames
    frames_out = [f for p in pkts for f in split_superframe(p.data)]
    assert [f for f in frames_out if len(f) > 1] == \
        [coded[0]] + [coded[p] for p in order]
    return pkts, coded, kept, order


@pytest.fixture(scope="module")
def clip():
    c = CLIP
    return list(synthetic_frames(c["w"], c["h"], c["n"], seed=c["seed"],
                                 motion=True))


@pytest.fixture(scope="module")
def jax_run(clip):
    c = CLIP
    sess = JaxRaSession(c["w"], c["h"], gop_len=c["gop"],
                        base_qindex=QINDEX)
    return sess, _run(sess, clip, c["w"], c["h"])


@pytest.fixture(scope="module")
def port_run(clip):
    c = CLIP
    steps = {}

    def on_step(poc, flags, args, outs):
        steps[poc] = (flags, args, outs)

    sess = PortRaSession(c["w"], c["h"], device="cpu", gop_len=c["gop"],
                         base_qindex=QINDEX)
    run = _run(sess, clip, c["w"], c["h"], on_step)
    sess.close()
    return sess, run, steps


def test_plan_decodes_in_pyramid_order():
    plan = plan_minigop(0, 4, 0) + plan_minigop(4, 4, 0)
    coded = [gf.poc for gf in plan if gf.show_existing_poc < 0]
    assert [0] + coded[:8] == [0, 4, 2, 1, 3, 8, 6, 5, 7]


def test_session_frames_match_jax_before_the_defect(jax_run, port_run):
    """Coded frames byte-identical in decode order up to the first frame
    whose JAX recon disagrees with its decode (poc 6); poc 6 differs."""
    _, (_, jcoded, _, jorder) = jax_run
    _, (_, pcoded, _, porder), _ = port_run
    assert porder == jorder == [4, 2, 1, 3, 8, 6, 5, 7, 9]
    before = [0] + porder[:porder.index(DEFECT_POC)]
    assert 8 in before
    for poc in before:
        assert pcoded[poc] == jcoded[poc], f"poc {poc} differs"
    assert pcoded[DEFECT_POC] != jcoded[DEFECT_POC]


def test_port_decodes_to_its_references_and_jax_does_not(jax_run,
                                                         port_run):
    """Every reference the port's session keeps is the decoder's picture
    of that poc; the JAX session's is too before poc 6 in decode order,
    and at poc 6 its chroma is not."""
    c = CLIP
    w, h = c["w"], c["h"]
    _, (ppkts, _, pkept, porder), _ = port_run
    _, (jpkts, _, jkept, _) = jax_run
    pdec, jdec = _decode(ppkts, w, h), _decode(jpkts, w, h)
    assert len(pdec) == len(jdec) == c["n"]
    assert sorted(pkept) == sorted(jkept) == [0, 2, 4, 6, 8, 9]

    def mismatch(dec, kept, poc):
        return tuple(int((np.asarray(dec[poc][k])[:p.shape[0], :p.shape[1]]
                          != p).sum()) for k, p in enumerate(kept[poc]))

    for poc in pkept:
        assert mismatch(pdec, pkept, poc) == (0, 0, 0), poc
    decode_order = [0] + porder
    for poc in decode_order[:decode_order.index(DEFECT_POC)]:
        if poc in jkept:
            assert mismatch(jdec, jkept, poc) == (0, 0, 0), poc
    assert mismatch(jdec, jkept, DEFECT_POC) == DEFECT_PIXELS


def _jax_args(args, n_refs):
    """The port step's arguments as the JAX step takes them."""
    planes = [jnp.asarray(a.numpy()) for a in args[:3 + n_refs]]
    prev_mv, prev16 = (jnp.asarray(a.numpy()) for a in
                       args[3 + n_refs:5 + n_refs])
    scalars = [jnp.asarray(int(v), jnp.int32)
               for v in args[5 + n_refs].tolist()]
    r = args[-1]
    rates = [jnp.asarray(np.asarray(r["mode_cost"], np.int32)),
             jnp.asarray(r["joint_cost"].numpy()),
             jnp.asarray(r["nmv_row"].numpy()),
             jnp.asarray(r["nmv_col"].numpy()),
             jnp.asarray(np.asarray(r["ref_cost"], np.int32)),
             jnp.asarray(np.float32(r["lam_bits"]))]
    return [*planes, prev_mv, prev16, *scalars, *rates]


def _not_last_splits(outs):
    split = outs["split32"].numpy().reshape(-1)
    ref = outs["m32"]["ref"].numpy()
    return np.flatnonzero((split > 0) & (ref > 0))


def _check_step(jsess, poc, flags, args, outs):
    """The JAX session's step on the port step's inputs. Returns the
    raster indices of the parents that took GOLDEN or ALTREF and split,
    and the number of chroma recon pixels that differ (around them
    only)."""
    golden, altref = flags
    assert altref
    n_refs = 3 * (1 + int(golden) + int(altref))
    want, _ = jsess._step_for(golden, altref)(*_jax_args(args, n_refs))
    g = P.make_geom(CLIP["w"], CLIP["h"])
    for k in ZONE_KEYS:
        np.testing.assert_array_equal(outs["m32"][k].numpy(),
                                      np.asarray(want["m32"][k]),
                                      err_msg=f"poc {poc} m32 {k}")
    np.testing.assert_array_equal(outs["split32"].numpy(),
                                  np.asarray(want["split32"]))
    np.testing.assert_array_equal(outs["rec_y"].numpy(),
                                  np.asarray(want["rec_y"]))
    bad = _not_last_splits(outs)
    sel = outs["m16f"]["sel_idx"].numpy()
    assert len(sel) == g.n_blocks32  # descend_frac=1: every parent
    ref = outs["m32"]["ref"].numpy()
    last_child = np.repeat(ref[sel] == 0, 4)
    for k in CHILD_LUMA:
        np.testing.assert_array_equal(outs["m16f"][k].numpy(),
                                      np.asarray(want["m16f"][k]),
                                      err_msg=f"poc {poc} m16f {k}")
    for k in CHILD_CHROMA:
        np.testing.assert_array_equal(
            outs["m16f"][k].numpy()[last_child],
            np.asarray(want["m16f"][k])[last_child],
            err_msg=f"poc {poc} m16f {k} (children of LAST parents)")
    # the chroma recon may differ only around the non-LAST split parents
    # (their 16x16 chroma blocks, and the loop filter's reach of 8)
    near = np.zeros((g.pad_h // 2, g.pad_w // 2), bool)
    for b in bad:
        r, c = divmod(int(b), g.cols32)
        near[max(0, 16 * r - 8):16 * r + 24, max(0, 16 * c - 8):16 * c + 24] \
            = True
    diff = 0
    for k in ("rec_u", "rec_v"):
        d = outs[k].numpy() != np.asarray(want[k])
        assert not (d & ~near).any(), f"poc {poc} {k} differs elsewhere"
        diff += int(d.sum())
    return bad, diff


def test_step_with_altref_matches_jax_where_no_other_parent_splits(
        jax_run, port_run):
    jsess, _ = jax_run
    _, _, steps = port_run
    pocs = [p for p, (flags, _, outs) in steps.items()
            if flags[1] and not len(_not_last_splits(outs))]
    assert len(pocs) >= 2
    for poc in pocs[:2]:
        bad, diff = _check_step(jsess, poc, *steps[poc])
        assert len(bad) == 0 and diff == 0


def test_step_with_altref_repairs_the_children_of_other_parents(
        jax_run, port_run):
    jsess, _ = jax_run
    _, _, steps = port_run
    flags = steps[DEFECT_POC][0]
    assert flags == (True, True)  # LAST, GOLDEN and ALTREF
    bad, diff = _check_step(jsess, DEFECT_POC, *steps[DEFECT_POC])
    assert len(bad) and diff > 0


def _zone_inputs(w, h, seed):
    """Source, LAST, GOLDEN, ALTREF border-extended planes (numpy), previous
    MVs' generator and rate tables. LAST is the frame before with noise;
    GOLDEN an older frame with noise, holding the source in its right
    half (its ZERO candidate is perfect there); ALTREF a later frame
    holding the source moved by (-4, 6) pixels in its left half (its NEW
    candidate finds it)."""
    rng = np.random.default_rng(seed)
    g = P.make_geom(w, h)
    frames = list(synthetic_frames(w, h, 6, seed=seed, motion=True))
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))

    def planes(fr):
        return [np.asarray(p).copy() for p in (fr.y, fr.u, fr.v)]

    cur, last = planes(frames[3]), planes(frames[2])
    gold, future = planes(frames[0]), planes(frames[5])
    for k, sp in enumerate(cur):
        s, half = int(k > 0), sp.shape[1] // 2
        last[k], gold[k] = (np.clip(p.astype(np.int16) + rng.integers(
            -20, 21, sp.shape), 0, 255).astype(np.uint8)
                            for p in (last[k], gold[k]))
        gold[k][:, half:] = sp[:, half:]
        moved = np.roll(sp, (-4 >> s, 6 >> s), axis=(0, 1))
        future[k][:, :half] = moved[:, :half]
    src = [P.pad_plane(p, *shp) for p, shp in zip(cur, shapes)]

    def refs(pl):
        return [t.numpy() for t in port_realtime.upload_refs(pl, g, "cpu")]

    fc = T.default_frame_context()
    fc.inter_mode_probs = rng.integers(
        1, 256, fc.inter_mode_probs.shape).astype(fc.inter_mode_probs.dtype)
    return (g, src, refs(last), refs(gold), refs(future),
            P.make_rate_tabs(fc, QINDEX), rng)


@pytest.mark.parametrize("w,h,n,with_gold", [
    (128, 96, 32, True), (128, 96, 32, False), (128, 112, 16, True)],
    ids=["n32_gold_alt", "n32_alt", "n16_gold_alt"])
def test_encode_zone_with_altref_matches_jax(w, h, n, with_gold):
    g, src, last, gold, alt, tabs, rng = _zone_inputs(w, h, 5)
    b = g.n_blocks32 if n == 32 else g.cols16
    prev = rng.integers(-64, 65, (b, 2)).astype(np.int32)
    dc_q, ac_q = T.dc_quant(QINDEX), T.ac_quant(QINDEX)
    lam = max(1, (ac_q ** 2) >> 6)

    def t(pl):
        return tuple(torch.from_numpy(p) for p in pl)

    got = P.encode_zone(
        *t(src), *t(last), torch.from_numpy(prev), g,
        P.step_scalars(dc_q, ac_q, lam, 0, 0, 0),
        torch.as_tensor(np.asarray(P.FILTERS, np.int32)),
        P.new_bits_table("cpu"), gold=t(gold) if with_gold else None,
        alt=t(alt), rates=P.upload_rate_tabs(tabs, "cpu"), n=n)
    jrates = {k: (jnp.asarray(v) if k != "mv_cost_max" else v)
              for k, v in tabs.items()}

    def j(pl):
        return tuple(jnp.asarray(p) for p in pl)

    want = J.encode_zone(
        *j(src), *j(last), jnp.asarray(prev), J.make_geom(w, h), n,
        jnp.int32(dc_q), jnp.int32(ac_q), jnp.int32(lam), P.FILTERS,
        gold=j(gold) if with_gold else None, alt=j(alt), rates=jrates)
    for k in ZONE_KEYS:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    ref = got["ref"].numpy()
    assert (ref == 2).any() and (ref == 1).any() == with_gold


def test_encode_zone_altref_needs_rate_tables():
    g, src, last, _, alt, _, _ = _zone_inputs(128, 96, 5)
    t = [torch.from_numpy(p) for p in src + last]
    with pytest.raises(ValueError, match="rate tables"):
        P.encode_zone(*t, torch.zeros((g.n_blocks32, 2), dtype=torch.int32),
                      g, P.step_scalars(40, 50, 25, 0, 0, 0), torch.as_tensor(
                          np.asarray(P.FILTERS, np.int32)),
                      P.new_bits_table("cpu"),
                      alt=tuple(torch.from_numpy(p) for p in alt))


def test_overhang_row_never_splits():
    """128x88 (mi_rows 11, % 4 == 3: the 32 grid's last row overhangs the
    picture, as at 1080p): every parent is descended, the overhang row's
    keep their 32, and the stream decodes to the session's references."""
    w, h = 128, 88
    frames = list(synthetic_frames(w, h, 10, seed=3, motion=True))
    sess = PortRaSession(w, h, device="cpu", gop_len=4, base_qindex=QINDEX)
    split_rows = []

    def on_step(poc, args, outs):
        split_rows.append(outs["split32"].numpy())
        assert len(outs["m16f"]["sel_idx"]) == sess.g.n_blocks32

    pkts, _, kept, _ = _run(sess, frames, w, h,
                            lambda poc, flags, args, outs: on_step(
                                poc, args, outs))
    sess.close()
    assert len(split_rows) == 9
    assert sum(int(s[:-1].sum()) for s in split_rows) > 0
    assert all(not s[-1].any() for s in split_rows)
    assert sess.tally["split_overhang"] == 0
    dec = _decode(pkts, w, h)
    for poc, planes in kept.items():
        for k, want in enumerate(planes):
            np.testing.assert_array_equal(
                np.asarray(dec[poc][k])[:want.shape[0], :want.shape[1]],
                want, err_msg=f"poc {poc} plane {k}")
