"""The port's M8 realtime session end to end.

``tpu_vp9_torch.pipeline.realtime.RtSession(split16=True, golden=True,
device="cpu")`` (the kernels' plain versions) against
``tpu_vp9.pipeline.realtime.RtSession`` on CPU-JAX, on the same panning
frames, with a short ``golden_interval`` so the anchor is refreshed inside
the clip: both with the device keyframe, as they ship, and both with the
host keyframe (``_kstep = None`` on both sessions). Every packet must be
byte-identical; the port's stream must decode with the port's own decoder
copy bit-exactly to the encoder's recon; some parents must split and some
blocks must pick GOLDEN.

The other tests mirror the JAX package's session tests
(``tests/test_tpu_encdec.py``: split16 round trip and gain, GOLDEN round
trip, GOLDEN with split16, the anchor picked after an occlusion) on the
port alone, and check that the stream does not depend on thread timing.
"""

import io
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vp9.pipeline import tpu_encdec as J
from tpu_vp9.pipeline.realtime import RtSession as JaxSession

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream.ivf import write_ivf_frame, write_ivf_header
from tpu_vp9_torch.decoder.decoder import decode_ivf
from tpu_vp9_torch.ops.loopfilter import pick_filter_level, sharpness_limits
from tpu_vp9_torch.pipeline import realtime as port_realtime
from tpu_vp9_torch.pipeline import tpu_encdec as P
from tpu_vp9_torch.pipeline.realtime import RtSession as PortSession
from tpu_vp9_torch.utils.yuv import (
    Frame420, panning_frames, synthetic_frames,
)

torch.set_num_threads(1)


def _run(sess, frames, qindex):
    out = []
    for fr in frames:
        out += sess.send(fr, qindex=qindex)
    out += sess.flush()
    assert [e.pts for e in out] == list(range(len(frames)))
    return out


def _decode(efs, w, h):
    buf = io.BytesIO()
    write_ivf_header(buf, w, h, 30, 1, len(efs))
    for i, ef in enumerate(efs):
        write_ivf_frame(buf, ef.payload, i)
    buf.seek(0)
    return list(decode_ivf(buf))


def _check_exact(efs, w, h):
    dec = _decode(efs, w, h)
    assert len(dec) == len(efs)
    for i, ((y, u, v, _), ef) in enumerate(zip(dec, efs)):
        for p, plane in enumerate((y, u, v)):
            np.testing.assert_array_equal(
                plane,
                ef.state.planes[p].recon[:plane.shape[0], :plane.shape[1]],
                err_msg=f"frame {i} (key={ef.is_keyframe}) plane {p}")
    return dec


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _port(w, h, **kw):
    return PortSession(w, h, device="cpu", want_recon=True, **kw)


@pytest.fixture
def host_outputs(monkeypatch):
    """Record the host dictionaries the port's session fetches."""
    seen = []
    real = port_realtime._device_out_to_host

    def spy(*args):
        host = real(*args)
        seen.append(host)
        return host

    monkeypatch.setattr(port_realtime, "_device_out_to_host", spy)
    return seen


@pytest.mark.parametrize("w,h,n,qindex,seed", [
    (128, 96, 6, 110, 1),    # aligned 32 grid
    (160, 120, 6, 120, 2),   # mi_rows % 4 == 3: the overhang row (1080p)
], ids=["aligned", "overhang"])
def test_m8_session_matches_jax_session(host_outputs, w, h, n, qindex, seed):
    frames = list(panning_frames(w, h, n, seed=seed))
    kw = dict(split16=True, golden=True, golden_interval=2)
    jsess = JaxSession(w, h, want_recon=True, **kw)
    psess = _port(w, h, **kw)
    jsess._kstep = psess._kstep = None  # the host keyframe on both sides
    jefs = _run(jsess, frames, qindex)
    pefs = _run(psess, frames, qindex)

    dec = _check_exact(pefs, w, h)
    assert [e.is_keyframe for e in pefs] == [True] + [False] * (n - 1)
    for i, (a, b) in enumerate(zip(pefs, jefs)):
        assert a.payload == b.payload, f"packet {i} differs from JAX's"
    # P-frames 2 and 4 refresh GOLDEN (interval 2): the refresh lies
    # inside the clip, and frames after it predict from the new anchor
    assert n - 1 > 2 * kw["golden_interval"]
    assert len(host_outputs) == n - 1
    n_split = sum(int(hst["split32"].sum()) for hst in host_outputs)
    n_gold = sum(int((hst["m32"]["ref"] == 1).sum()) for hst in host_outputs)
    print(f"{w}x{h}: {n_split} split parents, {n_gold} GOLDEN blocks over "
          f"{n - 1} P-frames")
    assert n_split > 0
    assert n_gold > 0
    if h % 32:  # the overhang row never splits
        assert all(not hst["split32"][-1].any() for hst in host_outputs)
    assert np.mean([_psnr(d[0], f.y) for d, f in zip(dec, frames)]) > 30


def test_m8_session_matches_jax_session_as_shipped(host_outputs):
    """Both sessions with their device keyframes: every packet, the
    keyframe included, byte-identical; GOLDEN refreshed inside the clip."""
    w, h, n = 128, 96, 6
    frames = list(panning_frames(w, h, n, seed=1))
    kw = dict(split16=True, golden=True, golden_interval=2)
    jefs = _run(JaxSession(w, h, want_recon=True, **kw), frames, 110)
    pefs = _run(_port(w, h, **kw), frames, 110)
    _check_exact(pefs, w, h)
    assert [e.is_keyframe for e in pefs] == [True] + [False] * (n - 1)
    for i, (a, b) in enumerate(zip(pefs, jefs)):
        assert a.payload == b.payload, f"packet {i} differs from JAX's"
    assert sum(int(hst["split32"].sum()) for hst in host_outputs) > 0
    assert sum(int((hst["m32"]["ref"] == 1).sum())
               for hst in host_outputs) > 0


def _step_inputs(w, h, seed):
    """One P-frame's inputs for both steps, as numpy: source planes,
    LAST and GOLDEN border-extended planes, previous MVs, rate tables.
    GOLDEN holds the source's own content in the top-left 64x64 (its ZERO
    candidate is perfect there, so those parents pick it) and an older
    frame elsewhere."""
    rng = np.random.default_rng(seed)
    g = P.make_geom(w, h)
    frames = list(panning_frames(w, h, 5, seed=seed))
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))

    def planes(fr):
        return [np.asarray(p) for p in (fr.y, fr.u, fr.v)]

    cur, before = planes(frames[4]), planes(frames[3])
    # local motion no 32x32 block describes with one vector: one 16x16
    # quadrant of some parents moves its own way, so splitting pays
    for by, bx in ((32, 64), (64, 32), (32, 96), (64, 96)):
        y0, x0 = by + 16, bx
        if y0 + 22 <= h and x0 + 16 <= w:
            cur[0][y0:y0 + 16, x0:x0 + 16] = \
                before[0][y0 + 5:y0 + 21, x0 - 6:x0 + 10]
    src = [P.pad_plane(p, *shp) for p, shp in zip(cur, shapes)]
    gold_planes = [p.copy() for p in planes(frames[0])]
    for k, (gp, sp) in enumerate(zip(gold_planes, cur)):
        n = 64 >> (k > 0)
        gp[:n, :n] = sp[:n, :n]
    last = [t.numpy() for t in
            port_realtime.upload_refs(before, g, "cpu")]
    gold = [t.numpy() for t in
            port_realtime.upload_refs(gold_planes, g, "cpu")]
    prev = rng.integers(-64, 65, (g.n_blocks32, 2)).astype(np.int32)
    prev[1] = (-300, 310)
    fc = T.default_frame_context()
    fc.inter_mode_probs = rng.integers(
        1, 256, fc.inter_mode_probs.shape).astype(fc.inter_mode_probs.dtype)
    return g, src, last, gold, prev, P.make_rate_tabs(fc, 120)


@pytest.mark.parametrize("w,h,seed", [(128, 96, 1), (160, 120, 2)],
                         ids=["aligned", "overhang"])
def test_m8_step_matches_jax_step(w, h, seed):
    """One M8 step on the same inputs: every output array of the port's
    step equals the JAX step's (the 32 zone, the children, the split
    mask, the loop-filtered recon and the new references). The JAX step
    is the one the session test compiled (same geometry and flags)."""
    g, src, last, gold, prev, tabs = _step_inputs(w, h, seed)
    qidx = 120
    lvl = pick_filter_level(qidx, False)
    lim_t, mblim_t = sharpness_limits(0)
    scalars = (T.dc_quant(qidx), T.ac_quant(qidx),
               max(1, (T.ac_quant(qidx) ** 2) >> 6), lvl, int(lim_t[lvl]),
               int(mblim_t[lvl]))
    jstep = J.make_pframe_step(J.make_geom(w, h), split16=True, golden=True,
                               blob_recon=True, aq=False, descend_frac=4)
    jouts, jrefs = jstep(
        *(jnp.asarray(a) for a in src + last + gold), jnp.asarray(prev),
        jnp.zeros((1, 2), jnp.int32),
        *(jnp.asarray(v, jnp.int32) for v in scalars),
        *(jnp.asarray(tabs[k]) for k in ("mode_cost", "joint_cost",
                                         "nmv_row", "nmv_col", "ref_cost",
                                         "lam_bits")))
    pstep = P.make_pframe_step(g, "cpu", split16=True, golden=True)
    pouts, prefs = pstep(
        *(torch.from_numpy(a) for a in src + last + gold),
        torch.from_numpy(prev), torch.zeros((1, 2), dtype=torch.int32),
        *scalars, P.upload_rate_tabs(tabs, "cpu"))

    def eq(got, want, msg):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=msg)

    for k in ("mv", "ref", "skip", "eob_y", "eob_u", "eob_v", "lv_y",
              "lv_u", "lv_v", "dist_b", "rate_b"):
        eq(pouts["m32"][k], jouts["m32"][k], f"m32 {k}")
    for k in ("sel_idx", "mv", "skip", "eob_y", "eob_u", "eob_v", "lv_y",
              "lv_u", "lv_v"):
        eq(pouts["m16f"][k], jouts["m16f"][k], f"m16f {k}")
    eq(pouts["split32"], jouts["split32"], "split32")
    for k in ("rec_y", "rec_u", "rec_v"):
        eq(pouts[k], jouts[k], k)
    for a, b in zip(prefs, jrefs):
        eq(a, b, "new reference")
    ref = pouts["m32"]["ref"].numpy()
    assert ref[0] == 1 and 0 < ref.sum() < ref.size  # both refs in use
    assert int(pouts["split32"].sum()) > 0
    sel = pouts["m16f"]["sel_idx"].numpy()
    assert len(sel) == max(1, g.n_blocks32 // 4)
    assert not ref[sel].any()  # GOLDEN parents are never descended
    if h % 32:
        assert (sel < g.n_blocks32 - g.cols32).all()  # nor the overhang row


def test_m8_children_match_jax_children():
    """``encode_children_masked`` alone, every output array, on the JAX
    function's own inputs (the 32 zone's search intermediates come from
    the port's zone, which the step test holds to JAX's)."""
    w, h = 128, 96
    g, src, last, gold, prev, tabs = _step_inputs(w, h, 7)
    qidx = 120
    dc_q, ac_q = T.dc_quant(qidx), T.ac_quant(qidx)
    lam = max(1, (ac_q ** 2) >> 6)
    filt = torch.as_tensor(np.asarray(P.FILTERS, np.int32))
    nb = P.new_bits_table("cpu")
    rates = P.upload_rate_tabs(tabs, "cpu")
    tsrc = [torch.from_numpy(a) for a in src]
    tlast = [torch.from_numpy(a) for a in last]
    z = P.encode_zone(*tsrc, *tlast, torch.from_numpy(prev), g, dc_q, ac_q,
                      lam, filt, nb, rates=rates, return_me=True)
    me = {k: z[k] for k in ("wins", "dy", "dx", "wu", "wv")}
    sel = np.array([5, 0, 10], np.int32)  # out of raster order on purpose
    got = P.encode_children_masked(
        *tsrc, tlast[0], me, z["mv"].to(torch.int32), torch.from_numpy(sel),
        g, dc_q, ac_q, lam, filt, nb, rates=rates)
    jrates = {k: (jnp.asarray(v) if k != "mv_cost_max" else v)
              for k, v in tabs.items()}
    fn = jax.jit(lambda sy, su, sv, ry, pme, pmv, si: J.encode_children_masked(
        sy, su, sv, ry, pme, pmv, si, J.make_geom(w, h),
        jnp.asarray(dc_q, jnp.int32), jnp.asarray(ac_q, jnp.int32),
        jnp.asarray(lam, jnp.int32), P.FILTERS, rates=jrates))
    want = fn(*(jnp.asarray(a) for a in src), jnp.asarray(last[0]),
              {k: jnp.asarray(v.numpy()) for k, v in me.items()},
              jnp.asarray(z["mv"].numpy().astype(np.int32)),
              jnp.asarray(sel))
    assert set(got) <= set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert {"dist4", "rate4", "rec_y32", "rec_u16", "rec_v16", "mv",
            "lv_y"} <= set(got)


def _moving_objects(w, h, n):
    """A rolling background under six small objects that move their own
    ways: motion no 32x32 block describes with one vector."""
    rng = np.random.default_rng(0)
    bg = rng.integers(40, 220, (h * 2, w * 2)).astype(np.uint8)
    bg = (bg[::2, ::2] // 2 + bg[1::2, 1::2] // 2)
    objs = [(rng.integers(0, h - 24), rng.integers(0, w - 24),
             rng.integers(40, 220, (24, 24)).astype(np.uint8))
            for _ in range(6)]
    frames = []
    for t in range(n):
        y = np.roll(bg, t * 2, axis=1).copy()
        for k, (oy, ox, tex) in enumerate(objs):
            dy = (oy + t * (k % 3 + 1)) % (h - 24)
            dx = (ox + t * ((k + 1) % 4)) % (w - 24)
            y[dy:dy + 24, dx:dx + 24] = tex
        frames.append(Frame420(y=y,
                               u=np.full((h // 2, w // 2), 128, np.uint8),
                               v=np.full((h // 2, w // 2), 128, np.uint8)))
    return frames


def test_m8_split16_roundtrip_and_gain():
    """32-against-16 alone (rate proxies, LAST only): the stream decodes
    bit-exactly and beats the uniform grid on rate and distortion on
    motion-complex content."""
    w, h = 192, 128
    frames = _moving_objects(w, h, 5)
    enc_u = _run(_port(w, h), frames, 140)
    enc_s = _run(_port(w, h, split16=True), frames, 140)
    _check_exact(enc_s, w, h)
    b_u = sum(len(e.payload) for e in enc_u if not e.is_keyframe)
    b_s = sum(len(e.payload) for e in enc_s if not e.is_keyframe)

    def dsum(enc):
        return sum(np.mean((ef.state.planes[0].recon[:h, :w].astype(float)
                            - fr.y.astype(float)) ** 2)
                   for ef, fr in zip(enc, frames) if not ef.is_keyframe)

    # with the device keyframe the port measures 0.895 here (0.900 with
    # the host keyframe); the JAX test asks 0.9 of its session, whose
    # stream is now the port's
    assert b_s < b_u * 0.9, (b_s, b_u)
    assert dsum(enc_s) <= dsum(enc_u) * 1.02


def test_m8_golden_roundtrip():
    """GOLDEN alone: per-block LAST/GOLDEN choice, periodic refresh,
    entropy-table candidate rates."""
    w, h = 128, 96
    frames = list(synthetic_frames(w, h, 12, seed=2, motion=True))
    _check_exact(_run(_port(w, h, golden=True, golden_interval=4), frames,
                      120), w, h)


def test_m8_golden_split16_roundtrip():
    w, h = 128, 96
    frames = list(synthetic_frames(w, h, 6, seed=3, motion=True))
    _check_exact(_run(_port(w, h, golden=True, split16=True), frames, 120),
                 w, h)


def test_m8_golden_picks_anchor_on_occlusion():
    """A static background occluded by a moving box for a few frames:
    once the box moves on, GOLDEN (pre-occlusion) predicts the revealed
    area better than LAST; at least one block must choose it."""
    rng = np.random.default_rng(7)
    w, h = 128, 96
    bg = rng.integers(0, 255, (h, w), dtype=np.uint8)
    frames = []
    for i in range(8):
        y = bg.copy()
        y[32:64, 8 * i:8 * i + 32] = 255  # moving occluder
        frames.append(Frame420(y=y,
                               u=np.full((h // 2, w // 2), 128, np.uint8),
                               v=np.full((h // 2, w // 2), 128, np.uint8)))
    enc = _run(_port(w, h, golden=True, golden_interval=16), frames, 60)
    _check_exact(enc, w, h)
    # the native serializer fills the flat field arrays; GOLDEN is
    # RefFrame id 2
    assert any((ef.state.mig.f_ref0 == 2).any() for ef in enc[2:])


@pytest.mark.parametrize("er", [False, True], ids=["fc_chain", "er"])
def test_m8_python_serializer_matches_native(monkeypatch, er):
    """Without the native library the session walks the mixed 32/16
    partition and serializes in Python: same packets."""
    w, h = 128, 96
    frames = list(panning_frames(w, h, 4, seed=9))
    kw = dict(split16=True, golden=True, golden_interval=2,
              error_resilient=er)
    native = _run(_port(w, h, **kw), frames, 110)
    monkeypatch.setattr(port_realtime, "serialize_device_frame",
                        lambda *a, **k: None)
    python = _run(_port(w, h, **kw), frames, 110)
    assert [e.payload for e in python] == [e.payload for e in native]
    _check_exact(python, w, h)


def test_m8_stream_does_not_depend_on_thread_timing(monkeypatch):
    """The rate tables read the frame context captured at the last join
    of the serialization worker: a worker that is slow (it finishes after
    the next step was issued) and one that is fast give the same bytes."""
    w, h = 128, 96
    frames = list(panning_frames(w, h, 6, seed=5))
    kw = dict(split16=True, golden=True, golden_interval=2)
    fast = _run(_port(w, h, **kw), frames, 110)
    real = PortSession._finish_host

    def slow(self, *args):
        time.sleep(0.2)
        return real(self, *args)

    monkeypatch.setattr(PortSession, "_finish_host", slow)
    late = _run(_port(w, h, **kw), frames, 110)
    assert [e.payload for e in late] == [e.payload for e in fast]


def test_m8_session_refuses_aq():
    """The M8 session takes aq (the adaptive lambda of tune SQ), refused
    until it was ported; without GOLDEN it drops it, as the JAX session
    does (the step has no rate tables to scale)."""
    sess = PortSession(128, 96, device="cpu", split16=True, golden=True,
                       aq=True)
    assert sess.aq
    sess.close()
    sess = PortSession(128, 96, device="cpu", aq=True)
    assert not sess.aq
    sess.flush()
