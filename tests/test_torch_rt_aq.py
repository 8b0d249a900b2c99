"""The adaptive lambda (``aq``, tune SQ) of the port's M8 step, against the
TPU package's.

``tpu_encdec._sb_lambda_scale`` (the float32 chain on the host from exact
integer sums) is held to the JAX function: the variance bit for bit, the
scale within 2 float32 ulp per block on the 32 zone and on the strip's
16x16 blocks at the parity tests' sizes; at 1080p's 2,040 blocks and the
720p strip, where XLA's log and its mean's order differ by more, within
the bound those differences give. The step with ``aq=True`` is held to the JAX step (every output
array), the public encoder at enc_mode 8 and tune SQ to the JAX encoder
(``tpu_realtime=2``: its realtime session on CPU-JAX), packets byte for
byte, at 128x96, 160x120 (the overhang row) and 128x112 (the strip), on
``synthetic_frames(seed=13, motion=True)``; no mode or split choice flips
there, so no near-tie needs naming. The port's streams decode bit-exactly
to its recon, and aq moves choices (160x120 at qindex 120). A mirror of
``test_rt_aq_tune_sq_roundtrip`` (``tests/test_tpu_encdec.py``) and the CLI
line at ``-tune 0`` close it.
"""

import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vp9 import api as jax_api
from tpu_vp9 import config as jax_config
from tpu_vp9.pipeline import tpu_encdec as J

from tpu_vp9_torch import api as port_api
from tpu_vp9_torch import config as port_config
from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream.ivf import write_ivf_frame, write_ivf_header
from tpu_vp9_torch.decoder.decoder import decode_ivf
from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.ops.loopfilter import pick_filter_level, sharpness_limits
from tpu_vp9_torch.pipeline import realtime as port_realtime
from tpu_vp9_torch.pipeline import tpu_encdec as P
from tpu_vp9_torch.pipeline.realtime import RtSession as PortSession
from tpu_vp9_torch.utils.yuv import panning_frames, synthetic_frames

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 4


def _ulps(a, b):
    """Per-element distance in float32 ulps of two positive float32
    arrays."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def _zone_blocks(plane, g, n):
    """The zone's (B, n, n) uint8 source blocks of a padded luma plane."""
    y0, rows, cols = P._zone(g, n)
    return P._extract_blocks(torch.from_numpy(plane), y0, rows, cols, n)


def _jax_chain(blocks, n):
    """The JAX package's variance, logs, mean of the logs and scale of a
    zone's blocks (its ``_sb_lambda_scale``, step by step), as numpy."""
    jb = jnp.asarray(blocks.numpy())
    mean = jb.astype(jnp.float32).sum(axis=(1, 2)) / (n * n)
    var = jnp.maximum(J._block_sq_sum(jb).astype(jnp.float32) / (n * n)
                      - mean * mean, 0.0)
    logv = jnp.log(var + 16.0)
    scale = J._sb_lambda_scale(jb, J._block_sq_sum(jb))
    return (np.asarray(var), np.asarray(logv), np.asarray(logv.mean()),
            np.asarray(scale))


def _scale_planes(w, h, n):
    """A panning frame's padded luma plane, and the same with a saturated
    and two flat blocks."""
    g = P.make_geom(w, h)
    fr = next(panning_frames(w, h, 1, seed=7))
    y = P.pad_plane(np.asarray(fr.y), g.pad_h, g.pad_w)
    y0 = P._zone(g, n)[0]
    y2 = y.copy()
    y2[y0:y0 + n, :n] = 255
    y2[y0:y0 + n, n:2 * n] = 0
    y2[y0:y0 + n, 2 * n:3 * n] = 17
    return g, (y, y2)


def _port_chain(blocks, n):
    """The port's exact sums (block_energy against zero blocks, as the
    step takes them), variance and scale."""
    src2, src_sum = K.block_energy(blocks, torch.zeros_like(blocks), n)
    assert torch.equal(src2, P._block_sq_sum(blocks))
    got = P._sb_lambda_scale(src_sum, src2, n)
    assert got.dtype == torch.float32 and got.shape == (blocks.shape[0],)
    return P._aq_var(src_sum, src2, n), got.numpy()


@pytest.mark.parametrize("w,h,n", [(128, 96, 32), (160, 120, 32),
                                   (128, 112, 16)],
                         ids=["128x96", "160x120", "strip_128x112"])
def test_lambda_scale_matches_jax(w, h, n):
    """The scale of every block of the parity tests' zones within 2
    float32 ulp of the JAX function's, on panning content and on the same
    frame with flat and saturated blocks; the variance bit for bit."""
    g, planes = _scale_planes(w, h, n)
    worst = 0
    for plane in planes:
        blocks = _zone_blocks(plane, g, n)
        var, got = _port_chain(blocks, n)
        jvar, _, _, want = _jax_chain(blocks, n)
        np.testing.assert_array_equal(var, jvar)
        assert not np.array_equal(want, np.ones_like(want))
        worst = max(worst, int(_ulps(got, want).max()))
    print(f"{w}x{h} n={n}: {blocks.shape[0]} blocks, worst {worst} ulp")
    assert worst <= 2


@pytest.mark.parametrize("w,h,n", [(1920, 1080, 32), (1280, 720, 16)],
                         ids=["1080p", "strip_720p"])
def test_lambda_scale_bound_at_full_size(w, h, n):
    """At the card's sizes (2,040 blocks at 1080p, the 720p strip's 80)
    XLA's float32 log is 1 ulp off the correctly rounded one for some
    blocks and its mean of the logs sums in another order, so a scale may
    differ by more than 2 ulp. Each stage is held to what it can differ
    by: the variance bit for bit, each log within 1 ulp, and each scale
    within 0.25 * scale * (ulp(log) + the two means' difference), the
    argument's error through exp, plus 2 ulp (exp's and the clip's
    roundings)."""
    g, planes = _scale_planes(w, h, n)
    f32 = np.float32
    for plane in planes:
        blocks = _zone_blocks(plane, g, n)
        var, got = _port_chain(blocks, n)
        jvar, jlog, jmean, want = _jax_chain(blocks, n)
        np.testing.assert_array_equal(var, jvar)
        logv = np.log((var + f32(16)).astype(np.float64)).astype(f32)
        assert _ulps(logv, jlog).max() <= 1
        mean = f32(np.sum(logv, dtype=np.float64)) / f32(logv.size)
        ulp_log = np.spacing(np.abs(jlog)).astype(np.float64)
        bound = (0.25 * want.astype(np.float64)
                 * (ulp_log + abs(float(mean) - float(jmean))) * 1.001
                 + 2 * np.spacing(want).astype(np.float64))
        err = np.abs(got.astype(np.float64) - want.astype(np.float64))
        assert (err <= bound).all(), int(np.argmax(err - bound))
        print(f"{w}x{h} n={n}: {blocks.shape[0]} blocks, worst "
              f"{int(_ulps(got, want).max())} ulp, "
              f"{int((_ulps(got, want) > 2).sum())} past 2")


def _step_inputs(w, h, seed):
    """One M8 P-frame's inputs for both steps, as numpy: source planes,
    LAST and GOLDEN border-extended planes, previous MVs, rate tables."""
    rng = np.random.default_rng(seed)
    g = P.make_geom(w, h)
    frames = list(synthetic_frames(w, h, 5, seed=13, motion=True))
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))

    def planes(fr):
        return [np.asarray(p) for p in (fr.y, fr.u, fr.v)]

    src = [P.pad_plane(p, *s) for p, s in zip(planes(frames[4]), shapes)]
    last = [t.numpy() for t in
            port_realtime.upload_refs(planes(frames[3]), g, "cpu")]
    gold = [t.numpy() for t in
            port_realtime.upload_refs(planes(frames[0]), g, "cpu")]
    prev = rng.integers(-64, 65, (g.n_blocks32, 2)).astype(np.int32)
    return g, src, last, gold, prev, P.make_rate_tabs(
        T.default_frame_context(), 120)


def test_aq_step_matches_jax_step():
    """One M8 step with aq on the same inputs: every output array equals
    the JAX step's (the step the public-encoder test compiles too)."""
    w, h = 128, 96
    g, src, last, gold, prev, tabs = _step_inputs(w, h, 4)
    qidx = 120
    lvl = pick_filter_level(qidx, False)
    lim_t, mblim_t = sharpness_limits(0)
    scalars = (T.dc_quant(qidx), T.ac_quant(qidx),
               max(1, (T.ac_quant(qidx) ** 2) >> 6), lvl, int(lim_t[lvl]),
               int(mblim_t[lvl]))
    jstep = J.make_pframe_step(J.make_geom(w, h), split16=True, golden=True,
                               blob_recon=True, aq=True, descend_frac=4)
    jouts, jrefs = jstep(
        *(jnp.asarray(a) for a in src + last + gold), jnp.asarray(prev),
        jnp.zeros((1, 2), jnp.int32),
        *(jnp.asarray(v, jnp.int32) for v in scalars),
        *(jnp.asarray(tabs[k]) for k in ("mode_cost", "joint_cost",
                                         "nmv_row", "nmv_col", "ref_cost",
                                         "lam_bits")))
    args = (*(torch.from_numpy(a) for a in src + last + gold),
            torch.from_numpy(prev), torch.zeros((1, 2), dtype=torch.int32),
            P.step_scalars(*scalars), P.upload_rate_tabs(tabs, "cpu"))
    pouts, prefs = P.make_pframe_step(g, "cpu", split16=True, golden=True,
                                      aq=True)(*args)

    def eq(got, want, msg):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=msg)

    for k in ("mv", "ref", "skip", "eob_y", "eob_u", "eob_v", "lv_y",
              "lv_u", "lv_v", "dist_b", "rate_b"):
        eq(pouts["m32"][k], jouts["m32"][k], f"m32 {k}")
    for k in ("sel_idx", "mv", "skip", "eob_y", "lv_y"):
        eq(pouts["m16f"][k], jouts["m16f"][k], f"m16f {k}")
    eq(pouts["split32"], jouts["split32"], "split32")
    for k in ("rec_y", "rec_u", "rec_v"):
        eq(pouts[k], jouts[k], k)
    for a, b in zip(prefs, jrefs):
        eq(a, b, "new reference")


def _cfg(config, w, h, tune, **kw):
    return config.EncoderConfig(
        source_width=w, source_height=h, enc_mode=8, qp=40,
        pred_structure=config.PredStructure.LOW_DELAY_P, tpu_realtime=2,
        tune=config.Tune(tune), recon_file="unused.yuv", **kw)


def _encode(api, cfg, frames, **kw):
    """Packets and the recon of each."""
    enc = api.Vp9Encoder(**kw)
    enc.set_parameter(cfg)
    enc.init()
    got = []
    emit = enc._emit

    def hook(pkt):
        emit(pkt)
        got.append((pkt, enc.get_recon()))

    enc._emit = hook
    for fr in frames:
        enc.send_picture(fr)
    enc.flush()
    while enc.get_packet() is not None:
        pass
    rt = enc._rt
    enc.close()
    assert [p.pts for p, _ in got] == list(range(len(frames)))
    return [p.data for p, _ in got], [r for _, r in got], rt


def _decode_exact(datas, recons, w, h):
    buf = io.BytesIO()
    write_ivf_header(buf, w, h, 30, 1, len(datas))
    for i, d in enumerate(datas):
        write_ivf_frame(buf, d, i)
    buf.seek(0)
    dec = list(decode_ivf(buf))
    assert len(dec) == len(datas)
    for i, ((y, u, v, _), rec) in enumerate(zip(dec, recons)):
        for p, (plane, want) in enumerate(zip((y, u, v), rec)):
            np.testing.assert_array_equal(
                plane, want[:plane.shape[0], :plane.shape[1]],
                err_msg=f"frame {i} plane {p}")


@pytest.mark.parametrize("w,h", [(128, 96), (160, 120), (128, 112)],
                         ids=["aligned", "overhang", "strip"])
def test_public_encoder_tune_sq_matches_jax_encoder(monkeypatch, w, h):
    """The public encoders at enc_mode 8, tune SQ: every packet byte for
    byte; the port's session has aq on, its scale ran on every zone of
    every P-frame (the strip's too), and the stream decodes to its
    recon."""
    frames = list(synthetic_frames(w, h, N_FRAMES, seed=13, motion=True))
    zones = []
    real = P._sb_lambda_scale
    monkeypatch.setattr(P, "_sb_lambda_scale",
                        lambda s, s2, n: zones.append(n) or real(s, s2, n))
    datas, recons, rt = _encode(port_api, _cfg(port_config, w, h, 0),
                                frames, device="cpu")
    assert rt.aq
    want = [32, 16] if P.make_geom(w, h).strip else [32]
    assert zones == want * (N_FRAMES - 1)
    ref, _, _ = _encode(jax_api, _cfg(jax_config, w, h, 0), frames)
    for i, (a, b) in enumerate(zip(datas, ref)):
        assert a == b, f"packet {i} differs from JAX's"
    _decode_exact(datas, recons, w, h)


def test_aq_moves_choices():
    """The per-block lambda changes decisions: the M8 session at 160x120,
    qindex 120, on the parity clip writes other P-frames with aq than
    without (the keyframe, which aq does not touch, the same)."""
    w, h = 160, 120
    frames = list(synthetic_frames(w, h, N_FRAMES, seed=13, motion=True))
    out = []
    for aq in (False, True):
        sess = PortSession(w, h, device="cpu", split16=True, golden=True,
                           aq=aq)
        efs = []
        for f in frames:
            efs += sess.send(f, qindex=120)
        efs += sess.flush()
        sess.close()
        out.append([e.payload for e in efs])
    assert out[0][0] == out[1][0] and out[0][1:] != out[1][1:]


def test_rt_aq_tune_sq_roundtrip():
    """The mirror of the JAX package's test of the same name: the M8
    session with aq stays conformant."""
    w, h = 128, 96
    frames = list(synthetic_frames(w, h, 4, seed=13, motion=True))
    sess = PortSession(w, h, device="cpu", want_recon=True, split16=True,
                       golden=True, aq=True)
    enc = []
    for f in frames:
        enc += sess.send(f, qindex=120)
    enc += sess.flush()
    sess.close()
    _decode_exact([e.payload for e in enc],
                  [tuple(e.state.planes[p].recon for p in range(3))
                   for e in enc], w, h)


def test_app_tune_sq_decodes(tmp_path):
    """``-enc-mode 8 -pred-struct 0 -tune 0 -device cpu``: the stream
    decodes, every frame."""
    from tpu_vp9_torch.utils.yuv import write_y4m

    clip = tmp_path / "clip.y4m"
    out = tmp_path / "out.ivf"
    with open(clip, "wb") as fh:
        write_y4m(fh, synthetic_frames(128, 96, 4, seed=13, motion=True))
    res = subprocess.run(
        [sys.executable, "-m", "tpu_vp9_torch.app", "-i", str(clip), "-b",
         str(out), "-enc-mode", "8", "-pred-struct", "0", "-tune", "0",
         "-q", "40", "-device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-2000:]
    assert "SUMMARY: 4 frames" in res.stdout
    with open(out, "rb") as fh:
        assert len(list(decode_ivf(fh))) == 4
