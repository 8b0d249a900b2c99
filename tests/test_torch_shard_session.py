"""Mesh sessions and the public encoder's mesh routes against JAX's.

``RtSession(mesh_shape=)`` of the port (device="cpu": the CPU repeated as
the mesh) against the JAX package's on its virtual CPU devices, payload for
payload (``tests/test_multichip_encdec.py``'s cases: meshes (1, 2) and
(1, 4) at 512x64, the strip geometry 256x80, GOLDEN at 256x128), and
``Vp9Encoder`` with ``tpu_mesh_shape`` against JAX's with the same
configuration, packet for packet: M8 and M9 low delay (the sharded
session, no GOLDEN, the descent off with the JAX session's notice), random
access (the host engine: no device RA session over a mesh), a geometry the
sharded step refuses (the host route, the JAX notice), and a mesh wider
than the machine's card count (``torch.cuda.device_count`` patched: the
notice and the host route, ``RuntimeError`` at tpu_realtime 1).
"""

import io

import numpy as np
import pytest
import torch

from tpu_vp9 import api as jax_api
from tpu_vp9 import config as jax_config
from tpu_vp9.pipeline.realtime import RtSession as JaxSession
from tpu_vp9.utils import trace as jax_trace
from tpu_vp9.utils.yuv import synthetic_frames as jax_frames

from tpu_vp9_torch import api as port_api
from tpu_vp9_torch import config as port_config
from tpu_vp9_torch.bitstream.ivf import write_ivf_frame, write_ivf_header
from tpu_vp9_torch.decoder.decoder import decode_ivf
from tpu_vp9_torch.pipeline import realtime as port_realtime
from tpu_vp9_torch.pipeline.realtime import RtSession as PortSession
from tpu_vp9_torch.utils.yuv import synthetic_frames

torch.set_num_threads(1)


def _payloads(sess, frames, qindex):
    out = []
    for fr in frames:
        out.extend(sess.send(fr, qindex=qindex))
    out.extend(sess.flush())
    if hasattr(sess, "close"):
        sess.close()
    return [ef.payload for ef in out]


@pytest.mark.parametrize("w,h,n,seed,q,mesh,golden", [
    (512, 64, 3, 4, 100, (1, 2), False),
    (512, 64, 3, 4, 100, (1, 4), False),
    (256, 80, 4, 6, 110, (1, 2), False),
    (256, 128, 6, 9, 120, (1, 2), True),
], ids=["512x64_1x2", "512x64_1x4", "strip_256x80", "golden_256x128"])
def test_mesh_session_matches_jax(w, h, n, seed, q, mesh, golden):
    kw = dict(want_recon=False, mesh_shape=mesh)
    if golden:
        kw.update(golden=True, golden_interval=3)
    want = _payloads(JaxSession(w, h, **kw),
                     list(jax_frames(w, h, n, seed=seed, motion=True)), q)
    sess = PortSession(w, h, device="cpu", **kw)
    got = _payloads(sess, list(synthetic_frames(w, h, n, seed=seed,
                                                motion=True)), q)
    assert len(got) == n
    assert got == want
    if golden:
        # the anchor wins somewhere, so the test bites
        assert sess.tally["golden32"] > 0


def _cfg(config, w, h, **kw):
    base = dict(source_width=w, source_height=h, qp=40, frame_rate=30,
                pred_structure=config.PredStructure.LOW_DELAY_P,
                recon_file="unused.yuv", tpu_realtime=2)
    base.update(kw)
    return config.EncoderConfig(**base)


def _encode(api, cfg, frames, **kw):
    """(packets, the recon of each, the encoder) of a public encoder."""
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
    enc.close()
    return [p for p, _ in got], [r for _, r in got], enc


def _same(pkts, ref):
    assert [(p.pts, p.dts, p.data) for p in pkts] == \
        [(p.pts, p.dts, p.data) for p in ref]


def _decode_exact(pkts, recons, w, h):
    buf = io.BytesIO()
    write_ivf_header(buf, w, h, 30, 1, len(pkts))
    for i, p in enumerate(pkts):
        write_ivf_frame(buf, p.data, i)
    buf.seek(0)
    dec = list(decode_ivf(buf))
    assert len(dec) == len(pkts)
    for (y, u, v, _), rec in zip(dec, recons):
        for plane, want in zip((y, u, v), rec):
            np.testing.assert_array_equal(plane, want)


@pytest.fixture
def notices(monkeypatch):
    got = []
    monkeypatch.setattr(port_api, "notice", got.append)
    monkeypatch.setattr(port_realtime, "notice", got.append)
    return got


@pytest.mark.parametrize("enc_mode,mesh", [(8, (1, 2)), (9, (1, 4))],
                         ids=["m8_1x2", "m9_1x4"])
def test_public_encoder_with_a_mesh_matches_jax(notices, enc_mode, mesh):
    w, h = 512, 64
    kw = dict(enc_mode=enc_mode, tpu_mesh_shape=mesh, intra_period=3)
    pkts, recons, enc = _encode(
        port_api, _cfg(port_config, w, h, **kw),
        synthetic_frames(w, h, 5, seed=2, motion=True), device="cpu")
    assert enc._rt is not None and enc._rt.mesh_shape == mesh
    assert not enc._rt.golden and not enc._rt.split16
    assert notices == ([] if enc_mode == 9 else [
        "mesh-sharded realtime session: split16 descent disabled "
        "(uniform 32 grid + GOLDEN)"])
    ref, _, jenc = _encode(jax_api, _cfg(jax_config, w, h, **kw),
                           jax_frames(w, h, 5, seed=2, motion=True))
    assert jenc._rt is not None
    _same(pkts, ref)
    _decode_exact(pkts, recons, w, h)


def test_random_access_with_a_mesh_takes_the_host_engine(notices):
    w, h = 128, 96
    kw = dict(pred_structure=port_config.PredStructure.RANDOM_ACCESS,
              hierarchical_levels=2, tpu_mesh_shape=(1, 2), tpu_realtime=-1,
              recon_file=None)
    pkts, _, enc = _encode(port_api, _cfg(port_config, w, h, **kw),
                           synthetic_frames(w, h, 9, seed=5, motion=True),
                           device="cpu")
    assert enc._ra is not None and enc._ra_dev is None and not notices
    kw["pred_structure"] = jax_config.PredStructure.RANDOM_ACCESS
    ref, _, jenc = _encode(jax_api, _cfg(jax_config, w, h, **kw),
                           jax_frames(w, h, 9, seed=5, motion=True))
    assert jenc._ra is not None and jenc._ra_dev is None
    _same(pkts, ref)


def test_mesh_the_step_refuses_falls_back_as_jax(notices, monkeypatch):
    """160 columns: 5 columns of 32-blocks over 2 tiles. Both packages'
    steps raise, both take the host route with the same notices (the
    session's about the descent comes first)."""
    w, h = 160, 96
    kw = dict(enc_mode=8, tpu_mesh_shape=(1, 2), intra_period=2)
    pkts, recons, enc = _encode(
        port_api, _cfg(port_config, w, h, **kw),
        synthetic_frames(w, h, 4, seed=7, motion=True), device="cpu")
    assert enc._rt is None
    assert notices == [
        "mesh-sharded realtime session: split16 descent disabled (uniform "
        "32 grid + GOLDEN)", "realtime device session unavailable (cols32 "
        "must divide n_tiles); falling back to host encode"]
    jax_notes = []
    monkeypatch.setattr(jax_trace, "notice", jax_notes.append)
    ref, _, jenc = _encode(jax_api, _cfg(jax_config, w, h, **kw),
                           jax_frames(w, h, 4, seed=7, motion=True))
    assert jenc._rt is None and jax_notes[-2:] == notices
    _same(pkts, ref)
    _decode_exact(pkts, recons, w, h)


@pytest.fixture
def eight_cards(monkeypatch):
    """A CUDA machine of 8 cards, as far as ``init`` asks: what the JAX
    tests' 8 virtual devices are to the JAX package."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)


def test_mesh_wider_than_the_machine_falls_back(notices, eight_cards,
                                                monkeypatch):
    w, h = 512, 64
    kw = dict(enc_mode=9, tpu_mesh_shape=(1, 16))
    enc = port_api.Vp9Encoder(device="cuda")
    enc.set_parameter(_cfg(port_config, w, h, **kw))
    enc.init()
    assert enc._rt is None and enc._ra is None
    assert notices == ["realtime device session unavailable (mesh requests "
                       "16 devices, 8 available); falling back to host "
                       "encode"]
    jax_notes = []
    monkeypatch.setattr(jax_trace, "notice", jax_notes.append)
    jenc = jax_api.Vp9Encoder()
    jenc.set_parameter(_cfg(jax_config, w, h, **kw))
    jenc.init()
    assert jenc._rt is None and jax_notes[-1] == notices[0]


def test_mesh_wider_than_the_machine_raises_at_rt1(eight_cards):
    w, h = 512, 64
    kw = dict(enc_mode=8, tpu_mesh_shape=(2, 8), tpu_realtime=1)
    enc = port_api.Vp9Encoder(device="cuda")
    enc.set_parameter(_cfg(port_config, w, h, **kw))
    with pytest.raises(RuntimeError, match="mesh requests 16 devices, 8 "
                                           "available"):
        enc.init()


@pytest.mark.parametrize("how", ["staged", "cbr", "golden_staged"])
def test_mesh_session_takes_staged_input_and_a_controller(how):
    """``step_args``, staged input (``stage``'s tuples for the P-frames)
    and a rate controller drive the sharded step unchanged: a (1, 4) mesh
    session gives the single-device session's payloads and qindexes."""
    from tpu_vp9_torch.pipeline.rate_control import RateControlState

    w, h = 256, 128
    frames = list(synthetic_frames(w, h, 5, seed=8, motion=True))

    def run(mesh):
        kw = dict(want_recon=False, mesh_shape=mesh)
        if how == "cbr":
            kw["rc"] = RateControlState.create(_cfg(
                port_config, w, h, enc_mode=9, target_bit_rate=150_000,
                rate_control_mode=port_config.RateControlMode.CBR).derive())
        if how.startswith("golden"):
            kw.update(golden=True, golden_interval=2)
        sess = PortSession(w, h, device="cpu", **kw)
        out = []
        for i, fr in enumerate(frames):
            staged = how != "cbr" and i > 0
            out.extend(sess.send(sess.stage(fr) if staged else fr,
                                 qindex=110))
        out.extend(sess.flush())
        sess.close()
        return [(ef.qindex, ef.payload) for ef in out]

    single = run(None)
    assert run((1, 4)) == single
    if how == "cbr":
        assert len({q for q, _ in single}) > 1
