"""The port's M9 realtime session end to end against the TPU package's.

``tpu_vp9_torch.pipeline.realtime.RtSession(device="cpu")`` (the kernels'
plain versions) against ``tpu_vp9.pipeline.realtime.RtSession`` on
CPU-JAX, on the same panning frames:
  - as both ship, with the device keyframe: every packet byte-identical,
    the port's stream decoded bit-exactly to its recon by the port's
    decoder; so also the public encoders at enc_mode 8 and 9, and a session
    that encodes on after a flush;
  - both with the host keyframe (``_kstep = None`` on both sessions): the
    port's stream must decode with ``tpu_vp9.decoder`` bit-exactly to its
    own recon; the keyframe packets must be byte-identical; the total bytes
    must lie within 1% of JAX's and the mean Y PSNR within 0.05 dB (the
    forward transform and the candidate costs are float in the TPU
    package, so a P-frame may differ where a level or a choice sits on a
    rounding boundary). The test prints how many P packets are
    byte-identical.
"""

import io

import numpy as np
import pytest
import torch

from tpu_vp9 import api as jax_api
from tpu_vp9 import config as jax_config
from tpu_vp9.bitstream.ivf import write_ivf_frame, write_ivf_header
from tpu_vp9.decoder.decoder import decode_ivf
from tpu_vp9.pipeline.realtime import RtSession as JaxSession

from tpu_vp9_torch import api as port_api
from tpu_vp9_torch import config as port_config
from tpu_vp9_torch.decoder.decoder import decode_ivf as port_decode_ivf
from tpu_vp9_torch.pipeline import realtime as port_realtime
from tpu_vp9_torch.pipeline.realtime import RtSession as PortSession
from tpu_vp9_torch.utils.yuv import panning_frames, synthetic_frames

torch.set_num_threads(1)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


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


@pytest.mark.parametrize("w,h,n,qindex,ip", [
    (128, 96, 4, 110, -1),   # aligned 32 grid
    (160, 120, 3, 120, -1),  # mi_rows % 4 == 3: the overhang row (1080p)
    (96, 64, 3, 100, -1),    # width % 64 == 32: padded-width loop filter
    (96, 64, 5, 110, 1),     # a keyframe every other frame
], ids=["aligned", "overhang", "odd_64_width", "keyframe_interval"])
def test_port_session_matches_jax_session(w, h, n, qindex, ip):
    frames = list(panning_frames(w, h, n, seed=w + h))
    jsess = JaxSession(w, h, want_recon=True, intra_period=ip)
    psess = PortSession(w, h, device="cpu", want_recon=True, intra_period=ip)
    jsess._kstep = psess._kstep = None  # the host keyframe on both sides
    jefs = _run(jsess, frames, qindex)
    pefs = _run(psess, frames, qindex)

    dec = _decode(pefs, w, h)
    assert len(dec) == n
    for i, ((y, u, v, _), ef) in enumerate(zip(dec, pefs)):
        st = ef.state
        for p, plane in enumerate((y, u, v)):
            np.testing.assert_array_equal(
                plane, st.planes[p].recon[:plane.shape[0], :plane.shape[1]],
                err_msg=f"frame {i} plane {p}")

    keys = [e.is_keyframe for e in jefs]
    assert [e.is_keyframe for e in pefs] == keys
    assert keys == [ip < 0 and i == 0 or ip >= 0 and i % (ip + 1) == 0
                    for i in range(n)]
    pairs = list(zip(pefs, jefs))
    assert all(a.payload == b.payload for a, b in pairs if b.is_keyframe)
    same = sum(a.payload == b.payload for a, b in pairs if not b.is_keyframe)
    print(f"{w}x{h}: {same} of {n - sum(keys)} P packets byte-identical to "
          "JAX's")
    pbytes = sum(len(e.payload) for e in pefs)
    jbytes = sum(len(e.payload) for e in jefs)
    assert abs(pbytes - jbytes) <= 0.01 * jbytes
    jdec = _decode(jefs, w, h)
    p_psnr = np.mean([_psnr(d[0], f.y) for d, f in zip(dec, frames)])
    j_psnr = np.mean([_psnr(d[0], f.y) for d, f in zip(jdec, frames)])
    assert abs(p_psnr - j_psnr) <= 0.05
    assert p_psnr > 30


def _port_decode_exact(efs, w, h):
    """Decode with the port's decoder; every plane bit-exact to the
    port's recon."""
    buf = io.BytesIO()
    write_ivf_header(buf, w, h, 30, 1, len(efs))
    for i, ef in enumerate(efs):
        write_ivf_frame(buf, ef.payload, i)
    buf.seek(0)
    dec = list(port_decode_ivf(buf))
    assert len(dec) == len(efs)
    for i, ((y, u, v, _), ef) in enumerate(zip(dec, efs)):
        for p, plane in enumerate((y, u, v)):
            np.testing.assert_array_equal(
                plane, ef.state.planes[p].recon[:plane.shape[0],
                                                :plane.shape[1]],
                err_msg=f"frame {i} plane {p}")


@pytest.mark.parametrize("n,ip", [(4, -1), (5, 1)],
                         ids=["one_keyframe", "keyframe_every_other"])
def test_port_session_matches_jax_session_as_shipped(n, ip):
    """Both sessions with their device keyframes: every packet, keyframes
    included, byte-identical."""
    w, h = 128, 96
    frames = list(panning_frames(w, h, n, seed=w + h))
    jefs = _run(JaxSession(w, h, want_recon=True, intra_period=ip), frames,
                110)
    pefs = _run(PortSession(w, h, device="cpu", want_recon=True,
                            intra_period=ip), frames, 110)
    assert [e.is_keyframe for e in pefs] == [e.is_keyframe for e in jefs]
    assert sum(e.is_keyframe for e in pefs) == (1 if ip < 0 else 3)
    for i, (a, b) in enumerate(zip(pefs, jefs)):
        assert a.payload == b.payload, f"packet {i} differs from JAX's"
    _port_decode_exact(pefs, w, h)


def test_port_session_encodes_on_after_flush():
    """A flush drains the pipeline and leaves the session usable, as the
    JAX session's does: the frames sent after it continue the stream."""
    w, h = 128, 96
    frames = list(panning_frames(w, h, 5, seed=4))
    jsess = JaxSession(w, h, want_recon=True)
    psess = PortSession(w, h, device="cpu", want_recon=True)
    out = {}
    for name, sess in (("jax", jsess), ("port", psess)):
        efs = _run(sess, frames[:3], 110)
        for fr in frames[3:]:
            efs += sess.send(fr, qindex=110)
        efs += sess.flush()
        out[name] = efs
    psess.close()
    assert [e.pts for e in out["port"]] == list(range(5))
    assert [e.is_keyframe for e in out["port"]] == [True] + [False] * 4
    assert [e.payload for e in out["port"]] == [e.payload for e in out["jax"]]
    _port_decode_exact(out["port"], w, h)


def _api_packets(api, enc_mode, frames, forced=(), intra_period=-1, **kw):
    """Packets of a public encoder at ``enc_mode``, low-delay CQP, with a
    recon file named (as the realtime sessions then keep the recon);
    ``tpu_realtime=2`` makes the JAX encoder take its realtime session on
    CPU-JAX, as the port's always does. Frames whose index is in
    ``forced`` are sent with ``force_keyframe``."""
    enc = api.Vp9Encoder(**kw)
    config = jax_config if api is jax_api else port_config
    enc.set_parameter(config.EncoderConfig(
        source_width=128, source_height=96, enc_mode=enc_mode, qp=40,
        pred_structure=config.PredStructure.LOW_DELAY_P, tpu_realtime=2,
        intra_period=intra_period, recon_file="unused.yuv"))
    enc.init()
    assert enc._rt is not None
    for i, fr in enumerate(frames):
        enc.send_picture(fr, force_keyframe=i in forced)
    enc.flush()
    pkts = []
    while (pkt := enc.get_packet()) is not None:
        pkts.append(pkt)
    enc.close()
    return pkts


@pytest.mark.parametrize("enc_mode", [8, 9])
def test_public_encoder_matches_jax_encoder(enc_mode):
    """``tpu_vp9_torch.api.Vp9Encoder(device="cpu")`` against
    ``tpu_vp9.api.Vp9Encoder`` at enc_mode 8 and 9, four frames: identical
    packets."""
    frames = list(panning_frames(128, 96, 4, seed=11))
    port = _api_packets(port_api, enc_mode, frames, device="cpu")
    ref = _api_packets(jax_api, enc_mode, frames)
    assert [p.is_keyframe for p in port] == [True, False, False, False]
    assert [(p.pts, p.data) for p in port] == [(p.pts, p.data) for p in ref]


def test_public_encoder_keyframes_take_the_device_route(monkeypatch):
    """Every keyframe of the public encoder at enc_mode 9 goes through the
    session's device keyframe: the first frame, the intra period, a scene
    cut and a forced one; the packets are JAX's."""
    pan = list(panning_frames(128, 96, 7, seed=12))
    cut = list(synthetic_frames(128, 96, 1, seed=99))[0]
    frames = pan[:2] + [cut] + pan[3:]
    calls = []
    real = PortSession._encode_key_device

    def spy(self, frame, idx, qidx):
        calls.append(idx)
        return real(self, frame, idx, qidx)

    monkeypatch.setattr(PortSession, "_encode_key_device", spy)
    kw = dict(forced=(6,), intra_period=3)
    port = _api_packets(port_api, 9, frames, device="cpu", **kw)
    ref = _api_packets(jax_api, 9, frames, **kw)
    keys = [p.pts for p in port if p.is_keyframe]
    assert keys == calls
    # first frame, the scene cut, the intra period (idx % 4 == 0), forced
    assert {0, 2, 4, 6} <= set(keys)
    assert [(p.pts, p.data) for p in port] == [(p.pts, p.data) for p in ref]


@pytest.mark.parametrize("er", [False, True], ids=["fc_chain", "er"])
def test_port_session_python_serializer_matches_native(monkeypatch, er):
    """Without the native library the session classifies the modes and
    serializes in Python (``classify_and_fill_state``): same packets."""
    w, h = 128, 96
    frames = list(panning_frames(w, h, 4, seed=9))
    native = _run(PortSession(w, h, device="cpu", error_resilient=er),
                  frames, 110)
    monkeypatch.setattr(port_realtime, "serialize_device_frame",
                        lambda *a, **k: None)
    python = _run(PortSession(w, h, device="cpu", error_resilient=er),
                  frames, 110)
    assert [e.payload for e in python] == [e.payload for e in native]
    assert len(_decode(python, w, h)) == len(frames)


def test_port_session_refuses_unported_configurations():
    # a mesh is taken since the sharded step was ported: the CPU repeated
    sess = PortSession(128, 96, device="cpu", mesh_shape=(1, 2))
    assert sess._step.devices == [torch.device("cpu")] * 2
    sess.close()
    # the adaptive lambda (aq, with GOLDEN) is taken since it was ported
    sess = PortSession(128, 96, device="cpu", golden=True, aq=True)
    assert sess.aq
    sess.close()
    # a rate controller is taken, and the session serializes inline
    rc = object()
    sess = PortSession(128, 96, device="cpu", rc=rc)
    assert sess.rc is rc and not sess._ser_async and sess._ser_pool is None
    sess.close()
    # a strip geometry is taken (the descent off, as in the JAX session)
    strip = PortSession(128, 112, device="cpu", split16=True, golden=True)
    assert strip.g.strip and not strip.split16
    strip.close()
    with pytest.raises(ValueError):
        PortSession(100, 64, device="cpu")
