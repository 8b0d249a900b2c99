"""The port's realtime session: staged device input, the descent override,
the step helper and speed control.

  - staged ``(y, u, v)`` tuples from ``RtSession.stage`` give the packets
    of ``Frame420`` input (twice, and staged), which are the JAX session's;
    a staged keyframe is refused;
  - ``TPU_VP9_DESCEND_FRAC=1`` descends every parent; the port's stream
    decodes bit-exactly to its recon and equals the JAX session's up to
    the frame where the JAX recon leaves its own decode (the children of
    a GOLDEN parent, which the port repairs: ROADMAP Queue C);
  - ``measure_step_fps`` leaves the session's stream as it was;
  - speed control: the controller, and the public encoder in low delay,
    whose stream it leaves as it was (the session reads no preset), where
    the host route refuses it.
"""

import io

import pytest
import torch

from tpu_vp9.pipeline.realtime import RtSession as JaxSession

from tpu_vp9_torch import api as port_api
from tpu_vp9_torch.bitstream.ivf import write_ivf_frame, write_ivf_header
from tpu_vp9_torch.config import EncoderConfig, PredStructure
from tpu_vp9_torch.decoder.decoder import decode_ivf
from tpu_vp9_torch.pipeline import realtime as port_realtime
from tpu_vp9_torch.pipeline.realtime import RtSession as PortSession
from tpu_vp9_torch.pipeline.speed_control import SpeedControl
from tpu_vp9_torch.utils.yuv import synthetic_frames

torch.set_num_threads(1)

W, H = 128, 96
M8 = dict(split16=True, golden=True)
# the JAX session's first frame whose recon leaves its decode at the full
# descent on this clip (M8's flags, qindex 120), and its Y, U, V pixels
# that differ
DEFECT_FRAME, DEFECT_PIXELS = 7, (0, 51, 49)


def _run(sess, frames, qindex=120):
    out = []
    for fr in frames:
        out += sess.send(fr, qindex=qindex)
    out += sess.flush()
    assert [e.pts for e in out] == list(range(len(frames)))
    return out


def _decode(payloads):
    buf = io.BytesIO()
    write_ivf_header(buf, W, H, 30, 1, len(payloads))
    for i, p in enumerate(payloads):
        write_ivf_frame(buf, p, i)
    buf.seek(0)
    dec = list(decode_ivf(buf))
    assert len(dec) == len(payloads)
    return dec


def _mismatch(efs):
    """Pixels of each plane where the decode differs from the recon, per
    frame."""
    return [tuple(int((plane != e.state.planes[k].recon[:plane.shape[0],
                                                        :plane.shape[1]])
                      .sum()) for k, plane in enumerate((y, u, v)))
            for (y, u, v, _), e in zip(_decode([e.payload for e in efs]),
                                       efs)]


def test_staged_input_matches_frames_and_jax():
    """As ``test_rt_staged_input_and_async_ser_deterministic`` of the JAX
    package: Frame420 input twice and staged tuples give the same packets,
    and they are the JAX session's."""
    frames = list(synthetic_frames(W, H, 6, seed=12, motion=True))

    def run(staged):
        sess = PortSession(W, H, device="cpu", want_recon=True, **M8)
        out = sess.send(frames[0], qindex=120)
        for fr in frames[1:]:
            out += sess.send(sess.stage(fr) if staged else fr, qindex=120)
        out += sess.flush()
        sess.close()
        return [e.payload for e in out]

    a, b, c = run(False), run(False), run(True)
    assert a == b == c
    jax = _run(JaxSession(W, H, want_recon=True, **M8), frames)
    assert a == [e.payload for e in jax]


def test_staged_keyframe_and_malformed_tuples_are_refused():
    frames = list(synthetic_frames(W, H, 2, seed=12))
    sess = PortSession(W, H, device="cpu")
    with pytest.raises(ValueError, match="keyframe"):
        sess.send(sess.stage(frames[0]))
    sess.close()
    sess = PortSession(W, H, device="cpu")
    sess.send(frames[0])
    y, u, v = sess.stage(frames[1])
    for bad in ((y, u), (y, u, v[:, :-2]), (y.to(torch.int16), u, v),
                (y[:-2], u, v)):
        with pytest.raises(ValueError, match="stage"):
            sess.send(bad)
    sess.close()


def test_descend_frac_override_descends_every_parent(monkeypatch):
    frames = list(synthetic_frames(W, H, 8, seed=3, motion=True))
    monkeypatch.setenv("TPU_VP9_DESCEND_FRAC", "1")
    selected = []
    real = port_realtime._device_out_to_host

    def spy(outs, geom, want_recon):
        selected.append(outs["m16f"]["sel_idx"].numel())
        return real(outs, geom, want_recon)

    monkeypatch.setattr(port_realtime, "_device_out_to_host", spy)
    psess = PortSession(W, H, device="cpu", want_recon=True, **M8)
    pefs = _run(psess, frames)
    psess.close()
    assert selected == [psess.g.n_blocks32] * (len(frames) - 1)
    assert all(m == (0, 0, 0) for m in _mismatch(pefs))
    jefs = _run(JaxSession(W, H, want_recon=True, **M8), frames)
    jm = _mismatch(jefs)
    assert jm[:DEFECT_FRAME] == [(0, 0, 0)] * DEFECT_FRAME
    assert jm[DEFECT_FRAME] == DEFECT_PIXELS
    for i in range(DEFECT_FRAME):
        assert pefs[i].payload == jefs[i].payload, f"frame {i}"
    # at the default share a quarter of the parents descend
    monkeypatch.delenv("TPU_VP9_DESCEND_FRAC")
    selected.clear()
    _run(PortSession(W, H, device="cpu", **M8), frames[:3])
    assert selected == [psess.g.n_blocks32 // 4] * 2


@pytest.mark.parametrize("kw", [M8, {}], ids=["m8", "m9"])
def test_measure_step_fps_leaves_the_stream(kw):
    frames = list(synthetic_frames(W, H, 6, seed=4, motion=True))
    plain = _run(PortSession(W, H, device="cpu", **kw), frames)
    sess = PortSession(W, H, device="cpu", **kw)
    out = []
    for i, fr in enumerate(frames):
        if i == 3:
            fps = sess.measure_step_fps(frames[1], iters=2, qindex=160)
            assert fps > 0
        out += sess.send(fr, qindex=120)
    out += sess.flush()
    sess.close()
    assert [e.payload for e in out] == [e.payload for e in plain]
    with pytest.raises(RuntimeError, match="keyframe"):
        PortSession(W, H, device="cpu").measure_step_fps(frames[0])


def test_speed_control_steps_up_and_back():
    """As the JAX package's test of its controller."""
    sc = SpeedControl(target_fps=30.0, base_mode=4, check_every=4)
    changed = []
    for _ in range(16):
        m = sc.report(1, 0.1)
        if m is not None:
            changed.append(m)
    assert changed and changed[-1] > 4
    assert sc.mode <= 9
    for _ in range(64):
        sc.report(1, 0.001)
    assert sc.mode == 4
    for _ in range(32):
        sc.report(1, 0.0001)
    assert sc.mode == 4


def _ld_packets(enc_mode, frames, speed_control):
    enc = port_api.Vp9Encoder(device="cpu")
    enc.set_parameter(EncoderConfig(
        source_width=W, source_height=H, enc_mode=enc_mode, qp=40,
        frame_rate=120, pred_structure=PredStructure.LOW_DELAY_P,
        speed_control=speed_control))
    enc.init()
    assert enc._rt is not None and (enc._sc is not None) == speed_control
    for fr in frames:
        enc.send_picture(fr)
    enc.flush()
    pkts = []
    while (p := enc.get_packet()) is not None:
        pkts.append(p.data)
    sc = enc._sc
    enc.close()
    return pkts, sc


@pytest.mark.parametrize("enc_mode", [8, 9])
def test_speed_control_on_the_realtime_route(enc_mode):
    """At a 120 fps target the CPU falls behind: after 8 frames the
    controller steps M8 up to 9 (M9 is its ceiling already). The realtime
    session reads no preset, so the stream is the one without speed
    control, and it decodes."""
    frames = list(synthetic_frames(W, H, 9, seed=2, motion=True))
    with_sc, sc = _ld_packets(enc_mode, frames, True)
    without, _ = _ld_packets(enc_mode, frames, False)
    assert with_sc == without
    assert sc.mode == 9 and sc.base_mode == enc_mode
    assert len(_decode(with_sc)) == len(frames)


def test_speed_control_on_the_host_route_names_item_10():
    """Refused until item 10a (the keyframe hints) was ported: speed
    control at enc_mode 7 now runs on the host route, whose controller
    starts at the configured mode (tests/test_torch_host_route.py holds
    its stream to the JAX package's)."""
    enc = port_api.Vp9Encoder(device="cpu")
    enc.set_parameter(EncoderConfig(
        source_width=W, source_height=H, enc_mode=7, qp=40,
        pred_structure=PredStructure.LOW_DELAY_P, speed_control=True))
    enc.init()
    assert enc._rt is None and enc._sc.base_mode == 7 == enc._sc.mode
    enc.close()
