"""The low-delay host route at enc_mode 8 and 9, against the TPU package's.

``tpu_vp9_torch.api.Vp9Encoder(device="cpu")`` against
``tpu_vp9.api.Vp9Encoder``, packets byte for byte, the port's stream
decoded bit-exactly to its recon:
  - enc_mode 8 and 9 at ``tpu_realtime=0`` (the host encode, each
    keyframe with the open-loop mode hints), 128x96, 5 frames at intra
    period 2, so that the second keyframe takes hints too;
  - geometries the realtime step rejects, 112x96 (width % 32) and 128x72
    (mi_rows % 4 == 1), at enc_mode 8 and 9: the port at the default
    ``tpu_realtime`` falls back to the host encode with the JAX package's
    notice, the JAX encoder at ``tpu_realtime=2`` (its own fallback under
    the tests' ``TPU_VP9_FORCE_HOST=1``); at ``tpu_realtime=1`` the port
    raises ``RuntimeError``;
  - speed control at enc_mode 7 on the host route, the controller made to
    step by a clock that both packages read (each read one second later):
    the mode steps to 8 at the first check (frame 8), the keyframe at
    frame 10 takes the hints.
"""

import io
import time

import numpy as np
import pytest
import torch

from tpu_vp9 import api as jax_api
from tpu_vp9 import config as jax_config

from tpu_vp9_torch import api as port_api
from tpu_vp9_torch import config as port_config
from tpu_vp9_torch.bitstream.ivf import write_ivf_frame, write_ivf_header
from tpu_vp9_torch.codec import intra_frame as port_intra_frame
from tpu_vp9_torch.decoder.decoder import decode_ivf
from tpu_vp9_torch.utils.yuv import synthetic_frames

torch.set_num_threads(1)


def _cfg(config, w, h, **kw):
    base = dict(source_width=w, source_height=h, qp=40, frame_rate=30,
                pred_structure=config.PredStructure.LOW_DELAY_P,
                recon_file="unused.yuv")
    base.update(kw)
    return config.EncoderConfig(**base)


def _encode(api, cfg, frames, modes=None, **kw):
    """(packets, the recon of each, the encoder); ``modes`` gets the speed
    controller's mode after each send."""
    enc = api.Vp9Encoder(**kw)
    enc.set_parameter(cfg)
    enc.init()
    assert enc._rt is None
    got = []
    emit = enc._emit

    def hook(pkt):
        emit(pkt)
        got.append((pkt, enc.get_recon()))

    enc._emit = hook
    for fr in frames:
        enc.send_picture(fr)
        if modes is not None:
            modes.append(enc._sc.mode)
    enc.flush()
    while enc.get_packet() is not None:
        pass
    assert [p.pts for p, _ in got] == list(range(len(frames)))
    return [p for p, _ in got], [r for _, r in got], enc


def _decode_exact(pkts, recons, w, h):
    buf = io.BytesIO()
    write_ivf_header(buf, w, h, 30, 1, len(pkts))
    for i, p in enumerate(pkts):
        write_ivf_frame(buf, p.data, i)
    buf.seek(0)
    dec = list(decode_ivf(buf))
    assert len(dec) == len(pkts)
    for i, ((y, u, v, _), rec) in enumerate(zip(dec, recons)):
        for p, (plane, want) in enumerate(zip((y, u, v), rec)):
            np.testing.assert_array_equal(plane, want,
                                          err_msg=f"frame {i} plane {p}")


@pytest.fixture
def hint_calls(monkeypatch):
    """The frame sizes the port's host keyframes compute hints for."""
    calls = []
    real = port_intra_frame.openloop_mode_hints_np

    def spy(plane, n, qindex):
        calls.append(plane.shape)
        return real(plane, n, qindex)

    monkeypatch.setattr(port_intra_frame, "openloop_mode_hints_np", spy)
    return calls


def _same(pkts, ref):
    assert len(pkts) == len(ref)
    for i, (a, b) in enumerate(zip(pkts, ref)):
        assert a.is_keyframe == b.is_keyframe and a.qindex == b.qindex, i
        assert a.data == b.data, f"packet {i} differs from JAX's"


@pytest.mark.parametrize("enc_mode", [8, 9])
def test_rt0_matches_jax(hint_calls, enc_mode):
    w, h, n = 128, 96, 5
    frames = list(synthetic_frames(w, h, n, seed=3, motion=True))
    kw = dict(enc_mode=enc_mode, tpu_realtime=0, intra_period=2)
    pkts, recons, _ = _encode(port_api, _cfg(port_config, w, h, **kw),
                              frames, device="cpu")
    assert hint_calls == [(h, w), (h, w)]  # the keyframes 0 and 3
    ref, _, _ = _encode(jax_api, _cfg(jax_config, w, h, **kw), frames)
    assert [p.is_keyframe for p in pkts] == [True, False, False, True, False]
    _same(pkts, ref)
    _decode_exact(pkts, recons, w, h)


@pytest.mark.parametrize("enc_mode", [8, 9])
@pytest.mark.parametrize("w,h,why", [(112, 96, "width % 32"),
                                     (128, 72, "mi_rows % 4 == 1")],
                         ids=["width_not_32", "mi_rows_4k_plus_1"])
def test_rejected_geometry_falls_back_as_jax(monkeypatch, hint_calls,
                                             enc_mode, w, h, why):
    notices = []
    monkeypatch.setattr(port_api, "notice", notices.append)
    frames = list(synthetic_frames(w, h, 5, seed=4, motion=True))
    pkts, recons, _ = _encode(port_api,
                              _cfg(port_config, w, h, enc_mode=enc_mode),
                              frames, device="cpu")
    assert len(notices) == 1 and why in notices[0]
    assert "falling back to host encode" in notices[0]
    assert hint_calls == [(h, w)]
    ref, _, _ = _encode(jax_api, _cfg(jax_config, w, h, enc_mode=enc_mode,
                                      tpu_realtime=2), frames)
    _same(pkts, ref)
    _decode_exact(pkts, recons, w, h)


def test_rejected_geometry_at_rt1_raises():
    """tpu_realtime=1 asks for the realtime session: a geometry it rejects
    raises RuntimeError naming the geometry, as in the JAX package."""
    enc = port_api.Vp9Encoder(device="cpu")
    enc.set_parameter(_cfg(port_config, 128, 72, enc_mode=8,
                           tpu_realtime=1))
    with pytest.raises(RuntimeError, match="128x72"):
        enc.init()


def test_speed_control_on_the_host_route_matches_jax(monkeypatch,
                                                     hint_calls):
    """Every read of the clock is one second after the last, so the
    controller (target 30 fps) steps up at each check, every 8 frames:
    enc_mode 7 to 8 after frame 7; the keyframe at frame 10 (intra period
    9) is the first to take hints. Both encoders see the same modes and
    write the same packets."""
    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    w, h, n = 128, 96, 12
    frames = list(synthetic_frames(w, h, n, seed=2, motion=True))
    kw = dict(enc_mode=7, speed_control=True, intra_period=9)
    modes, jax_modes = [], []
    pkts, recons, enc = _encode(port_api, _cfg(port_config, w, h, **kw),
                                frames, modes, device="cpu")
    assert modes == [7] * 7 + [8] * 5
    assert enc._sig.use_tpu_hints
    assert hint_calls == [(h, w)]
    ref, _, _ = _encode(jax_api, _cfg(jax_config, w, h, **kw), frames,
                        jax_modes)
    assert jax_modes == modes
    assert [p.is_keyframe for p in pkts] == [i in (0, 10) for i in range(n)]
    _same(pkts, ref)
    _decode_exact(pkts, recons, w, h)
