"""Rate control (VBR and CBR) on the port's realtime session, against the
TPU package's.

``tpu_vp9_torch.api.Vp9Encoder(device="cpu")`` against
``tpu_vp9.api.Vp9Encoder`` (``tpu_realtime=2``: its realtime session on
CPU-JAX) in low delay at enc_mode 8 (CBR) and 9 (VBR), on 8 frames at
128x96 (the aligned 32 grid) and 160x120 (the overhang row): every
packet byte for byte, each packet's qindex, and the controller's state at
the end equal; the port's stream decodes bit-exactly to its recon. The
session holds the controller: it picks each frame's qindex before the
previous frame's bits are fed back (a lag of one frame, the JAX
package's), so a ``set_frame_qp`` override is overridden there too.
``encode_stream_rt`` with a controller is held to the JAX function.
"""

import io

import numpy as np
import pytest
import torch

from tpu_vp9 import api as jax_api
from tpu_vp9 import config as jax_config
from tpu_vp9.pipeline.rate_control import (
    RateControlState as JaxRateControlState,
)
from tpu_vp9.pipeline.realtime import encode_stream_rt as jax_encode_stream_rt

from tpu_vp9_torch import api as port_api
from tpu_vp9_torch import config as port_config
from tpu_vp9_torch.bitstream.ivf import write_ivf_frame, write_ivf_header
from tpu_vp9_torch.decoder.decoder import decode_ivf
from tpu_vp9_torch.pipeline.presets import qp_to_qindex
from tpu_vp9_torch.pipeline.rate_control import RateControlState
from tpu_vp9_torch.pipeline.realtime import encode_stream_rt
from tpu_vp9_torch.utils.yuv import synthetic_frames

torch.set_num_threads(1)

N_FRAMES, TBR = 8, 150_000
# the controller's state that the two packages must end with
RC_FIELDS = ("corr_key", "corr_inter", "buffer_level", "vbv_violations",
             "total_bits", "frames_coded", "vbr_bits_off_target")


def _cfg(config, w, h, enc_mode, rc_mode):
    return config.EncoderConfig(
        source_width=w, source_height=h, enc_mode=enc_mode, qp=40,
        pred_structure=config.PredStructure.LOW_DELAY_P, tpu_realtime=2,
        rate_control_mode=config.RateControlMode(rc_mode),
        target_bit_rate=TBR, frame_rate=30, recon_file="unused.yuv")


def _encode(api, cfg, frames, overrides=(), **kw):
    """Packets, the recon of each and the encoder's controller."""
    enc = api.Vp9Encoder(**kw)
    enc.set_parameter(cfg)
    for idx, qp in overrides:
        enc.set_frame_qp(idx, qp)
    enc.init()
    assert enc._rt is not None and enc._rt.rc is enc._rc
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
    assert [p.pts for p, _ in got] == list(range(len(frames)))
    return [p for p, _ in got], [r for _, r in got], enc._rc


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


def _same_rc(port_rc, jax_rc):
    for f in RC_FIELDS:
        assert getattr(port_rc, f) == getattr(jax_rc, f), f


@pytest.mark.parametrize("w,h", [(128, 96), (160, 120)],
                         ids=["aligned", "overhang"])
@pytest.mark.parametrize("enc_mode,rc_mode", [(8, 2), (9, 1)],
                         ids=["m8_cbr", "m9_vbr"])
def test_public_encoder_rc_matches_jax_encoder(w, h, enc_mode, rc_mode):
    frames = list(synthetic_frames(w, h, N_FRAMES, seed=3, motion=True))
    pkts, recons, prc = _encode(port_api,
                                _cfg(port_config, w, h, enc_mode, rc_mode),
                                frames, device="cpu")
    ref, _, jrc = _encode(jax_api, _cfg(jax_config, w, h, enc_mode,
                                        rc_mode), frames)
    assert [p.is_keyframe for p in pkts] == [True] + [False] * (N_FRAMES - 1)
    qidx = [p.qindex for p in pkts]
    assert qidx == [p.qindex for p in ref]
    assert len(set(qidx)) > 2, qidx  # the controller moved the qindex
    for i, (a, b) in enumerate(zip(pkts, ref)):
        assert a.data == b.data, f"packet {i} differs from JAX's"
    _same_rc(prc, jrc)
    assert prc.frames_coded == N_FRAMES  # fed once a frame, not twice
    _decode_exact([p.data for p in pkts], recons, w, h)
    print(f"{w}x{h} M{enc_mode}: qindex {qidx}, "
          f"{prc.total_bits / N_FRAMES * 30:.0f} b/s of {TBR}, "
          f"{prc.vbv_violations} VBV violations")


def test_qp_override_is_overridden_under_vbr():
    """A ``set_frame_qp`` override under VBR: the API hands the session
    its qindex, and the session's controller picks the frame's own, as in
    the JAX package."""
    w, h = 128, 96
    frames = list(synthetic_frames(w, h, N_FRAMES, seed=3, motion=True))
    over = ((3, 10), (5, 60))
    pkts, recons, prc = _encode(port_api, _cfg(port_config, w, h, 9, 1),
                                frames, over, device="cpu")
    ref, _, jrc = _encode(jax_api, _cfg(jax_config, w, h, 9, 1), frames,
                          over)
    assert [(p.qindex, p.data) for p in pkts] == [(p.qindex, p.data)
                                                 for p in ref]
    _same_rc(prc, jrc)
    for idx, qp in over:
        assert pkts[idx].qindex != qp_to_qindex(qp)
    _decode_exact([p.data for p in pkts], recons, w, h)


def test_encode_stream_rt_with_rc_matches_jax():
    """``encode_stream_rt(rc=...)`` with M8's flags at CBR against the JAX
    function: the same packets and qindexes, the same controller state,
    and the port's decode bit-exact to its recon."""
    w, h = 128, 96
    frames = list(synthetic_frames(w, h, N_FRAMES, seed=3, motion=True))
    prc = RateControlState.create(_cfg(port_config, w, h, 8, 2).derive())
    jrc = JaxRateControlState.create(_cfg(jax_config, w, h, 8, 2).derive())
    kw = dict(want_recon=True, split16=True, golden=True)
    pefs = encode_stream_rt(frames, rc=prc, device="cpu", **kw)
    jefs = jax_encode_stream_rt(frames, rc=jrc, **kw)
    assert [(e.qindex, e.payload) for e in pefs] == [(e.qindex, e.payload)
                                                    for e in jefs]
    assert len({e.qindex for e in pefs}) > 2
    _same_rc(prc, jrc)
    assert prc.frames_coded == N_FRAMES
    _decode_exact([e.payload for e in pefs],
                  [[e.state.planes[p].recon for p in range(3)]
                   for e in pefs], w, h)
