"""Random access through the port's public encoder, against the JAX one.

The encoder's default configuration (random access, hierarchical levels,
enc_mode 9, CQP) routes to ``DeviceRaSession`` in both packages:
  - ``tpu_vp9_torch.api.Vp9Encoder(device="cpu")`` at that configuration
    with 2 levels (mini-GOPs of 4), at enc_mode 9 and 8, against
    ``tpu_vp9.api.Vp9Encoder(tpu_realtime=2)``, on a key and one mini-GOP
    of 128x96: packets, pts and dts equal, decoded bit-exactly;
  - a scheduled keyframe inside a mini-GOP: the port codes the waiting
    frames first and every frame comes out; the JAX session leaves one
    behind and fails at ``flush``;
  - the random-access configurations that the JAX package sends to its
    host RA engine take the port's (``tests/test_torch_ra_host.py`` holds
    its packets against JAX's), a mesh among them.
The strip geometry's sessions are in ``tests/test_torch_ra_strip.py`` (a
file of their own, so that ``--dist loadfile`` runs their JAX compiles
beside this file's).
"""

import io

import numpy as np
import pytest
import torch

from tpu_vp9 import api as jax_api
from tpu_vp9 import config as jax_config
from tpu_vp9.pipeline.ra_device import DeviceRaSession as JaxRaSession

from tpu_vp9_torch import api as port_api
from tpu_vp9_torch import config as port_config
from tpu_vp9_torch.bitstream.ivf import write_ivf_frame, write_ivf_header
from tpu_vp9_torch.decoder.decoder import decode_ivf
from tpu_vp9_torch.pipeline import tpu_encdec as P
from tpu_vp9_torch.pipeline.ra_device import DeviceRaSession as PortRaSession
from tpu_vp9_torch.utils.yuv import synthetic_frames

torch.set_num_threads(1)

W, H = 128, 96


def _decode(pkts, w, h):
    buf = io.BytesIO()
    write_ivf_header(buf, w, h, 30, 1, len(pkts))
    for p in pkts:
        write_ivf_frame(buf, p.data, p.pts)
    buf.seek(0)
    return list(decode_ivf(buf))


def _api_packets(api, frames, **kw):
    """Packets of a public encoder at the default random-access
    configuration with 2 hierarchical levels, qp 40; ``tpu_realtime=2``
    makes the JAX encoder take its device session on CPU-JAX."""
    enc_mode = kw.pop("enc_mode")
    enc = api.Vp9Encoder(**kw)
    config = jax_config if api is jax_api else port_config
    enc.set_parameter(config.EncoderConfig(
        source_width=W, source_height=H, enc_mode=enc_mode, qp=40,
        hierarchical_levels=2, tpu_realtime=2))
    enc.init()
    assert enc._ra_dev is not None and enc._ra_dev.gop_len == 4
    for fr in frames:
        enc.send_picture(fr)
    enc.flush()
    pkts = []
    while (pkt := enc.get_packet()) is not None:
        pkts.append(pkt)
    enc.close()
    return pkts


@pytest.mark.parametrize("enc_mode", [9, 8])
def test_public_encoder_matches_jax_encoder(enc_mode):
    frames = list(synthetic_frames(W, H, 5, seed=3, motion=True))
    port = _api_packets(port_api, frames, device="cpu", enc_mode=enc_mode)
    ref = _api_packets(jax_api, frames, enc_mode=enc_mode)
    assert [p.pts for p in port] == list(range(5))
    assert [p.dts for p in port] == [-3, -2, -1, 0, 1]
    assert [p.is_keyframe for p in port] == [True] + [False] * 4
    assert [(p.pts, p.dts, p.is_keyframe, p.data) for p in port] == \
        [(p.pts, p.dts, p.is_keyframe, p.data) for p in ref]
    assert len(_decode(port, W, H)) == 5


def _session_packets(cls, frames, w, h, **kw):
    sess = cls(w, h, gop_len=4, base_qindex=120, **kw)
    pkts = []
    for f in frames:
        pkts += sess.push(f)
    return pkts, sess


def test_scheduled_keyframe_inside_a_minigop():
    """intra_period 5 with mini-GOPs of 4: the key at poc 6 comes while
    poc 5 waits for its mini-GOP. The port codes poc 5 first (a one-frame
    mini-GOP) and every frame comes out, decoding to the session's
    references; the JAX session never codes poc 5 and its flush looks for
    a frame that never came."""
    frames = list(synthetic_frames(W, H, 12, seed=3, motion=True))
    port, psess = _session_packets(PortRaSession, frames, W, H,
                                   device="cpu", intra_period=5)
    port += psess.flush()
    psess.close()
    assert [p.pts for p in port] == list(range(12))
    assert [p.pts for p in port if p.is_keyframe] == [0, 6]
    dec = _decode(port, W, H)
    b = P.BORDER
    for poc, planes in psess.planes_of.items():
        for k, plane in enumerate(planes):
            hh, ww = H >> (k > 0), W >> (k > 0)
            np.testing.assert_array_equal(
                np.asarray(dec[poc][k])[:hh, :ww],
                plane.numpy()[b:b + hh, b:b + ww])
    ref, jsess = _session_packets(JaxRaSession, frames, W, H,
                                  intra_period=5)
    assert 5 not in [p.pts for p in ref]
    with pytest.raises(KeyError):
        jsess.flush()


@pytest.mark.parametrize("kw", [
    dict(enc_mode=7),
    dict(tpu_realtime=0),
    dict(rate_control_mode=port_config.RateControlMode.VBR,
         target_bit_rate=200_000),
    dict(recon_file="recon.yuv"),
    dict(speed_control=True),
    dict(source_width=112),
], ids=["m7", "rt0", "vbr", "recon_file", "speed_control", "width_not_32"])
def test_host_ra_routes_are_taken(kw):
    """Refused until the host random-access engine was ported: each takes
    it (a width the device session rejects after its notice), with no
    device session."""
    enc = port_api.Vp9Encoder(device="cpu")
    enc.set_parameter(port_config.EncoderConfig(
        **{**dict(source_width=W, source_height=H, qp=40), **kw}))
    enc.init()
    assert enc._ra is not None and enc._ra_dev is None and enc._rt is None
    enc.close()


def test_host_ra_routes_stay_refused():
    """A mesh, refused until the sharded step was ported, takes the host
    RA engine: there is no device RA session over a mesh, in either
    package (``tests/test_torch_shard_session.py`` holds its packets
    against JAX's)."""
    enc = port_api.Vp9Encoder(device="cpu")
    enc.set_parameter(port_config.EncoderConfig(
        source_width=W, source_height=H, qp=40, tpu_mesh_shape=(1, 2)))
    enc.init()
    assert enc._ra is not None and enc._ra_dev is None and enc._rt is None
    enc.close()


def test_qp_overrides_at_init_stay_refused():
    """qp overrides set before ``init`` keep the stream off the device
    session, as in the JAX package: the host engine takes it and reads
    them."""
    enc = port_api.Vp9Encoder(device="cpu")
    enc.set_parameter(port_config.EncoderConfig(source_width=W,
                                                source_height=H))
    enc.set_frame_qp(3, 30)
    enc.init()
    assert enc._ra_dev is None and enc._ra is not None
    assert enc._qp_overridden(3) == port_api.qp_to_qindex(30)
