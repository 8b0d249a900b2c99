"""The host random-access engine through the port's public encoder, against
the JAX package's.

``tpu_vp9_torch.api.Vp9Encoder(device="cpu")`` against
``tpu_vp9.api.Vp9Encoder`` on the same frames from a seed, both on their
host random-access engine (``pipeline/gop.py``, ``RaEncoder``): packets,
pts, dts and qindexes equal byte for byte, and the port's stream decoded
by ``tpu_vp9_torch.decoder`` bit-exactly to the engine's recon of each
poc (``RaEncoder.keep_recon``). At enc_mode 8 and 9 the JAX encoder takes
its host engine under the tests' ``TPU_VP9_FORCE_HOST=1`` unless
``tpu_realtime`` is 1 or 2, so the port runs at ``tpu_realtime=0`` there:
  - M8 at 96x80, 17 frames, 4 levels; M7; M5 (qpm, the adaptive-partition
    budget); M3 (part_depths, compound prediction); M0 at 64x64 on 5
    frames with 2 levels (full RDO); error resilient;
  - intra period 7 with a forced keyframe and a scene cut inside mini-GOPs;
  - VBR with the lookahead window's scales (the controller's end state
    equal too); qp overrides set before ``init``; speed control, with a
    clock that both packages read;
  - C7's random-access half: 112x96 (width % 32) and 128x72
    (mi_rows % 4 == 1) at M8 and the default ``tpu_realtime`` fall back
    from the device session to the host engine with the JAX package's
    notice;
  - ``LookaheadWindow`` against JAX's on the same pushes and drops;
  - the engine hands the encoder's device to ``encode_pframe``.
"""

import io
import time

import numpy as np
import pytest
import torch

from tpu_vp9 import api as jax_api
from tpu_vp9 import config as jax_config
from tpu_vp9.pipeline.lookahead import LookaheadWindow as JaxWindow

from tpu_vp9_torch import api as port_api
from tpu_vp9_torch import config as port_config
from tpu_vp9_torch.bitstream.ivf import write_ivf_frame, write_ivf_header
from tpu_vp9_torch.decoder.decoder import decode_ivf
from tpu_vp9_torch.pipeline.lookahead import LookaheadWindow as PortWindow
from tpu_vp9_torch.utils.yuv import synthetic_frames

torch.set_num_threads(1)


def _cfg(config, w, h, **kw):
    base = dict(source_width=w, source_height=h, qp=40, frame_rate=30,
                enc_mode=8, tpu_realtime=0)
    base.update(kw)
    return config.EncoderConfig(**base)


def _encode(api, cfg, frames, keys=(), qp=None, modes=None, **kw):
    """(packets, the encoder): every frame sent (``keys`` forced), flushed
    and drained; ``qp`` {frame: qp} set before ``init``; ``modes`` gets
    the speed controller's mode after each send."""
    enc = api.Vp9Encoder(**kw)
    enc.set_parameter(cfg)
    for idx, q in (qp or {}).items():
        enc.set_frame_qp(idx, q)
    enc.init()
    assert enc._ra is not None and enc._ra_dev is None
    enc._ra.keep_recon = True
    for i, fr in enumerate(frames):
        enc.send_picture(fr, force_keyframe=i in keys)
        if modes is not None:
            modes.append(enc._sc.mode)
    enc.flush()
    pkts = []
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
    assert sorted(p.pts for p in pkts) == list(range(len(frames)))
    return pkts, enc


def _same(pkts, ref):
    assert len(pkts) == len(ref)
    for i, (a, b) in enumerate(zip(pkts, ref)):
        assert (a.pts, a.dts, a.is_keyframe, a.qindex) == \
            (b.pts, b.dts, b.is_keyframe, b.qindex), i
        assert a.data == b.data, f"packet {i} (pts {a.pts}) differs"


def _decode_exact(pkts, enc, w, h):
    """Each packet shows one frame: decoded, it equals the engine's recon
    of that poc."""
    buf = io.BytesIO()
    write_ivf_header(buf, w, h, 30, 1, len(pkts))
    for p in pkts:
        write_ivf_frame(buf, p.data, p.pts)
    buf.seek(0)
    dec = list(decode_ivf(buf))
    assert len(dec) == len(pkts)
    log = enc._ra.recon_log
    for p, (y, u, v, _) in zip(pkts, dec):
        for k, (plane, want) in enumerate(zip((y, u, v), log[p.pts])):
            np.testing.assert_array_equal(
                plane, want, err_msg=f"poc {p.pts} plane {k}")


def _check(w, h, n, seed=3, keys=(), qp=None, cut_at=None, **kw):
    frames = list(synthetic_frames(w, h, n, seed=seed, motion=True))
    if cut_at is not None:
        rng = np.random.default_rng(99)
        for fr in frames[cut_at:]:
            fr.y[:] = rng.integers(0, 255, fr.y.shape)
    pkts, enc = _encode(port_api, _cfg(port_config, w, h, **kw), frames,
                        keys, qp, device="cpu")
    ref, jenc = _encode(jax_api, _cfg(jax_config, w, h, **kw), frames,
                        keys, qp)
    _same(pkts, ref)
    _decode_exact(pkts, enc, w, h)
    return pkts, enc, jenc


@pytest.mark.parametrize("enc_mode,kw", [
    (8, dict(hierarchical_levels=4)),
    (7, dict(hierarchical_levels=3)),
    (5, dict(hierarchical_levels=2)),
    (3, dict(hierarchical_levels=2)),
    (8, dict(hierarchical_levels=3, error_resilient=True)),
], ids=["m8_rt0", "m7", "m5_qpm", "m3_part_depths", "m8_error_resilient"])
def test_host_ra_matches_jax(enc_mode, kw):
    n = 17 if enc_mode == 8 and not kw.get("error_resilient") else 9
    pkts, enc, _ = _check(96, 80, n, enc_mode=enc_mode, **kw)
    gop = 1 << kw["hierarchical_levels"]
    # a key, then mini-GOPs of 2^levels whose ALTREFs ride superframes
    assert [p.is_keyframe for p in pkts] == [True] + [False] * (n - 1)
    assert pkts[0].dts == 1 - gop
    assert enc._sig.qpm == (enc_mode <= 5)
    if enc_mode == 3:
        assert enc._sig.part_depths is not None


def test_host_ra_m0_matches_jax():
    """Full RDO (enc_mode 0) on a key and one mini-GOP of 4."""
    pkts, enc, _ = _check(64, 64, 5, enc_mode=0, hierarchical_levels=2)
    assert [p.is_keyframe for p in pkts] == [True] + [False] * 4


def test_host_ra_keys_inside_mini_gops_match_jax():
    """Intra period 7 with 4 levels: the scheduled keys at 8 and 16 cut
    mini-GOPs short; a forced key at 3 and a scene cut at 12 cut them
    again."""
    pkts, _, _ = _check(96, 80, 18, seed=4, keys=(3,), cut_at=12,
                        enc_mode=8, intra_period=7, hierarchical_levels=4)
    keys = sorted(p.pts for p in pkts if p.is_keyframe)
    assert keys == [0, 3, 8, 12, 16]


def test_host_ra_vbr_matches_jax():
    """VBR: the lookahead window's scales before each mini-GOP, the
    controller's qindex per frame and its end state equal."""
    pkts, enc, jenc = _check(
        96, 80, 17, enc_mode=8, hierarchical_levels=3, intra_period=15,
        rate_control_mode=port_config.RateControlMode.VBR,
        target_bit_rate=150_000)
    assert len({p.qindex for p in pkts if not p.is_keyframe}) > 1
    assert enc._la.distance == jenc._la.distance == 17
    assert enc._rc.la_scale == jenc._rc.la_scale
    assert vars(enc._rc).keys() == vars(jenc._rc).keys()
    for k, v in vars(jenc._rc).items():
        if k != "cfg":
            assert repr(getattr(enc._rc, k)) == repr(v), k


def test_host_ra_qp_overrides_match_jax():
    """qp overrides set before ``init``: the key's qindex and a mini-GOP's
    base qindex (its layer ladder still applied)."""
    pkts, _, _ = _check(96, 80, 9, qp={0: 30, 1: 50}, enc_mode=8,
                        hierarchical_levels=3)
    assert pkts[0].qindex == port_api.qp_to_qindex(30)


def test_host_ra_speed_control_matches_jax(monkeypatch):
    """Every read of the clock is one second after the last: a send that
    completes a mini-GOP reports its packets in one second, so the
    controller (target 30 fps) steps enc_mode 7 to 8 once 8 frames are
    counted (the send of frame 8) and the next mini-GOPs take M8's
    signals. Both encoders see the same modes and write the same
    packets."""
    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    modes, jax_modes = [], []
    w, h, n = 96, 80, 13
    frames = list(synthetic_frames(w, h, n, seed=2, motion=True))
    kw = dict(enc_mode=7, speed_control=True, hierarchical_levels=2)
    pkts, enc = _encode(port_api, _cfg(port_config, w, h, **kw), frames,
                        modes=modes, device="cpu")
    ref, _ = _encode(jax_api, _cfg(jax_config, w, h, **kw), frames,
                     modes=jax_modes)
    assert modes == jax_modes == [7] * 8 + [8] * 5
    assert enc._ra.sig is enc._sig and enc._sig.use_tpu_hints
    _same(pkts, ref)
    _decode_exact(pkts, enc, w, h)


@pytest.mark.parametrize("w,h,why", [(112, 96, "width % 32"),
                                     (128, 72, "mi_rows % 4 == 1")],
                         ids=["width_not_32", "mi_rows_4k_plus_1"])
def test_rejected_geometry_falls_back_to_the_host_engine(monkeypatch, w, h,
                                                         why):
    """C7's random-access half: at the default tpu_realtime the device
    session rejects the geometry and the host engine takes it, with the
    JAX package's notice; the packets equal JAX's host engine's."""
    notices = []
    monkeypatch.setattr(port_api, "notice", notices.append)
    frames = list(synthetic_frames(w, h, 9, seed=5, motion=True))
    kw = dict(tpu_realtime=-1, hierarchical_levels=3)
    pkts, enc = _encode(port_api, _cfg(port_config, w, h, **kw), frames,
                        device="cpu")
    assert len(notices) == 1 and why in notices[0]
    assert notices[0].startswith("device RA session unavailable")
    assert notices[0].endswith("; host RA engine")
    ref, _ = _encode(jax_api, _cfg(jax_config, w, h, **kw), frames)
    _same(pkts, ref)
    _decode_exact(pkts, enc, w, h)


def test_rejected_geometry_at_rt1_falls_back_too(monkeypatch):
    """At tpu_realtime 1 the JAX package falls back to its host engine
    here as well (only its low-delay route raises): so does the port."""
    notices = []
    monkeypatch.setattr(port_api, "notice", notices.append)
    enc = port_api.Vp9Encoder(device="cpu")
    enc.set_parameter(_cfg(port_config, 128, 72, tpu_realtime=1))
    enc.init()
    assert enc._ra is not None and enc._ra_dev is None
    assert len(notices) == 1 and "host RA engine" in notices[0]


def test_lookahead_window_matches_jax():
    rng = np.random.default_rng(7)
    port, ref = PortWindow(5), JaxWindow(5)
    for poc in range(40):
        y = rng.integers(0, 256, (48, 64), dtype=np.uint8)
        if poc % 9 == 4:
            y[:] = 128  # a still frame
        port.push(poc, y)
        ref.push(poc, y)
        pocs = range(max(0, poc - 6), poc + 1)
        assert port.scales(pocs) == ref.scales(pocs)
        if poc % 4 == 3:
            port.drop(range(poc - 3, poc - 1))
            ref.drop(range(poc - 3, poc - 1))
        assert port._c == ref._c and port._run_avg == ref._run_avg
    assert PortWindow(0).distance == JaxWindow(0).distance == 1
    assert PortWindow(0).scales([0]) == {}


def test_ra_encoder_runs_the_search_on_the_encoder_s_device(monkeypatch):
    """The engine hands the encoder's device to every inter frame's
    ``encode_pframe``: an encoder built with device="cpu" never reaches
    for CUDA (the copy's call had none, and ``encode_pframe`` defaults to
    CUDA)."""
    from tpu_vp9_torch.pipeline import gop

    seen = []
    real = gop.encode_pframe

    def spy(*args, **kw):
        seen.append(kw.get("device"))
        return real(*args, **kw)

    monkeypatch.setattr(gop, "encode_pframe", spy)
    frames = list(synthetic_frames(64, 64, 5, seed=1, motion=True))
    pkts, enc = _encode(port_api, _cfg(port_config, 64, 64, enc_mode=7,
                                       hierarchical_levels=2),
                        frames, device="cpu")
    assert enc._ra.device == torch.device("cpu")
    assert seen == [torch.device("cpu")] * 4
    _decode_exact(pkts, enc, 64, 64)
