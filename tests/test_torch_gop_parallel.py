"""GOP-parallel encoding in the port: chunks in spawned workers equal the
sequential encode byte for byte (the CQP determinism oracle), and the
JAX package's ``encode_gop_parallel`` on the host random-access route.

At 96x80, enc_mode 8, intra period 7 (chunks of 8 frames), 20 frames:
  - the host random-access engine (``tpu_realtime=0``): 2 spawned workers
    against the port's sequential encode and JAX's chunked one, with a
    scene cut inside a chunk and one at a chunk boundary;
  - the device random-access session (the default ``tpu_realtime``)
    against the port's sequential encode only: at intra period 7 a key
    falls inside a 16-frame mini-GOP, where the JAX session leaves a
    frame behind;
  - low delay at ``tpu_realtime=0`` (128x96, intra period 3): 1 and 2
    workers alike and equal to JAX's chunks. Neither package's chunks
    equal its sequential encode here: a chunk's first keyframe reads its
    own picture as the previous one for its zz-staticness (the warm-up's
    last frame is the chunk's first), so its adaptive qindex differs;
    the test pins that;
  - the rejections: VBR and speed control;
  - the CLI: ``-gop-parallel 2`` writes the sequential bytes, ``-nch 2``
    two streams that decode.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_vp9 import config as jax_config
from tpu_vp9.pipeline.gop_parallel import encode_gop_parallel as jax_gop

from tpu_vp9_torch import api as port_api
from tpu_vp9_torch import config as port_config
from tpu_vp9_torch.decoder.decoder import decode_ivf
from tpu_vp9_torch.pipeline.gop_parallel import encode_gop_parallel
from tpu_vp9_torch.utils.yuv import synthetic_frames, write_y4m

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread_workers(monkeypatch):
    """Spawned workers start from a fresh interpreter: one intra-op
    thread each, as this process has, so that they do not oversubscribe
    the cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _cfg(config, **kw):
    base = dict(source_width=96, source_height=80, frame_rate=30, qp=45,
                enc_mode=8, intra_period=7, tpu_realtime=0)
    base.update(kw)
    return config.EncoderConfig(**base).derive()


def _frames(n, scene_cut_at=None, w=96, h=80, seed=4):
    frames = list(synthetic_frames(w, h, n, seed=seed, motion=True))
    if scene_cut_at is not None:
        rng = np.random.default_rng(99)
        for fr in frames[scene_cut_at:]:
            fr.y[:] = rng.integers(0, 255, fr.y.shape)
    return frames


def _sequential(frames, cfg):
    enc = port_api.Vp9Encoder(device="cpu")
    enc.set_parameter(cfg)
    enc.init()
    route = ("ra_dev" if enc._ra_dev is not None else
             "ra" if enc._ra is not None else "ld")
    for fr in frames:
        enc.send_picture(fr)
    enc.flush()
    out = []
    while (p := enc.get_packet()) is not None:
        out.append((p.data, p.pts, p.dts, p.is_keyframe, p.qindex))
    enc.close()
    return out, route


@pytest.mark.parametrize("cut", [None, 11, 8],
                         ids=["no_cut", "cut_mid_chunk", "cut_at_boundary"])
def test_host_ra_chunks_equal_sequential_and_jax(cut):
    frames = _frames(20, cut)
    cfg = _cfg(port_config)
    seq, route = _sequential(frames, cfg)
    assert route == "ra"
    reports = []
    par = encode_gop_parallel(frames, cfg, workers=2, device="cpu",
                              reports=reports)
    assert par == seq
    # three chunks, each a report of its own worker's (CPU) encode
    assert [r["start"] for r in reports] == [0, 8, 16]
    assert all(r["peak_bytes"] is None for r in reports)
    assert len({r["pid"] for r in reports} - {os.getpid()}) >= 1
    ref = jax_gop(frames, _cfg(jax_config), workers=1)
    assert [p[:2] for p in par] == [p[:2] for p in ref]
    assert par == [tuple(p) for p in ref]
    keys = [p[1] for p in par if p[3]]
    assert keys == ([0, 8, 16] if cut != 11 else [0, 8, 11, 16])


def test_device_ra_chunks_equal_sequential():
    """The device random-access session in each worker (mini-GOPs of 16,
    a key every 8 frames), equal to the port's own sequential encode."""
    frames = _frames(17)
    cfg = _cfg(port_config, tpu_realtime=-1)
    seq, route = _sequential(frames, cfg)
    assert route == "ra_dev"
    assert encode_gop_parallel(frames, cfg, workers=2, device="cpu") == seq


def test_low_delay_chunks_equal_sequential():
    frames = _frames(12, w=128, h=96, seed=8)
    cfg = _cfg(port_config, source_width=128, source_height=96, qp=52,
               intra_period=3,
               pred_structure=port_config.PredStructure.LOW_DELAY_P)
    seq, route = _sequential(frames, cfg)
    assert route == "ld"
    one = encode_gop_parallel(frames, cfg, workers=1, device="cpu")
    assert encode_gop_parallel(frames, cfg, workers=2, device="cpu") == one
    ref = jax_gop(frames, _cfg(jax_config, source_width=128,
                               source_height=96, qp=52, intra_period=3,
                               pred_structure=jax_config.PredStructure
                               .LOW_DELAY_P), workers=1)
    assert one == [tuple(p) for p in ref]
    # the first chunk is the sequential encode's; the second chunk's key
    # (frame 4) takes another qindex than the sequential one
    assert one[:4] == seq[:4]
    assert one[4][4] != seq[4][4] and one[4][3] and seq[4][3]


@pytest.mark.parametrize("kw", [
    dict(rate_control_mode=port_config.RateControlMode.VBR,
         target_bit_rate=200_000),
    dict(speed_control=True),
    dict(intra_period=-1),
], ids=["vbr", "speed_control", "no_intra_period"])
def test_rejections(kw):
    with pytest.raises(ValueError, match="GOP-parallel"):
        encode_gop_parallel(_frames(4), _cfg(port_config, **kw), workers=2,
                            device="cpu")


def _cli(tmp_path, flags, n=10):
    clip = tmp_path / "clip.y4m"
    with open(clip, "wb") as fh:
        write_y4m(fh, _frames(n))
    return subprocess.run(
        [sys.executable, "-m", "tpu_vp9_torch.app", "-i", str(clip),
         "-q", "45", "-enc-mode", "8", "-intra-period", "7", "-device",
         "cpu", *flags],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})


def test_cli_gop_parallel_writes_the_sequential_bytes(tmp_path):
    seq, par = tmp_path / "seq.ivf", tmp_path / "par.ivf"
    res = _cli(tmp_path, ["-b", str(seq)])
    assert res.returncode == 0, res.stderr[-2000:]
    res = _cli(tmp_path, ["-b", str(par), "-gop-parallel", "2"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "SUMMARY: 10 frames" in res.stdout
    assert "gop-parallel x2" in res.stdout
    assert par.read_bytes() == seq.read_bytes()


def test_cli_nch_writes_a_stream_per_channel(tmp_path):
    res = _cli(tmp_path, ["-b", str(tmp_path / "out.ivf"), "-nch", "2"],
               n=5)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.count("SUMMARY: 5 frames") == 2
    assert not (tmp_path / "out.ivf").exists()
    streams = [(tmp_path / f"out.ch{k}.ivf").read_bytes() for k in (0, 1)]
    assert streams[0] == streams[1]
    for k in (0, 1):
        with open(tmp_path / f"out.ch{k}.ivf", "rb") as fh:
            assert len(list(decode_ivf(fh))) == 5
