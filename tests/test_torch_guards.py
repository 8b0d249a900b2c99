"""Guards of the port: no jax, no silent CPU fallback, refused routes."""

import os
import pkgutil
import subprocess
import sys
import textwrap

import pytest
import torch

import tpu_vp9_torch
from tpu_vp9.config import EncoderConfig, PredStructure, RateControlMode

from tpu_vp9_torch import api as port_api

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# an import hook that makes any import of jax fail
_BLOCK_JAX = textwrap.dedent("""
    import sys

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError("jax is blocked in this process")
            return None

    sys.meta_path.insert(0, _NoJax())
""")


def _run(code, env_extra=None, timeout=300):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        tpu_vp9_torch.__path__, "tpu_vp9_torch."))


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    for m in ("ops.cuda_kernels", "ops.txfm", "pipeline.tpu_encdec",
              "pipeline.realtime", "app"):
        assert f"tpu_vp9_torch.{m}" in mods
    code = _BLOCK_JAX + textwrap.dedent(f"""
        import importlib
        for m in {mods!r}:
            importlib.import_module(m)
        assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules)
        # the TPU package's step and session import jax: never reused
        for m in ("tpu_vp9.pipeline.realtime", "tpu_vp9.pipeline.tpu_encdec",
                  "tpu_vp9.ops.pallas_kernels"):
            assert m not in sys.modules, m
        print("imported", len({mods!r}))
    """)
    res = _run(code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert f"imported {len(mods)}" in res.stdout


def test_port_encode_runs_without_jax():
    """A 720p P-frame reaches the device search (on the CPU here) in a
    process where jax cannot be imported."""
    code = _BLOCK_JAX + textwrap.dedent("""
        import torch
        torch.set_num_threads(1)
        from tpu_vp9.config import EncoderConfig, PredStructure, RateControlMode
        from tpu_vp9_torch.api import Vp9Encoder
        from tpu_vp9_torch.codec import inter_frame
        from tpu_vp9_torch.utils.yuv import panning_frames

        calls = []
        real = inter_frame.tpu_block_motion
        inter_frame.tpu_block_motion = lambda *a: calls.append(1) or real(*a)
        enc = Vp9Encoder(device="cpu")
        enc.set_parameter(EncoderConfig(
            source_width=1280, source_height=720, enc_mode=7, qp=50,
            pred_structure=PredStructure.LOW_DELAY_P))
        enc.init()
        for fr in panning_frames(1280, 720, 2):
            enc.send_picture(fr)
        enc.flush()
        assert len(calls) == 1
        assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules)
        print("encoded", sum(len(enc.get_packet().data) for _ in range(2)))
    """)
    res = _run(code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "encoded" in res.stdout


def test_port_m9_encode_runs_without_jax():
    """A 128x96 M9 encode through the public API runs the port's realtime
    session on device="cpu" in a process where jax cannot be imported."""
    code = _BLOCK_JAX + textwrap.dedent("""
        import torch
        torch.set_num_threads(1)
        from tpu_vp9.config import EncoderConfig, PredStructure, RateControlMode
        from tpu_vp9_torch.api import Vp9Encoder
        from tpu_vp9_torch.pipeline import realtime
        from tpu_vp9_torch.utils.yuv import panning_frames

        enc = Vp9Encoder(device="cpu")
        enc.set_parameter(EncoderConfig(
            source_width=128, source_height=96, enc_mode=9, qp=40,
            pred_structure=PredStructure.LOW_DELAY_P))
        enc.init()
        assert isinstance(enc._rt, realtime.RtSession)
        for fr in panning_frames(128, 96, 3):
            enc.send_picture(fr)
        enc.flush()
        pkts = [enc.get_packet() for _ in range(3)]
        assert enc.get_packet() is None
        assert [p.is_keyframe for p in pkts] == [True, False, False]
        assert not any(k == "jax" or k.startswith("jax.") for k in sys.modules)
        print("encoded", sum(len(p.data) for p in pkts))
    """)
    res = _run(code)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "encoded" in res.stdout


def _slice_cfg(**kw):
    base = dict(source_width=128, source_height=96, enc_mode=7, qp=40,
                pred_structure=PredStructure.LOW_DELAY_P)
    base.update(kw)
    return EncoderConfig(**base)


def test_default_device_without_cuda_fails_loudly(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc = port_api.Vp9Encoder()
    assert enc.device.type == "cuda"
    enc.set_parameter(_slice_cfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enc.init()


def test_app_without_cuda_fails_loudly(tmp_path):
    from tpu_vp9.utils.yuv import synthetic_frames, write_y4m

    clip = tmp_path / "clip.y4m"
    with open(clip, "wb") as fh:
        write_y4m(fh, synthetic_frames(128, 96, 2))
    res = subprocess.run(
        [sys.executable, "-m", "tpu_vp9_torch.app", "-i", str(clip), "-b",
         str(tmp_path / "out.ivf"), "-enc-mode", "7", "-pred-struct", "0",
         "-q", "40"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert "SUMMARY" not in res.stdout


def test_m9_without_cuda_fails_loudly(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc = port_api.Vp9Encoder()
    enc.set_parameter(_slice_cfg(enc_mode=9))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        enc.init()


@pytest.mark.parametrize("kw", [
    dict(pred_structure=PredStructure.RANDOM_ACCESS),
    dict(enc_mode=8),
    dict(enc_mode=9, tpu_realtime=0),
    dict(enc_mode=9, rate_control_mode=RateControlMode.VBR,
         target_bit_rate=200_000),
    dict(enc_mode=9, source_height=112),
    dict(enc_mode=9, source_width=112),
    dict(enc_mode=9, pred_structure=PredStructure.RANDOM_ACCESS),
    dict(speed_control=True),
    dict(tpu_mesh_shape=(1, 2)),
], ids=["random_access", "m8", "m9", "m9_vbr", "m9_strip",
        "m9_width_not_32", "m9_random_access", "speed_control", "mesh"])
def test_unported_routes_raise(kw):
    enc = port_api.Vp9Encoder(device="cpu")
    enc.set_parameter(_slice_cfg(**kw))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        enc.init()


@pytest.mark.parametrize("flags,why", [
    (["-gop-parallel", "2"], "-gop-parallel"),
    (["-nch", "2"], "-nch"),
    (["-distributed", "localhost:1234,2,0"], "-distributed"),
    (["-enc-mode", "9", "-pred-struct", "0", "-rt", "0"], "tpu_realtime 0"),
    (["-enc-mode", "8", "-pred-struct", "0"], "enc_mode 8"),
    ([], "random access"),
], ids=["gop_parallel", "nch", "distributed", "m9", "m8", "default_ra"])
def test_app_refuses_unported_options(tmp_path, flags, why):
    from tpu_vp9.utils.yuv import synthetic_frames, write_y4m

    clip = tmp_path / "clip.y4m"
    with open(clip, "wb") as fh:
        write_y4m(fh, synthetic_frames(128, 96, 1))
    res = subprocess.run(
        [sys.executable, "-m", "tpu_vp9_torch.app", "-i", str(clip),
         "-device", "cpu", *flags],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode != 0
    assert why in res.stderr


def test_app_encodes_m9_on_cpu_device(tmp_path):
    """The M9 CLI line, decoded back."""
    from tpu_vp9.decoder.decoder import decode_ivf
    from tpu_vp9.utils.yuv import synthetic_frames, write_y4m

    clip = tmp_path / "clip.y4m"
    out = tmp_path / "out.ivf"
    with open(clip, "wb") as fh:
        write_y4m(fh, synthetic_frames(128, 96, 3, motion=True))
    res = subprocess.run(
        [sys.executable, "-m", "tpu_vp9_torch.app", "-i", str(clip), "-b",
         str(out), "-enc-mode", "9", "-pred-struct", "0", "-q", "40",
         "-device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-2000:]
    assert "SUMMARY: 3 frames" in res.stdout
    with open(out, "rb") as fh:
        assert len(list(decode_ivf(fh))) == 3


def test_app_encodes_on_cpu_device(tmp_path):
    from tpu_vp9.decoder.decoder import decode_ivf
    from tpu_vp9.utils.yuv import synthetic_frames, write_y4m

    clip = tmp_path / "clip.y4m"
    out = tmp_path / "out.ivf"
    with open(clip, "wb") as fh:
        write_y4m(fh, synthetic_frames(128, 96, 3))
    res = subprocess.run(
        [sys.executable, "-m", "tpu_vp9_torch.app", "-i", str(clip), "-b",
         str(out), "-enc-mode", "7", "-pred-struct", "0", "-q", "40",
         "-device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": REPO})
    assert res.returncode == 0, res.stderr[-2000:]
    assert "SUMMARY: 3 frames" in res.stdout
    with open(out, "rb") as fh:
        assert len(list(decode_ivf(fh))) == 3
