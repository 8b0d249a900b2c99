"""The port's open-loop keyframe hints (``pipeline/tpu_intra.py`` and the
plain version of the kernel ``openloop_modes``) against the TPU package's
``tpu_intra``, and the encoders that take them.

``openloop_refs`` (numpy and torch) equals the JAX function's (numpy and
``jnp``) at n = 32 and 16; ``openloop_mode_hints_np``, the public
encoder's numpy route (float32 predictions), equals the JAX package's,
cropped sizes included; ``decide_modes_openloop`` on a CPU plane (the
kernel's plain version) equals the jitted JAX function: modes, SSEs and
least costs, on random planes, a smooth gradient, a constant plane and a
plane whose blocks tie. ``encode_stream(use_tpu_hints=True)`` and
``encode_video`` at enc_mode 8 and 9 give the JAX package's packets byte
for byte, their keyframes through the port's hints; the JAX
``encode_video`` computes its hints only when its accelerator probe
answers, so the test makes ``tpu_alive`` answer True (nothing in the JAX
package changes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_vp9 import config as jax_config
from tpu_vp9.codec import intra_frame as jax_intra_frame
from tpu_vp9.pipeline import encoder as jax_encoder
from tpu_vp9.pipeline import tpu_intra as J
from tpu_vp9.utils import device as jax_device
from tpu_vp9.utils.yuv import Frame420 as JaxFrame

from tpu_vp9_torch import config as port_config
from tpu_vp9_torch.codec import intra_frame as port_intra_frame
from tpu_vp9_torch.ops import cuda_kernels as K
from tpu_vp9_torch.pipeline import encoder as port_encoder
from tpu_vp9_torch.pipeline import tpu_intra as P
from tpu_vp9_torch.utils.yuv import synthetic_frames

torch.set_num_threads(1)


def _plane(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w),
                                                dtype=np.uint8)


@pytest.mark.parametrize("n", [32, 16])
def test_openloop_refs_match_jax(n):
    plane = _plane(3 * n, 4 * n, n)
    want = J.openloop_refs(plane, n, np)
    want_j = J.openloop_refs(jnp.asarray(plane), n, jnp)
    got_np = P.openloop_refs(plane, n, np)
    got_t = P.openloop_refs(torch.from_numpy(plane), n, torch)
    names = ("above_ext", "above_left", "left", "have_above", "have_left")
    for name, w, wj, g, gt in zip(names, want, want_j, got_np, got_t):
        wj = np.asarray(wj)
        assert g.dtype == w.dtype == wj.dtype == gt.numpy().dtype, name
        np.testing.assert_array_equal(w, wj, err_msg=name)
        np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(gt.numpy(), w, err_msg=name)
    np.testing.assert_array_equal(P.extract_blocks(plane, n),
                                  J.extract_blocks(plane, n))


@pytest.mark.parametrize("qindex", [0, 100, 255])
@pytest.mark.parametrize("dims", [(96, 128), (72, 112), (64, 96)],
                         ids=["128x96", "112x72_cropped", "96x64"])
def test_openloop_mode_hints_np_matches_jax(dims, qindex):
    plane = _plane(*dims, seed=qindex + dims[1])
    got = port_intra_frame.openloop_mode_hints_np(plane, 32, qindex)
    want = jax_intra_frame.openloop_mode_hints_np(plane, 32, qindex)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _tie_plane():
    """Block (1, 1) has DC, V and TM tie at the least cost at qindex 45
    (see tests/test_torch_openloop_kernel.py)."""
    p = np.full((96, 96), 100, np.uint8)
    p[31:64, 63] = 101
    return p


def _gradient():
    y, x = np.mgrid[0:96, 0:128]
    return ((3 * x + 2 * y) % 256).astype(np.uint8)


@pytest.mark.parametrize("name,plane,qindex", [
    ("random_q0", _plane(96, 128, 1), 0),
    ("random_q120", _plane(64, 160, 2), 120),
    ("random_q255", _plane(128, 96, 3), 255),
    ("gradient", _gradient(), 60),
    ("constant", np.full((64, 64), 77, np.uint8), 255),
    ("ties", _tie_plane(), 45),
], ids=lambda v: v if isinstance(v, str) else "")
def test_decide_modes_openloop_matches_jax(name, plane, qindex):
    got = P.decide_modes_openloop(torch.from_numpy(plane), qindex)
    want = J.decide_modes_openloop(jnp.asarray(plane), jnp.asarray(qindex),
                                   32)
    for label, g, w in zip(("modes", "sse", "best"), got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.shape == w.shape, label
        np.testing.assert_array_equal(g.numpy(), w, err_msg=label)
    if name == "ties":
        cost = got[1][1, 1].long() + torch.tensor(K.KF_MODE_BIAS) * 32
        assert cost[0] == cost[1] == cost[9] == cost.min()
        assert int(got[0][1, 1]) == 0


def _jax_frames(frames):
    return [JaxFrame(y=f.y, u=f.u, v=f.v) for f in frames]


def _spy_hints(monkeypatch):
    """Count the port encoder's calls of the open-loop decision."""
    calls = []
    real = port_encoder.decide_modes_openloop

    def spy(plane, qindex, n=32):
        calls.append(plane.device.type)
        return real(plane, qindex, n)

    monkeypatch.setattr(port_encoder, "decide_modes_openloop", spy)
    return calls


def test_encode_stream_with_hints_matches_jax(monkeypatch):
    calls = _spy_hints(monkeypatch)
    frames = list(synthetic_frames(128, 96, 4, seed=5, motion=True))
    got = port_encoder.encode_stream(frames, qindex=110, intra_period=1,
                                     use_tpu_hints=True, device="cpu")
    want = jax_encoder.encode_stream(_jax_frames(frames), qindex=110,
                                     intra_period=1, use_tpu_hints=True)
    assert calls == ["cpu", "cpu"]  # the keyframes 0 and 2
    assert [e.is_keyframe for e in got] == [True, False, True, False]
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.payload == b.payload, f"packet {i} differs from JAX's"


@pytest.mark.parametrize("enc_mode", [8, 9])
def test_encode_video_matches_jax(monkeypatch, enc_mode):
    monkeypatch.setattr(jax_device, "tpu_alive", lambda *a, **k: True)
    calls = _spy_hints(monkeypatch)
    frames = list(synthetic_frames(128, 96, 4, seed=6, motion=True))
    kw = dict(source_width=128, source_height=96, enc_mode=enc_mode, qp=40,
              intra_period=2)
    got = port_encoder.encode_video(frames, port_config.EncoderConfig(**kw),
                                    device="cpu")
    want = jax_encoder.encode_video(_jax_frames(frames),
                                    jax_config.EncoderConfig(**kw))
    assert calls == ["cpu", "cpu"]  # the keyframes 0 and 3
    assert [e.is_keyframe for e in got] == [True, False, False, True]
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.payload == b.payload, f"packet {i} differs from JAX's"
