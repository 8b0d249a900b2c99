"""The port's M9 realtime session end to end against the TPU package's.

``tpu_vp9_torch.pipeline.realtime.RtSession(device="cpu")`` (the kernels'
plain versions) against ``tpu_vp9.pipeline.realtime.RtSession`` on
CPU-JAX, both with the host keyframe (the JAX session's device keyframe is
switched off by ``_kstep = None``), on the same panning frames. The
port's stream must decode with ``tpu_vp9.decoder`` bit-exactly to its own
recon; the keyframe packets must be byte-identical; the total bytes must
lie within 1% of JAX's and the mean Y PSNR within 0.05 dB (the forward
transform and the candidate costs are float in the TPU package, so a
P-frame may differ where a level or a choice sits on a rounding
boundary). The test prints how many P packets are byte-identical.
"""

import io

import numpy as np
import pytest
import torch

from tpu_vp9.bitstream.ivf import write_ivf_frame, write_ivf_header
from tpu_vp9.decoder.decoder import decode_ivf
from tpu_vp9.pipeline.realtime import RtSession as JaxSession

from tpu_vp9_torch.pipeline import realtime as port_realtime
from tpu_vp9_torch.pipeline.realtime import RtSession as PortSession
from tpu_vp9_torch.utils.yuv import panning_frames

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
    jsess._kstep = None  # the host keyframe, as the port encodes it
    jefs = _run(jsess, frames, qindex)
    pefs = _run(PortSession(w, h, device="cpu", want_recon=True,
                            intra_period=ip), frames, qindex)

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
    for kw in (dict(golden=True, aq=True), dict(mesh_shape=(1, 2)),
               dict(rc=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PortSession(128, 96, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="strip"):
        PortSession(128, 112, device="cpu")
    with pytest.raises(ValueError):
        PortSession(100, 64, device="cpu")
