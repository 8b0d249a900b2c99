"""The port's slice end to end against the TPU package.

M7, LOW_DELAY_P, CQP at 1280x720 over three panning frames: the JAX
``Vp9Encoder`` with device motion search forced on (its CPU-JAX search is
``full_search_sse``) against the port's ``Vp9Encoder(device="cpu")`` (the
kernel's plain version). The packets must be byte-identical, and the
port's stream must decode with ``tpu_vp9.decoder`` to its own recon.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

from tpu_vp9.api import Vp9Encoder as JaxEncoder
from tpu_vp9.bitstream.ivf import write_ivf_frame, write_ivf_header
from tpu_vp9.config import (
    EncoderConfig, PredStructure, RateControlMode, Tune,
)
from tpu_vp9.decoder.decoder import decode_ivf

from tpu_vp9_torch import api as port_api
from tpu_vp9_torch.codec import inter_frame as port_inter
from tpu_vp9_torch.utils.yuv import panning_frames

torch.set_num_threads(1)

W, H, N = 1280, 720, 3


def _cfg():
    return EncoderConfig(source_width=W, source_height=H, enc_mode=7,
                         pred_structure=PredStructure.LOW_DELAY_P,
                         rate_control_mode=RateControlMode.CQP, qp=40,
                         frame_rate=30)


def _encode(enc, frames):
    pkts, recons = [], []
    for fr in frames:
        enc.send_picture(fr)
        pkts.append(enc.get_packet())
        recons.append(enc.get_recon())
    enc.flush()
    assert enc.get_packet() is None
    return pkts, recons


def test_port_slice_matches_jax_and_decodes(monkeypatch):
    frames = list(panning_frames(W, H, N, seed=1))

    jenc = JaxEncoder()
    jenc.set_parameter(_cfg())
    jenc.init()
    # the test config forces host ME on CPU-JAX; force the device search
    jenc._sig = dataclasses.replace(jenc._sig, use_tpu_me=True)
    jpkts, _ = _encode(jenc, frames)

    found = []
    real = port_inter.tpu_block_motion

    def spy(*args):
        mvs = real(*args)
        found.append(mvs)
        return mvs

    monkeypatch.setattr(port_inter, "tpu_block_motion", spy)
    penc = port_api.Vp9Encoder(device="cpu")
    penc.set_parameter(_cfg())
    penc.init()
    assert penc._sig.use_tpu_me
    ppkts, recons = _encode(penc, frames)

    assert len(found) == N - 1  # one device search per P-frame
    assert any(np.any(m != 0) for m in found)
    assert [p.is_keyframe for p in ppkts] == [True] + [False] * (N - 1)
    for jp, pp in zip(jpkts, ppkts):
        assert pp.data == jp.data
        assert (pp.pts, pp.dts, pp.qindex) == (jp.pts, jp.dts, jp.qindex)

    _assert_decodes_to(ppkts, recons, W, H)


def _assert_decodes_to(pkts, recons, w, h):
    buf = io.BytesIO()
    write_ivf_header(buf, w, h, 30, 1, len(pkts))
    for p in pkts:
        write_ivf_frame(buf, p.data, p.pts)
    buf.seek(0)
    dec = list(decode_ivf(buf))
    assert len(dec) == len(pkts)
    for (y, u, v, _), (ry, ru, rv) in zip(dec, recons):
        np.testing.assert_array_equal(y, ry)
        np.testing.assert_array_equal(u, ru)
        np.testing.assert_array_equal(v, rv)


SW, SH, SN = 128, 96, 5


@pytest.mark.parametrize("kw", [
    dict(),
    dict(intra_period=2),
    dict(error_resilient=True),
    dict(frame_parallel_decoding=True),
    dict(pred_structure=PredStructure.LOW_DELAY_B),
    dict(pred_structure=PredStructure.RANDOM_ACCESS, hierarchical_levels=0),
    dict(tune=Tune.SQ),
    dict(rate_control_mode=RateControlMode.VBR, target_bit_rate=200_000),
    dict(enc_mode=4),
    dict(enc_mode=6),
    dict(qp_file={2: 30, 3: 55}, force_key=(3,)),
], ids=["m7", "intra_period", "error_resilient", "fpdm", "ld_b", "ra_flat",
        "tune_sq", "vbr", "m4", "m6", "qp_file_force_key"])
def test_port_send_picture_matches_jax_host_branch(kw):
    """Below 1280x720 no device search runs: the port's send_picture must
    still take every branch of the JAX host path the same way."""
    kw = dict(kw)
    qp_file = kw.pop("qp_file", {})
    force_key = kw.pop("force_key", ())
    cfg = dict(source_width=SW, source_height=SH, enc_mode=7, qp=40,
               pred_structure=PredStructure.LOW_DELAY_P, frame_rate=30)
    cfg.update(kw)
    frames = list(panning_frames(SW, SH, SN, seed=2))
    out = []
    for enc in (JaxEncoder(), port_api.Vp9Encoder(device="cpu")):
        enc.set_parameter(EncoderConfig(**cfg))
        enc.init()
        for idx, qp in qp_file.items():
            enc.set_frame_qp(idx, qp)
        pkts, recons = [], []
        for idx, fr in enumerate(frames):
            enc.send_picture(fr, force_keyframe=idx in force_key)
            pkts.append(enc.get_packet())
            recons.append(enc.get_recon())
        enc.flush()
        out.append((pkts, recons))
    (jpkts, _), (ppkts, precons) = out
    assert [p.data for p in ppkts] == [p.data for p in jpkts]
    assert ([(p.pts, p.dts, p.qindex, p.is_keyframe) for p in ppkts]
            == [(p.pts, p.dts, p.qindex, p.is_keyframe) for p in jpkts])
    _assert_decodes_to(ppkts, precons, SW, SH)
