"""The port's random-access session at a strip geometry, against the JAX
package's.

128x112 (mi_rows 14: the bottom 16-pixel strip of 16x16 blocks; the
descent off there, as in the JAX package), ``synthetic_frames`` seed 8, 6
frames, mini-GOPs of 4: ``tpu_vp9_torch.pipeline.ra_device.
DeviceRaSession(device="cpu")`` against ``tpu_vp9.pipeline.ra_device.
DeviceRaSession`` on CPU-JAX, every packet byte-identical, the strip
zone searching ALTREF flat at +-40 (``sse_map_search`` and
``subpel_search`` on ALTREF's windows). A file of its own, so that
``--dist loadfile`` runs its JAX compiles beside the other RA files'.
"""

import io

import torch

from tpu_vp9.pipeline.ra_device import DeviceRaSession as JaxRaSession

from tpu_vp9_torch.bitstream.ivf import write_ivf_frame, write_ivf_header
from tpu_vp9_torch.decoder.decoder import decode_ivf
from tpu_vp9_torch.pipeline.ra_device import DeviceRaSession as PortRaSession
from tpu_vp9_torch.utils.yuv import synthetic_frames

torch.set_num_threads(1)


def _decode(pkts, w, h):
    buf = io.BytesIO()
    write_ivf_header(buf, w, h, 30, 1, len(pkts))
    for p in pkts:
        write_ivf_frame(buf, p.data, p.pts)
    buf.seek(0)
    return list(decode_ivf(buf))


def _session_packets(cls, frames, w, h, **kw):
    sess = cls(w, h, gop_len=4, base_qindex=120, **kw)
    pkts = []
    for f in frames:
        pkts += sess.push(f)
    return pkts + sess.flush(), sess


def test_strip_session_matches_jax_session():
    """128x112 (mi_rows 14: the bottom 16-pixel strip; the descent off),
    where the strip zone searches ALTREF flat at +-40."""
    w, h = 128, 112
    frames = list(synthetic_frames(w, h, 6, seed=8, motion=True))
    port, psess = _session_packets(PortRaSession, frames, w, h,
                                   device="cpu")
    psess.close()
    ref, _ = _session_packets(JaxRaSession, frames, w, h)
    assert psess.g.strip and psess.tally["split32"] == 0
    assert psess.tally["altref32"] > 0
    assert [p.pts for p in port] == list(range(6))
    assert [(p.pts, p.data) for p in port] == [(p.pts, p.data) for p in ref]
    assert len(_decode(port, w, h)) == 6
