"""Bridge helpers for the embedded-interpreter C API (plugins/capi).

Keeps the C side free of numpy/dataclass details: pictures arrive as
contiguous plane bytes, packets leave as plain tuples.
"""

from __future__ import annotations

import numpy as np


def send_picture_bytes(enc, y: bytes, u: bytes, v: bytes, w: int, h: int,
                       force_keyframe: int) -> None:
    from tpu_vp9_torch.utils.yuv import Frame420

    cw, ch = (w + 1) // 2, (h + 1) // 2
    fr = Frame420(
        y=np.frombuffer(y, np.uint8).reshape(h, w).copy(),
        u=np.frombuffer(u, np.uint8).reshape(ch, cw).copy(),
        v=np.frombuffer(v, np.uint8).reshape(ch, cw).copy(),
    )
    enc.send_picture(fr, force_keyframe=bool(force_keyframe))


def get_packet_tuple(enc):
    p = enc.get_packet()
    if p is None:
        return None
    return (bytes(p.data), int(p.pts), int(p.dts),
            1 if p.is_keyframe else 0)
