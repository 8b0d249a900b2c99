"""Synthetic test content with global motion.

``tpu_vp9.utils.yuv.synthetic_frames`` moves one flat box over a static
background, so most full-pel vectors are zero. A pan moves every block:
the motion search has a nonzero answer everywhere.
"""

from __future__ import annotations

import numpy as np

from tpu_vp9.utils.yuv import Frame420


def _box(a: np.ndarray, k: int) -> np.ndarray:
    """k x k box sums; the result is k pixels smaller on each axis."""
    c = np.cumsum(np.cumsum(a, axis=0), axis=1)
    return c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]


def _texture(h: int, w: int, rng, lo: int, hi: int) -> np.ndarray:
    """Smooth random texture in [lo, hi]: uniform noise through two
    15x15 box blurs (about a tent of 30 pixels)."""
    k = 15
    box = _box(_box(rng.random((h + 2 * k, w + 2 * k)), k), k)
    box = (box - box.min()) / max(box.max() - box.min(), 1e-9)
    return (lo + box[:h, :w] * (hi - lo)).astype(np.uint8)


def panning_frames(width: int, height: int, num_frames: int, seed: int = 0,
                   step=(2, 4)):
    """Frames cut from one textured canvas that pans by ``step`` = (dy, dx)
    luma pixels per frame (even, so chroma pans by whole pixels too)."""
    sy, sx = step
    if sy % 2 or sx % 2:
        raise ValueError(f"pan step {step} must be even")
    rng = np.random.default_rng(seed)
    span_y, span_x = abs(sy) * num_frames, abs(sx) * num_frames
    ch, cw = (height + 1) // 2, (width + 1) // 2
    y = _texture(height + span_y, width + span_x, rng, 16, 235)
    u = _texture(ch + span_y // 2, cw + span_x // 2, rng, 64, 192)
    v = _texture(ch + span_y // 2, cw + span_x // 2, rng, 64, 192)
    oy = span_y if sy > 0 else 0
    ox = span_x if sx > 0 else 0
    for t in range(num_frames):
        y0, x0 = oy - sy * t, ox - sx * t
        yield Frame420(
            y=y[y0:y0 + height, x0:x0 + width].copy(),
            u=u[y0 // 2:y0 // 2 + ch, x0 // 2:x0 // 2 + cw].copy(),
            v=v[y0 // 2:y0 // 2 + ch, x0 // 2:x0 // 2 + cw].copy())
