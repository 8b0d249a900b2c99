"""Hierarchical motion estimation (HME) — coarse-to-fine full-pel search.

The reference's ME kernel runs a 3-level HME (EbMotionEstimationProcess.c:
hme level0/1/2 over decimated pictures) so large search areas stay cheap.
Same idea here: a 2x/4x box-downsampled pyramid per reference plane; the
quarter-res level covers the full search area, each finer level refines
±REFINE around the upscaled coarse vector.  All levels reuse the native
SAD kernel through ops.me.full_pel_search.
"""

from __future__ import annotations

import numpy as np

from tpu_vp9_torch.ops import me as me_ops

REFINE = 2  # per-level refinement radius after upscaling


def downsample2x(plane: np.ndarray) -> np.ndarray:
    """2x2 box average with rounding; odd trailing row/col replicated."""
    h, w = plane.shape
    if h & 1:
        plane = np.concatenate([plane, plane[-1:]], axis=0)
        h += 1
    if w & 1:
        plane = np.concatenate([plane, plane[:, -1:]], axis=1)
        w += 1
    p = plane.astype(np.uint16)
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    return ((s + 2) >> 2).astype(np.uint8)


def build_pyramid(ref_padded: np.ndarray):
    """(full, half, quarter) planes; the bordered layout survives the
    downsampling (border b -> b/2 -> b/4), so plane coords just scale."""
    half = downsample2x(ref_padded)
    quarter = downsample2x(half)
    return (ref_padded, half, quarter)


def hme_search(src_block: np.ndarray, pyramid, px: int, py: int,
               border: int, total_range: int, center=(0, 0)):
    """Full-pel HME: quarter-res sweep of ±total_range/4, then ±REFINE
    refinements at half and full resolution.

    Returns (dy, dx, sad) in full-res full-pel units, like
    full_pel_search.  Falls back to a direct search for blocks too small
    to downsample twice.
    """
    n = min(src_block.shape)
    if n < 8 or total_range < 16:
        return me_ops.full_pel_search(src_block, pyramid[0], px, py,
                                      border, total_range, center)
    src_h = downsample2x(src_block)
    src_q = downsample2x(src_h)
    # L2: quarter res, centered on the scaled predictor
    c2 = (int(np.round(center[0] / 4)), int(np.round(center[1] / 4)))
    dy2, dx2, _ = me_ops.full_pel_search(
        src_q, pyramid[2], px >> 2, py >> 2, border >> 2,
        max(total_range >> 2, REFINE), c2)
    # L1: half res around the upscaled L2 vector
    dy1, dx1, _ = me_ops.full_pel_search(
        src_h, pyramid[1], px >> 1, py >> 1, border >> 1,
        REFINE, (dy2 * 2, dx2 * 2))
    # L0: full res around the upscaled L1 vector
    return me_ops.full_pel_search(
        src_block, pyramid[0], px, py, border, REFINE, (dy1 * 2, dx1 * 2))
