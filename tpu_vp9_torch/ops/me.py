"""Motion estimation kernels.

v1: vectorized full-pel exhaustive SAD search (numpy host; JAX batched
variant for the TPU path).  Mirrors the *capability* of the reference's
``full_pel_search_sb`` (``EbMotionEstimation.c:951``); the TPU design
batches all blocks x all candidate offsets instead of per-SB loops.
"""

from __future__ import annotations

import numpy as np


def full_pel_search(src_block, ref_padded, px: int, py: int, border: int,
                    search_range: int = 16, center=(0, 0)):
    """Exhaustive SAD over +-search_range around `center` (full-pel).

    src_block: (h, w) uint8 (rectangular blocks supported); ref_padded:
    border-extended reference plane; (px, py): block position in plane
    coords. center: full-pel (dy, dx).  Returns (best_dy, best_dx,
    best_sad) relative to (0,0) (absolute displacement incl. center).
    """
    h, w = src_block.shape
    r = search_range
    cy, cx = center
    # clamp the center so the search window stays inside the padded plane
    hp, wp = ref_padded.shape
    cy = int(np.clip(cy, r - border - py, hp - border - py - h - r))
    cx = int(np.clip(cx, r - border - px, wp - border - px - w - r))
    y0 = border + py + cy - r
    x0 = border + px + cx - r
    # strided VIEW into the padded plane: the native search takes a row
    # stride, so the per-call region copy (the dominant per-probe cost
    # of the M0-M4 partition descent) is unnecessary
    region = ref_padded[y0 : y0 + h + 2 * r, x0 : x0 + w + 2 * r]
    from tpu_vp9_torch.native import native_sad_search_rect

    res = native_sad_search_rect(src_block, region,
                                 ref_padded.strides[0], r)
    if res is not None:
        dy, dx, sad = res
        return cy + dy, cx + dx, sad
    src = src_block.astype(np.int32)
    # sliding windows via stride tricks (fallback)
    win = np.lib.stride_tricks.sliding_window_view(region, (h, w))
    sads = np.abs(win.astype(np.int32) - src[None, None]).sum(axis=(2, 3))
    idx = np.unravel_index(np.argmin(sads), sads.shape)
    best_dy = cy + int(idx[0]) - r
    best_dx = cx + int(idx[1]) - r
    return best_dy, best_dx, int(sads[idx])


def subpel_refine(src_block, ref_padded, px: int, py: int, border: int,
                  mv_full, filters, steps=(4, 2)):
    """Refine a full-pel mv at half- then quarter-pel (q3 units).

    Returns mv_q3 (row, col).  Uses the exact 8-tap interpolation so the
    cost reflects the real prediction.
    """
    from tpu_vp9_torch.native import native_subpel_refine_rect
    from tpu_vp9_torch.ops.inter import convolve8_2d

    res = native_subpel_refine_rect(ref_padded, border, px, py, src_block,
                                    mv_full)
    if res is not None:
        return res

    h, w = src_block.shape
    src = src_block.astype(np.int32)
    best_mv = (mv_full[0] * 8, mv_full[1] * 8)

    def sad_at(mv_q3):
        # build prediction window at this subpel mv
        x_q4 = ((px) << 4) + mv_q3[1] * 2
        y_q4 = ((py) << 4) + mv_q3[0] * 2
        x0, y0 = x_q4 >> 4, y_q4 >> 4
        sx, sy = x_q4 & 15, y_q4 & 15
        window = ref_padded[border + y0 - 3 : border + y0 + h + 4,
                            border + x0 - 3 : border + x0 + w + 4]
        pred = convolve8_2d(window, filters, filters, sx, sy, w, h)
        return int(np.abs(pred.astype(np.int32) - src).sum())

    best_sad = sad_at(best_mv)
    for step in steps:  # 4 = half-pel in q3, 2 = quarter-pel
        improved = True
        while improved:
            improved = False
            for dy, dx in ((-step, 0), (step, 0), (0, -step), (0, step)):
                cand = (best_mv[0] + dy, best_mv[1] + dx)
                s = sad_at(cand)
                if s < best_sad:
                    best_sad, best_mv = s, cand
                    improved = True
    return best_mv, best_sad
