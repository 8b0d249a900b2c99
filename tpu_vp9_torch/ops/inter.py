"""VP9 inter prediction: exact 8-tap sub-pel interpolation + MV clamping.

Parity reference: vendored libvpx ``vpx_convolve.c`` (two-stage convolve
with clipped uint8 intermediates), ``vp9_reconinter.c:102``
(build_inter_predictors, q4 mv handling) and ``:68``
(clamp_mv_to_umv_border) in SVT-VP9.  MVs are in 1/8 luma-pel units
("q3"); plane mvs are converted to 1/16-plane-pel ("q4") per spec.
"""

from __future__ import annotations

import numpy as np

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream.tables import InterpFilter

SUBPEL_BITS = 4
SUBPEL_MASK = 15
INTERP_EXTEND = 4
BORDER = 96  # reference-frame border padding (>= 64 + 8 taps + slack)


def convolve8_2d(src, h_filters, v_filters, subpel_x: int, subpel_y: int,
                 w: int, h: int):
    """Exact vpx_convolve8 on a numpy window.

    src: int array whose [3 + y, 3 + x] element corresponds to output (0,0)
    at full-pel; i.e. src has shape (h + 7, w + 7) covering taps.
    Returns (h, w) uint8.
    """
    fx = h_filters[subpel_x]
    fy = v_filters[subpel_y]
    src = src.astype(np.int32)
    # horizontal pass over intermediate height h + 7
    inter = np.zeros((h + 7, w), np.int32)
    for k in range(8):
        inter += src[:, k : k + w] * int(fx[k])
    inter = np.clip((inter + 64) >> 7, 0, 255)
    out = np.zeros((h, w), np.int32)
    for k in range(8):
        out += inter[k : k + h, :] * int(fy[k])
    out = np.clip((out + 64) >> 7, 0, 255)
    return out.astype(np.uint8)


def clamp_mv(mv, lo_col, hi_col, lo_row, hi_row):
    row = min(max(mv[0], lo_row), hi_row)
    col = min(max(mv[1], lo_col), hi_col)
    return (row, col)


def clamp_mv_to_umv_border(mv_q3, mi_row: int, mi_col: int, bw: int, bh: int,
                           ss: int, mi_rows: int, mi_cols: int):
    """Returns plane-space q4 MV clamped to the usable border
    (vp9_reconinter.c:68).  bw/bh are the *plane* block dims in pixels."""
    spel_left = (INTERP_EXTEND + bw) << SUBPEL_BITS
    spel_right = spel_left - (1 << SUBPEL_BITS)
    spel_top = (INTERP_EXTEND + bh) << SUBPEL_BITS
    spel_bottom = spel_top - (1 << SUBPEL_BITS)
    scale = 1 << (1 - ss)
    row = mv_q3[0] * scale
    col = mv_q3[1] * scale
    # mb edges in q3 luma units, scaled to plane q4.  Edges use the mi
    # extent of the coding block (min 1 mi: a sub-8x8 block still spans
    # one mi unit — clamp_mv_to_umv_border_sb uses xd->mb_to_* edges of
    # the mi while spel margins use the prediction dims)
    mi_w = max((bw << ss) // 8, 1)
    mi_h = max((bh << ss) // 8, 1)
    mb_to_left = -((mi_col * 8) * 8)
    mb_to_right = ((mi_cols - mi_w - mi_col) * 8) * 8
    mb_to_top = -((mi_row * 8) * 8)
    mb_to_bottom = ((mi_rows - mi_h - mi_row) * 8) * 8
    row, col = clamp_mv(
        (row, col),
        mb_to_left * scale - spel_left,
        mb_to_right * scale + spel_right,
        mb_to_top * scale - spel_top,
        mb_to_bottom * scale + spel_bottom,
    )
    return row, col


def predict_inter_block(ref_plane, mi_row: int, mi_col: int,
                        x_off: int, y_off: int, bw: int, bh: int,
                        mv_q3, ss: int, mi_rows: int, mi_cols: int,
                        filter_type=InterpFilter.EIGHTTAP):
    """MC prediction for one plane block.

    ref_plane: border-extended reference plane as returned by
    ``padded_ref`` (origin shifted by BORDER).
    x_off/y_off: pixel offset of this block within the mi block (plane
    units; nonzero for sub-8x8 later).  Returns (bh, bw) uint8.
    """
    row_q4, col_q4 = clamp_mv_to_umv_border(
        mv_q3, mi_row, mi_col, bw, bh, ss, mi_rows, mi_cols)
    px = ((mi_col * 8) >> ss) + x_off
    py = ((mi_row * 8) >> ss) + y_off
    x_q4 = (px << SUBPEL_BITS) + col_q4
    y_q4 = (py << SUBPEL_BITS) + row_q4
    x0 = x_q4 >> SUBPEL_BITS
    y0 = y_q4 >> SUBPEL_BITS
    subpel_x = x_q4 & SUBPEL_MASK
    subpel_y = y_q4 & SUBPEL_MASK
    if subpel_x == 0 and subpel_y == 0:
        # full-pel: phase-0 kernel is the identity (normatively exact)
        return ref_plane[BORDER + y0 : BORDER + y0 + bh,
                         BORDER + x0 : BORDER + x0 + bw].astype(np.uint8)
    filters = T.subpel_filters(filter_type)
    window = ref_plane[BORDER + y0 - 3 : BORDER + y0 + bh + 4,
                       BORDER + x0 - 3 : BORDER + x0 + bw + 4]
    return convolve8_2d(window, filters, filters, subpel_x, subpel_y, bw, bh)


def extend_borders(plane, crop_w: int, crop_h: int, border: int = BORDER):
    """Return a border-extended copy: replication from the *crop* edges,
    overwriting any alignment-gap content (libvpx extend_frame semantics:
    right/bottom extension width includes the alignment gap)."""
    h, w = plane.shape
    out = np.empty((h + 2 * border, w + 2 * border), plane.dtype)
    inner = out[border : border + h, border : border + w]
    inner[:] = plane
    # overwrite alignment gap from crop edges
    inner[:crop_h, crop_w:] = inner[:crop_h, crop_w - 1 : crop_w]
    inner[crop_h:, :] = inner[crop_h - 1 : crop_h, :]
    # borders
    out[border : border + h, :border] = out[border : border + h,
                                            border : border + 1]
    out[border : border + h, border + w :] = out[border : border + h,
                                                 border + w - 1 : border + w]
    out[:border, :] = out[border : border + 1, :]
    out[border + h :, :] = out[border + h - 1 : border + h, :]
    return out
