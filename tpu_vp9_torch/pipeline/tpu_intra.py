"""Open-loop keyframe mode hints: the counterpart of
``tpu_vp9/pipeline/tpu_intra.py``.

The host route's keyframes at enc_mode 8 and 9 take their 32x32 luma modes
from an open-loop decision: every block's 10 intra predictions from the
*source* samples around it, not the recon, their SSE, a small mode prior,
the first mode of least cost. ``codec/intra_frame.py:openloop_mode_hints_np``
(the public encoder's route) computes it in numpy from ``extract_blocks``
and ``openloop_refs``; ``pipeline/encoder.py`` asks ``decide_modes_openloop``,
which runs the hand-written kernel ``ops/cuda_kernels.py:openloop_modes`` on
a CUDA plane and its plain version on a CPU one.

The JAX module's ``intra_encode_step``, ``multi_frame_step``,
``analyze_frame_stats`` and ``transform_quant_blocks`` have no caller
outside it and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_vp9_torch.ops.cuda_kernels import openloop_modes


def extract_blocks(plane, n: int):
    """(H, W) -> (R, C, n, n) non-overlapping blocks (a view). H, W
    multiples of n; numpy arrays and torch tensors alike."""
    h, w = plane.shape
    blocks = plane.reshape(h // n, n, w // n, n)
    if isinstance(blocks, np.ndarray):
        return blocks.transpose(0, 2, 1, 3)
    return blocks.permute(0, 2, 1, 3)


def openloop_refs(plane, n: int, xp=np):
    """Source reference samples of every n x n block, as the JAX module's
    ``openloop_refs`` gives them.

    plane: (H, W) uint8, H and W multiples of n, a numpy array (``xp=np``)
    or a torch tensor (``xp=torch``). Returns (above_ext (R, C, 2n) int32:
    the row above the block, 127 above the frame, its second half
    repeating above[n-1]; above_left (R, C) int32: the corner, 127 without
    a row above, else 129 without a column to the left; left (R, C, n)
    int32: the column to the left, 129 left of the frame; have_above (R,
    C) bool; have_left (R, C) bool), in ``xp``'s kind, on the plane's
    device for torch.
    """
    h, w = plane.shape
    rows, cols = h // n, w // n
    if xp is np:
        p = np.asarray(plane).astype(np.int32)
        put = np.asarray
    else:
        p = plane.to(torch.int32)

        def put(a):
            return torch.as_tensor(a, device=plane.device)

    r, c = np.arange(rows), np.arange(cols)
    ya = np.clip(r * n - 1, 0, h - 1)  # the row above each block row
    xl = np.clip(c * n - 1, 0, w - 1)  # the column left of each block col
    have_above = np.broadcast_to((r > 0)[:, None], (rows, cols)).copy()
    have_left = np.broadcast_to((c > 0)[None, :], (rows, cols)).copy()
    # above and above-right: columns c*n .. c*n + n-1, then c*n + n-1 again
    kx = np.minimum(np.arange(2 * n), n - 1)
    above_ext = p[put(ya[:, None, None]), put(c[None, :, None] * n + kx)]
    above_ext = xp.where(put(have_above[..., None]), above_ext, 127)
    left = p[put(r[:, None, None] * n + np.arange(n)), put(xl[None, :, None])]
    left = xp.where(put(have_left[..., None]), left, 129)
    corner = p[put(ya[:, None]), put(xl[None, :])]
    corner = xp.where(put(have_above),
                      xp.where(put(have_left), corner, 129), 127)
    if xp is np:
        return (above_ext.astype(np.int32), corner.astype(np.int32),
                left.astype(np.int32), have_above, have_left)
    return (above_ext.to(torch.int32), corner.to(torch.int32),
            left.to(torch.int32), put(have_above), put(have_left))


def decide_modes_openloop(plane, qindex, n: int = 32):
    """Open-loop intra mode decision for all n x n blocks of a plane.

    plane: (H, W) uint8 torch tensor, H and W multiples of n; qindex an
    int. Returns (modes (R, C) int32, sse (R, C, 10) int32, best (R, C)
    int32, the least cost sse + bias * (qindex^2 // 64 + 1)), as the JAX
    function does, on the plane's device: a CUDA plane runs the kernel
    ``openloop_modes``, a CPU plane its plain version.
    """
    return openloop_modes(plane, int(qindex), n)
