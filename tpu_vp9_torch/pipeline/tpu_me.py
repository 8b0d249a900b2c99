"""Batched full-pel motion search on the card.

The counterpart of ``tpu_vp9/pipeline/tpu_me.py``. The reference region
and the source plane are the same numpy arrays the TPU package takes; they
are uploaded to ``device``, tiled into per-block source blocks and search
windows, and searched by ``ops.cuda_kernels.sad_full_search``. There is one
formulation: on a CUDA device the kernel runs or the call raises. On the
CPU the kernel's plain version runs, which stands in for the TPU package's
XLA ``full_search_sse``.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_vp9_torch.ops.cuda_kernels import sad_full_search


def _prep_blocks_regions(src_plane, ref_region, n: int, r: int):
    """Tile an (H, W) source plane into (R*C, n, n) blocks in raster order
    and gather their (R*C, n+2r, n+2r) search windows from the
    (H+2r, W+2r) reference region. H and W are multiples of n."""
    h, w = src_plane.shape
    rows, cols = h // n, w // n
    blocks = src_plane.reshape(rows, n, cols, n).permute(0, 2, 1, 3)
    blocks = blocks.reshape(-1, n, n)
    win = n + 2 * r
    dev = ref_region.device
    ir = (torch.arange(rows, device=dev) * n)[:, None] + torch.arange(
        win, device=dev)[None, :]
    ic = (torch.arange(cols, device=dev) * n)[:, None] + torch.arange(
        win, device=dev)[None, :]
    regions = ref_region[ir[:, None, :, None], ic[None, :, None, :]]
    return blocks, regions.reshape(-1, win, win)


# device copies of reference search regions, keyed by the host array's
# identity (DPB planes are reused across frames; upload once)
_REF_CACHE: dict = {}


def tpu_block_motion(src_plane, ref_padded, border: int, n: int, r: int,
                     device):
    """Full-pel MVs for every n x n block of a plane in one device call.

    src_plane: (H, W) uint8 numpy with H, W multiples of n; ref_padded: the
    border-extended reference plane (numpy). Returns (R, C, 2) int32 numpy
    of (dy, dx) per block.
    """
    h, w = src_plane.shape
    rows, cols = h // n, w // n
    if r > border:
        raise ValueError(f"search range {r} exceeds the reference border "
                         f"{border}")
    device = torch.device(device)
    key = (id(ref_padded), h, w, r, str(device))
    ent = _REF_CACHE.get(key)
    # id() values are reused after garbage collection: check identity too
    if ent is None or ent[0] is not ref_padded:
        region_np = np.ascontiguousarray(
            ref_padded[border - r : border + h + r,
                       border - r : border + w + r])
        ent = (ref_padded, torch.from_numpy(region_np).to(device))
        if len(_REF_CACHE) >= 8:  # bound device memory pinned by cache
            _REF_CACHE.pop(next(iter(_REF_CACHE)))
        _REF_CACHE[key] = ent
    src = torch.from_numpy(np.ascontiguousarray(src_plane)).to(device)
    blocks, regions = _prep_blocks_regions(src, ent[1], n, r)
    dy, dx, _ = sad_full_search(blocks.contiguous(), regions.contiguous(),
                                n, r)
    out = torch.stack([dy, dx], dim=-1).cpu().numpy()
    return out.reshape(rows, cols, 2)
