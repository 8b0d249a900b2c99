"""Entry points of the port: a check of the device P-frame step on
one device, and a dry run of the sharded step over a mesh.

The counterpart of ``__graft_entry__.py`` beside the JAX package, with the
same inputs, outputs and printed lines:

- ``entry(device=None)`` returns ``(fn, example_args)``: ``fn`` runs the
  port's full device P-frame step (``pipeline/tpu_encdec.make_pframe_step``:
  the window search, the quarter-pel refinement, the decision and MC, the
  transform and recon, the exact loop filter and the border extension) at
  256x128 on random planes from ``np.random.default_rng(0)`` against
  border-extended references, and returns (the 32 grid's MVs, its luma
  levels, the new luma reference). Its per-frame scalars are one int32 row
  on the device (``step_scalars``), as the JAX entry passes each scalar as
  a device value.
- ``dryrun_multichip(n_devices, device=None)`` runs the sharded step
  (``pipeline/tpu_shard.make_pframe_step_sharded``) once over a (frame,
  tile) mesh of 128-pixel-wide shards, (2, n/2) for an even n > 2 and (1,
  n) otherwise, then an ``RtSession`` over a (1, n_tile) mesh on three
  synthetic frames, and prints one line for each. The mesh repeats one
  device n times, as ``tests/test_torch_shard.py`` does: the machine's
  first card, or the CPU.

Both run on the card unless the caller passes the CPU:

    python -m tpu_vp9_torch.graft_entry [--device cpu] [--devices N]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.ops.loopfilter import pick_filter_level, sharpness_limits
from tpu_vp9_torch.pipeline.tpu_encdec import (
    extend_borders, make_geom, make_pframe_step, pad_plane, step_scalars,
)
from tpu_vp9_torch.utils.device import require_cuda

QINDEX = 120
LAM = 100  # the JAX entry's lambda


def _device(device) -> torch.device:
    """The entries' device: the caller's, else the card; a card without
    its index is the current one (the mesh names it as its tensors do)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _scalars(device):
    """The entries' row of scalars: qindex 120's quantizers and P-frame
    filter level, lambda 100."""
    lf = pick_filter_level(QINDEX, False)
    lim_t, mblim_t = sharpness_limits(0)
    return step_scalars(T.dc_quant(QINDEX), T.ac_quant(QINDEX), LAM, lf,
                        int(lim_t[lf]), int(mblim_t[lf]), device)


def _random_planes(rng, g, w: int, h: int, device):
    """Padded (y, u, v) uint8 planes of uniform noise, drawn in that
    order."""
    return tuple(
        torch.from_numpy(pad_plane(rng.integers(0, 255, (hh, ww),
                                                dtype=np.uint8), ph, pw))
        .to(device)
        for hh, ww, ph, pw in ((h, w, g.pad_h, g.pad_w),
                               (h // 2, w // 2, g.pad_h // 2, g.pad_w // 2),
                               (h // 2, w // 2, g.pad_h // 2, g.pad_w // 2)))


def entry(device=None):
    """(fn, example_args): the port's device P-frame step at 256x128 and
    its inputs (see the module's docstring)."""
    dev = _device(device)
    w, h = 256, 128
    g = make_geom(w, h)
    src = _random_planes(np.random.default_rng(0), g, w, h, dev)
    refs = extend_borders(src, ((w, h), (w // 2, h // 2), (w // 2, h // 2)))
    pm32 = torch.zeros((g.n_blocks32, 2), dtype=torch.int32, device=dev)
    pm16 = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    step = make_pframe_step(g, dev)

    def fn(sy, su, sv, ry, ru, rv, pm32, pm16, sc):
        outs, new_refs = step(sy, su, sv, ry, ru, rv, pm32, pm16, sc)
        return outs["m32"]["mv"], outs["m32"]["lv_y"], new_refs[0]

    return fn, (*src, *refs, pm32, pm16, _scalars(dev))


def dryrun_multichip(n_devices: int, device=None) -> None:
    """The sharded step over a mesh of ``n_devices`` (one device
    repeated), then an ``RtSession`` over its (1, n_tile) mesh (see the
    module's docstring); raises where a check fails."""
    from tpu_vp9_torch.pipeline.realtime import RtSession
    from tpu_vp9_torch.pipeline.tpu_shard import make_pframe_step_sharded
    from tpu_vp9_torch.utils.yuv import synthetic_frames

    dev = _device(device)
    if n_devices % 2 == 0 and n_devices > 2:
        shape = (2, n_devices // 2)
    else:
        shape = (1, n_devices)
    n_frame, n_tile = shape
    mesh = [[dev] * n_tile for _ in range(n_frame)]
    # 128px-wide shards: wider than the 96px BORDER halo, so each shard
    # takes its halo from its neighbours' edge columns
    w, h = 128 * n_tile, 128
    g = make_geom(w, h)
    f = n_frame  # one stream per frame row
    src = [_random_planes(np.random.default_rng(i), g, w, h, dev)
           for i in range(f)]
    ref = [_random_planes(np.random.default_rng(100 + i), g, w, h, dev)
           for i in range(f)]
    planes = [torch.stack([p[k] for p in trio])
              for k in range(3) for trio in (src, ref)]
    sy, ry, su, ru, sv, rv = planes
    step = make_pframe_step_sharded(g, mesh, n_tile)
    outs, new_refs = step(
        sy, su, sv, ry, ru, rv,
        torch.zeros((f, g.n_blocks32, 2), dtype=torch.int32, device=dev),
        torch.zeros((f, n_tile, 2), dtype=torch.int32, device=dev),
        _scalars(dev))
    mv = outs["mv"].cpu().numpy()
    rate = int(outs["rate"][0])
    dist = int(outs["dist"][0])
    assert mv.shape == (f, g.n_blocks32, 2)
    assert tuple(new_refs[0].shape) == (f, g.pad_h, g.pad_w)
    print(f"dryrun_multichip OK: mesh={shape} pframe_step_sharded "
          f"mv={mv.shape} lv_y={tuple(outs['lv_y'].shape)} "
          f"refs={tuple(new_refs[0].shape)} rate={rate} dist={dist}")

    # the public multi-device path: an RtSession over a (1, n_tile) mesh
    # encodes and serializes a short stream
    frames = list(synthetic_frames(w, h, 3, seed=1, motion=True))
    sess = RtSession(w, h, device=dev, want_recon=False,
                     mesh_shape=(1, n_tile), mesh_devices=[dev] * n_tile)
    payloads = []
    for fr in frames:
        payloads.extend(e.payload for e in sess.send(fr, qindex=QINDEX))
    payloads.extend(e.payload for e in sess.flush())
    sess.close()
    assert len(payloads) == 3 and all(len(p) > 0 for p in payloads)
    print(f"dryrun_multichip OK: RtSession mesh=(1,{n_tile}) serialized "
          f"{len(payloads)} frames ({sum(map(len, payloads))} bytes)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (the default: the card)")
    ap.add_argument("--devices", type=int, default=8,
                    help="the dry run's mesh size")
    args = ap.parse_args(argv)
    fn, ex = entry(args.device)
    out = fn(*ex)
    print("entry OK:", [tuple(o.shape) for o in out])
    dryrun_multichip(args.devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
