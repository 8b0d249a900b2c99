"""Command-line encoder of the port, on a CUDA card.

The counterpart of ``tpu_vp9/app.py``: the same flags (its parser, config
and input readers are reused) driving ``tpu_vp9_torch.api.Vp9Encoder``,
plus ``-device`` (default ``cuda``). Multi-channel (``-nch``), GOP-parallel
and multi-host runs are not ported yet and exit with an error, as does any
configuration the port's encoder refuses.

Usage (M9: the realtime P-frame step on the card; M7: the host encode
with the full-pel search on the card):
  python -m tpu_vp9_torch.app -i clip.y4m -b out.ivf -enc-mode 9 \
      -pred-struct 0 -q 40
  python -m tpu_vp9_torch.app -i clip.y4m -b out.ivf -enc-mode 7 \
      -pred-struct 0 -q 40
"""

from __future__ import annotations

import json
import sys
import time

from tpu_vp9.app import (
    _print_lib_params, _read_qp_file, build_parser, config_from_args,
    expand_config_file, open_input,
)
from tpu_vp9.bitstream.ivf import (
    patch_ivf_frame_count, write_ivf_frame, write_ivf_header,
)

from tpu_vp9_torch.api import Vp9Encoder


def _parser():
    p = build_parser()
    p.prog = "SvtVp9EncApp (tpu_vp9_torch)"
    p.add_argument("-device", dest="device", default="cuda",
                   help="torch device of the device stages (default cuda)")
    return p


def _refused(args) -> str | None:
    if args.channels > 1:
        return "-nch > 1 (multi-channel) is not ported yet"
    if args.gop_parallel > 1:
        return "-gop-parallel > 1 is not ported yet"
    if args.distributed:
        return "-distributed is not ported yet"
    return None


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    try:
        argv = expand_config_file(argv)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    args = _parser().parse_args(argv)
    why = _refused(args)
    if why:
        print(f"error: tpu_vp9_torch: {why}", file=sys.stderr)
        return 2
    try:
        width, height, (fps_num, fps_den), frames = open_input(args)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    cfg = config_from_args(args, width, height)
    if args.fps_num == 0:
        cfg.frame_rate_numerator = fps_num
        cfg.frame_rate_denominator = fps_den
    if args.errlog:
        sys.stderr = open(args.errlog, "w")
    _print_lib_params(cfg, width, height)
    if args.trace:
        from tpu_vp9.utils.trace import enable as _trace_enable

        _trace_enable(True)

    enc = Vp9Encoder(device=args.device)
    try:
        enc.set_parameter(cfg)
        enc.init()
    except ValueError as e:
        print(f"config error: {e}", file=sys.stderr)
        return 1
    except (NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    for idx, qp in (_read_qp_file(args) or {}).items():
        enc.set_frame_qp(idx, qp)

    out_fh = open(args.bitstream, "wb") if args.bitstream else None
    recon_fh = open(args.recon, "wb") if args.recon else None
    if out_fh:
        write_ivf_header(out_fh, width, height, fps_num, fps_den)

    def drain() -> int:
        nbytes = 0
        while (pkt := enc.get_packet()) is not None:
            if out_fh:
                write_ivf_frame(out_fh, pkt.data, pkt.pts)
            nbytes += len(pkt.data)
        return nbytes

    n_coded = total_bytes = 0
    max_latency = 0.0
    t0 = time.time()
    for frame in frames:
        if args.frames and n_coded >= args.frames:
            break
        tf = time.time()
        enc.send_picture(frame)
        got = drain()
        total_bytes += got
        if got:
            max_latency = max(max_latency, time.time() - tf)
        if recon_fh and enc.get_recon() is not None:
            y, u, v = enc.get_recon()
            recon_fh.write(y.tobytes() + u.tobytes() + v.tobytes())
        n_coded += 1
    enc.flush()
    total_bytes += drain()
    elapsed = max(time.time() - t0, 1e-9)
    if out_fh:
        patch_ivf_frame_count(out_fh, n_coded)
        out_fh.close()
    if recon_fh:
        recon_fh.close()
    kbps = (total_bytes * 8 * (fps_num / max(fps_den, 1))
            / max(n_coded, 1) / 1000)
    print(f"SUMMARY: {n_coded} frames, {n_coded / elapsed:.2f} fps, "
          f"{kbps:.1f} kbps, avg {total_bytes // max(n_coded, 1)} B/frame, "
          f"max latency {max_latency * 1000:.1f} ms")
    if args.trace:
        from tpu_vp9.utils.trace import summary as _trace_summary

        print("TRACE:", json.dumps(_trace_summary()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
