"""Command-line encoder of the port, on a CUDA card.

The counterpart of ``tpu_vp9/app.py`` with the same flags (the
SvtVp9EncApp-compatible surface: ``-i -b -o -w -h -n -q -fps -enc-mode
-tune -intra-period -pred-struct -rc -tbr ...``) driving
``tpu_vp9_torch.api.Vp9Encoder``, plus ``-device`` (default ``cuda``).
Reads raw YUV or Y4M (incl. stdin pipes), writes IVF and an optional recon
file. ``-nch N`` runs N independent channels as processes of this CLI
(outputs ``name.chK.ext``), ``-gop-parallel K`` encodes the file's GOPs in
K spawned workers and ``-distributed coordinator:port,n,i`` as process i
of a gloo group of n (CQP and a fixed intra period; both write the
sequential encode's bytes). A configuration the port's encoder refuses
(``-rt 1`` where the realtime step cannot run) exits with an error.

Usage (the default, random access with 4 hierarchical levels at enc_mode
9: the ALTREF pyramids of the device random-access session on the card;
random access at enc_mode 0-7, at ``-rt 0``, VBR or CBR, with a recon file,
speed control or a qp file, and at a size the device session does not
take (640x360): the host random-access engine, its full-pel search on the
card from 1280x720 up;
M8: the realtime P-frame step with rate tables, the GOLDEN anchor and the
32-against-16 descent on the card, at ``-tune 0`` (SQ) with the adaptive
lambda; M9: the uniform 32 grid; in low delay M8 and M9 also at VBR
(``-rc 1``) or CBR (``-rc 2``, a VBV of twice ``-tbr`` unless
``-vbv-bufsize``) and with speed control (``-speed-ctrl 1``); M7: the host
encode with the full-pel search on the card; M8 and M9 at ``-rt 0``, and
at a size the realtime step does not take (a width not a multiple of 32,
or 640x360), the same host encode with the open-loop keyframe mode hints;
the host encode with ``-speed-ctrl 1``, which may step it to M8 and M9):
  python -m tpu_vp9_torch.app -i clip.y4m -b out.ivf -q 40
  python -m tpu_vp9_torch.app -i clip.y4m -b out.ivf -enc-mode 8 \
      -pred-struct 0 -q 40
  python -m tpu_vp9_torch.app -i clip.y4m -b out.ivf -enc-mode 9 \
      -pred-struct 0 -q 40
  python -m tpu_vp9_torch.app -i clip.y4m -b out.ivf -enc-mode 8 \
      -pred-struct 0 -rc 2 -tbr 2000000
  python -m tpu_vp9_torch.app -i clip.y4m -b out.ivf -enc-mode 8 \
      -pred-struct 0 -tune 0 -q 40
  python -m tpu_vp9_torch.app -i clip.y4m -b out.ivf -enc-mode 7 \
      -pred-struct 0 -q 40
  python -m tpu_vp9_torch.app -i clip.y4m -b out.ivf -enc-mode 9 \
      -pred-struct 0 -rt 0 -q 40
  python -m tpu_vp9_torch.app -i clip.y4m -b out.ivf -enc-mode 7 \
      -pred-struct 0 -speed-ctrl 1 -fps 30 -q 40
  python -m tpu_vp9_torch.app -i clip.y4m -b out.ivf -enc-mode 7 -q 40
  python -m tpu_vp9_torch.app -i clip.y4m -b out.ivf -nch 2 -q 40
  python -m tpu_vp9_torch.app -i clip.y4m -b out.ivf -enc-mode 8 \
      -intra-period 15 -gop-parallel 4 -q 40
  python -m tpu_vp9_torch.app -i clip.y4m -b out.ivf -enc-mode 8 \
      -intra-period 15 -distributed host0:29500,2,0 -q 40
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from tpu_vp9_torch.api import Vp9Encoder
from tpu_vp9_torch.bitstream.ivf import (
    patch_ivf_frame_count, write_ivf_frame, write_ivf_header,
)
from tpu_vp9_torch.config import (
    EncoderConfig, PredStructure, RateControlMode, Tune,
)
from tpu_vp9_torch.utils.yuv import read_y4m, read_yuv_frames


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="SvtVp9EncApp (tpu_vp9_torch)", add_help=False,
        description="VP9 encoder on PyTorch and CUDA")
    p.add_argument("--help", action="help")
    p.add_argument("-i", dest="input", required=True,
                   help="input file (.y4m/.yuv or 'stdin')")
    p.add_argument("-b", dest="bitstream", help="output IVF bitstream")
    p.add_argument("-o", dest="recon", help="output recon YUV")
    p.add_argument("-errlog", dest="errlog", help="error log file")
    p.add_argument("-w", dest="width", type=int, default=0)
    p.add_argument("-h", dest="height", type=int, default=0)
    p.add_argument("-n", dest="frames", type=int, default=0,
                   help="number of frames to encode (0 = all)")
    p.add_argument("-q", dest="qp", type=int, default=50)
    p.add_argument("-fps", dest="fps", type=int, default=30)
    p.add_argument("-fps-num", dest="fps_num", type=int, default=0)
    p.add_argument("-fps-denom", dest="fps_denom", type=int, default=0)
    p.add_argument("-enc-mode", dest="enc_mode", type=int, default=9)
    p.add_argument("-tune", dest="tune", type=int, default=1)
    p.add_argument("-intra-period", dest="intra_period", type=int, default=-2)
    p.add_argument("-pred-struct", dest="pred_struct", type=int, default=2)
    p.add_argument("-rc", dest="rc", type=int, default=0)
    p.add_argument("-tbr", dest="tbr", type=int, default=7_000_000)
    p.add_argument("-max-qp", dest="max_qp", type=int, default=63)
    p.add_argument("-min-qp", dest="min_qp", type=int, default=10)
    p.add_argument("-vbv-bufsize", dest="vbv_bufsize", type=int, default=0)
    p.add_argument("-loop-filter", dest="loop_filter", type=int, default=1)
    p.add_argument("-use-q-file", dest="use_q_file", type=int, default=0)
    p.add_argument("-qp-file", dest="qp_file")
    p.add_argument("-hme", dest="hme", type=int, default=1)
    p.add_argument("-use-default-me-hme", dest="default_me", type=int,
                   default=1)
    p.add_argument("-search-w", dest="search_w", type=int, default=16)
    p.add_argument("-search-h", dest="search_h", type=int, default=9)
    p.add_argument("-bit-depth", dest="bit_depth", type=int, default=8)
    p.add_argument("-profile", dest="profile", type=int, default=0)
    p.add_argument("-level", dest="level", type=int, default=0)
    p.add_argument("-nch", dest="channels", type=int, default=1)
    p.add_argument("-speed-ctrl", dest="speed_ctrl", type=int, default=0)
    p.add_argument("-trace", dest="trace", type=int, default=0)
    p.add_argument("-distributed", dest="distributed", default="",
                   help="multi-host GOP-parallel over DCN: "
                        "coordinator:port,num_processes,process_id "
                        "(every process gets the full stream; CQP + "
                        "fixed intra period only)")
    p.add_argument("-gop-parallel", dest="gop_parallel", type=int,
                   default=1)
    p.add_argument("-tile-columns", dest="tile_columns", type=int,
                   default=-1)
    p.add_argument("-rt", dest="tpu_realtime", type=int, default=-1,
                   help="device-resident realtime loop: -1 auto, 0 off, "
                        "1 force")
    p.add_argument("-device", dest="device", default="cuda",
                   help="torch device of the device stages (default cuda)")
    return p


def config_from_args(args, width: int, height: int) -> EncoderConfig:
    return EncoderConfig(
        enc_mode=args.enc_mode,
        tune=Tune(args.tune),
        intra_period=args.intra_period,
        pred_structure=PredStructure(min(args.pred_struct, 2)),
        source_width=width,
        source_height=height,
        frame_rate=args.fps,
        frame_rate_numerator=args.fps_num,
        frame_rate_denominator=args.fps_denom,
        encoder_bit_depth=args.bit_depth,
        qp=args.qp,
        use_qp_file=bool(args.use_q_file),
        loop_filter=bool(args.loop_filter),
        use_default_me_hme=bool(args.default_me),
        enable_hme=bool(args.hme),
        search_area_width=args.search_w,
        search_area_height=args.search_h,
        rate_control_mode=RateControlMode(args.rc),
        target_bit_rate=args.tbr,
        max_qp_allowed=args.max_qp,
        min_qp_allowed=args.min_qp,
        vbv_buf_size=args.vbv_bufsize,
        profile=args.profile,
        level=args.level,
        speed_control=bool(args.speed_ctrl),
        tpu_tile_columns=args.tile_columns,
        tpu_realtime=args.tpu_realtime,
    )


def open_input(args):
    if args.input == "stdin":
        fh = sys.stdin.buffer
        peek = fh.peek(9) if hasattr(fh, "peek") else b""
        if peek.startswith(b"YUV4MPEG2") or args.width == 0:
            header, frames = read_y4m(fh)
            return header.width, header.height, \
                (header.fps_num, header.fps_den), frames
        return args.width, args.height, (args.fps, 1), \
            read_yuv_frames(fh, args.width, args.height)
    if args.input.endswith(".y4m"):
        fh = open(args.input, "rb")
        header, frames = read_y4m(fh)
        return header.width, header.height, \
            (header.fps_num, header.fps_den), frames
    if args.width <= 0 or args.height <= 0:
        raise SystemExit("raw YUV input requires -w and -h")
    fh = open(args.input, "rb")
    return args.width, args.height, (args.fps, 1), \
        read_yuv_frames(fh, args.width, args.height)


def expand_config_file(argv):
    """-c <file>: config lines 'token value' prepended as CLI args
    (Config/Sample.cfg style; CLI flags win)."""
    argv = list(argv)
    if "-c" not in argv:
        return argv
    i = argv.index("-c")
    path = argv[i + 1]
    del argv[i : i + 2]
    pre = []
    with open(path) as fh:
        for line in fh:
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.replace(":", " ").split()
            if len(parts) >= 2:
                tok = parts[0] if parts[0].startswith("-") else "-" + parts[0]
                pre.extend([tok, parts[1]])
    return pre + argv


def _print_lib_params(cfg, width, height) -> None:
    """Startup parameter echo (print_lib_params, EbEncHandle.c:2600)."""
    d = cfg.derive()
    rc_names = {0: "CQP", 1: "VBR", 2: "CBR"}
    print(f"SVT-TPU [config]: Profile [{d.profile}] {width}x{height} "
          f"@ {d.fps:g} fps", file=sys.stderr)
    print(f"SVT-TPU [config]: EncoderMode / Tune\t: {d.enc_mode} / "
          f"{int(d.tune)}", file=sys.stderr)
    rc = rc_names.get(int(d.rate_control_mode), "?")
    detail = (f"qp {d.qp}" if rc == "CQP"
              else f"target {d.target_bit_rate} bps")
    print(f"SVT-TPU [config]: RC / {rc}\t\t: {detail}, "
          f"intra period {d.intra_period}, hierarchical levels "
          f"{d.hierarchical_levels}", file=sys.stderr)


def _read_qp_file(args):
    """Per-frame QP overrides from -qp-file (one qp per line)."""
    if not (args.qp_file and args.use_q_file):
        return None
    overrides = {}
    with open(args.qp_file) as fh:
        for idx, line in enumerate(fh):
            line = line.strip()
            if line:
                overrides[idx] = int(line)
    return overrides


def run_channels(argv, n: int) -> int:
    """-nch N: run N independent encoder channels as parallel processes
    of this CLI (outputs get .chK suffixes); ``-device`` passes through."""
    import subprocess as sp

    base = list(argv)
    i = base.index("-nch")
    del base[i : i + 2]
    procs = []
    for ch in range(n):
        args = list(base)
        for flag in ("-b", "-o", "-errlog"):
            if flag in args:
                j = args.index(flag) + 1
                root, dot, ext = args[j].rpartition(".")
                args[j] = (f"{root}.ch{ch}.{ext}" if dot
                           else f"{args[j]}.ch{ch}")
        procs.append(sp.Popen([sys.executable, "-m", "tpu_vp9_torch.app"]
                              + args))
    rc = 0
    for p in procs:
        rc |= p.wait()
    return rc


def _write_chunked(args, pkts, n_frames, width, height, fps_num, fps_den,
                   elapsed, what) -> None:
    """The IVF of a chunked encode's packets and its SUMMARY line."""
    total_bytes = sum(len(p[0]) for p in pkts)
    if args.bitstream:
        with open(args.bitstream, "wb") as out_fh:
            write_ivf_header(out_fh, width, height, fps_num, fps_den)
            for data, pts, _dts, _k, _q in pkts:
                write_ivf_frame(out_fh, data, pts)
            patch_ivf_frame_count(out_fh, len(pkts))
    n = max(n_frames, 1)
    kbps = total_bytes * 8 * (fps_num / max(fps_den, 1)) / n / 1000
    print(f"SUMMARY: {n_frames} frames, {n_frames / elapsed:.2f} fps, "
          f"{kbps:.1f} kbps, avg {total_bytes // n} B/frame, {what}")


def _run_gop_parallel(args, cfg, frames, width, height, fps_num,
                      fps_den) -> int:
    """Whole-file GOP-parallel encode (CQP; bit-identical to sequential)."""
    from tpu_vp9_torch.pipeline.gop_parallel import encode_gop_parallel

    frames = list(frames)
    if args.frames:
        frames = frames[: args.frames]
    overrides = _read_qp_file(args) or {}
    t0 = time.time()
    pkts = encode_gop_parallel(frames, cfg, workers=args.gop_parallel,
                               qp_overrides=overrides, device=args.device)
    _write_chunked(args, pkts, len(frames), width, height, fps_num, fps_den,
                   max(time.time() - t0, 1e-9),
                   f"gop-parallel x{args.gop_parallel}")
    return 0


def _run_distributed(args, cfg, frames, width, height, fps_num,
                     fps_den) -> int:
    """-distributed coordinator:port,n,i: GOP-parallel across the n
    processes of a gloo group (see pipeline/distributed.py); every process
    writes the full presentation-order stream (byte-identical to the
    sequential encode)."""
    from tpu_vp9_torch.pipeline.distributed import encode_gop_distributed

    try:
        coord, n_s, i_s = args.distributed.rsplit(",", 2)
        n_proc, pid = int(n_s), int(i_s)
    except ValueError:
        print("error: -distributed wants coordinator:port,n,i",
              file=sys.stderr)
        return 1
    frames = list(frames)
    if args.frames:
        frames = frames[: args.frames]
    overrides = _read_qp_file(args) or {}
    t0 = time.time()
    pkts = encode_gop_distributed(frames, cfg, coordinator=coord,
                                  num_processes=n_proc, process_id=pid,
                                  qp_overrides=overrides, device=args.device)
    _write_chunked(args, pkts, len(frames), width, height, fps_num, fps_den,
                   max(time.time() - t0, 1e-9),
                   f"distributed {pid + 1}/{n_proc}")
    return 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    try:
        argv = expand_config_file(argv)
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if "-nch" in argv:
        n = int(argv[argv.index("-nch") + 1])
        if n > 1:
            return run_channels(argv, n)
    args = build_parser().parse_args(argv)
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
        from tpu_vp9_torch.utils.trace import enable as _trace_enable

        _trace_enable(True)

    if args.distributed:
        dcfg = cfg.derive()
        if (dcfg.rate_control_mode != RateControlMode.CQP
                or dcfg.intra_period < 0):
            print("error: -distributed requires CQP + fixed intra period",
                  file=sys.stderr)
            return 1
        return _run_distributed(args, dcfg, frames, width, height,
                                fps_num, fps_den)
    if args.gop_parallel > 1:
        dcfg = cfg.derive()  # resolve the auto (-2) intra period
        if (dcfg.rate_control_mode != RateControlMode.CQP
                or dcfg.intra_period < 0 or dcfg.speed_control):
            print("warning: -gop-parallel requires CQP + intra period "
                  "(and no speed control); falling back to sequential",
                  file=sys.stderr)
        else:
            if args.trace:
                print("warning: -trace is per-process; no trace summary "
                      "in -gop-parallel mode", file=sys.stderr)
            return _run_gop_parallel(args, dcfg, frames, width, height,
                                     fps_num, fps_den)

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
        from tpu_vp9_torch.utils.trace import summary as _trace_summary

        print("TRACE:", json.dumps(_trace_summary()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
