"""Smoke run of the tpu_vp9_torch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. the card, the software, and the build of every kernel (one nvcc per
     source, all started together) and of the native host library;
  2. kernels: first a keyframe and an M8 P-frame of the clip through the
     public encoder, the real inputs of the step's loop filter, transform,
     quarter-pel and MC calls recorded; then sad_full_search, block_energy
     (on blocks and positioned, block_energy_at), sse_map_search (one level,
     and both levels fused, hier_search_fused), subpel_search, mc_predict,
     transform_recon, kframe_wave, loop_filter, the descent's four
     kernels (descent_gather with the children's ZERO SSE, descent_decide,
     descent_pack with their recon SSE, descent_split, in place: the M8
     P-frame's real calls at K = 510 parents, the RA shape of every
     parent's children, K = 2,040,
     the frame's edges, unions clamped at both ends and starting at every
     byte of a word, all-tie costs, a lam that flips the split, the
     overhang row, every block the split keeps byte-identical, the pack's
     SSE at its most and every level zero and nonzero), the mode
     decision (mode_decide: the M8 P-frame's real
     32 zone with GOLDEN and the rate tables, M9's proxies, tune SQ's
     per-block lam_bits, a shard's LEFT edge, ALTREF, SSEs above 2^24,
     all-tie inputs that must go to LAST's ZERO, the real 720p 32 zone and
     strip), the decisions folded into MC (mode_decide_mc and
     descent_decide_mc, mc_predict.cu's decided instances, against their
     plain compositions and against the two launches each replaces: the
     real 1080p M8 zone and children, the zone's made-up decisions, a 1x4
     shard's 510 blocks with and without a LEFT edge, the children without
     the rate tables and all ties at 8,160, the real RA shape's children,
     the real 720p 32 zone and strip; timed beside the two launches and
     the plain instance, in turns), the windows and borders
     (extract_windows on the real 1080p search site, the real 720p ones,
     4K's made-up, each beside
     unfold(...).contiguous(); extend_borders
     on the real 1080p keyframe and P-frame, 1080p planes at odd crops,
     the real 720p P-frame, a made-up 4K recon) against their plain
     PyTorch versions on the card, bit for bit, at the shapes the 1080p
     paths give them (the M8 children's included), ties, negative minima and
     the largest operands included; subpel_search on the zone's and the
     children's real windows, on windows where all 49 offsets tie, at the
     largest SSE, on 0/255 checkerboards and with winners at +-r; mc_predict
     (which reads the reference planes in place) on the zone's and the
     children's real calls, on the zone's planes with ALTREF planes added
     at every chroma q4 phase pair, at +-(WIN_R + 0.75) pel at every edge,
     past the windows' reach and with ALTREF but no GOLDEN, on planes one
     byte into their storage with odd pitches, at the RA children's shape
     (8,160) and the strips' (n=16, B=80 and 240, their y_base), its
     ptxas report and CTAs per SM; transform_recon at its four path
     shapes on the step's real blocks, on source against the previous recon,
     on +-255 and zero residuals and on one nonzero level at each scan
     place, at four qindex values (the 8191 level clip reached), its level
     flips counted, after the ptxas report of each of its template instances
     (registers, spills, which fail the run, static shared memory) and its
     resident CTAs per SM from the CUDA runtime's occupancy query;
     kframe_wave on the first panning frame at four qindex values, on
     patches that make every intra mode win (the blocks each mode won
     printed), on a constant frame whose tied modes must all go to the
     first, on 0/255 blocks at qindex 0 (the 8191 level clip) and at small
     geometries (a 1x1, a 1-row and a 1-column grid among them), after its
     ptxas report (registers, spills, which fail the run) and its resident
     CTAs per SM, with its one-block latency and the chain of 93 of them
     beside its device time per keyframe; loop_filter on made-up planes that
     reach every class of the edge filter (the lanes of each class counted
     by the plain version and printed), without a split mask, with a random
     one and with all ones, at three levels, at small geometries, at
     geometries with the bottom 16-pixel strip (720p, 4K and three small
     ones, no mask; the lanes of each class of the strip's own edges
     printed), and on the unfiltered recon, mask and level of the real
     keyframe and M8 P-frame, timed at 1080p, 720p and 4K and by kind of
     CTA, after its ptxas report and resident CTAs per SM; the strip
     geometries' shapes (a 720p keyframe and M8 P-frame through the public
     encoder first, their strip calls recorded): sse_map_search at n=16 r=40
     with its map (its level opting in to more shared memory) for B=80 and
     B=240 and on the real 720p strip, subpel_search at n=16 r=40 likewise,
     transform_recon's ADST_DCT instance on the real keyframe strip's V and
     D63 candidates and on 4K strip blocks at four qindex values, the strip
     zone's transforms and SSEs on the real 720p P-frame, and kframe_wave on
     the 720p and 4K 32 zones (every error word 0); txq_cost on made-up
     residuals within its tolerance; each timed per call with CUDA events
     and on the host clock, and per launch with the profiler; then the
     steps' per-frame scalars as device values (step_scalars_phase): the
     1080p M8 step, the same at tune SQ, a 1080p RA step, the 720p strip
     step and the 1080p keyframe step, each at two qindex values with
     torch.cuda.set_sync_debug_mode("error") around the step call alone,
     every launch's non-pointer words identical at both (cuda_kernels.
     LAUNCH_RECORDER), the launches asserted, a new row giving the held
     row's outputs; aq_scale against its plain version bit for bit on the
     tune SQ zone's real sums, timed; tpu_vp9_torch.graft_entry's entry()
     on the card against the CPU bit for bit and dryrun_multichip(4);
  3. M8 end to end: a 1920x1080 M8 low-delay CQP encode (the device
     keyframe, rate tables, the GOLDEN anchor, the 32-against-16 descent)
     through the public Vp9Encoder; the keyframe must launch kframe_wave
     once (a CTA per block row) and loop_filter once; per P-frame the search
     entry points must launch twice (hier_search_fused, then sse_map_search
     for the children), subpel_search twice, mc_predict twice (the zone
     with its mode decision at the launch's head, the children with
     theirs), transform_recon 6 times, the block_energy ones 3 times,
     descent_gather, descent_pack and descent_split once each,
     mode_decide and descent_decide never (their decisions run in the MC
     launches), extract_windows once (the search's windows; MC reads the
     planes in place), loop_filter once and extend_borders once: 21
     launches (the
     keyframe: kframe_wave, loop_filter and extend_borders once each); some
     parents must split; the stream must
     decode with the port's decoder to the encoder's own recon across two
     GOLDEN refreshes; fps, step time, the host-clock stage split and the send
     split by the spans rt_device_step, rt_stage, rt_rate_args,
     api_scene_cut, api_frame_qindex and rt_d2h_transfer. Inside the same
     counted window txq_cost runs at its own entry point on every P-frame's
     residual (source minus the previous frame's recon), at n=32 and n=16;
  4. txq_cost against its plain version on those residuals (B=2040 n=32,
     B=8160 n=16), within the stated tolerance, flipped blocks counted;
  5. M8 profile: three steady P-frames under torch.profiler, for the share
     of their time the device is busy, the top device operations, and
     each stage's device time (its PyTorch ops' from the profiler's
     ranges, plus its hand kernels', which the ranges leave out); three
     more if the profile lacks a hand kernel's record, and the phase
     fails if that one lacks one too;
  6. keyframes: four 1080p device keyframes through RtSession, decoded,
     with the send time split by the spans kf_device_step, kf_d2h_transfer
     and kf_serialize, and one more under the profiler (up to three, until
     one holds the records of kframe_wave and loop_filter);
  7. M8 same bytes: the first frames again with device="cpu" (the plain
     versions) must give identical packets;
  8. M9 (the uniform 32 grid): end to end on the first frames of the same
     clip, profile and same bytes, as before, at a smaller depth;
  9. the strip geometries (mi_rows % 4 == 2) through the public encoder,
     each with its launch counts per P-frame and per keyframe asserted
     (the strip zone's search, quarter-pel search, transforms and SSEs;
     the keyframe strip's five transforms and one block_energy), decode
     bit-exact, fps, step time (by hand, and by
     RtSession.measure_step_fps), send split, profile: 720p M8 and M9 on
     panning_frames(1280, 720, 10), each also on the CPU for the first
     CPU_FRAMES (identical packets), and 4K M8 on panning_frames(3840,
     2160, 6);
 10. rate control, low delay: 1080p M8 at CBR (2,000,000 b/s) and M9 at
     VBR (4,000,000 b/s), 30 fps, the default VBV and intra period, on 30
     frames of panning_frames(1920, 1080, 30, seed=1) through the public
     encoder, the session holding the controller and serializing inline:
     launches per P-frame and keyframe as at CQP, decode bit-exact, the
     qindex of every frame (it must move), the achieved bitrate against
     the target and the VBV violations, bytes per frame, Y PSNR, fps over
     the P-frames, the send split by the spans of phase 3 and
     rt_serialize_native; the first RC_SAME_FRAMES again on the CPU
     (identical packets and qindexes); the CBR one also under the profiler
     (three P-frames); then bench.py's 4K field: RtSession(3840, 2160,
     intra_period=-1, want_recon=False, golden=True) on
     synthetic_frames(3840, 2160, 12, seed=0, motion=True) at qindex 160,
     fed Frame420s, then the same session's P-frames staged on the card
     (launches asserted, identical packets), the single-stream fps, and
     two sessions interleaved on the staged frames (identical packets each),
     their aggregate fps;
 11. random access, the encoder's default configuration (4 hierarchical
     levels, mini-GOPs of 16, enc_mode 9, CQP qp 40, intra period -1)
     through the public encoder, on the device RA session (ALTREF,
     GOLDEN, at 1080p the descent over every parent): 1080p on
     panning_frames(1920, 1080, 33, seed=1), a key and two mini-GOPs,
     then 720p on 17 frames; packets in display order with DTS = decode
     order - 15, every frame decoded by the port's decoder and every
     reference the session keeps equal to the decoder's picture of that
     poc, the launches of each step held to its (GOLDEN, ALTREF)
     variant, the overhang row's split32 0 in every frame (the split
     parents that took GOLDEN or ALTREF counted), Y PSNR, bytes per
     frame, fps over the P-frames and their split by the spans rt_stage,
     ra_rate_args, ra_device_step, ra_d2h_transfer, ra_serialize; at
     1080p the kernels at the path's new shapes on a real step with
     GOLDEN and ALTREF (the 8,160 children's sse_map_search,
     subpel_search, transform_recon and block_energy;
     ALTREF's hier_search_fused, ZERO SSE and subpel_search; mode_decide
     with all three references, ALTREF's search windows, the borders)
     against
     their plain versions and timed, and one mini-GOP under the
     profiler; at both sizes the RA session on the CPU and the card on
     the first RA_SAME_FRAMES frames with mini-GOPs of RA_SAME_GOP,
     identical packets;
 12. the host route and tune SQ: openloop_modes against its plain version
     (2560x1440 panning and made-up, 1024x768 panning and a plane whose
     tied blocks must take DC, at qindex 0, 120, 255; its ptxas report,
     CTAs per SM, timed), then encode_video at 2560x1440 M8, one keyframe,
     its hints one launch of the kernel, decode bit-exact; the public
     encoder at enc_mode 8 and 9 with tpu_realtime 0 on the clip's first 4
     frames (no realtime session, one sad_full_search a P-frame, decode
     bit-exact, fps, device_me, the keyframe's hint time); 640x360 M8 (the
     realtime step rejects it: the notice, the host route, decode
     bit-exact; at tpu_realtime 1 a RuntimeError); 720p M7 with speed
     control at 30 fps, intra period 9, 12 frames (the mode steps above 7
     at frame 8, the key at frame 10 takes hints, decode bit-exact); M8 at
     tune SQ, the adaptive lambda, at 1080p (the M8 clip) and 720p (10
     frames): one more block_energy a zone a P-frame, decode bit-exact,
     B/frame and Y PSNR beside tune OQ's, fps, send split; at 1080p the
     first 5 frames on the CPU too, packets and every scale vector
     identical;
 13. the host random-access engine and the multi-process routes: 1080p
     random access at M7 (tpu_realtime 0, a key and one 16-frame pyramid):
     exactly one sad_full_search an inter frame, hidden ALTREFs included,
     and no other launch, decode bit-exact, fps over the inter frames,
     B/frame, Y PSNR, the span split (device_me, mode_decision,
     batch_txfm, serialize); 1280x720 M7 on 5 frames with 2 levels on the
     CPU and the card, identical packets; bench.py's CIF fields, M8 random
     access at tpu_realtime 0 and M0, 17 frames each: fps, B/frame, Y
     PSNR, decode bit-exact; 640x360 at the default configuration (the
     device session rejects it: the notice, the host engine, fps, decode
     bit-exact); GOP-parallel, 1080p M8 random access on the device
     session at intra period 16, 4 chunks of a key and one pyramid (68
     frames): the sequential encode, then 1 (in this process), 2 and 4
     spawned workers on the one card, identical packets, fps, each
     worker's peak device memory and its own launches; -nch 2 through the
     CLI at 720p, 9 frames (both streams decode); -distributed with 2
     local processes at 720p, intra period 8, 18 frames (each writes the
     sequential encode's packets);
 14. tile-column sharding (``pipeline/tpu_shard.py``) on the one card:
     make_pframe_step_sharded with GOLDEN and the rate tables on meshes
     that repeat the card, (1, 2), (1, 4) and two frames over (2, 2) at
     1080p, (1, 2) and (1, 4) at 720p (the strip zone sharded too), on the
     real inputs of panning_frames(seed=1) (a device keyframe and two
     P-frames), every per-block array, the gathered recon, the filtered
     references, distortion and rate bit-equal to the single-device
     step's, the launches of each mesh asserted (each shard's zones at
     its shard-local batch, one loop filter a frame); the step time with
     1, 2 and 4 shards beside the single-device step's, and the 2- and
     4-shard steps under the profiler (the kernels' device time at the
     shards' shapes); the public encoder at 1080p M8 with
     tpu_mesh_shape=(1, 1) on 10 frames: the sharded session (no GOLDEN,
     no descent), launches asserted, packets equal to
     RtSession(split16=False, golden=False)'s, decode bit-exact, fps; a
     mesh one wider than the machine at tpu_realtime 1 raises
     RuntimeError; with two cards or more a (1, count) mesh across them
     gives the one card's packets (a line says when it did not run);
 15. M7 (the host encode with the device full-pel search): end to end,
     profile and same bytes, as before.
Before the last line it prints one JSON object of the kernels; the last
line is {"ok": true, "device": {...}}. Without a CUDA card it exits
nonzero before printing any result. jax and the JAX package tpu_vp9 are
blocked from being imported: the port stands alone.

    python3 chip_smoke.py --kernels

stops after phase 2 (a short first run of a changed kernel; one keyframe
and one P-frame are encoded for loop_filter's real input) and prints
neither JSON line.

    python3 chip_smoke.py --ra

runs phase 11 alone after the builds, and prints neither JSON line.

    python3 chip_smoke.py --rc

runs phase 10 alone after the builds, and prints neither JSON line.

    python3 chip_smoke.py --host

runs phase 12 alone after the builds, and prints neither JSON line.

    python3 chip_smoke.py --ra-host

runs phase 13 alone after the builds, and prints neither JSON line.

    python3 chip_smoke.py --mesh

runs phase 14 alone after the builds, and prints neither JSON line.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import statistics
import sys
import time


class _PortOnly:
    """Import hook: the port must run where jax is absent, and must not
    reach into the JAX package."""

    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "tpu_vp9") or name.startswith(
                ("jax.", "jaxlib", "tpu_vp9.")):
            raise ImportError(f"chip_smoke: the port must not import {name}")
        return None


sys.meta_path.insert(0, _PortOnly())

import numpy as np  # noqa: E402
import torch  # noqa: E402

WIDTH, HEIGHT, QP = 1920, 1080, 40
M8_FRAMES, M9_FRAMES, M7_FRAMES, CPU_FRAMES = 20, 10, 4, 3
LIBS = ("sad_search", "block_energy", "sse_search", "txq_cost",
        "loop_filter", "kframe_wave", "transform_recon", "subpel_search",
        "openloop_modes", "mc_predict", "descent", "mode_decide", "windows",
        "aq_scale")
# main-path shapes at 1080p. M7 searches 32x32 blocks at range 16 over
# the 33 whole block rows; the realtime step's 32-grid has 34 rows (the
# last overhangs the picture by 8 pixels) of 60 blocks; M8 descends a
# quarter of them, so it has as many 16x16 children as 32x32 parents
SAD_B, SAD_N, SAD_R = 33 * 60, 32, 16
M9_B = 34 * 60
# launches per P-frame of the step, by wrapper (a decision folded into MC
# counts as an mc_predict launch). M8: the fused two-level
# search of the 32 zone and the children's search; the recon distortion of the
# 32 zone (block_energy; the children's is descent_pack's); the 32 zone's
# ZERO SSE and GOLDEN's ZERO and previous-MV SSE in one launch
# (block_energy_at; the children's ZERO SSE is descent_gather's): 2 search
# and 3 energy launches;
# the quarter-pel search of the zone and of the children; the transform of the
# zone's Y32, U16 and V16 and of the children's Y16, U8 and V8; the loop
# filter of all three planes, split mask included, is one launch; MC of the
# zone's Y, U and V (LAST's and GOLDEN's windows by ref_sel), with the
# zone's mode decision (LAST, GOLDEN, ALTREF and the reference choice) at
# its head, is one launch, and of the children's (their parents' windows by
# index), with their candidate decision at its head, one; the descent's
# gathers, pack and split merge are one launch each; each zone's windows are
# one launch (the search's luma windows; MC reads the reference planes in
# place); the new references' border extension of three planes is one: 21
# launches. M9: the fused search, ZERO SSE, quarter-pel, the window launch,
# the zone's decision and MC, its three transforms, recon distortion, the
# loop filter (no mask) and the borders.
DESCENT_WRAPPERS = ("descent_gather", "descent_decide", "descent_pack",
                    "descent_split")
MD_WINDOW_WRAPPERS = ("mode_decide", "extract_windows", "extend_borders")
# the decisions folded into MC: the step's zone decision and the children's
# run at the head of their MC launch (mc_predict.cu's decided instances,
# through the dispatches mode_decide_mc and descent_decide_mc, counted as
# mc_predict's launches); their own kernels stay for the checks below and
# are launched 0 times on every path. FOLDED_INTO: the merged dispatch and
# how many of its first arguments are the decision's
FOLDED = ("mode_decide", "descent_decide")
FOLDED_INTO = {"mode_decide": ("mode_decide_mc", 18),
               "descent_decide": ("descent_decide_mc", 13)}
DECIDED_MC = ("mode_decide_mc", "descent_decide_mc")
NO_DESCENT = dict.fromkeys(DESCENT_WRAPPERS, 0)
# the position of the step's row of scalars (tpu_encdec.step_scalars) in
# the arguments of the dispatches that take one; their plain versions take
# its values as ints (_plain_args)
ROW_ARG = {"mode_decide": 12, "mode_decide_mc": 12, "descent_decide": 10,
           "descent_decide_mc": 10, "descent_split": 11,
           "transform_recon": 2, "encode_children_masked": 8}
# the descent's launches per descending step
DESCENT_LAUNCHES = {w: int(w not in FOLDED) for w in DESCENT_WRAPPERS}
# a zone's window launch (without ALTREF; its decision runs in its MC
# launch), and the border extension of a step or keyframe
ZONE_MD_WINDOWS = {"mode_decide": 0, "extract_windows": 1}
BORDERS = {"extend_borders": 1}
M8_LAUNCHES = {"hier_search_fused": 1, "sse_map_search": 1,
               "block_energy": 1, "block_energy_at": 2, "txq_cost": 2,
               "loop_filter": 1, "transform_recon": 6, "subpel_search": 2,
               "mc_predict": 2, "aq_scale": 0, **DESCENT_LAUNCHES,
               **ZONE_MD_WINDOWS, **BORDERS}
M9_LAUNCHES = {"hier_search_fused": 1, "sse_map_search": 0,
               "block_energy": 1, "block_energy_at": 1, "txq_cost": 0,
               "loop_filter": 1, "transform_recon": 3, "subpel_search": 1,
               "mc_predict": 1, "aq_scale": 0, **NO_DESCENT,
               **ZONE_MD_WINDOWS, **BORDERS}
# launches per keyframe (M8 and M9 alike): one kframe_wave for the whole
# 34 x 60 grid (its 93 anti-diagonals are its chain), the loop filter of
# the three planes and their border extension
KF_DIAGONALS = 34 + 60 - 1
KEY_LAUNCHES = {"kframe_wave": 1, "loop_filter": 1, **BORDERS}
# the wrappers that launch kernels of one source, by the kernel's name in
# the JSON line
ENTRY_WRAPPERS = {"sad_full_search": ("sad_full_search",),
                  "block_energy": ("block_energy", "block_energy_at"),
                  "sse_map_search": ("sse_map_search", "hier_search_fused"),
                  "txq_cost": ("txq_cost",),
                  "loop_filter": ("loop_filter",),
                  "kframe_wave": ("kframe_wave",),
                  "transform_recon": ("transform_recon",),
                  "subpel_search": ("subpel_search",),
                  "openloop_modes": ("openloop_modes",),
                  "mc_predict": ("mc_predict",),
                  "aq_scale": ("aq_scale",),
                  **{w: (w,) for w in DESCENT_WRAPPERS},
                  **{w: (w,) for w in MD_WINDOW_WRAPPERS}}
# each wrapper's kernel, by a part of its name in a profile
WRAPPER_KERNELS = {"sad_full_search": "sad_search_kernel",
                   "block_energy": "block_energy_kernel",
                   "block_energy_at": "block_energy_at_kernel",
                   "sse_map_search": "sse_search_kernel",
                   "hier_search_fused": "hier_search_kernel",
                   "txq_cost": "txq_cost_kernel",
                   "loop_filter": "loop_filter_kernel",
                   "kframe_wave": "kframe_wave_kernel",
                   "transform_recon": "transform_recon_kernel",
                   "subpel_search": "subpel_search_kernel",
                   "openloop_modes": "openloop_modes_kernel",
                   "mc_predict": "mc_predict_kernel",
                   "aq_scale": "aq_scale_kernel",
                   **{w: f"{w}_kernel" for w in DESCENT_WRAPPERS},
                   **{w: f"{w}_kernel" for w in MD_WINDOW_WRAPPERS}}
# loop_filter: levels with thresh 0 and 3 (and 0: copies), the small
# geometries of the CPU tests (the last no wider than 64: no band), and
# integer operations per filtered edge lane (an upper estimate: 16 loads,
# the masks, filter16's sums and stores)
LF_LEVELS = (0, 9, 50)
LF_SMALL_DIMS = ((128, 128), (192, 120), (160, 96), (96, 64), (64, 64))
LF_OPS_PER_LANE = 100
# geometries with the bottom 16-pixel strip (mi_rows % 4 == 2, no mask):
# 720p and 4K, where the kernel is also timed, and the CPU tests' own
LF_STRIP_DIMS = ((1280, 720), (3840, 2160), (128, 112), (96, 80),
                 (256, 176))
# published peaks of one H100 SXM (NVIDIA's data sheet, dense): HBM bytes/s
# and operations/s by the type of the operands.
# INT8: sums of products of 8-bit integers, which the tensor cores take
# (sse_map_search on uint8 pixels).
# ALU: float32 work outside the tensor cores (txq_cost, whose function is
# defined in float32), and integer work the tensor cores cannot take: the
# half-res search's operands are sums of four pixels and need 10 bits, and
# |a - b| (sad_full_search, block_energy's SAD) is no product. The data
# sheet gives no other rate off the tensor cores.
HBM_BYTES_PER_S, INT8_OPS_PER_S, ALU_OPS_PER_S = 3.35e12, 1979e12, 67e12
# FP64: float64 work at the data sheet's highest float64 rate (its tensor
# cores', where the forward products of transform_recon and kframe_wave
# run; the bounds are held against it), and its rate on the CUDA cores,
# printed beside it
FP64_OPS_PER_S, FP64_CORE_OPS_PER_S = 67e12, 34e12
# kframe_wave per 32x32 block and its two 16x16 chroma blocks: the float64
# operations of the forward transform (two products a plane, a multiply and
# an add per term) and an estimate of the integer ones: 8 a pixel for each
# of the 10 luma predictions and its SSE, 8 a pixel for the chosen mode's
# three planes, 10 a coefficient to quantize and dequantize, about 500 an
# idct32 line (64) and 200 an idct16 line (64), 4 a pixel for the recon
KF_FP64_OPS = 2 * (2 * 32 ** 3 + 2 * 2 * 16 ** 3)
KF_INT_OPS = (8 * 10 * 1024 + 8 * 1536 + 10 * 1536 + 500 * 64 + 200 * 64
              + 4 * 1536)
# kframe_wave's phase: the quantizer indices (0: the 8191 level clip is
# reached), the mode patches' size, and the small geometries of the CPU
# tests (128x32 one block row, 32x128 one block column, 32x32 one block:
# its time is one block's latency)
KF_QINDICES = (10, 100, 255)
KF_SMALL_DIMS = ((128, 96), (160, 120), (96, 64), (64, 64), (192, 120),
                 (128, 32), (32, 128), (32, 32))
# txq_cost's stated tolerance (ops/cuda_kernels.py:txq_cost)
TXQ_RTOL, TXQ_ATOL, TXQ_BAND, TXQ_MAX_FLIPPED = 1e-4, 1e-3, 1e-3, 0.01
# transform_recon: the qindex values of its phase (0: the 8191 level clip),
# the one at which each scan place gets a lone nonzero level (LONE_LEVEL, 4
# at DC), and the band around a rounding boundary where a level may differ
# from the plain version's (the float64 products sum in another order)
TR_QINDICES = (0, 10, 100, 255)
TR_LONE_QINDEX, TR_LONE_LEVEL = 60, 20
TR_FLIP_BAND = 1e-9
# its path's calls per M8 P-frame, in the step's order: the zone's Y, U, V,
# then the children's U, V, Y; and the shapes timed (label, the call's
# index, its launches per P-frame): one launch of each distinct shape, the
# zone's U standing for both its chroma planes and the children's U for
# theirs
TR_CALLS = ("zone Y", "zone U", "zone V", "children U", "children V",
            "children Y")
TR_TIMED = (("zone Y", 0, 1), ("zone U, V", 1, 2), ("children Y", 5, 1),
            ("children U, V", 3, 2))
# integer operations per block besides the float64 transform (an upper
# estimate: the inverse's lines, about 500 an idct32 line, 200 an idct16
# one and 60 an idct8 one, two passes; 16 a pixel for the residual,
# quantizer, dequantizer, eob and recon)
TR_INT_OPS = {32: 500 * 64 + 16 * 1024, 16: 200 * 32 + 16 * 256,
              8: 60 * 16 + 16 * 64}
# subpel_search's path calls per M8 P-frame: the zone's, then the children's
SP_CALLS = ("zone n=32 r=4", "children n=16 r=8")
# mc_predict's path calls per M8 P-frame: the zone's (LAST's and GOLDEN's
# planes by ref_sel), then the children's (their parents' windows by index
# in LAST's planes)
MC_CALLS = ("zone n=32", "children n=16")
# mc_predict.cu's template instances (luma block size n, what it decides
# first: 0 nothing, 1 the zone's decision, 2 the children's) and the names
# of the second (ops/cuda_kernels.py: MC_DECIDED)
MC_INSTANCES = ((16, 0), (16, 1), (16, 2), (32, 0), (32, 1))
MC_DECIDED_BY_KEY = {0: "plain", 1: "zone", 2: "children"}
# the strip geometries (mi_rows % 4 == 2) run end to end, their frames,
# and the blocks of their bottom strip (cols16): 720p has a 22 x 40 grid of
# 32-blocks and a strip of 80 16x16 blocks at y = 704, 4K 67 x 120 and 240
# at y = 2144
STRIP_GEOMS = {"720p": (1280, 720), "4K": (3840, 2160)}
STRIP_FRAMES = {"720p": 10, "4K": 6}
STRIP_B = {"720p": 80, "4K": 240}
# the strip zone's flat search reach (WIN_R)
STRIP_R = 40
# launches per P-frame at a strip geometry, where the descent is off: the
# 32 zone as at 1080p (M8: ZERO, then GOLDEN's two sets, in block_energy_at)
# and the strip zone's search (sse_map_search), quarter-pel search, ZERO
# (and GOLDEN) SSE, decision, window launch, MC, three transforms and
# recon distortion; one border extension
STRIP_MD_WINDOWS = {k: 2 * v for k, v in ZONE_MD_WINDOWS.items()}
M8_STRIP_LAUNCHES = {"hier_search_fused": 1, "sse_map_search": 1,
                     "block_energy": 2, "block_energy_at": 4, "txq_cost": 0,
                     "loop_filter": 1, "transform_recon": 6,
                     "subpel_search": 2, "mc_predict": 2, "aq_scale": 0,
                     **NO_DESCENT, **STRIP_MD_WINDOWS, **BORDERS}
M9_STRIP_LAUNCHES = {"hier_search_fused": 1, "sse_map_search": 1,
                     "block_energy": 2, "block_energy_at": 2, "txq_cost": 0,
                     "loop_filter": 1, "transform_recon": 6,
                     "subpel_search": 2, "mc_predict": 2, "aq_scale": 0,
                     **NO_DESCENT, **STRIP_MD_WINDOWS, **BORDERS}
# per keyframe at a strip geometry: the wave of the 32 zone, the strip's
# three luma candidates (V and D63 ADST_DCT, D45 DCT_DCT) and two chroma
# transforms, the candidates' recon SSE in one block_energy launch, the
# loop filter and the borders
KEY_STRIP_LAUNCHES = {"kframe_wave": 1, "transform_recon": 5,
                      "block_energy": 1, "loop_filter": 1, **BORDERS}
# a profile's warm-up before the work it reports (_profile)
WARM_SPINS, WARM_WAIT_S = 32, 0.05
# rate control in low delay (RateControlMode: VBR 1, CBR 2), every encode's
# frame rate, and the rate-control phase: 1080p M8 at CBR and M9 at VBR, by
# their target bits per second, on RC_FRAMES frames at the default intra
# period (31 at 30 fps) and VBV (twice the target at CBR); the first
# RC_SAME_FRAMES again on the CPU
RC_VBR, RC_CBR, RC_FPS = 1, 2, 30
RC_FRAMES, RC_SAME_FRAMES = 30, 3
RC_CASES = (("1080p m8 cbr", 8, RC_CBR, 2_000_000),
            ("1080p m9 vbr", 9, RC_VBR, 4_000_000))
# bench.py's 4K single- and dual-stream field: RtSession(intra_period=-1,
# want_recon=False, golden=True) on synthetic_frames(3840, 2160, 12, seed=0,
# motion=True) at qindex 160, the P-frames' sources staged on the card
STAGED_DIMS, STAGED_FRAMES, STAGED_QINDEX = (3840, 2160), 12, 160
# the open-loop keyframe hints (openloop_modes): its phase's planes, 2560x1440
# (3,600 blocks; the first 32-aligned size above 1080p) and 1024x768, at
# three qindex values, and the tie plane's qindex (its lam 32 makes DC, V
# and TM tie; ``_ol_tie_plane``); integer operations a 32x32 block, the
# function's work as the first kernel did it and the yardstick of every
# form of the kernel (per pixel and mode a prediction, a difference, a
# square and a sum, 7, 10 modes; the 768 distinct directional words
# filtered, 8 each); beside it, not a bound, the present kernel's own count
# a block by kind (the SSE by expansion, csrc/openloop_modes.cu): per lane,
# integer operations (32 columns of a byte extract and 6 adds, a shift for
# each of the sweeps' 154 moves, 16 folds of 10, the column sums' 65,
# about 40 more), shuffles and warp reductions (the sweeps' 154 moves, the
# column sums' 16, 16 reductions) and dp4a (16 row sums, 16 folds; four
# products each), times the 32 lanes; that count's time, also not a bound,
# at the SM's integer and shuffle rates: 64 32-bit integer results (dp4a
# counted with them) and 32 shuffle results a clock an SM (the CUDA C
# Programming Guide's throughput table, compute capability 9.0), 132 SMs
# at 1.98 GHz (the clock the data sheet's float32 rate implies)
OL_DIMS = {"1440p": (2560, 1440), "768p": (1024, 768)}
OL_QINDICES, OL_TIE_QINDEX = (0, 120, 255), 45
OL_OPS_PER_BLOCK = 7 * 10 * 1024 + 8 * 768
OL_DESIGN_OPS = {"integer": 32 * (32 * 7 + 154 + 16 * 10 + 65 + 40),
                 "shuffle and reduction": 32 * (154 + 16 + 16),
                 "dp4a": 32 * (16 + 16)}
INT32_OPS_PER_S, SHFL_OPS_PER_S = 132 * 64 * 1.98e9, 132 * 32 * 1.98e9
# the host route (enc_mode 8 and 9 at tpu_realtime 0): 1080p frames; the
# fallback of a geometry the realtime step rejects (640x360: mi_rows 45)
# and its frames; speed control on the host route: 720p M7 at 30 fps,
# intra period 9, its frames and the frame of its first check
HOST_FRAMES = 4
FALLBACK_DIMS, FALLBACK_FRAMES = (640, 360), 6
SC_DIMS, SC_FRAMES, SC_INTRA_PERIOD, SC_CHECK = (1280, 720), 12, 9, 8
# tune SQ (the adaptive lambda, Tune.SQ = 0) at enc_mode 8: 1080p on the M8
# phase's frames, 720p (the strip zone) on 10; CPU and CUDA on the first
# AQ_SAME_FRAMES at 1080p, packets and every scale vector
TUNE_SQ, AQ_720P_FRAMES, AQ_SAME_FRAMES = 0, 10, 5


def _bound(nbytes: float, ops: float, ops_per_s: float):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` (each input read once, each output written once) or
    to do ``ops`` operations at the peak for their operands' type,
    whichever is larger."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return 1000 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def _sum_bounds(parts):
    """Sum of (count, (ms, by)) bounds; bound_by is that of the larger
    share."""
    total = sum(c * ms for c, (ms, _) in parts)
    by = {}
    for c, (ms, kind) in parts:
        by[kind] = by.get(kind, 0.0) + c * ms
    return total, max(by, key=by.get)


def _cuda_time_ms(fn, reps: int) -> float:
    """Median of per-call device times from CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _calls_in_turns(fn_a, fn_b, reps: int):
    """Medians of per-call times from CUDA events of two functions of the
    same work, called in turns (a, b, b, a, ...) after a warm-up of
    each, so that the host's state favours neither."""
    times = ([], [])
    for fn in (fn_a, fn_b):
        fn()
    torch.cuda.synchronize()
    for i in range(2 * reps):
        k = (i + i // 2) % 2  # a b b a a b b a ...
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        (fn_a, fn_b)[k]()
        end.record()
        end.synchronize()
        times[k].append(start.elapsed_time(end))
    return statistics.median(times[0]), statistics.median(times[1])


def _max_err(got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        if (g is None) != (w is None):
            raise AssertionError("kernel and plain version disagree on "
                                 "which outputs exist")
        if g is not None:
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def _check(name, label, got, want):
    torch.cuda.synchronize()
    err = _max_err(got, want)
    print(f"kernel {name} [{label}]: max_abs_err={err}")
    if err != 0:
        raise AssertionError(f"{name} disagrees with its plain version on "
                             f"{label}")
    return err


def _row(dev, dc_q=40, ac_q=48, lam=0, lvl=0, lim=0, mblim=0):
    """A step's row of scalars on ``dev`` (``tpu_encdec.step_scalars``):
    the form in which the step's kernels take the quantizers, the lambda
    and the loop filter's level and limits."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    return P.step_scalars(dc_q, ac_q, lam, lvl, lim, mblim, dev)


def _held(name, args):
    """A dispatch's recorded arguments as they were at its call: the
    step's row of scalars (``ROW_ARG``) and the rate tables' dicts, which a
    session refills in place before its next frame, as copies (no wait);
    the rest as they are."""
    at = ROW_ARG.get(name)
    return tuple(a.clone() if i == at else
                 {k: v.clone() if isinstance(v, torch.Tensor) else v
                  for k, v in a.items()} if isinstance(a, dict) else a
                 for i, a in enumerate(args))


def _plain_args(name, args):
    """A dispatch's arguments as its plain version takes them: the step's
    row of scalars (``ROW_ARG``) replaced by its lam (a read of the
    row)."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    at = ROW_ARG[name]
    return (*args[:at], int(args[at][P.SC_LAM]), *args[at + 1:])


def _tr_ints(args):
    """A recorded transform call (src, pred, row, n[, tx_type]) with the
    row's quantizers as ints: (src, pred, dc_q, ac_q, n[, tx_type])."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    row = args[2].tolist()
    return (*args[:2], row[P.SC_DC_Q], row[P.SC_AC_Q], *args[3:])


def _tr_row(args):
    """(src, pred, dc_q, ac_q, n[, tx_type]) as the transform's wrapper
    takes it: the quantizers in a step's row on the blocks' device."""
    return (*args[:2], _row(args[0].device, args[2], args[3]), *args[4:])


def _device_ms(fn, kernel_key: str, reps: int = 20):
    from tpu_vp9_torch.utils.device import device_ms

    return device_ms(fn, kernel_key, reps)


def _host_ms(fn, reps: int = 1000) -> float:
    """Host-clock time per call of the wrapper: ``reps`` calls back to
    back without waiting for the device, then one synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1000 * host / reps


def _timed(name, label, kernel_fn, plain_fn, plain_reps, bound, kernel_key,
           count=1):
    """One shape's part of a kernel's entry: (launches of this shape per
    P-frame, label, call ms, plain ms, bound, device ms or None, host ms).
    Call time is the median of CUDA-event times around one call, wrapper
    included; device time is the kernel's own per launch (profiler); host
    time is what the wrapper costs the host per call."""
    ms = _cuda_time_ms(kernel_fn, 50)
    plain_ms = _cuda_time_ms(plain_fn, plain_reps)
    device_ms = _device_ms(kernel_fn, kernel_key)
    host_ms = _host_ms(kernel_fn)
    shown = "not measured" if device_ms is None else f"{device_ms:.4f} ms"
    print(f"kernel {name} {label}: call {ms:.4f} ms (CUDA events, median), "
          f"device {shown} per launch (profiler), host {host_ms:.4f} ms per "
          f"call (1000 back to back); plain {plain_ms:.4f} ms; bound "
          f"{bound[0]:.5f} ms by {bound[1]}")
    return (count, label, ms, plain_ms, bound, device_ms, host_ms)


def _entry(name, source, replaces, max_err, parts):
    """One kernel's line of the JSON from the parts ``_timed`` returns: the
    times are summed over one P-frame's launches on the kernel's main
    path. The bound is to be held against ``device_ms``; the path pays
    ``ms``. No single PyTorch call computes any of these functions, so
    library_ms is null."""
    parts = [p for p in parts if p[0] > 0]
    bound_ms, bound_by = _sum_bounds([(p[0], p[4]) for p in parts])
    measured = all(p[5] is not None for p in parts)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "max_abs_err": max_err,
            "ms": sum(p[0] * p[2] for p in parts),
            "plain_ms": sum(p[0] * p[3] for p in parts),
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "device_ms": (sum(p[0] * p[5] for p in parts) if measured
                          else None),
            "host_ms": sum(p[0] * p[6] for p in parts),
            "parts": [{"shape": p[1], "per_frame": p[0], "ms": p[2],
                       "device_ms": p[5], "host_ms": p[6],
                       "bound_ms": p[4][0]} for p in parts]}


def _sad_inputs(b, n, r, seed):
    rng = np.random.default_rng(seed)
    win = n + 2 * r
    blocks = rng.integers(0, 256, (b, n, n), dtype=np.uint8)
    regions = rng.integers(0, 256, (b, win, win), dtype=np.uint8)
    # planted exact matches at seeded displacements in every other block
    for i in range(0, b, 2):
        oy, ox = rng.integers(0, 2 * r + 1, 2)
        regions[i, oy:oy + n, ox:ox + n] = blocks[i]
    return blocks, regions


def sad_kernel_phase(dev):
    """sad_full_search (CUDA) against sad_full_search_ref on the card."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    cases = []
    blocks, regions = _sad_inputs(SAD_B, SAD_N, SAD_R, seed=0)
    cases.append(("random+planted", SAD_N, SAD_R, blocks, regions))
    # every candidate ties: the first in dy-major order, (-r, -r), wins
    win = SAD_N + 2 * SAD_R
    cases.append(("constant tie", SAD_N, SAD_R,
                  np.full((SAD_B, SAD_N, SAD_N), 99, np.uint8),
                  np.full((SAD_B, win, win), 99, np.uint8)))
    for n, r in ((16, 4), (64, 16)):
        blocks, regions = _sad_inputs(512, n, r, seed=n + r)
        cases.append((f"random n={n} r={r}", n, r, blocks, regions))
    max_err = 0
    part = None
    for label, n, r, blocks, regions in cases:
        src = torch.from_numpy(blocks).to(dev)
        reg = torch.from_numpy(regions).to(dev)
        got = K.sad_full_search(src, reg, n, r)
        max_err = max(max_err, _check(
            "sad_full_search", f"{label} B={src.shape[0]} n={n} r={r}", got,
            K.sad_full_search_ref(src, reg, n, r)))
        if label == "constant tie":
            if not (bool((got[0] == -r).all()) and bool((got[1] == -r).all())):
                raise AssertionError("sad_full_search: tie did not go to "
                                     "(-r, -r)")
        if part is None:  # the main path's shape
            b, d = src.shape[0], 2 * r + 1
            # reads blocks and regions, writes three int32 per block; two
            # integer operations (|a - b|, add) per candidate pixel
            bound = _bound(b * (n * n + (n + 2 * r) ** 2) + 12 * b,
                           2 * b * d * d * n * n, ALU_OPS_PER_S)
            part = _timed(
                "sad_full_search", f"B={b} n={n} r={r}",
                lambda: K.sad_full_search(src, reg, n, r),
                lambda: K.sad_full_search_ref(src, reg, n, r), 5, bound,
                "sad_search_kernel")
    return _entry("sad_full_search", "tpu_vp9_torch/csrc/sad_search.cu",
                  "tpu_vp9/ops/pallas_kernels.py:76", max_err, [part])


def _energy_at_inputs(n, c, seed):
    """A border-extended 1080p luma plane, source blocks and (c, B) starts
    for B = 2040 blocks: the grid positions (set 0, as the ZERO candidate)
    and seeded starts anywhere in the plane at any alignment (the others),
    with blocks in all four corners and one copied out of the plane at an
    odd start (zero energy)."""
    rng = np.random.default_rng(seed)
    hh, ww = 1088 + 192, WIDTH + 192
    plane = rng.integers(0, 256, (hh, ww), dtype=np.uint8)
    src = rng.integers(0, 256, (M9_B, n, n), dtype=np.uint8)
    cols = WIDTH // n
    idx = np.arange(M9_B)
    y0 = np.empty((c, M9_B), np.int32)
    x0 = np.empty((c, M9_B), np.int32)
    y0[0] = np.minimum(96 + (idx // cols) * n, hh - n)
    x0[0] = 96 + (idx % cols) * n
    y0[1:] = rng.integers(0, hh - n + 1, (c - 1, M9_B))
    x0[1:] = rng.integers(0, ww - n + 1, (c - 1, M9_B))
    last = c - 1
    for i, (y, x) in enumerate(((0, 0), (0, ww - n), (hh - n, 0),
                                (hh - n, ww - n), (hh - n, ww - n - 1),
                                (1, 1), (2, 3))):
        y0[last, i], x0[last, i] = y, x
    y0[last, 7], x0[last, 7] = 101, 203
    src[7] = plane[101:101 + n, 203:203 + n]
    return plane, src, y0, x0


def energy_kernel_phase(dev):
    """block_energy and block_energy_at (CUDA) against their plain
    versions at B=2040, n=32 (the 32 zone's recon SSE; n=16, the M8
    children's until descent_pack took it, checked at B=256 with n=8 and
    64: the strips time it at their shapes)."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    rng = np.random.default_rng(3)
    max_err = 0
    parts = []
    for n, per_frame in ((32, 1), (16, 0), (8, 0), (64, 0)):
        b = M9_B if per_frame else 256
        src = rng.integers(0, 256, (b, n, n), dtype=np.uint8)
        pred = np.clip(src.astype(np.int32) + rng.integers(-40, 41, src.shape),
                       0, 255).astype(np.uint8)
        pred[0] = src[0]  # zero energy
        src[1], pred[1] = 0, 255  # the largest energy of a block
        pred[2] = rng.integers(0, 256, (n, n), dtype=np.uint8)  # unrelated
        s = torch.from_numpy(src).to(dev)
        p = torch.from_numpy(pred).to(dev)
        max_err = max(max_err, _check(
            "block_energy", f"B={b} n={n}", K.block_energy(s, p, n),
            K.block_energy_ref(s, p, n)))
        if per_frame:
            # reads both blocks, writes two int32 per block; subtract,
            # square or abs, add, twice over per pixel
            bound = _bound(2 * b * n * n + 8 * b, 5 * b * n * n,
                           ALU_OPS_PER_S)
            parts.append(_timed(
                "block_energy", f"blocks B={b} n={n}",
                lambda: K.block_energy(s, p, n),
                lambda: K.block_energy_ref(s, p, n), 20, bound,
                "block_energy_kernel", per_frame))
    # positioned: the 32 zone's ZERO (C=1), GOLDEN's ZERO and previous MV
    # (C=2); other sizes checked only (the children's ZERO, n=16 C=1, is
    # descent_gather's)
    K.CHECK_STARTS = True  # the checks below also run the starts' check
    for n, c, per_frame in ((32, 1, 1), (32, 2, 1), (16, 1, 0), (16, 3, 0),
                            (8, 2, 0), (64, 2, 0)):
        plane_np, src_np, y0_np, x0_np = _energy_at_inputs(n, max(c, 2),
                                                           seed=n + c)
        plane = torch.from_numpy(plane_np).to(dev)
        s = torch.from_numpy(src_np).to(dev)
        # C=1 is timed on the grid (the ZERO candidate) and checked on the
        # seeded starts as well
        for rows in ([max(c, 2) - 1], [0]) if c == 1 else (list(range(c)),):
            y0 = torch.from_numpy(y0_np[rows]).to(dev)
            x0 = torch.from_numpy(x0_np[rows]).to(dev)
            got = K.block_energy_at(s, plane, y0, x0, n)
            max_err = max(max_err, _check(
                "block_energy_at", f"B={M9_B} n={n} C={len(rows)} sets "
                f"{rows}", got, K.block_energy_at_ref(s, plane, y0, x0, n)))
            if rows[-1] != 0 and int(got[0][-1, 7]) != 0:
                raise AssertionError("block_energy_at: the copied block has "
                                     "energy")
        # a view of a wider plane: the pitch is not the width
        wide = torch.from_numpy(np.pad(plane_np, ((0, 0), (0, 20)))).to(dev)
        view = wide[:, :plane_np.shape[1]]
        max_err = max(max_err, _check(
            "block_energy_at", f"n={n} C={y0.shape[0]} pitch "
            f"{view.stride(0)} != width {view.shape[1]}",
            K.block_energy_at(s, view, y0, x0, n), got))
        if per_frame:
            K.CHECK_STARTS = False  # as the step runs it
            # reads the blocks once and each candidate's prediction, the
            # starts, writes two int32 per candidate
            bound = _bound(M9_B * n * n * (1 + c) + 16 * c * M9_B,
                           5 * c * M9_B * n * n, ALU_OPS_PER_S)
            parts.append(_timed(
                "block_energy_at", f"positioned B={M9_B} n={n} C={c}",
                lambda: K.block_energy_at(s, plane, y0, x0, n),
                lambda: K.block_energy_at_ref(s, plane, y0, x0, n), 20,
                bound, "block_energy_at_kernel", per_frame))
            K.CHECK_STARTS = True
    K.CHECK_STARTS = False
    return _entry("block_energy", "tpu_vp9_torch/csrc/block_energy.cu",
                  "tpu_vp9/ops/pallas_kernels.py:118", max_err, parts)


def _sse_inputs(n, r, half, seed, b=M9_B):
    """Search inputs as the step makes them: windows of n+2r+8 (2x2 sums
    of uint8 pixels at the half-res level, int16), with a planted exact
    match in every other block (its minimum relative SSE is
    -sum(src^2) < 0), block 1 constant (every candidate ties), block 3
    constant but for one bright window pixel, and the largest operands:
    block 5 a window of the largest value against a zero source (the
    largest sum(reg^2)), block 7 against a source of the largest value
    (the largest cross term as well)."""
    rng = np.random.default_rng(seed)
    sw = n + 2 * r + 8
    k = 2 if half else 1
    wins = rng.integers(0, 256, (b, sw * k, sw * k)).astype(np.int32)
    src = rng.integers(0, 256, (b, n * k, n * k)).astype(np.int32)
    if half:
        wins = wins.reshape(b, sw, 2, sw, 2).sum(axis=(2, 4))
        src = src.reshape(b, n, 2, n, 2).sum(axis=(2, 4))
    for i in range(0, b, 2):
        oy, ox = rng.integers(0, 2 * r + 1, 2)
        wins[i, 4 + oy:4 + oy + n, 4 + ox:4 + ox + n] = src[i]
    src[1], wins[1] = 40 * k * k, 40 * k * k
    src[3], wins[3] = 10, 10
    wins[3, 4 + r, 4 + r] = 200
    top = 255 * k * k
    src[5], wins[5] = 0, top
    src[7], wins[7] = top, top
    dt = np.int16 if half else np.uint8
    return src.astype(dt), wins.astype(dt)


def _hier_inputs(seed):
    """(B, 32, 32) sources and (B, 120, 120) windows of the fused search,
    B = 2040. Every fourth block is an exact copy of its window at a
    seeded displacement within +-40 (at an even one the half-res minimum
    is -sum(src_h^2) < 0); the others are such copies plus noise. Block 1
    is constant (every candidate ties at both levels); blocks 2, 3, 6, 10
    are planted at the four corners of the +-40 reach (the centre at its
    clamp of +-36, the refine winner at +-4); block 5 is the largest
    window against a zero source and block 7 against the largest source
    (half-res operands of 1020). The windows are smooth, the corners' a
    bowl."""
    rng = np.random.default_rng(seed)
    # smooth windows (a coarse random field, interpolated, and a little
    # noise), so that the half-res level leads the refine to a planted
    # match
    coarse = torch.from_numpy(rng.uniform(0, 255, (M9_B, 1, 6, 6)))
    field = torch.nn.functional.interpolate(
        coarse, size=(120, 120), mode="bicubic", align_corners=True)
    field = field[:, 0].numpy() + rng.integers(-3, 4, (M9_B, 120, 120))
    wins = np.clip(field, 0, 255).astype(np.uint8)
    src = np.empty((M9_B, 32, 32), np.uint8)
    disp = rng.integers(-40, 41, (M9_B, 2))
    disp[0] = (-12, 22)  # even: its half-res match is exact
    corners = {2: (-40, -40), 3: (-40, 40), 6: (40, -40), 10: (40, 40)}
    yy, xx = np.mgrid[0:120, 0:120]
    for i, c in corners.items():
        disp[i] = c
        # a bowl: the SSE grows with the distance from the planted match,
        # so the half-res level ends at its nearest corner
        wins[i] = ((yy - 60) ** 2 + (xx - 60) ** 2) * 255 // 7200
    for i in range(M9_B):
        oy, ox = 44 + disp[i]
        blk = wins[i, oy:oy + 32, ox:ox + 32]
        if i % 4 and i not in corners:
            blk = np.clip(blk.astype(np.int32) + rng.integers(-6, 7, (32, 32)),
                          0, 255)
        src[i] = blk
    src[1], wins[1] = 77, 77
    src[5], wins[5] = 0, 255
    src[7], wins[7] = 255, 255
    return src, wins, corners


def hier_kernel_checks(dev):
    """hier_search_fused (CUDA) against hier_search_ref, all seven
    outputs; returns (max_abs_err, its part of the sse_map_search
    entry)."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    src_np, wins_np, corners = _hier_inputs(seed=11)
    s = torch.from_numpy(src_np).to(dev)
    w = torch.from_numpy(wins_np).to(dev)
    got = K.hier_search_fused(s, w, 32)
    want = K.hier_search_ref(s, w, 32)
    err = _check("hier_search_fused", f"B={M9_B} n=32 (c_y, c_x, dyr, dxr, "
                 "loc, ssem_h, src2_h)", got, want)
    c_y, c_x, dyr, dxr, _, ssem_h, src2_h = (t.cpu() for t in got)
    if not (int(ssem_h[0].min()) == -int(src2_h[0]) < 0):
        raise AssertionError("hier_search_fused: the planted block's "
                             "half-res minimum is not -sum(src_h^2)")
    if (int(c_y[1]), int(c_x[1]), int(dyr[1]), int(dxr[1])) != (-36, -36,
                                                                -4, -4):
        raise AssertionError("hier_search_fused: ties did not go to the "
                             "first candidate of both levels")
    for i, (dy, dx) in corners.items():
        found = (int(c_y[i] + dyr[i]), int(c_x[i] + dxr[i]))
        if found != (dy, dx) or abs(int(c_y[i])) != 36:
            raise AssertionError(f"hier_search_fused: corner {dy, dx} found "
                                 f"as {found} around centre "
                                 f"{int(c_y[i]), int(c_x[i])}")
    if int(ssem_h[5, 0, 0]) != 256 * 1020 ** 2 or \
            int(ssem_h[7, 0, 0]) != -256 * 1020 ** 2:
        raise AssertionError("hier_search_fused: the largest operands' map "
                             "entries are wrong")
    # least work: reads the source and the window once, writes the map,
    # the refine window and five int32 per block; a multiply and an add
    # per candidate pixel, the half-res level's (10-bit operands) at the
    # rate off the tensor cores and the refine's (pixels) at the 8-bit
    # tensor-core rate, here as operations at the former
    ops = 2 * M9_B * (37 * 37 * 16 * 16
                      + 9 * 9 * 32 * 32 * ALU_OPS_PER_S / INT8_OPS_PER_S)
    bound = _bound(M9_B * (120 * 120 + 32 * 32 + 4 * 37 * 37 + 48 * 48 + 20),
                   ops, ALU_OPS_PER_S)
    part = _timed("hier_search_fused", f"fused B={M9_B} n=32",
                  lambda: K.hier_search_fused(s, w, 32),
                  lambda: K.hier_search_ref(s, w, 32), 3, bound,
                  "hier_search_kernel", 1)
    return err, part


def sse_kernel_phase(dev):
    """sse_map_search (CUDA) against sse_map_search_ref at the shapes of
    both levels of the hierarchical search and of the children's +-8
    search (B = 4 * K = 2040, with the map), then both levels fused. One
    M8 P-frame launches the fused kernel once and the children's search
    once; the two levels on their own are timed beside them."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    max_err = 0
    parts = []
    for label, n, r, half, want_map, per_frame in (
            ("half-res", 16, 18, True, True, 0),
            ("refine", 32, 4, False, False, 0),
            ("children", 16, 8, False, True, 1)):
        s_np, w_np = _sse_inputs(n, r, half, seed=n + r)
        s = torch.from_numpy(s_np).to(dev)
        w = torch.from_numpy(w_np).to(dev)
        for with_map in (True, False):
            got = K.sse_map_search(s, w, n, r, want_map=with_map)
            want = K.sse_map_search_ref(s, w, n, r, want_map=with_map)
            max_err = max(max_err, _check(
                "sse_map_search", f"{label} B={M9_B} n={n} r={r} "
                f"{s.dtype} map={with_map}", got, want))
        rel = K.sse_map_search_ref(s, w, n, r)[2].reshape(M9_B, -1)
        if not bool((rel[0].min() < 0).item()):
            raise AssertionError("sse_map_search: the planted block's "
                                 "minimum relative SSE is not negative")
        if not (int(got[0][1]) == -r and int(got[1][1]) == -r):
            raise AssertionError("sse_map_search: tie did not go to (-r, -r)")
        top = int(w_np.max())
        if int(rel[5, 0]) != n * n * top * top or \
                int(rel[7, 0]) != -n * n * top * top:
            raise AssertionError("sse_map_search: the largest operands' map "
                                 "entries are wrong")
        d, sw = 2 * r + 1, n + 2 * r + 8
        # reads blocks and windows, writes the winner and (if asked) the
        # map; a multiply and an add per candidate pixel, at the tensor
        # cores' 8-bit rate where the operands are pixels
        bound = _bound(M9_B * ((n * n + sw * sw) * s.element_size() + 8
                               + (4 * d * d if want_map else 0)),
                       2 * M9_B * d * d * n * n,
                       ALU_OPS_PER_S if half else INT8_OPS_PER_S)
        part = _timed(
            "sse_map_search", f"{label} B={M9_B} n={n} r={r} map={want_map}",
            lambda: K.sse_map_search(s, w, n, r, want_map),
            lambda: K.sse_map_search_ref(s, w, n, r, want_map), 5, bound,
            "sse_search_kernel", per_frame)
        parts.append(part)
    # small shapes of the other strip width and block size, and B = 1
    for n, r, b in ((8, 3, 1), (8, 12, 33), (32, 6, 17), (16, 4, 5)):
        rng = np.random.default_rng(n * r)
        sw = n + 2 * r + 8
        s = torch.from_numpy(rng.integers(0, 256, (b, n, n),
                                          dtype=np.uint8)).to(dev)
        w = torch.from_numpy(rng.integers(0, 256, (b, sw, sw),
                                          dtype=np.uint8)).to(dev)
        max_err = max(max_err, _check(
            "sse_map_search", f"random B={b} n={n} r={r} uint8",
            K.sse_map_search(s, w, n, r), K.sse_map_search_ref(s, w, n, r)))
    err, part = hier_kernel_checks(dev)
    parts.insert(0, part)
    return _entry("sse_map_search", "tpu_vp9_torch/csrc/sse_search.cu",
                  "tpu_vp9/pipeline/tpu_encdec.py:406", max(max_err, err),
                  parts)


def _residual_blocks(dev, frame, prev_recon, n):
    """(B, n, n) float32 blocks of source minus the co-located previous
    reconstruction, the picture edge-padded to whole 32-blocks (34 rows of
    60 at 1080p): B=2040 at n=32, B=8160 at n=16."""
    h = (HEIGHT + 31) // 32 * 32
    d = (np.pad(frame.y, ((0, h - HEIGHT), (0, 0)), mode="edge")
         .astype(np.float32)
         - np.pad(prev_recon[0], ((0, h - HEIGHT), (0, 0)), mode="edge"))
    t = torch.from_numpy(d).to(dev)
    return t.reshape(h // n, n, WIDTH // n, n).permute(0, 2, 1, 3) \
        .reshape(-1, n, n).contiguous()


def _txq_exposed(resid, dc_q, ac_q, n):
    """Blocks with a coefficient whose |c|/q + 0.38 lies within TXQ_BAND
    of an integer, from float64 products of the float32 DCT matrix."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    d = torch.from_numpy(K.dct_matrix(n)).to(resid.device, torch.float64)
    c = d @ resid.to(torch.float64) @ d.T
    q = torch.full((n, n), float(ac_q), dtype=torch.float64,
                   device=resid.device)
    q[0, 0] = float(dc_q)
    v = c.abs() / q + float(np.float32(K.TXQ_BIAS))
    return ((v - v.round()).abs() < TXQ_BAND).flatten(1).any(dim=1)


def _txq_compare(resid, dc_q, ac_q, n):
    """txq_cost against txq_cost_ref on one batch: (blocks outside the
    tolerance, blocks, largest error of the others). Raises if a block
    with no coefficient near a rounding boundary is outside."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    got = K.txq_cost(resid, dc_q, ac_q, n)
    want = K.txq_cost_ref(resid, dc_q, ac_q, n)
    torch.cuda.synchronize()
    exposed = _txq_exposed(resid, dc_q, ac_q, n)
    bad = torch.zeros_like(exposed)
    max_err = 0.0
    for g, w in zip(got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError("txq_cost: non-finite output")
        err = (g.double() - w.double()).abs()
        off = err > TXQ_ATOL + TXQ_RTOL * w.double().abs()
        bad |= off
        if bool((~off).any()):
            max_err = max(max_err, float(err[~off].max()))
    if bool((bad & ~exposed).any()):
        raise AssertionError(
            f"txq_cost n={n}: a block with no coefficient near a rounding "
            "boundary is outside the tolerance")
    return int(bad.sum()), bad.numel(), max_err


def _txq_bound(b, n):
    # reads the residuals and the matrix, writes two floats per block;
    # two n^3 products (a multiply and an add each) and about ten
    # operations per coefficient for the quantizer and the sums
    return _bound(4 * (b * n * n + n * n + 2 * b),
                  b * (4 * n ** 3 + 10 * n * n), ALU_OPS_PER_S)


def _txq_report(label, n, q, flipped, total, max_err):
    print(f"kernel txq_cost [{label} n={n} q=({q[0]}, {q[1]})]: {flipped} "
          f"of {total} blocks outside the tolerance (each with a "
          f"coefficient within {TXQ_BAND} of a rounding boundary); "
          f"max_abs_err of the others {max_err:.6f}")
    if flipped >= TXQ_MAX_FLIPPED * total:
        raise AssertionError(f"txq_cost n={n}: {flipped} of {total} "
                             "blocks flipped")


# the step-scalars phase: qindex values the steps run at twice (a third
# warms the caches first), and aq_scale's float64 operations a block (two
# logs and an exp, about 20 each, beside its float32 steps)
SC_QINDICES, SC_WARM_QINDEX = (60, 200), 120
AQ_FP64_OPS = 60


def _step_call(step, args, words):
    """One call of a step with ``torch.cuda.set_sync_debug_mode("error")``
    around it alone (any operation that waits for the card raises), every
    launch's non-pointer words appended to ``words`` (``cuda_kernels.
    LAUNCH_RECORDER``) and the launches counted (``_read_counts``)."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    _reset_counts()
    K.LAUNCH_RECORDER = lambda name, w: words.append((name, tuple(w)))
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        K.LAUNCH_RECORDER = None
    return out, _read_counts()


def _same_outputs(label, a, b):
    """Raise unless two step results (dicts, tuples and tensors) are equal
    tensor by tensor."""
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"{label}: outputs {sorted(a)} and "
                                 f"{sorted(b)}")
        for k in a:
            _same_outputs(f"{label} {k}", a[k], b[k])
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _same_outputs(f"{label} [{i}]", x, y)
    elif isinstance(a, torch.Tensor):
        if a.shape != b.shape or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{label}: the outputs differ")


def step_scalars_phase(dev, frames, recons):
    """The steps' per-frame scalars as device values (the step's row of
    scalars, ``tpu_encdec.step_scalars``, and the rate tables, refilled in
    place in tensors held for the phase, as the sessions hold them): the
    1080p M8 step (GOLDEN, the rate tables, the descent), the same at tune
    SQ, a 1080p RA step (GOLDEN and ALTREF, every parent descending), the
    720p M8 strip step and the 1080p keyframe step, each at two qindex
    values after one at a third that fills the caches, the step call alone
    under ``torch.cuda.set_sync_debug_mode("error")`` (nothing in a step
    waits for the card). Every launch's non-pointer words (``cuda_kernels.
    LAUNCH_RECORDER``) must be identical at the two qindex values, the
    outputs must differ, and each step's launches are asserted; a step run
    again on a new row of the second qindex must give the held row's
    outputs (no stale scalar). Then aq_scale against aq_scale_ref bit for
    bit on the tune SQ zone's real sums (its launch timed for the kernels'
    line), and ``tpu_vp9_torch.graft_entry`` on the card: ``entry()``'s
    function against its run on the CPU bit for bit, and
    ``dryrun_multichip(4)`` on a mesh of the card repeated. ``frames``,
    ``recons``: the 1080p clip's first two frames and their recon (the
    keyframe's is LAST, GOLDEN and ALTREF). Returns aq_scale's entry of
    the kernels' line."""
    from tpu_vp9_torch import graft_entry
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.ops.loopfilter import (
        pick_filter_level, sharpness_limits,
    )
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.pipeline.realtime import upload_refs
    from tpu_vp9_torch.utils.yuv import panning_frames

    lim_t, mblim_t = sharpness_limits(0)
    fc = T.default_frame_context()

    def stage(g, fr):
        shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
                  (g.pad_h // 2, g.pad_w // 2))
        return tuple(torch.from_numpy(P.pad_plane(np.asarray(p), *shp))
                     .to(dev) for p, shp in zip((fr.y, fr.u, fr.v), shapes))

    def refill(row, rates, q, key):
        lvl = pick_filter_level(q, key)
        ac_q = T.ac_quant(q)
        P.step_scalars(T.dc_quant(q), ac_q, max(1, (ac_q ** 2) >> 6), lvl,
                       int(lim_t[lvl]), int(mblim_t[lvl]), out=row)
        if rates is not None:
            P.upload_rate_tabs(P.make_rate_tabs(fc, q), dev, out=rates)

    g = P.make_geom(WIDTH, HEIGHT)
    src = stage(g, frames[1])
    last = upload_refs(recons[0], g, dev)
    zero32 = torch.zeros((g.n_blocks32, 2), dtype=torch.int32, device=dev)
    zero16 = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    g7 = P.make_geom(*STRIP_GEOMS["720p"])
    f7 = list(panning_frames(*STRIP_GEOMS["720p"], 2, seed=1))
    last7 = upload_refs([np.asarray(p) for p in (f7[0].y, f7[0].u,
                                                 f7[0].v)], g7, dev)
    m8 = _path_launches(g, 8)[0]
    cases = (
        ("1080p M8 step (GOLDEN, rate tables, descent)",
         P.make_pframe_step(g, dev, split16=True, golden=True),
         (*src, *last, *last), (zero32, zero16), True, False,
         {**m8, "txq_cost": 0}),
        ("1080p M8 step at tune SQ",
         P.make_pframe_step(g, dev, split16=True, golden=True, aq=True),
         (*src, *last, *last), (zero32, zero16), True, False,
         _path_launches(g, 8, aq=True)[0]),
        ("1080p RA step (GOLDEN, ALTREF, every parent)",
         P.make_pframe_step(g, dev, split16=True, golden=True, altref=True,
                            with_rates=True, descend_frac=1),
         (*src, *last, *last, *last), (zero32, zero16), True, False,
         _ra_launches(g, True, True)),
        ("720p M8 strip step",
         P.make_pframe_step(g7, dev, golden=True),
         (*stage(g7, f7[1]), *last7, *last7),
         (torch.zeros((g7.n_blocks32, 2), dtype=torch.int32, device=dev),
          torch.zeros((g7.cols16, 2), dtype=torch.int32, device=dev)),
         True, False, {**_path_launches(g7, 8)[0], "txq_cost": 0}),
        ("1080p keyframe step", P.make_kframe_step(g, dev),
         src, (), False, True, KEY_LAUNCHES))
    aq_calls = []
    for label, step, planes, prev, with_rates, key, launches in cases:
        row = torch.zeros(len(K.STEP_SCALARS), dtype=torch.int32, device=dev)
        rates = None
        if with_rates:
            rates = P.upload_rate_tabs(P.make_rate_tabs(fc, SC_WARM_QINDEX),
                                       dev)
        args = (*planes, *prev, row, *(() if rates is None else (rates,)))
        refill(row, rates, SC_WARM_QINDEX, key)
        step(*args)
        torch.cuda.synchronize()
        words, outs = [], []
        for q in SC_QINDICES:
            refill(row, rates, q, key)
            w = []
            real = _recording_scales(aq_calls) if "tune SQ" in label \
                else None
            try:
                (out, _), counts = _step_call(step, args, w)
            finally:
                if real is not None:
                    P.aq_scale = real
            torch.cuda.synchronize()
            want = {**dict.fromkeys(counts, 0), **launches}
            if counts != want:
                raise AssertionError(f"{label} at qindex {q}: launches "
                                     f"{counts} != {want}")
            words.append(w)
            outs.append(out)
        if words[0] != words[1]:
            diff = [(a, b) for a, b in zip(*words) if a != b][:3]
            raise AssertionError(f"{label}: launch words differ between "
                                 f"qindex {SC_QINDICES}: {diff}, "
                                 f"{len(words[0])} and {len(words[1])} "
                                 "launches")
        zone = outs[0]["m32"]
        if torch.equal(zone["lv_y"], outs[1]["m32"]["lv_y"]):
            raise AssertionError(f"{label}: the same levels at qindex "
                                 f"{SC_QINDICES}")
        # a new row (and tables) of the second qindex: the held ones were
        # refilled before the step read them
        fresh = torch.zeros_like(row)
        fresh_rates = None if rates is None else P.upload_rate_tabs(
            P.make_rate_tabs(fc, SC_QINDICES[1]), dev)
        refill(fresh, None, SC_QINDICES[1], key)
        again = step(*planes, *prev, fresh,
                     *(() if fresh_rates is None else (fresh_rates,)))[0]
        _same_outputs(f"{label}: a new row against the held one", again,
                      outs[1])
        n = sum(launches.values())
        print(f"step scalars [{label}]: {n} launches a step, "
              f"{len(words[0])} recorded, their non-pointer words identical "
              f"at qindex {SC_QINDICES[0]} and {SC_QINDICES[1]}; no wait for "
              "the card inside the step (sync debug mode 'error'); a new "
              "row gives the held row's outputs")
    # aq_scale on the tune SQ steps' real zone sums
    vectors, _ = _aq_vectors(aq_calls, "1080p M8 tune SQ step, real sums")
    src_sum, src2, n, scalars, _ = aq_calls[-1]
    b = src_sum.shape[0]
    bound = _bound(12 * b + 4, AQ_FP64_OPS * b, FP64_CORE_OPS_PER_S)
    parts = [_timed("aq_scale", f"1080p M8 tune SQ zone B={b} n={n}",
                    lambda: K.aq_scale(src_sum, src2, n, scalars),
                    lambda: P.aq_scale_ref(src_sum, src2, n, scalars), 5,
                    bound, "aq_scale_kernel", 1)]
    _kernel_resources(dev, "aq_scale", None,
                      lambda k, dv: K.aq_scale_occupancy(dv), threads=1024)
    print(f"kernel aq_scale: {len(vectors)} zones, lambda "
          f"{min(v.min() for v in vectors):.2f} to "
          f"{max(v.max() for v in vectors):.2f}")
    # the port's graft entry on the card
    fn, ex = graft_entry.entry()
    cfn, cex = graft_entry.entry("cpu")
    got, want = fn(*ex), cfn(*cex)
    torch.cuda.synchronize()
    for name, a, c in zip(("mv", "lv_y", "ref_y"), got, want, strict=True):
        if a.device.type != "cuda" or not torch.equal(a.cpu(), c):
            raise AssertionError(f"graft_entry.entry(): {name} on the card "
                                 "differs from the CPU's")
    print(f"graft_entry.entry() on {torch.cuda.get_device_name(0)}: "
          f"{[tuple(t.shape) for t in got]}, bit for bit the CPU's")
    graft_entry.dryrun_multichip(4)
    return _entry("aq_scale", "tpu_vp9_torch/csrc/aq_scale.cu",
                  "tpu_vp9/pipeline/tpu_encdec.py:226", 0, parts)


def txq_synthetic_phase(dev):
    """txq_cost (CUDA) against txq_cost_ref on made-up residuals (a smooth
    field plus noise, as a prediction error looks) at every block size,
    with batch sizes that leave the last unit of the kernel partly empty;
    the two main shapes timed."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    rng = np.random.default_rng(17)
    q = (43.0, 52.0)
    for n, b in ((32, M9_B), (16, 4 * M9_B), (32, 1), (32, 7), (16, 33),
                 (8, 1001), (4, 4099)):
        coarse = torch.from_numpy(rng.normal(0, 12, (b, 1, 3, 3)))
        field = torch.nn.functional.interpolate(
            coarse, size=(n, n), mode="bilinear", align_corners=True)[:, 0]
        resid = (field.numpy() + rng.normal(0, 4, (b, n, n))).round()
        resid = torch.from_numpy(resid.astype(np.float32)).to(dev)
        flipped, total, max_err = _txq_compare(resid, *q, n)
        _txq_report(f"made-up residuals B={b}", n, q, flipped, total,
                    max_err)
        if b >= M9_B:
            _timed("txq_cost", f"made-up B={b} n={n}",
                   lambda: K.txq_cost(resid, *q, n),
                   lambda: K.txq_cost_ref(resid, *q, n), 20,
                   _txq_bound(b, n), "txq_cost_kernel")


def txq_kernel_phase(dev, frames, recons):
    """txq_cost (CUDA) against txq_cost_ref on residuals of the M8
    encode's own frames, at B=2040 n=32 and B=8160 n=16, within the stated
    tolerance: blocks none of whose coefficients sits within 1e-3 of a
    rounding boundary agree within 1e-4 relative + 1e-3 absolute; the
    blocks that disagree are counted and must stay under 1%."""
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline.presets import qp_to_qindex

    qidx = qp_to_qindex(QP)
    dc_q, ac_q = float(T.dc_quant(qidx)), float(T.ac_quant(qidx))
    max_err = 0.0
    parts = []
    for n in (32, 16):
        flipped = total = 0
        for i in (1, len(frames) // 2, len(frames) - 1):
            resid = _residual_blocks(dev, frames[i], recons[i - 1], n)
            f, t, err = _txq_compare(resid, dc_q, ac_q, n)
            flipped, total, max_err = flipped + f, total + t, max(max_err,
                                                                  err)
        b = resid.shape[0]
        _txq_report(f"frames' residuals B={b}", n, (dc_q, ac_q), flipped,
                    total, max_err)
        parts.append(_timed(
            "txq_cost", f"B={b} n={n}",
            lambda: K.txq_cost(resid, dc_q, ac_q, n),
            lambda: K.txq_cost_ref(resid, dc_q, ac_q, n), 20,
            _txq_bound(b, n), "txq_cost_kernel"))
    # an all-zero block costs nothing
    zero = K.txq_cost(torch.zeros((4, 32, 32), device=dev), dc_q, ac_q, 32)
    if float(zero[0].abs().max()) != 0.0 or float(zero[1].abs().max()) != 0.0:
        raise AssertionError("txq_cost: a zero residual has a cost")
    return _entry("txq_cost", "tpu_vp9_torch/csrc/txq_cost.cu",
                  "tpu_vp9/ops/pallas_kernels.py:175", max_err, parts)


def _kf_mode_frame(h, w, patch=96):
    """A luma plane of ``patch``-pixel squares, each of a kind that one
    intra mode predicts best: flat (DC), sinusoids along x (V), along y
    (H) and along the six diagonal directions (D45, D135, D117, D153, D207,
    D63), a ramp in x and y (TM), and noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    phases = (xx, yy, xx + yy, xx - yy, 2 * xx - yy, xx - 2 * yy,
              xx + 2 * yy, 2 * xx + yy)
    kinds = len(phases) + 3
    kind = ((yy // patch) * (w // patch + 1) + xx // patch).astype(int) % kinds
    noise = np.random.default_rng(7).integers(0, 256, (h, w))
    out = np.where(kind == 0, 90.0, 0.0)
    for i, t in enumerate(phases):
        out = np.where(kind == i + 1, 128 + 90 * np.sin(2 * np.pi * t / 14),
                       out)
    out = np.where(kind == kinds - 2,
                   40 + 1.3 * (xx % patch) + 0.9 * (yy % patch), out)
    out = np.where(kind == kinds - 1, noise, out)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _kf_planes(y):
    """Padded (y, u, v) planes from a padded luma plane: chroma subsampled
    from it (v inverted)."""
    u = np.ascontiguousarray(y[::2, ::2])
    return [y, u, np.ascontiguousarray(255 - y[1::2, 1::2])]


def _kf_case(dev, label, geom, planes, qidx, lam=None):
    """kframe_wave (CUDA) against kframe_wave_ref on the card: modes,
    levels, eobs and recon bit for bit. Prints the blocks each mode won and
    the blocks whose levels differ from the plain version's; returns
    (max_abs_err, blocks won by each mode, the kernel's outputs)."""
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    dc_q, ac_q = T.dc_quant(qidx), T.ac_quant(qidx)
    lam = max(1, (ac_q ** 2) >> 6) if lam is None else lam
    ts = [torch.from_numpy(p).to(dev) for p in planes]
    got = K.kframe_wave(*ts, geom, _row(dev, dc_q, ac_q, lam))
    want = P.kframe_wave_ref(*ts, geom, dc_q, ac_q, lam)
    torch.cuda.synchronize()
    b = got[0].numel()
    differ = torch.zeros(b, dtype=torch.bool, device=dev)
    for g_lv, w_lv in zip(got[1:4], want[1:4]):
        differ |= (g_lv != w_lv).reshape(b, -1).any(dim=1)
    won = torch.bincount(got[0].long(), minlength=10).tolist()
    print(f"kframe_wave {label} {geom.width}x{geom.height} qindex {qidx} "
          f"lam {lam}: blocks won by each mode (DC..TM) {won}; "
          f"{int(differ.sum())} of {b} blocks with levels unlike the plain "
          f"version's; largest |level| {int(got[1].abs().max())}")
    err = _check("kframe_wave", f"{label} {geom.width}x{geom.height} qindex "
                 f"{qidx}", got, want)
    return err, won, got


def kframe_kernel_phase(dev):
    """kframe_wave (CUDA) against kframe_wave_ref on the card, bit for bit:
    the first 1080p panning frame at the paths' qindex and at 10, 100 and
    255; 1080p mode patches on which every mode wins somewhere; a constant
    frame at lam 0 (modes tie: DC, the first, must win every block); 0/255
    blocks at qindex 0 (levels reach the 8191 clip); the small geometries
    of the CPU tests (1-row and 1-column grids among them). Its registers,
    spills and shared memory (ptxas) and resident CTAs per SM (occupancy
    query) first. Timed at 1080p: per keyframe (one launch) with CUDA
    events, the kernel's device time (profiler), the host's, the plain
    version's; the bound; and, beside it, the chain: 93 times this
    kernel's own measured latency for one block (the device time of the
    32x32 geometry's launch of one CTA), a figure of this design, not a
    limit of the card."""
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.pipeline.presets import qp_to_qindex
    from tpu_vp9_torch.utils.yuv import panning_frames

    _kernel_resources(dev, "kframe_wave", None,
                      lambda n, d: K.kframe_wave_occupancy(d), threads=256)
    g = P.make_geom(WIDTH, HEIGHT)
    if g.rows32 + g.cols32 - 1 != KF_DIAGONALS:
        raise AssertionError("KF_DIAGONALS does not fit the 1080p grid")
    qidx = qp_to_qindex(QP)
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))
    frame = next(panning_frames(WIDTH, HEIGHT, 1, seed=1))
    pan = [P.pad_plane(np.asarray(p), *shp)
           for p, shp in zip((frame.y, frame.u, frame.v), shapes)]
    max_err = 0
    for q in (qidx, *KF_QINDICES):
        max_err = max(max_err, _kf_case(dev, "panning frame", g, pan, q)[0])
    for q in KF_QINDICES:
        err, won, _ = _kf_case(dev, "mode patches", g,
                               _kf_planes(_kf_mode_frame(g.pad_h, g.pad_w)), q)
        max_err = max(max_err, err)
        if not all(won):
            raise AssertionError(f"kframe_wave: a mode won no block of the "
                                 f"mode patches: {won}")
    # a constant 128: every prediction with a neighbour is exact, so DC, V,
    # H, TM and the diagonals tie at SSE 0 and, at lam 0, at cost 0
    const = np.full((g.pad_h, g.pad_w), 128, np.uint8)
    err, won, _ = _kf_case(dev, "constant 128", g, _kf_planes(const), qidx,
                           lam=0)
    max_err = max(max_err, err)
    if won[0] != g.n_blocks32:
        raise AssertionError(f"kframe_wave: tied modes did not all go to the "
                             f"first, DC: {won}")
    yy, xx = np.mgrid[0:g.pad_h, 0:g.pad_w]
    ext = np.where((yy // 32 + xx // 32) % 2, 255, 0).astype(np.uint8)
    err, _, got = _kf_case(dev, "0/255 blocks", g, _kf_planes(ext), 0)
    max_err = max(max_err, err)
    if int(got[1].abs().max()) != 8191:
        raise AssertionError("kframe_wave: qindex 0 did not reach the level "
                             "clip")
    rng = np.random.default_rng(23)
    for dims in KF_SMALL_DIMS:
        gs = P.make_geom(*dims)
        noise = rng.integers(0, 256, (gs.pad_h, gs.pad_w), dtype=np.uint8)
        for label, y in (("noise", noise),
                         ("mode patches",
                          _kf_mode_frame(gs.pad_h, gs.pad_w, 32))):
            for q in KF_QINDICES:
                max_err = max(max_err, _kf_case(dev, label, gs, _kf_planes(y),
                                                q)[0])
    # timing on the panning frame at the paths' qindex
    ts = [torch.from_numpy(p).to(dev) for p in pan]
    dc_q, ac_q = T.dc_quant(qidx), T.ac_quant(qidx)
    lam = max(1, (ac_q ** 2) >> 6)

    # as the step calls it: the error word handed back, not read (a read
    # would wait for the device); checked once after the timing
    status = []
    sc = _row(dev, dc_q, ac_q, lam)

    def call():
        return K.kframe_wave(*ts, g, sc, status)

    ms = _cuda_time_ms(call, 20)
    plain_ms = _cuda_time_ms(lambda: P.kframe_wave_ref(*ts, g, dc_q, ac_q,
                                                       lam), 2)
    device_ms = _device_ms(call, "kframe_wave_kernel", reps=20)
    host_ms = _host_ms(call, reps=20)
    g1 = P.make_geom(32, 32)
    one = [torch.from_numpy(p).to(dev) for p in _kf_planes(
        rng.integers(0, 256, (g1.pad_h, g1.pad_w), dtype=np.uint8))]
    block_ms = _device_ms(
        lambda: K.kframe_wave(*one, g1, sc, status),
        "kframe_wave_kernel", reps=50)
    torch.cuda.synchronize()
    for word in status:
        K.kf_check_status(word)
    chain_ms = None if block_ms is None else KF_DIAGONALS * block_ms
    # reads the source planes once; writes the recon, the int16 levels, the
    # modes and eobs; the float64 operations of every block at
    # FP64_OPS_PER_S (the tensor cores', where they run) and the integer
    # ones, here as operations at ALU_OPS_PER_S; beside it the bound with
    # the float64 work at the CUDA cores' rate
    nb = g.n_blocks32
    nbytes = sum(t.numel() for t in ts) + nb * 1536 * 3 + 16 * nb

    def kf_bound(fp64_ops_per_s):
        return _bound(nbytes, nb * (KF_FP64_OPS * ALU_OPS_PER_S
                                    / fp64_ops_per_s + KF_INT_OPS),
                      ALU_OPS_PER_S)

    bound, core_bound = kf_bound(FP64_OPS_PER_S), kf_bound(
        FP64_CORE_OPS_PER_S)

    def shown(v, unit=" ms"):
        return "not measured" if v is None else f"{v:.4f}{unit}"

    print(f"kernel kframe_wave 1080p keyframe (one launch): call "
          f"{ms:.4f} ms (CUDA events, median); device {shown(device_ms)} "
          f"(profiler); host {host_ms:.4f} ms per call; plain "
          f"{plain_ms:.4f} ms; bound {bound[0]:.5f} ms by {bound[1]} "
          f"({nbytes / 1e6:.2f} MB, {nb * KF_FP64_OPS:.3g} float64 "
          f"operations at {FP64_OPS_PER_S / 1e12:.0f} TFLOP/s and "
          f"{nb * KF_INT_OPS:.3g} integer ones; with the float64 work at the "
          f"CUDA cores' {FP64_CORE_OPS_PER_S / 1e12:.0f} TFLOP/s "
          f"{core_bound[0]:.5f} ms); one-block latency {shown(block_ms)} "
          "(the 32x32 geometry's launch); chain "
          f"{shown(chain_ms)} ({KF_DIAGONALS} x the one-block latency; not a "
          "bound)")
    return {"name": "kframe_wave", "route": "cuda",
            "source": "tpu_vp9_torch/csrc/kframe_wave.cu",
            "replaces": "tpu_vp9/pipeline/tpu_encdec.py:2259",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
            "device_ms": device_ms, "host_ms": host_ms,
            "block_ms": block_ms, "chain_ms": chain_ms,
            "parts": [{"shape": "1080p keyframe, one launch",
                       "per_frame": 1, "ms": ms, "device_ms": device_ms,
                       "host_ms": host_ms, "bound_ms": bound[0]}]}


def _lf_planes(geom, rng):
    """Padded (y, u, v) planes that reach every class of the edge filter:
    32x32 patches (16x16 in chroma), each of one kind. Blocky: 8x8 blocks
    of any level with a little noise (masked-out lanes at the large steps,
    filter4 with and without high edge variance at the small ones);
    gentle: levels within 3 of each other and noise of 0 or 1 (flat and
    flat2); extremes: 8x8 blocks at 0 or 255 and small steps right at
    them (the filters' clamps)."""
    def plane(h, w, patch):
        ph, pw = h // patch + 1, w // patch + 1
        kind = np.kron(rng.integers(0, 3, (ph, pw)),
                       np.ones((patch, patch), np.int64))[:h, :w]
        bh, bw = h // 8 + 1, w // 8 + 1

        def blocks(levels):
            return np.kron(levels, np.ones((8, 8)))[:h, :w]

        blocky = blocks(rng.integers(0, 256, (bh, bw))) \
            + rng.normal(0, 2, (h, w))
        base = np.kron(rng.integers(60, 200, (ph, pw)),
                       np.ones((patch // 8, patch // 8), np.int64))
        gentle = blocks(base[:bh, :bw] + rng.integers(0, 4, (bh, bw))) \
            + rng.integers(0, 2, (h, w))
        ends = blocks(rng.choice([0, 2, 5, 250, 253, 255], (bh, bw))) \
            + rng.integers(-1, 2, (h, w))
        out = np.where(kind == 0, blocky, np.where(kind == 1, gentle, ends))
        return np.ascontiguousarray(np.clip(np.rint(out), 0, 255), np.uint8)

    g = geom
    return [plane(g.pad_h, g.pad_w, 32), plane(g.pad_h // 2, g.pad_w // 2, 16),
            plane(g.pad_h // 2, g.pad_w // 2, 16)]


def _lf_case(label, planes, geom, lvl, lim, mblim, split):
    """loop_filter (CUDA) against loop_filter_ref on one input: all three
    planes bit for bit, the inputs unchanged. Returns (max_abs_err, the
    plain version's lanes per filter class)."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    before = [p.clone() for p in planes]
    mask_before = None if split is None else split.clone()
    got = K.loop_filter(*planes, geom, _row(planes[0].device, lvl=lvl,
                                            lim=lim, mblim=mblim), split)
    P.LF_CLASS_COUNTS = {}
    want = P.loop_filter_ref(*planes, geom, lvl, lim, mblim, split)
    counts, P.LF_CLASS_COUNTS = P.LF_CLASS_COUNTS, None
    shown = ", ".join(f"{k} {counts.get(k, 0)}" for k in P.LF_CLASSES)
    err = _check("loop_filter", f"{label} lvl={lvl} lim={lim} mblim={mblim}; "
                 f"lanes: {shown}", got, want)
    for a, b in zip(planes, before):
        if not torch.equal(a, b):
            raise AssertionError("loop_filter changed its input planes")
    if split is not None and not torch.equal(split, mask_before):
        raise AssertionError("loop_filter changed its split mask")
    if lvl == 0 and not all(torch.equal(a, b) for a, b in zip(got, planes)):
        raise AssertionError("loop_filter: lvl 0 is not a copy")
    return err, counts


def _lf_strip_classes(planes, geom, lvl, lim, mblim):
    """Lanes of each filter class of the strip's own edges (the luma and
    chroma verticals of its rows, the chroma edge at its top), counted by
    loop_filter_ref on the planes' device."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    g = geom
    counts, junk = {}, {}
    real_vert, real_horz = P._lf_vert, P._lf_horz

    def vert(plane, rows0, nrows, xs, *args, **kw):
        luma = plane.shape[0] == g.pad_h
        P.LF_CLASS_COUNTS = (counts if rows0 >= g.strip_y >> (not luma)
                             else junk)
        real_vert(plane, rows0, nrows, xs, *args, **kw)

    def horz(plane, ys, *args, **kw):
        top = plane.shape[0] != g.pad_h and g.strip_y >> 1 in ys
        P.LF_CLASS_COUNTS = counts if top else junk
        real_horz(plane, ys, *args, **kw)

    P._lf_vert, P._lf_horz = vert, horz
    P.LF_CLASS_COUNTS = junk
    P.loop_filter_ref(*planes, g, lvl, lim, mblim)
    P._lf_vert, P._lf_horz = real_vert, real_horz
    P.LF_CLASS_COUNTS = None
    return counts


def _lf_kinds_alone(label, planes, geom, lvl, lim, mblim, split):
    """Device time of loop_filter with every kind of CTA at work and with
    each kind alone (the others return at once): which columns of the
    picture the kernel's time is."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    shown = []
    sc = _row(planes[0].device, lvl=lvl, lim=lim, mblim=mblim)
    for name, bits in (("all", K.LF_ALL_PARTS), *K.LF_PARTS.items()):
        ms = _device_ms(lambda: K.loop_filter(*planes, geom, sc, split,
                                              parts=bits),
                        "loop_filter_kernel")
        shown.append(f"{name} " + ("not measured" if ms is None
                                   else f"{ms:.4f} ms"))
    print(f"kernel loop_filter on {label}, device time per launch by kind "
          f"of CTA alone: {', '.join(shown)}")


def _mc_args_of(name, args, out):
    """The plain MC call (``mc_predict``'s dispatch's (args, keyword
    args)) that a decided call ``name`` (``DECIDED_MC``) made at its head,
    with the MVs (and ref_sel) it decided (``out``, its result)."""
    if name == "mode_decide_mc":
        planes, pos_y, pos_x, n, mi_rows, mi_cols, filters, grid = args[18:]
        return ((planes, pos_y, pos_x, out[0], out[1], n, mi_rows, mi_cols,
                 filters, grid), {"ref_sel": out[2]})
    (planes, pos_y, pos_x, n, mi_rows, mi_cols, filters, grid, win_idx,
     off_y, off_x) = args[13:]
    return ((planes, pos_y, pos_x, out[0], out[1], n, mi_rows, mi_cols,
             filters, grid), {"org_off_x": off_x, "org_off_y": off_y,
                              "win_idx": win_idx})


def _real_m8_inputs(dev):
    """The real inputs of four stages of the steps: the first two frames
    of the clip (a keyframe and an M8 P-frame) through the public encoder,
    the steps' calls of ``loop_filter_device`` (keyframe and P-frame),
    ``transform_recon``, ``subpel_search`` and the decided MC
    (``mode_decide_mc``, ``descent_decide_mc``: P-frame) recorded, with
    the descent's four dispatches (its decision from its MC's call) and
    its ``encode_children_masked`` call, and the dispatches ``mode_decide``
    (from the zone's MC call), ``extract_windows`` (its search site; none
    at MC) and ``extend_borders`` (keyframe and P-frame). Returns ({"lf":
    [(y, u, v, geom, lvl, lim, mblim, split32)], "tr": [(src, pred, dc_q,
    ac_q, n)], "sp": [(wins, src, dy, dx, n, r)], "mc": [(args, keyword
    args)] (the plain MC calls with the MVs the decided ones made, the
    zone's, then the children's), "dmc": [(name, args)] (the decided
    calls), "desc": [(dispatch name, args)], "ecm": [(args, keyword
    args)], "md": [(dispatch name, args)]}, the two frames, their
    recon)."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.utils.yuv import panning_frames

    calls = {"lf": [], "tr": [], "sp": [], "mc": [], "dmc": [], "desc": [],
             "ecm": []}
    real_ecm = P.encode_children_masked

    def record_ecm(*args, **kw):
        calls["ecm"].append((_held("encode_children_masked", args),
                             {k: _held("", (v,))[0] for k, v in kw.items()}))
        return real_ecm(*args, **kw)
    real_lf, real_tr, real_sp = (P.loop_filter_device, P.transform_recon,
                                 P.subpel_search)
    real_dmc = {name: getattr(P, name) for name in DECIDED_MC}

    def record_lf(y, u, v, geom, sc, split32=None):
        calls["lf"].append((y, u, v, geom, sc.clone(), split32))
        return real_lf(y, u, v, geom, sc, split32=split32)

    def record_tr(*args):
        calls["tr"].append(_held("transform_recon", args))
        return real_tr(*args)

    def record_sp(*args):
        calls["sp"].append(args)
        return real_sp(*args)

    def record_dmc(name):
        def call(*args):
            out = real_dmc[name](*args)
            args = _held(name, args)
            calls["dmc"].append((name, args))
            calls["mc"].append(_mc_args_of(name, args, out))
            return out
        return call

    P.loop_filter_device = record_lf
    P.transform_recon, P.subpel_search = record_tr, record_sp
    P.encode_children_masked = record_ecm
    for name in DECIDED_MC:
        setattr(P, name, record_dmc(name))
    enc = _make_encoder(dev, 8)
    got = _capture(enc)
    frames = list(panning_frames(WIDTH, HEIGHT, 2, seed=1))
    desc, md = [], []
    with _recording(DESCENT_WRAPPERS, desc, [True]), \
            _recording(MD_WINDOW_WRAPPERS, md, [True]):
        for frame in frames:
            enc.send_picture(frame)
        enc.flush()
    calls["desc"], calls["md"] = desc, md
    P.loop_filter_device = real_lf
    P.transform_recon, P.subpel_search = real_tr, real_sp
    P.encode_children_masked = real_ecm
    for name in DECIDED_MC:
        setattr(P, name, real_dmc[name])
    torch.cuda.synchronize()
    # the loop filter's level and limits, and the transforms' quantizers,
    # as ints (the phases hold the kernels against the plain versions, which
    # take them so)
    calls["lf"] = [(*c[:4], *c[4].tolist()[P.SC_LF_LVL:], c[5])
                   for c in calls["lf"]]
    calls["tr"] = [_tr_ints(c) for c in calls["tr"]]
    lf = calls["lf"]
    if len(lf) != 2 or lf[0][7] is not None or lf[1][7] is None:
        raise AssertionError(f"the keyframe and the M8 P-frame called the "
                             f"loop filter {len(lf)} times, or the "
                             "keyframe with a mask or the P-frame without")
    mc = [(a[5], sorted(kw)) for a, kw in calls["mc"]]
    if ([c[4] for c in calls["tr"]] != [32, 16, 16, 8, 8, 16]
            or [c[4:] for c in calls["sp"]] != [(32, 4), (16, 8)]
            or mc != [(32, ["ref_sel"]),
                      (16, ["org_off_x", "org_off_y", "win_idx"])]
            or [c[0] for c in calls["dmc"]] != list(DECIDED_MC)
            or [c[0] for c in calls["desc"]] != list(DESCENT_WRAPPERS)
            or len(calls["ecm"]) != 1
            or [c[0] for c in calls["md"]] != [
                "extend_borders", "extract_windows", "mode_decide",
                "extend_borders"]):
        raise AssertionError(
            "the M8 P-frame's transform, quarter-pel, MC and descent calls "
            f"were {[c[4] for c in calls['tr']]}, "
            f"{[c[4:] for c in calls['sp']]}, {mc}, "
            f"{[c[0] for c in calls['dmc']]}, "
            f"{[c[0] for c in calls['desc']]}, {len(calls['ecm'])} "
            "encode_children_masked and "
            f"{[c[0] for c in calls['md']]}")
    return calls, frames, [r for _, r in got]


def loop_filter_kernel_phase(dev, lf_calls):
    """loop_filter (CUDA) against loop_filter_ref on the card; lf_calls:
    the real keyframe's and M8 P-frame's arguments (``_real_m8_inputs``)."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.ops.loopfilter import sharpness_limits
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    lim_t, mblim_t = sharpness_limits(0)
    rng = np.random.default_rng(5)
    max_err = 0
    seen = dict.fromkeys(P.LF_CLASSES, 0)
    for dims in ((WIDTH, HEIGHT),) + LF_SMALL_DIMS:
        g = P.make_geom(*dims)
        planes = [torch.from_numpy(p).to(dev) for p in _lf_planes(g, rng)]
        masks = {"no mask": None,
                 "random mask": torch.from_numpy(rng.integers(
                     0, 2, (g.rows32, g.cols32)).astype(np.int32)).to(dev),
                 "all-ones mask": torch.ones((g.rows32, g.cols32),
                                             dtype=torch.int32, device=dev)}
        for name, mask in masks.items():
            for lvl in LF_LEVELS:
                err, counts = _lf_case(
                    f"made-up {dims[0]}x{dims[1]}, {name}", planes, g, lvl,
                    int(lim_t[lvl]), int(mblim_t[lvl]), mask)
                max_err = max(max_err, err)
                if dims == (WIDTH, HEIGHT):
                    for k in seen:
                        seen[k] += counts.get(k, 0)
        if dims == (WIDTH, HEIGHT):
            made_up = (planes, g, masks["random mask"])
    if not all(seen.values()):
        raise AssertionError(f"the made-up 1080p planes reach no lane of a "
                             f"filter class: {seen}")
    # the strip geometries, without a mask (the step has none there): the
    # lanes of each class that the strip's own edges reach
    strip_planes = {}
    for dims in LF_STRIP_DIMS:
        g = P.make_geom(*dims)
        planes = [torch.from_numpy(p).to(dev) for p in _lf_planes(g, rng)]
        strip_seen = dict.fromkeys(P.LF_CLASSES, 0)
        for lvl in LF_LEVELS:
            lim, mblim = int(lim_t[lvl]), int(mblim_t[lvl])
            err, _ = _lf_case(f"made-up {dims[0]}x{dims[1]} (strip rows "
                              f"from {g.strip_y}), no mask", planes, g, lvl,
                              lim, mblim, None)
            max_err = max(max_err, err)
            strip = _lf_strip_classes(planes, g, lvl, lim, mblim)
            print(f"loop_filter: the strip's own edges at "
                  f"{dims[0]}x{dims[1]} lvl={lvl}: " + ", ".join(
                      f"{k} {strip.get(k, 0)}" for k in P.LF_CLASSES))
            for k in strip_seen:
                strip_seen[k] += strip.get(k, 0)
        if dims[1] >= 720 and not all(strip_seen.values()):
            raise AssertionError(f"the made-up {dims[0]}x{dims[1]} planes' "
                                 f"strip reaches no lane of a filter class: "
                                 f"{strip_seen}")
        strip_planes[dims] = (planes, g)
    # the real thing: a keyframe's and an M8 P-frame's unfiltered recon,
    # (mask) and level
    key_in, (y, u, v, g, lvl, lim, mblim, split) = lf_calls
    err, _ = _lf_case("real keyframe", key_in[:3], *key_in[3:])
    max_err = max(max_err, err)
    print(f"loop_filter: a real M8 P-frame's input: lvl={lvl} lim={lim} "
          f"mblim={mblim}, {int(split.sum())} of {split.numel()} blocks "
          "split")
    err, counts = _lf_case("real M8 P-frame", (y, u, v), g, lvl, lim, mblim,
                           split)
    max_err = max(max_err, err)
    err, counts9 = _lf_case("real M8 P-frame's planes, no mask", (y, u, v),
                            g, lvl, lim, mblim, None)
    max_err = max(max_err, err)
    parts = []
    nbytes = 2 * sum(t.numel() for t in (y, u, v))
    sc = _row(dev, lvl=lvl, lim=lim, mblim=mblim)
    for label, mask, cnt, per_frame in (
            ("1080p split mask (M8)", split, counts, 1),
            ("1080p no mask (M9)", None, counts9, 0)):
        lanes = sum(cnt.values())
        # every plane read once and written once, and the mask; the
        # arithmetic of this input's edge lanes
        bound = _bound(nbytes + (0 if mask is None else 4 * mask.numel()),
                       LF_OPS_PER_LANE * lanes, ALU_OPS_PER_S)
        parts.append(_timed(
            "loop_filter", f"{label}, {lanes} edge lanes",
            lambda: K.loop_filter(y, u, v, g, sc, mask),
            lambda: P.loop_filter_ref(y, u, v, g, lvl, lim, mblim, mask), 2,
            bound, "loop_filter_kernel", per_frame))
    # 720p and 4K (the strip, no mask), at the real P-frame's level
    for dims in LF_STRIP_DIMS[:2]:
        planes, gs = strip_planes[dims]
        P.LF_CLASS_COUNTS = {}
        P.loop_filter_ref(*planes, gs, lvl, lim, mblim)
        lanes, P.LF_CLASS_COUNTS = sum(P.LF_CLASS_COUNTS.values()), None
        bound = _bound(2 * sum(t.numel() for t in planes),
                       LF_OPS_PER_LANE * lanes, ALU_OPS_PER_S)
        _timed("loop_filter", f"made-up {dims[0]}x{dims[1]} (strip), no "
               f"mask, lvl={lvl}, {lanes} edge lanes",
               lambda: K.loop_filter(*planes, gs, sc),
               lambda: P.loop_filter_ref(*planes, gs, lvl, lim, mblim), 2,
               bound, "loop_filter_kernel", 0)
        _lf_kinds_alone(f"made-up {dims[0]}x{dims[1]} (strip)", planes, gs,
                        lvl, lim, mblim, None)
    _lf_kinds_alone("the real M8 P-frame", (y, u, v), g, lvl, lim, mblim,
                    split)
    _lf_kinds_alone("the real M8 P-frame at lvl 0 (loads and stores only)",
                    (y, u, v), g, 0, lim, mblim, split)
    _lf_kinds_alone("the real M8 P-frame's planes, no mask", (y, u, v), g,
                    lvl, lim, mblim, None)
    _lf_kinds_alone("the made-up planes, random mask", made_up[0],
                    made_up[1], LF_LEVELS[-1], int(lim_t[LF_LEVELS[-1]]),
                    int(mblim_t[LF_LEVELS[-1]]), made_up[2])
    _kernel_resources(dev, "loop_filter", (0, 1), K.loop_filter_occupancy,
                      threads=256)
    return _entry("loop_filter", "tpu_vp9_torch/csrc/loop_filter.cu",
                  "tpu_vp9/pipeline/tpu_encdec.py:1115", max_err, parts)


def _ptxas_instances(name, lib=None):
    """The template instances of kernel ``name`` in the ptxas report of
    its build (``_build/lib<lib>.log``, lib = name unless given, for a
    source of several kernels): {key: (registers, spill stores,
    spill loads, static shared memory)}, the key an instance's integer
    template arguments (one: that int; none: 0; several: their tuple),
    led by its element type's letter where it has one (h uint8, s
    int16)."""
    import re

    from tpu_vp9_torch.ops import _build

    found = {}
    for m in re.finditer(
            r"Compiling entry function '[^']*" + name + r"_kernel([^']*)'"
            r".*?(\d+) bytes spill stores, (\d+) bytes spill loads"
            r".*?Used (\d+) registers([^\n]*)", _build.build_log(lib or name),
            re.S):
        args = m.group(1)
        kind = re.match(r"I([hs])", args)
        key = ((kind.group(1),) if kind else ()) + tuple(
            int(v) for v in re.findall(r"Li(\d+)E", args))
        key = key[0] if len(key) == 1 else (key or 0)
        smem = re.search(r"(\d+) bytes smem", m.group(5))
        found[key] = (int(m.group(4)), int(m.group(2)), int(m.group(3)),
                      int(smem.group(1)) if smem else 0)
    return found


def _print_resources(label, found_entry, ctas, dyn, threads):
    regs, st, ld, smem = found_entry
    print(f"{label}: {regs} registers, spill stores {st} B, spill "
          f"loads {ld} B, static shared memory {smem} B (ptxas); "
          f"dynamic shared memory {dyn} B, {ctas} resident CTAs of "
          f"{threads} threads per SM (occupancy query)")
    if st or ld:
        raise AssertionError(f"{label} spills registers")


def _kernel_resources(dev, name, sizes, occupancy, threads=128, lib=None,
                      key_names="(n, type)"):
    """Each template instance of kernel ``name`` (keyed as
    ``_ptxas_instances`` keys them: block size n, or (n, transform type)),
    or with ``sizes`` None its one kernel (key 0): its registers, spill
    bytes and static shared memory from the ptxas report of its build, and
    its resident CTAs of ``threads`` threads per SM and dynamic shared
    memory from the CUDA runtime's occupancy query (``occupancy(key,
    dev)``); printed, and raised on if an instance spills. ``lib``: the
    build the kernel is in, where that is not ``name``'s; ``key_names``
    what a key of several template arguments holds, for the labels."""
    found = _ptxas_instances(name, lib)
    want = [0] if sizes is None else sorted(sizes)
    if sorted(found) != want:
        raise AssertionError(f"{name}: the ptxas report has the instances "
                             f"{sorted(found)}, want {want}")
    for key in sorted(want, reverse=True):
        ctas, dyn = occupancy(key, dev)
        label = (name if sizes is None else f"{name} n={key}"
                 if isinstance(key, int) else f"{name} {key_names} {key}")
        _print_resources(label, found[key], ctas, dyn, threads)


def _tr_bound(b, n, fp64_ops_per_s=FP64_OPS_PER_S):
    """transform_recon's bound for B blocks of n: reads src and pred,
    writes int16 levels, recon and eob; the two forward products (a
    multiply and an add per term, n^3 terms each per block) in float64 at
    ``fp64_ops_per_s`` and the integer work, here as operations at
    ALU_OPS_PER_S."""
    return _bound(5 * b * n * n + 4 * b,
                  b * (4 * n ** 3 * ALU_OPS_PER_S / fp64_ops_per_s
                       + TR_INT_OPS[n]), ALU_OPS_PER_S)


def _tr_case(label, src, pred, dc_q, ac_q, n, tx_type=0):
    """transform_recon (CUDA) against transform_recon_ref on one batch, of
    transform type ``tx_type``:
    the level flips counted and printed, each allowed only where the plain
    version's float64 |c| / q + 0.38 lies within TR_FLIP_BAND of an
    integer; eob and recon bit-equal in every block whose levels are.
    Returns (max_abs_err over all three outputs, the kernel's outputs)."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.ops import txfm
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    got = K.transform_recon(src, pred, _row(src.device, dc_q, ac_q), n,
                            tx_type)
    want = P.transform_recon_ref(src, pred, dc_q, ac_q, n, tx_type)
    torch.cuda.synchronize()
    b = src.shape[0]
    differ = got[0] != want[0]
    flips = int(differ.sum())
    same = ~differ.reshape(b, -1).any(dim=1)
    if flips:
        coef = txfm.fwd_txfm2d_f64(src.to(torch.int32) - pred.to(torch.int32),
                                   tx_type)
        q = torch.full((n, n), float(ac_q), dtype=torch.float64,
                       device=src.device)
        q[0, 0] = float(dc_q)
        if n == 32:
            q = q * 0.5
        mag = (coef.abs() / q + txfm.QBIAS)[differ]
        off = float((mag - mag.round()).abs().max())
        if off >= TR_FLIP_BAND:
            raise AssertionError(f"transform_recon [{label}]: a level flipped "
                                 f"{off:.3g} from a rounding boundary")
    for name, g, w in (("eob", got[1], want[1]), ("recon", got[2], want[2])):
        if not torch.equal(g[same], w[same]):
            raise AssertionError(f"transform_recon [{label}]: {name} differs "
                                 "in a block whose levels are equal")
    err = _max_err(got, want)
    print(f"kernel transform_recon [{label} B={b} n={n} type {tx_type} "
          f"q=({dc_q}, {ac_q})]: "
          f"{flips} level flips in {b - int(same.sum())} of {b} blocks; "
          f"max_abs_err={err}; eob {int(got[1].min())}..{int(got[1].max())}, "
          f"largest |level| {int(got[0].abs().max())}")
    return err, got


def _plane_blocks(plane, h, n, b, dev):
    """The first b (n, n) blocks, raster order, of a host plane
    edge-padded to h rows, on the card."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    t = torch.from_numpy(P.pad_plane(np.asarray(plane), h, plane.shape[1]))
    return P._extract_blocks(t.to(dev), 0, h // n, plane.shape[1] // n,
                             n)[:b].contiguous()


def transform_kernel_phase(dev, real, frames, recons):
    """transform_recon (CUDA) against transform_recon_ref on the card at
    the four shapes of the M8 path at 1080p (B = 2040: the zone's luma at
    32 and chroma at 16, the children's luma at 16 and chroma at 8): the
    step's real blocks (``_real_m8_inputs``), the second frame's source
    against the first frame's recon at four qindex values, +-255
    residuals at the same four (the level clip reached at qindex 0), zero
    residuals (eob 0), and blocks with one nonzero level at each scan place
    (every eob value). Timed on the real blocks."""
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    _kernel_resources(dev, "transform_recon",
                      [(n, t) for n, ts in K.TXFM_TYPES.items() for t in ts],
                      lambda k, d: K.transform_recon_occupancy(k[0], d, k[1]))
    rng = np.random.default_rng(29)
    max_err = 0
    for label, (src, pred, dc_q, ac_q, n) in zip(TR_CALLS, real):
        max_err = max(max_err, _tr_case(f"M8 P-frame's {label}", src, pred,
                                        dc_q, ac_q, n)[0])
    # (label, plane index, n) of the path's four shapes
    shapes = (("luma", 0, 32), ("chroma", 1, 16), ("luma", 0, 16),
              ("chroma", 1, 8))
    clip = False
    for plane_name, p, n in shapes:
        b = M9_B
        h = (HEIGHT + 31) // 32 * 32 >> (1 if p else 0)
        cur = frames[1]
        src = _plane_blocks((cur.y, cur.u, cur.v)[p], h, n, b, dev)
        prev = _plane_blocks(recons[0][p], h, n, b, dev)
        ext = torch.from_numpy(rng.choice([0, 255], (b, n, n))
                               .astype(np.uint8)).to(dev)
        ext[0], ext[1] = 255, 0
        for q in TR_QINDICES:
            dc_q, ac_q = T.dc_quant(q), T.ac_quant(q)
            max_err = max(max_err, _tr_case(
                f"{plane_name} source against the previous recon", src, prev,
                dc_q, ac_q, n)[0])
            err, got = _tr_case("+-255 residuals", ext, 255 - ext, dc_q, ac_q,
                                n)
            max_err = max(max_err, err)
            clip |= int(got[0].abs().max()) == 8191
        dc_q, ac_q = T.dc_quant(TR_LONE_QINDEX), T.ac_quant(TR_LONE_QINDEX)
        err, got = _tr_case("zero residuals", src, src.clone(), dc_q, ac_q, n)
        max_err = max(max_err, err)
        if int(got[1].abs().max()) or int(got[0].abs().max()):
            raise AssertionError("transform_recon: a zero residual has levels")
        # one lone level at each scan place: its recon is the source
        nn = n * n
        scan = torch.as_tensor(np.asarray(T.scan_order(
            P.txfm.TX_SIZE[n], T.TxType.DCT_DCT)[0]), device=dev)
        levels = torch.zeros((nn, nn), dtype=torch.int32, device=dev)
        levels[torch.arange(nn, device=dev), scan] = TR_LONE_LEVEL
        levels[0, scan[0]] = 4
        pred = torch.full((nn, n, n), 128, dtype=torch.uint8, device=dev)
        lone = P.recon_from_levels(levels.reshape(nn, n, n), pred, dc_q, ac_q,
                                   n)[1]
        err, got = _tr_case("one level at each scan place", lone, pred, dc_q,
                            ac_q, n)
        max_err = max(max_err, err)
        print(f"transform_recon n={n}: the lone levels reach "
              f"{len(set(got[1].tolist()))} of {nn} eob values")
    if not clip:
        raise AssertionError("transform_recon: the 8191 level clip was not "
                             "reached")
    parts = []
    for label, i, per_frame in TR_TIMED:
        src, pred, dc_q, ac_q, n = real[i]
        b = src.shape[0]
        sc = _row(dev, dc_q, ac_q)
        parts.append(_timed(
            "transform_recon", f"{label} B={b} n={n}",
            lambda: K.transform_recon(src, pred, sc, n),
            lambda: P.transform_recon_ref(src, pred, dc_q, ac_q, n), 5,
            _tr_bound(b, n), "transform_recon_kernel", per_frame))
        print(f"kernel transform_recon {label} B={b} n={n}: bound with the "
              "float64 products on the CUDA cores (34 TFLOP/s) "
              f"{_tr_bound(b, n, FP64_CORE_OPS_PER_S)[0]:.5f} ms")
    return _entry("transform_recon", "tpu_vp9_torch/csrc/transform_recon.cu",
                  "tpu_vp9/pipeline/tpu_encdec.py:820", max_err, parts)


def _sp_bound(b, n):
    """subpel_search's bound for B blocks of n: reads each block's (n+8)^2
    window, its source and two int32, writes three int32; 8-tap sums (a
    multiply and an add a tap) for the 4 H planes of (n+8) x (n+1) and the
    16 V planes of (n+1)^2, and a subtract, multiply and add per pixel of
    the 49 SSEs, at ALU_OPS_PER_S."""
    ops = (4 * (n + 8) * (n + 1) * 16 + 16 * (n + 1) ** 2 * 16
           + 49 * n * n * 3)
    return _bound(b * ((n + 8) ** 2 + n * n + 20), b * ops, ALU_OPS_PER_S)


def _sp_made_up(rng, dev, b, n, r):
    """subpel_search's made-up cases of B blocks of n at reach r: (label,
    wins, src, (dy, dx), the SSE every offset ties at or None)."""
    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    sw = n + 2 * r + 8
    d = on(rng.integers(-r, r + 1, (2, b)).astype(np.int32))
    corner = on(np.array([[(-r, r)[i % 2] for i in range(b)],
                          [(-r, r)[i // 2 % 2] for i in range(b)]], np.int32))
    yy, xx = np.mgrid[0:sw, 0:sw]
    cb = ((yy + xx) % 2 * 255).astype(np.uint8)
    return (
        ("random", rng.integers(0, 256, (b, sw, sw), dtype=np.uint8),
         rng.integers(0, 256, (b, n, n), dtype=np.uint8), d, None),
        ("winners at +-r", rng.integers(0, 256, (b, sw, sw), dtype=np.uint8),
         rng.integers(0, 256, (b, n, n), dtype=np.uint8), corner, None),
        ("constant: all tie", np.full((b, sw, sw), 77, np.uint8),
         np.full((b, n, n), 77, np.uint8), d, 0),
        ("largest SSE: all tie", np.zeros((b, sw, sw), np.uint8),
         np.full((b, n, n), 255, np.uint8), d, n * n * 255 * 255),
        ("0/255 checkerboards", np.repeat(cb[None], b, axis=0),
         np.repeat(255 - cb[None, :n, :n], b, axis=0), d, None))


def subpel_kernel_phase(dev, real):
    """subpel_search (CUDA) against subpel_search_ref on the card, bit for
    bit, at the two shapes of the M8 path at 1080p: the zone's real refine
    windows and winners from hier_search_fused and the children's real
    windows (``_real_m8_inputs``); B = 2040 made-up batches of each shape
    and of n=16 r=40 (the strip zone's reach): random windows, winners at
    the corners of +-r, constant windows (all 49 offsets tie: (-6, -6) must
    win), a zero window against a source of 255 (the largest SSE, tied too)
    and 0/255 checkerboards; random batches of B = 2037 at n=16 (the last
    CTA of four blocks ragged) and B = 7 at n=32. Each instance's
    registers, spills and resident CTAs per SM printed. Timed on the real
    inputs."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    _kernel_resources(dev, "subpel_search", K.SUBPEL_BLOCK_SIZES,
                      K.subpel_search_occupancy)
    rng = np.random.default_rng(31)
    max_err = 0
    for label, args in zip(SP_CALLS, real):
        max_err = max(max_err, _check(
            "subpel_search", f"M8 P-frame's {label}",
            K.subpel_search(*args), P.subpel_search_ref(*args)))
    cases = [(M9_B, n, r, c) for n, r in
             [a[4:] for a in real] + [(16, 40)]
             for c in _sp_made_up(rng, dev, M9_B, n, r)]
    cases += [(b, n, r, _sp_made_up(rng, dev, b, n, r)[0])
              for b, n, r in ((2037, 16, 8), (7, 32, 4))]
    for b, n, r, (label, wins, src, dyx, tie_sse) in cases:
        args = (torch.from_numpy(wins).to(dev),
                torch.from_numpy(src).to(dev), dyx[0].contiguous(),
                dyx[1].contiguous(), n, r)
        got = K.subpel_search(*args)
        max_err = max(max_err, _check(
            "subpel_search", f"{label} B={b} n={n} r={r}", got,
            P.subpel_search_ref(*args)))
        if tie_sse is not None and not (
                torch.equal(got[0], args[2] * 8 - 6)
                and torch.equal(got[1], args[3] * 8 - 6)
                and bool((got[2] == tie_sse).all())):
            raise AssertionError(f"subpel_search: ties ({label}) did not "
                                 "go to the first offset, (-6, -6)")
    parts = []
    for label, args in zip(SP_CALLS, real):
        b, n = args[1].shape[0], args[4]
        parts.append(_timed(
            "subpel_search", f"{label} B={b}",
            lambda: K.subpel_search(*args),
            lambda: P.subpel_search_ref(*args), 5, _sp_bound(b, n),
            "subpel_search_kernel", 1))
    return _entry("subpel_search", "tpu_vp9_torch/csrc/subpel_search.cu",
                  "tpu_vp9/pipeline/tpu_encdec.py:510", max_err, parts)


def _mc_work(args, kw):
    """mc_predict's work in one call (``args``, ``kw``: the dispatch's):
    (bytes, operations). It reads each block's three (n+7)^2 regions (Y
    at n, U and V at n / 2) and its per-block words (positions and MVs,
    16 bytes; ref_sel 1, the window index 4 and the offsets 8 where
    given), writes its three predictions; 8-tap sums (a multiply and an
    add a tap) of the H pass, (n+7) x n outputs, and of the V pass, n x n,
    of each plane where the block's phase in that axis is not 0 (phase 0
    is a copy), counted from this call's clamped MVs."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    _, pos_y, pos_x, mv_r, mv_c, n, mi_rows, mi_cols = args[:8]
    b = pos_y.shape[0]
    nbytes = b * (16 + 1 * (kw.get("ref_sel") is not None)
                  + 4 * (kw.get("win_idx") is not None)
                  + 8 * (kw.get("org_off_y") is not None))
    ops = 0
    for ss in (0, 1, 1):
        m = n >> ss
        py, px = pos_y >> ss, pos_x >> ss
        row, col = P._clamp_mv_umv(mv_r, mv_c, (py << ss) // 8,
                                   (px << ss) // 8, m, m, ss, mi_rows,
                                   mi_cols)
        h = int(((((px << 4) + col) & 15) != 0).sum())
        v = int(((((py << 4) + row) & 15) != 0).sum())
        nbytes += b * ((m + 7) ** 2 + m * m)
        ops += 2 * 8 * (h * (m + 7) * m + v * m * m)
    return nbytes, ops


def _mc_bound(args, kw):
    """mc_predict's bound for one call (``_mc_work``) at ALU_OPS_PER_S."""
    return _bound(*_mc_work(args, kw), ALU_OPS_PER_S)


def mc_kernel_phase(dev, real):
    """mc_predict (CUDA; it reads the border-extended planes in place)
    against mc_predict_planes_ref (the windows cut, then mc_predict_ref) on
    the card, bit for bit: the M8 P-frame's two real calls at 1080p
    (``_real_m8_inputs``: the zone's LAST and GOLDEN planes by ref_sel,
    the children's parent windows by index in LAST's planes); on the
    zone's real planes with ALTREF planes added (the RA zone's shape,
    B=2040), MVs that take every chroma q4 phase pair (the luma even ones,
    phase 0 in either axis, both and neither), +-(WIN_R + 0.75) pel at
    every edge and the overhang row, MVs past the windows' reach (the
    window clamp), ALTREF without GOLDEN (GOLDEN's blocks read LAST), and
    the planes one byte into their storage with an odd pitch; the RA
    children's shape, 8,160 children of every parent in LAST's planes;
    the strip zones' shapes (n=16 at their y_base, B=80 at 720p and 240 at
    4K, made-up planes, LAST and GOLDEN). Each instance's registers,
    spills and resident CTAs per SM printed. Timed on the real calls, the
    RA shapes and the strips."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    _kernel_resources(dev, "mc_predict", MC_INSTANCES,
                      lambda key, d: K.mc_predict_occupancy(
                          key[0], d, MC_DECIDED_BY_KEY[key[1]]),
                      threads=128, key_names="(n, decided)")
    rng = np.random.default_rng(41)
    max_err = 0
    edge = P.WIN_R * 8 + 6  # q3

    def kernel(args, kw):
        # the dispatch's path to the wrapper: the kernel's window grid
        # (cached a shape), then the launch
        shapes = tuple(tuple(t.shape) for t in args[0][0])
        return lambda: K.mc_predict(
            *args[:8], P.mc_window_grid(shapes, tuple(args[9])), **kw)

    def plain(args, kw):
        return lambda: P.mc_predict_planes_ref(*args, **kw)

    def held(label, args, kw):
        nonlocal max_err
        max_err = max(max_err, _check("mc_predict", label,
                                      kernel(args, kw)(), plain(args, kw)()))

    def on(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    def shifted(t):
        """``t`` with a column more on its right (an odd pitch), one byte
        into its storage."""
        wide = torch.cat([t, t[:, :1]], dim=1)
        buf = torch.empty(wide.numel() + 1, dtype=torch.uint8, device=dev)
        buf[1:] = wide.reshape(-1)
        return buf[1:].view(wide.shape)

    for label, (args, kw) in zip(MC_CALLS, real):
        held(f"M8 P-frame's {label}", args, kw)
    (zargs, zkw), (cargs, ckw) = real
    planes, pos_y, pos_x, _, _, n, mi_rows, mi_cols, filters, grid = zargs
    last, gold = planes[0], planes[1]
    # a third reference: LAST's planes turned upside down and mirrored
    alt = tuple(torch.flip(p, (0, 1)).contiguous() for p in last)
    b = pos_y.shape[0]
    i = np.arange(b)
    combos = np.array([(r, c) for r in (-edge, 0, edge)
                       for c in (-edge, 0, edge)])
    sel3 = on(rng.integers(0, 3, b), torch.int8)
    made_up = (
        ("every q4 phase pair", [last, gold, alt],
         np.stack([i % 16, i // 16 % 16])
         + 16 * rng.integers(-19, 20, (2, b))),
        ("+-(WIN_R + 0.75) pel at every edge", [last, gold, alt],
         combos[i % 9].T),
        ("past the windows' reach", [last, gold, alt],
         rng.choice([-1, 1], (2, b)) * rng.integers(edge + 8, edge + 400,
                                                    (2, b))),
        ("ALTREF without GOLDEN", [last, None, alt],
         rng.integers(-edge, edge + 1, (2, b))),
        ("planes one byte into their storage, odd pitches",
         [tuple(shifted(p) for p in ref) for ref in (last, gold, alt)],
         rng.integers(-edge, edge + 1, (2, b))))
    for label, w, mv in made_up:
        args = (w, pos_y, pos_x, on(mv[0]), on(mv[1]), n, mi_rows, mi_cols,
                filters, grid)
        held(f"{label} B={b} n={n}", args, {"ref_sel": sel3})
        if label == "every q4 phase pair":
            ra_zone = args  # the RA zone's shape: three references
    del made_up
    # the RA children: four of every parent, in the parents' windows
    ii, jj = torch.tensor([0, 0, 1, 1], device=dev), \
        torch.tensor([0, 1, 0, 1], device=dev)
    c_kw = {"win_idx": torch.arange(b, dtype=torch.int32,
                                    device=dev).repeat_interleave(4),
            "org_off_y": (ii * 16).repeat(b).to(torch.int32),
            "org_off_x": (jj * 16).repeat(b).to(torch.int32)}
    c_pos = [(p.repeat_interleave(4) + off).contiguous()
             for p, off in ((pos_y, c_kw["org_off_y"]),
                            (pos_x, c_kw["org_off_x"]))]
    bc = 4 * b
    mv = rng.integers(-edge + 128, edge - 127, (2, bc))
    ra_children = (cargs[0], *c_pos, on(mv[0]), on(mv[1]), 16, mi_rows,
                   mi_cols, filters, cargs[9])
    held(f"RA children B={bc} n=16", ra_children, c_kw)
    # the strip zones: n=16 at the strip's row, LAST and GOLDEN
    strips = []
    for tag, dims in STRIP_GEOMS.items():
        g = P.make_geom(*dims)
        bs = STRIP_B[tag]
        shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
                  (g.pad_h // 2, g.pad_w // 2))
        ref_planes = [tuple(on(rng.integers(0, 256, (h + 2 * P.BORDER,
                                                     w + 2 * P.BORDER)),
                               torch.uint8) for h, w in shapes)
                      for _ in range(2)]
        mv = rng.integers(-edge, edge + 1, (2, bs))
        args = (ref_planes, on(np.full(bs, g.strip_y)),
                on(np.arange(bs) * 16), on(mv[0]), on(mv[1]), 16, g.mi_rows,
                g.mi_cols, filters, (16, g.strip_y, 1, g.cols16))
        kw = {"ref_sel": on(rng.integers(0, 2, bs), torch.int8)}
        held(f"{tag} strip B={bs} n=16", args, kw)
        strips.append((tag, args, kw))

    def timed(label, args, kw, count):
        return _timed("mc_predict", f"{label} B={args[1].shape[0]}",
                      kernel(args, kw), plain(args, kw), 5,
                      _mc_bound(args, kw), "mc_predict_kernel", count)

    parts = [timed(label, args, kw, 1)
             for label, (args, kw) in zip(MC_CALLS, real)]
    entry = _entry("mc_predict", "tpu_vp9_torch/csrc/mc_predict.cu",
                   "tpu_vp9/pipeline/tpu_encdec.py:359", max_err, parts)
    entry["ra_parts"] = [_part(timed(
        "RA zone LAST GOLDEN ALTREF n=32", ra_zone, {"ref_sel": sel3}, 1)),
        _part(timed("RA children n=16", ra_children, c_kw, 1))]
    entry["strip_parts"] = [_part(timed(f"{tag} strip n=16", args, kw, 1))
                            for tag, args, kw in strips]
    return entry


def _host_rates(rates):
    """``rates`` with its device row "scalars" made from its host numbers
    (a made-up case that changes a host scalar uploads again, as the
    session does), unless its lam_bits is a per-block tensor."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    if rates is None or isinstance(rates["lam_bits"], torch.Tensor):
        return rates
    row = torch.from_numpy(K.rate_scalars(rates)).to(
        rates["joint_cost"].device)
    return dict(rates, scalars=row)


def _dmc_fns(name, args):
    """(the decided call, its plain composition, the two launches it
    replaces: the standalone decision, then mc_predict with its MVs) of
    the merged dispatch ``name`` (``DECIDED_MC``) on its arguments. The
    calls go to the wrappers as the dispatches hand them over."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    if name == "mode_decide_mc":
        d, (planes, pos_y, pos_x, n, mi_rows, mi_cols, _, grid) = \
            args[:18], args[18:]
        proxy, tail, kw = P.CAND_RATE_PROXY, (), {}
    else:
        d, (planes, pos_y, pos_x, n, mi_rows, mi_cols, _, grid) = \
            args[:13], args[13:21]
        proxy = (P.CAND_RATE_PROXY[0], P.CAND_RATE_PROXY[4])
        tail = args[21:]
        kw = dict(zip(("win_idx", "org_off_y", "org_off_x"), tail))
    kgrid = P.mc_window_grid(tuple(tuple(t.shape) for t in planes[0]),
                             tuple(grid))
    merged = getattr(K, name)
    decide = getattr(K, name[:-3])

    def kernel():
        return merged(*d, proxy, planes, pos_y, pos_x, n, mi_rows, mi_cols,
                      kgrid, *tail)

    def two():
        dec = decide(*d, proxy)
        if name == "mode_decide_mc":
            mv_r, mv_c, ref = dec
            mv = torch.stack([mv_r, mv_c], dim=-1).to(torch.int16)
            kw["ref_sel"] = ref
            head = (mv_r, mv_c, ref, mv)
        else:
            mv_r, mv_c, mv = head = dec
        return (*head, *K.mc_predict(planes, pos_y, pos_x, mv_r, mv_c, n,
                                     mi_rows, mi_cols, kgrid, **kw))

    plain = _plain_args(name, args)
    return kernel, lambda: getattr(P, f"{name}_ref")(*plain), two


def _dmc_bound(name, args, got):
    """The least time of one decided call: its MC's bytes and operations
    (``_mc_work`` at the MVs it decided, ``got``), less the MVs and
    ref_sel it does not read, and its decision's: the zone's as
    ``_md_bound`` counts its reads, a child's nine words, one map entry
    and one rate entry (48 bytes); the MVs written as int32 and int16 (12
    bytes a block) and the zone's ref_sel (1); the decision's float32
    operations, about 60 a block."""
    mc_args, kw = _mc_args_of(name, args, got)
    nbytes, ops = _mc_work(mc_args, {k: v for k, v in kw.items()
                                     if k != "ref_sel"})
    b = mc_args[1].shape[0]
    nbytes -= 8 * b
    if name == "mode_decide_mc":
        rates, left, gold, alt = args[14:18]
        nbytes += b * (20 + 8 + 12 + 13 + (8 if gold is not None else 0)
                       + (16 if alt is not None else 0))
        nbytes += 0 if left is None else left.numel() * 4
        if rates is not None:
            nbytes += 9 * 4 + 3 * 4 * b
            if isinstance(rates["lam_bits"], torch.Tensor):
                nbytes += 4 * b
    else:
        nbytes += b * (48 + 12)
    return _bound(nbytes, ops + 60 * b, ALU_OPS_PER_S)


def _children_mc_tail(dev, zone_args, children_args, nch):
    """The MC arguments (``descent_decide_mc``'s after the decision's) of
    ``nch`` children, four of every parent in raster order (the RA
    shape's; past the zone's parents, again from its first), at the
    zone's window grid in LAST's planes of the real children's call."""
    pos_y, pos_x = zone_args[19], zone_args[20]
    b = nch // 4
    ii = torch.tensor([0, 0, 1, 1], device=dev).repeat(b)
    jj = torch.tensor([0, 1, 0, 1], device=dev).repeat(b)
    off_y, off_x = (ii * 16).to(torch.int32), (jj * 16).to(torch.int32)
    par = (torch.arange(b, device=dev) % pos_y.shape[0]).repeat_interleave(4)
    return (children_args[13], (pos_y[par] + off_y).contiguous(),
            (pos_x[par] + off_x).contiguous(), *children_args[16:21],
            par.to(torch.int32), off_y, off_x)


def _zone_columns(args, c0, c1):
    """The zone's decided call ``args`` cut to its columns c0..c1 - 1 (a
    column shard's batch; LEFT at its column 0 from the NEW MVs of column
    c0 - 1, none at c0 = 0), in its planes from the shard's first column
    on, at the grid of those columns."""
    rows, cols = args[7], args[8]

    def cut(t, per=()):
        return t.reshape(rows, cols, *per)[:, c0:c1].reshape(
            -1, *per).contiguous()

    d = args[0].shape[1]
    left = None if c0 == 0 else torch.stack(
        [args[4].reshape(rows, cols)[:, c0 - 1],
         args[5].reshape(rows, cols)[:, c0 - 1]], dim=-1).contiguous()
    gold = None if args[16] is None else torch.stack(
        [cut(args[16][0]), cut(args[16][1])]).contiguous()
    alt = None if args[17] is None else tuple(cut(t) for t in args[17])
    step, y_base = args[25][:2]
    # the shard's planes start at its first column (copies, as a shard's
    # are); the positions stay the frame's
    planes = [None if ref is None else tuple(
        p[:, (c0 * step) >> ss:].contiguous() for p, ss in zip(ref, (0, 1, 1)))
        for ref in args[18]]
    return (cut(args[0], (d, d)), *(cut(t) for t in args[1:6]),
            cut(args[6], (2,)), rows, c1 - c0, *args[9:15], left, gold, alt,
            planes, cut(args[19]), cut(args[20]), *args[21:25],
            (step, y_base, rows, c1 - c0))


def decided_kernel_phase(dev, real, mc_entry):
    """The decisions folded into MC (mc_predict.cu's decided instances,
    through mode_decide_mc and descent_decide_mc) against their plain
    compositions (mode_decide_ref or descent_decide_ref, then
    mc_predict_planes_ref) and against the two launches they replace
    (mode_decide or descent_decide, then mc_predict), on the card, bit for
    bit (values, dtypes, shapes): the 1080p M8 P-frame's real zone (GOLDEN,
    the rate tables) and children calls (``_real_m8_inputs``); the zone's
    made-up decisions of ``_md_made_up`` (M9's proxies, tune SQ's
    per-block lam_bits, a shard's LEFT edge, ALTREF with its planes,
    SSEs past 2^24, all ties, which must go to LAST's ZERO) on the real
    MC arguments; the zone's first 15 columns, a 1x4 shard's 510 blocks
    (no multiple of four warps), and its next 15 with their LEFT edge;
    the children without the rate tables, and ``_descent_made_up``'s
    children (all ties with and without the tables, which must go to
    ZERO; PARENT beyond the map) at the RA shape's 8,160; the real RA
    shape (every parent's children, ``encode_children_masked`` run again
    on the recorded inputs); the 720p M8 P-frame's real 32 zone and strip
    zone (n=16). Each instance's registers, spills and CTAs per SM are
    ``mc_kernel_phase``'s. Timed at the 1080p M8 and 720p shapes: call,
    device, host, plain and bound, the two replaced launches' call, device
    and host beside, and in turns the decided call against the two
    launches and against the plain instance's call on the same MVs.
    Returns ``mc_entry`` rebuilt on the decided parts (the main path's
    calls), its plain instance's parts kept under "plain_instance_*"."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.utils.yuv import panning_frames

    max_err = 0

    def held(label, name, args):
        nonlocal max_err
        kernel, plain, two = _dmc_fns(name, args)
        got, want, pair = list(kernel()), list(plain()), list(two())
        for x, y, z in zip(got, want, pair, strict=True):
            if not x.dtype == y.dtype == z.dtype or \
                    not x.shape == y.shape == z.shape:
                raise AssertionError(
                    f"{name} [{label}]: {x.dtype} {tuple(x.shape)} against "
                    f"the plain version's {y.dtype} {tuple(y.shape)} and "
                    f"the two launches' {z.dtype} {tuple(z.shape)}")
        max_err = max(max_err, _check(name, label, got, want),
                      _check(name, f"{label}, against the two launches",
                             got, pair))
        return got

    zargs, cargs = (dict(real["dmc"])[k] for k in DECIDED_MC)
    held("1080p M8 P-frame zone, real, GOLDEN and rate tables",
         "mode_decide_mc", zargs)
    held("1080p M8 P-frame children, real, rate tables",
         "descent_decide_mc", cargs)
    # the zone's made-up decisions on the real MC arguments; ALTREF's
    # planes LAST's turned upside down and mirrored
    rng = np.random.default_rng(53)
    last, gold = zargs[18][0], zargs[18][1]
    alt_planes = tuple(torch.flip(p, (0, 1)).contiguous() for p in last)
    for label, d in _md_made_up(dev, zargs[:18], rng):
        d = (*d[:14], _host_rates(d[14]), *d[15:])
        planes = [last, gold, None if d[17] is None else alt_planes]
        got = held(label, "mode_decide_mc", (*d, planes, *zargs[19:]))
        if label.startswith("all ties") and any(t.any() for t in got[:4]):
            raise AssertionError(f"mode_decide_mc [{label}]: a tie did not "
                                 "go to LAST's ZERO")
        print(f"kernel mode_decide_mc [{label}]: blocks by reference "
              f"{[int((got[2] == i).sum()) for i in range(3)]}")
    q = max(1, zargs[8] // 4)  # a 1x4 mesh's shard: 15 of 1080p's 60
    for c0, c1 in ((0, q), (q, 2 * q)):
        cut = _zone_columns(zargs, c0, c1)
        held(f"columns {c0}-{c1 - 1}, B={cut[1].shape[0]}"
             + (", LEFT edge" if c0 else ""), "mode_decide_mc", cut)
    # the children: without the rate tables, the made-up ones at 8,160
    held("1080p M8 children, real, without rate tables",
         "descent_decide_mc", (*cargs[:12], None, *cargs[13:]))
    desc = dict(real["desc"])
    for label, name, d in _descent_made_up(dev, desc, rng):
        if name != "descent_decide" or label.startswith("real"):
            continue
        d = (*d[:12], _host_rates(d[12]))
        tail = _children_mc_tail(dev, zargs, cargs, d[1].shape[0])
        got = held(label, "descent_decide_mc", (*d, *tail))
        if label.startswith("all ties") and (got[0].any() or got[1].any()):
            raise AssertionError(f"descent_decide_mc [{label}]: a tie did "
                                 "not go to ZERO")
    # the real RA shape: every parent's children
    (eargs, ekw), = real["ecm"]
    g = eargs[7]
    score = desc["descent_split"][1].clone()
    score[-g.cols32:] = -1
    ra_calls = []
    with _recording(("descent_decide_mc",), ra_calls, [True]):
        P.encode_children_masked(*eargs[:6], P.descent_parents(
            score, g.n_blocks32), *eargs[7:], **ekw)
    (_, ra_children), = ra_calls
    held(f"1080p RA shape children, real, B={ra_children[1].shape[0]}",
         "descent_decide_mc", ra_children)
    # the 720p strip geometry's two zones, real
    strip_calls = []
    w, h = STRIP_GEOMS["720p"]
    with _recording(("mode_decide_mc",), strip_calls, [True]):
        enc = _make_encoder(dev, 8, (w, h))
        for frame in panning_frames(w, h, 2, seed=1):
            enc.send_picture(frame)
        enc.flush()
        enc.close()
    if [a[21] for _, a in strip_calls] != [32, 16]:
        raise AssertionError(f"the 720p P-frame's decided MC calls were at "
                             f"n={[a[21] for _, a in strip_calls]}")
    strip = list(zip(("32 zone", "strip"), (a for _, a in strip_calls)))
    for label, args in strip:
        held(f"720p M8 {label}, real, B={args[1].shape[0]}",
             "mode_decide_mc", args)
    if max_err:
        raise AssertionError(f"a decided MC call disagrees: {max_err}")

    def timed(label, name, args):
        kernel, plain, two = _dmc_fns(name, args)
        got = kernel()
        part = _timed("mc_predict", f"{label} B={args[1].shape[0]}", kernel,
                      plain, 5, _dmc_bound(name, args, got),
                      "mc_predict_kernel", 1)
        mc_args, kw = _mc_args_of(name, args, got)
        kgrid = P.mc_window_grid(tuple(tuple(t.shape)
                                       for t in mc_args[0][0]),
                                 tuple(mc_args[9]))

        def plain_mc():
            return K.mc_predict(*mc_args[:8], kgrid, **kw)

        two_ms = _cuda_time_ms(two, 50)
        two_dev = [_device_ms(two, key) for key in
                   (f"{name[:-3]}_kernel", "mc_predict_kernel")]
        two_host = _host_ms(two)
        k_ms, t_ms = _calls_in_turns(kernel, two, 100)
        k2_ms, p_ms = _calls_in_turns(kernel, plain_mc, 100)
        shown = ("not measured" if None in two_dev else
                 f"{two_dev[0]:.4f} + {two_dev[1]:.4f} ms")
        print(f"kernel mc_predict {label}: the two launches it replaces "
              f"({name[:-3]}, then mc_predict): call {two_ms:.4f} ms (CUDA "
              f"events, median), device {shown} (profiler), host "
              f"{two_host:.4f} ms a call; in turns (medians of 100 each) "
              f"the decided call {k_ms:.4f} ms against the two "
              f"{t_ms:.4f} ms, and {k2_ms:.4f} ms against the plain "
              f"instance's call on the same MVs {p_ms:.4f} ms")
        return part, {"shape": part[1], "ms": k_ms, "two_launches_ms": t_ms,
                      "two_launches_device_ms": two_dev,
                      "two_launches_host_ms": two_host,
                      "decided_ms_vs_plain": k2_ms, "plain_mc_ms": p_ms}

    parts, turns = [], []
    for label, name, args in (
            ("1080p M8 zone n=32, decided", "mode_decide_mc", zargs),
            ("1080p M8 children n=16, decided", "descent_decide_mc",
             cargs)):
        part, turn = timed(label, name, args)
        parts.append(part)
        turns.append(turn)
    strip_parts = []
    for label, args in strip:
        part, turn = timed(f"720p M8 {label}, decided", "mode_decide_mc",
                           args)
        strip_parts.append(part)
        turns.append(turn)
    entry = _entry("mc_predict", mc_entry["source"], mc_entry["replaces"],
                   max(max_err, mc_entry["max_abs_err"]), parts)
    entry["strip_parts"] = [_part(p) for p in strip_parts]
    entry["ra_parts"] = []  # the real RA step's, from ra_kernel_phase
    entry["decided_vs_replaced"] = turns
    entry["decides"] = {"mode_decide_mc": "tpu_vp9/pipeline/"
                        "tpu_encdec.py:1407",
                        "descent_decide_mc": "tpu_vp9/pipeline/"
                        "tpu_encdec.py:1902"}
    for key in ("parts", "strip_parts", "ra_parts"):
        entry[f"plain_instance_{key}"] = mc_entry.get(key, [])
    return entry


# the descent's kernels: the JAX lines each replaces (tpu_encdec.py:
# encode_children_masked's gathers, candidate decision and pack, and
# pframe_step's split decision and merge), and their threads a CTA
DESCENT_REPLACES = {"descent_gather": "tpu_vp9/pipeline/tpu_encdec.py:1933",
                    "descent_decide": "tpu_vp9/pipeline/tpu_encdec.py:1973",
                    "descent_pack": "tpu_vp9/pipeline/tpu_encdec.py:2044",
                    "descent_split": "tpu_vp9/pipeline/tpu_encdec.py:2134"}
DESCENT_THREADS = {"descent_gather": 128, "descent_decide": 128,
                   "descent_pack": 128, "descent_split": 128}
# the dispatch arguments a call writes in place on the card: the split's
# zone planes
IN_PLACE_ARGS = {"descent_split": (5, 6, 7)}


def _descent_fns(name, args):
    """(kernel call, plain call) of the descent's ``name`` on its
    dispatch's positional arguments ``args``. The split's kernel call
    writes copies of the zone's planes, taken once here (the call is the
    same each time), so that ``args`` keep the zone's recon."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    if name == "descent_decide":
        proxy = (P.CAND_RATE_PROXY[0], P.CAND_RATE_PROXY[4])
        plain = _plain_args(name, args)
        return (lambda: K.descent_decide(*args, proxy),
                lambda: P.descent_decide_ref(*plain))
    if name == "descent_split":
        planes = [t.clone() for t in args[5:8]]
        plain = _plain_args(name, args)
        return (lambda: K.descent_split(*args[:5], *planes, *args[8:],
                                        P.SPLIT_RATE_EXTRA),
                lambda: P.descent_split_ref(*plain))
    # the wrappers take the constants that the dispatches hand them
    extra = {"descent_gather": (P.BORDER,)}.get(name, ())
    return (lambda: getattr(K, name)(*args, *extra),
            lambda: getattr(P, f"{name}_ref")(*args))


def _descent_tensors(out):
    return list(out.values()) if isinstance(out, dict) else list(out)


def _split_kept(label, args, got):
    """Raise unless every block of the zone that did not split (not
    selected, or selected and kept whole) is byte-identical in the planes
    the in-place split returned to the zone's recon before the call
    (``args``' planes)."""
    kept = ~got[0].bool()
    for plane, before, n in zip(got[1:], args[5:8], (32, 16, 16)):
        mask = kept.repeat_interleave(n, 0).repeat_interleave(n, 1)
        if not torch.equal(plane[mask], before[mask]):
            raise AssertionError(f"descent_split [{label}]: a block that "
                                 "did not split changed")


def _descent_bound(name, args):
    """The least time of one call of the descent's ``name`` (its
    dispatch's ``args``) by bytes, each input read once and each output
    written once, at HBM speed, against its operations (the gather's
    dp4a sums, five a byte of its source; the others' few a word are far
    below their bytes). Per parent the gather reads the 56x56 region of
    its union slice that its four children's 40x40 windows cover (rows and
    columns 16i .. 16i + 39 of child (i, j)), 3,136 bytes, its sel entry,
    winner and MV (20), and each child's source blocks (384) and
    co-located LAST luma block (256), and writes each child's window and
    blocks (1,984) and eleven int32 words (44): 13,828 bytes; the decide
    reads a child's map entry, nine words and a rate entry, and writes its
    MVs (12 bytes); the pack reads a child's eobs, levels (int16), recon
    and luma source, and writes skip, the merged recon and a parent's two
    int64 sums (7,236 bytes a parent), against its operations (the SSE's
    five a luma byte); the split reads each selected parent's sel entry
    and the zone's and children's costs (32 bytes), zeroes split32 and
    writes each selected parent's, and for each parent that splits in this
    run reads its children's blocks and writes them into the planes (3,072
    bytes)."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    ops = 0
    if name == "descent_gather":
        k = args[0].shape[0]
        nbytes = k * (3136 + 20 + 4 * (384 + 256) + 4 * (1984 + 44))
        ops = 5 * 256 * 4 * k
    elif name == "descent_decide":
        nbytes = args[1].shape[0] * (4 + 9 * 4 + 4 + 12)
    elif name == "descent_pack":
        nch = args[0].shape[0]
        nbytes = nch * (12 + 2 * 384 + 384 + 256) + nch * (1 + 384) \
            + 16 * nch // 4
        ops = 5 * 256 * nch
    else:
        k, b32 = args[0].shape[0], args[1].shape[0]
        n_split = int(P.descent_split_ref(
            *_plain_args("descent_split", args))[0].sum())
        nbytes = 32 * k + 4 * b32 + 4 * k + 3072 * n_split
    return _bound(nbytes, ops, ALU_OPS_PER_S)


def _descent_made_up(dev, real, rng):
    """The made-up cases (label, dispatch name, args) on the real 1080p
    calls: the gather at every frame-edge parent out of raster order with
    winners at -WIN_R and WIN_R (the union clamped at 0 and at SW - 64),
    and on every parent with the union starting at every byte of a word
    (rows and columns 0-56 in steps of 7 and 5);
    the decide without rate tables, and with all three costs tied (with
    and without the tables: ZERO must win) on 8,160 made-up children whose
    PARENT MVs lie anywhere in the parents' reach; the pack with its SSE at
    256 * 255^2 a child and every level nonzero, and at 0 with every level
    zero; the split with every
    parent of the overhang row selected and its children far better (none
    may split), at lam 0 and 10^6 (the rate terms gone, and ruling), and
    at lam 0 with the children's distortion equal to their parent's in
    every real parent (all ties: none may split) and one less (all but the
    overhang row split)."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    args = dict(real)
    g = args["descent_gather"][9]
    cases = []
    # the gather at the frame's edges
    idx = torch.arange(g.n_blocks32, device=dev).reshape(g.rows32, g.cols32)
    edges = torch.unique(torch.cat([idx[0], idx[-1], idx[:, 0], idx[:, -1]]))
    sel = edges[torch.from_numpy(rng.permutation(edges.numel())).to(dev)]
    ga = list(args["descent_gather"])
    ar = torch.arange(g.n_blocks32, device=dev, dtype=torch.int32)
    ga[0] = sel.to(torch.int32).contiguous()
    ga[2] = torch.where(ar % 2 == 0, -P.WIN_R, P.WIN_R).to(torch.int32)
    ga[3] = torch.where(ar % 3 == 0, P.WIN_R, -P.WIN_R).to(torch.int32)
    cases.append(("every edge parent, winners at +-WIN_R",
                  "descent_gather", tuple(ga)))
    ga = list(args["descent_gather"])
    ga[2] = ((ar * 5) % 57 - 36).to(torch.int32)
    ga[3] = ((ar * 7) % 57 - 36).to(torch.int32)
    ga[0] = ar[torch.from_numpy(rng.permutation(g.n_blocks32)).to(dev)]
    cases.append(("every parent, the union at every byte of a word",
                  "descent_gather", tuple(ga)))
    # the decide without the rate tables, on the real children
    da = list(args["descent_decide"])
    cases.append(("real children without rate tables", "descent_decide",
                  (*da[:12], None)))
    # all ties on made-up children
    n = 8160
    d = 2 * P.CHILD_R + 1
    edge = 8 * P.WIN_R + 6

    def on(a, dtype=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    src2 = rng.integers(0, 4_000_000, n)
    sub = rng.integers(-70, 71, (2, n))
    base = rng.integers(-32, 25, (2, n))
    # cost = sse + rate (its device row too, which the kernel reads)
    rates = _host_rates(dict(da[12], lam_bits=256.0))
    m = rates["mv_cost_max"]
    jc, nr, nc = (rates[k].cpu().numpy() for k in ("joint_cost", "nmv_row",
                                                   "nmv_col"))
    for tables in (rates, None):
        par = base * 8 + sub  # mvd 0: NEW's rate is known
        if tables is None:
            rate = (2, 10, 4)  # lam 1: the proxies, NEW's at mvd 0
        else:
            mc = tables["mode_cost"]
            rate = (mc[2], mc[3] + int(jc[0] + nr[m] + nc[m]), mc[0])
        top = 3_000_000
        fy = np.clip(((par[0] + 4) >> 3) - base[0], -8, 8) + 8
        fx = np.clip(((par[1] + 4) >> 3) - base[1], -8, 8) + 8
        ssem = rng.integers(-2_000_000, 2_000_000, (n, d, d))
        ssem[np.arange(n), fy, fx] = top - rate[2] - src2
        cases.append((f"all ties {'with' if tables else 'without'} rate "
                      f"tables B={n}", "descent_decide",
                      (on(ssem), on(np.full(n, top - rate[0])),
                       on(np.full(n, top - rate[1])), on(sub[0]), on(sub[1]),
                       on(src2), on(base[0]), on(base[1]), on(par[0]),
                       on(par[1]), _row(dev, lam=1), da[11], tables)))
    # PARENT anywhere in the parents' reach, costs far apart
    par = rng.integers(-edge, edge + 1, (2, n))
    cases.append((f"PARENT beyond the map B={n}", "descent_decide",
                  (on(rng.integers(-2_000_000, 2_000_000, (n, d, d))),
                   on(rng.integers(0, 4_000_000, n)),
                   on(rng.integers(0, 4_000_000, n)), on(sub[0]), on(sub[1]),
                   on(src2), on(base[0]), on(base[1]), on(par[0]),
                   on(par[1]), _row(dev, lam=300), da[11], da[12])))
    # the pack on the real call's shapes: its SSE at its most (recon 255
    # against a source of 0) with every level nonzero, and 0 with every
    # level zero
    pa = args["descent_pack"]
    lv = [torch.full_like(t, -3) for t in pa[3:6]]
    cases.append(("pack: recon 255 against a source of 0, every level "
                  "nonzero", "descent_pack",
                  (*pa[:3], *lv, torch.full_like(pa[6], 255), *pa[7:9],
                   torch.zeros_like(pa[9]))))
    cases.append(("pack: every level zero, recon equal to its source",
                  "descent_pack",
                  (*pa[:3], *(torch.zeros_like(t) for t in pa[3:6]),
                   pa[6], *pa[7:9], pa[6].clone())))
    # the split: the overhang row selected with children far better
    sa = list(args["descent_split"])
    b32, c32 = g.n_blocks32, g.cols32
    last = torch.arange(b32 - c32, b32, device=dev)
    sel = torch.cat([last, torch.arange(min(200, b32 - c32),
                                        device=dev)]).to(torch.int32)
    k = sel.numel()
    dist_b, rate_b = sa[1], sa[2]
    u8 = torch.uint8
    over = (sel.contiguous(), dist_b, rate_b,
            (dist_b[sel.long()] // 10).to(torch.int64),
            torch.zeros(k, dtype=torch.int64, device=dev), *sa[5:8],
            on(rng.integers(0, 256, (k, 32, 32)), u8),
            on(rng.integers(0, 256, (k, 16, 16)), u8),
            on(rng.integers(0, 256, (k, 16, 16)), u8), sa[11], g)
    cases.append(("the overhang row selected, its children far better",
                  "descent_split", over))
    for lam in (0, 10 ** 6):
        cases.append((f"lam {lam}", "descent_split",
                      (*sa[:11], _row(dev, lam=lam), g)))
    for gap, tag in ((0, "all ties"), (1, "children one better")):
        tie = list(sa)
        tie[3] = (dist_b[sa[0].long()] - gap).to(torch.int64)
        cases.append((f"{tag} at lam 0", "descent_split",
                      (*tie[:11], _row(dev, lam=0), g)))
    return cases


def descent_kernel_phase(dev, real, ecm):
    """descent_gather, descent_decide, descent_pack and descent_split
    (CUDA) against their plain versions on the card, bit for bit (values,
    dtypes, shapes): on the 1080p M8 P-frame's real calls (K = 510 parents,
    2,040 children; ``_real_m8_inputs``); at the random-access shape, the
    same frame's children of every parent (K = 2,040, 8,160 children, in
    descent_parents' order, the overhang row last; encode_children_masked
    run again on the recorded inputs, its dispatches recorded); and on the
    made-up cases of ``_descent_made_up``, ties going to ZERO and the
    overhang row kept whole. The split writes copies of the zone's planes
    in place; every block it did not split must stay byte-identical to
    the zone's recon before the call. Each kernel's registers, spills and
    resident CTAs per SM printed; call, device, plain and bound times on
    the real and the RA calls."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    for name, short in zip(DESCENT_WRAPPERS, K.DESCENT_KERNELS):
        _kernel_resources(dev, name, None,
                          lambda key, d, s=short: K.descent_occupancy(s, d),
                          threads=DESCENT_THREADS[name], lib="descent")
    errs = dict.fromkeys(DESCENT_WRAPPERS, 0)

    def held(label, name, args):
        kernel, plain = _descent_fns(name, args)
        got, want = kernel(), plain()
        if isinstance(got, dict) and list(got) != list(want):
            raise AssertionError(f"{name} [{label}]: keys {list(got)}, "
                                 f"plain {list(want)}")
        g_t, w_t = _descent_tensors(got), _descent_tensors(want)
        for a, b in zip(g_t, w_t):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"{name} [{label}]: {a.dtype} "
                                     f"{tuple(a.shape)} against the plain "
                                     f"version's {b.dtype} {tuple(b.shape)}")
        errs[name] = max(errs[name], _check(name, label, g_t, w_t))
        if name == "descent_split":
            _split_kept(label, args, got)
        return got

    m8 = dict(real)
    for name in DESCENT_WRAPPERS:
        held("1080p M8 P-frame, real", name, m8[name])
    # the RA shape: every parent's children, again through the dispatches
    (args, kw), = ecm
    g = args[7]
    score = m8["descent_split"][1].clone()
    score[-g.cols32:] = -1
    sel_all = P.descent_parents(score, g.n_blocks32)
    calls = []
    with _recording(DESCENT_WRAPPERS[:3], calls, [True]):
        out16 = P.encode_children_masked(*args[:6], sel_all, *args[7:], **kw)
    ra = dict(calls)
    sa = m8["descent_split"]
    ra["descent_split"] = (out16["sel_idx"], sa[1], sa[2], out16["dist4"],
                           out16["rate4"], *sa[5:8], out16["rec_y32"],
                           out16["rec_u16"], out16["rec_v16"], sa[11], g)
    split = None
    for name in DESCENT_WRAPPERS:
        got = held(f"1080p RA shape, K={g.n_blocks32}", name, ra[name])
        if name == "descent_split":
            split = got[0]
    if split[-1].any():
        raise AssertionError("descent_split: an overhang parent split at "
                             "the RA shape")
    print(f"kernel descent_split [1080p RA shape]: {int(split.sum())} of "
          f"{g.n_blocks32} parents split, none of the overhang row")
    rng = np.random.default_rng(43)
    for label, name, args in _descent_made_up(dev, m8, rng):
        got = held(label, name, args)
        if name == "descent_decide" and label.startswith("all ties") and \
                (got[0].any() or got[1].any()):
            raise AssertionError(f"descent_decide [{label}]: a tie did not "
                                 "go to ZERO")
        if name == "descent_pack":
            most = label.startswith("pack: recon 255")
            want = ((4 * 256 * 255 ** 2, 4 * (256 + 128)) if most
                    else (0, 0))
            if not (torch.all(got["dist4"] == want[0])
                    and torch.all(got["rate4"] == want[1])):
                raise AssertionError(f"descent_pack [{label}]: dist4, rate4 "
                                     f"not {want}")
        if name != "descent_split":
            continue
        sel = args[0].long()
        over = sel >= g.n_blocks32 - g.cols32
        taken = got[0].reshape(-1)[sel].bool()
        if taken[over].any():
            raise AssertionError(f"descent_split [{label}]: an overhang "
                                 "parent split")
        want_all = {"all ties": False, "children one better": True}
        for tag, every in want_all.items():
            if label.startswith(tag) and \
                    not torch.equal(taken[~over], torch.full_like(
                        taken[~over], every)):
                raise AssertionError(f"descent_split [{label}]: "
                                     f"{int(taken.sum())} of {sel.numel()} "
                                     "parents split")
        if label.startswith("the overhang row") and not taken.any():
            raise AssertionError(f"descent_split [{label}]: no parent "
                                 "split")
        print(f"kernel descent_split [{label}]: {int(got[0].sum())} of "
              f"{sel.numel()} parents split")

    def timed(name, label, args):
        kernel, plain = _descent_fns(name, args)
        return _timed(name, label, kernel, plain, 5,
                      _descent_bound(name, args),
                      WRAPPER_KERNELS[name], 1)

    entries = {}
    for name in DESCENT_WRAPPERS:
        k = m8["descent_split"][0].shape[0]
        entry = _entry(name, "tpu_vp9_torch/csrc/descent.cu",
                       DESCENT_REPLACES[name], errs[name],
                       [timed(name, f"1080p M8 real K={k}", m8[name])])
        entry["ra_parts"] = [_part(timed(
            name, f"1080p RA shape K={g.n_blocks32}", ra[name]))]
        entries[name] = entry
    # the split's zeroing of split32: a memset on the stream, no launch
    memset = _device_ms(_descent_fns("descent_split", m8["descent_split"])[0],
                        "Memset")
    print("kernel descent_split: its split32 memset "
          + ("not measured" if memset is None else f"{memset:.4f} ms")
          + " of device time per call (profiler), not a kernel launch")
    entries["descent_split"]["memset_ms"] = memset
    return entries


# the mode decision's and the windows' kernels: the JAX functions each
# replaces (tpu_encdec.py: _candidate_decide, with _ssem_gather and
# encode_zone's GOLDEN and ALTREF blocks; _extract_search_windows;
# extend_borders_device) and their sources
MD_WINDOW_REPLACES = {
    "mode_decide": "tpu_vp9/pipeline/tpu_encdec.py:1407",
    "extract_windows": "tpu_vp9/pipeline/tpu_encdec.py:296",
    "extend_borders": "tpu_vp9/pipeline/tpu_encdec.py:112"}
MD_WINDOW_SOURCES = {"mode_decide": "tpu_vp9_torch/csrc/mode_decide.cu",
                     "extract_windows": "tpu_vp9_torch/csrc/windows.cu",
                     "extend_borders": "tpu_vp9_torch/csrc/windows.cu"}
MD_WINDOW_THREADS = {"mode_decide": 128, "extract_windows": 256,
                     "extend_borders": 256}


def _md_bound(args):
    """The least time of one ``mode_decide`` call (the dispatch's
    ``args``), by bytes: per block the five int32 words of LAST, its
    previous MV, the three map entries PREV, LEFT and ABOVE read, GOLDEN's
    two SSEs, ALTREF's four words and the block's lam_bits where given,
    and the MVs and ref_sel written; the rate tables' entries and the
    left edge besides. Its float32 arithmetic, about 60 operations a
    block, is far below that."""
    b = args[4].shape[0]
    rates, left, gold, alt = args[14:18]
    per = 20 + 8 + 12 + 9 + (8 if gold is not None else 0) \
        + (16 if alt is not None else 0)
    nbytes = b * per + (0 if left is None else left.numel() * 4)
    if rates is not None:
        nbytes += 9 * 4 + 3 * 4 * b  # the scalars, three LUT entries
        if isinstance(rates["lam_bits"], torch.Tensor):
            nbytes += 4 * b
    return _bound(nbytes, 60 * b, ALU_OPS_PER_S)


def _win_bound(jobs, rows, cols):
    """The least time of one ``extract_windows`` call, by bytes: each
    set's windows written and the plane region they cover read once."""
    nbytes = 0
    for _, n, _, r in jobs:
        sw = n + 2 * r + 8
        nbytes += rows * cols * sw * sw \
            + ((rows - 1) * n + sw) * ((cols - 1) * n + sw)
    return _bound(nbytes, 0, ALU_OPS_PER_S)


def _eb_bound(planes, crops):
    """The least time of one ``extend_borders`` call, by bytes: each
    bordered plane written and its visible crop read once."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    bd = 2 * P.BORDER
    nbytes = sum((p.shape[0] + bd) * (p.shape[1] + bd) + cw * ch
                 for p, (cw, ch) in zip(planes, crops))
    return _bound(nbytes, 0, ALU_OPS_PER_S)


def _md_window_fns(name, args):
    """(kernel call, plain call, library call or None) of ``name`` on its
    dispatch's positional arguments. The library calls compute the same
    function with one PyTorch call a set or plane: unfold(...).contiguous()
    of each set's region, two index_selects of each plane."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    if name == "mode_decide":
        plain = _plain_args(name, args)
        return (lambda: K.mode_decide(*args, P.CAND_RATE_PROXY),
                lambda: P.mode_decide_ref(*plain), None)
    if name == "extract_windows":
        jobs, rows, cols = args
        specs = P.window_specs(jobs, rows, cols)
        regions = [(p[y0:y0 + (rows - 1) * n + sw,
                      x0:x0 + (cols - 1) * n + sw], n, sw)
                   for p, n, sw, y0, x0 in specs]
        return (lambda: K.extract_windows(specs, rows, cols),
                lambda: [P._extract_search_windows(p, n, rows, cols, y, r)
                         for p, n, y, r in jobs],
                lambda: [reg.unfold(0, sw, n).unfold(1, sw, n).contiguous()
                         for reg, n, sw in regions])
    planes, crops = args[:2]
    idx = []
    for p, (cw, ch) in zip(planes, crops):
        idx.append((
            torch.arange(-P.BORDER, p.shape[0] + P.BORDER,
                         device=p.device).clamp(0, ch - 1),
            torch.arange(-P.BORDER, p.shape[1] + P.BORDER,
                         device=p.device).clamp(0, cw - 1)))
    return (lambda: K.extend_borders(planes, crops, P.BORDER),
            lambda: [P.extend_borders_device(p, *c)
                     for p, c in zip(planes, crops)],
            lambda: [p.index_select(0, r).index_select(1, c)
                     for p, (r, c) in zip(planes, idx)])


def _md_window_bound(name, args):
    if name == "mode_decide":
        return _md_bound(args)
    if name == "extract_windows":
        return _win_bound(*args)
    return _eb_bound(*args[:2])


def _md_made_up(dev, md_args, rng):
    """The mode decision's made-up cases on the real 1080p M8 call
    ``md_args`` (LAST and GOLDEN with the rate tables; GOLDEN's SSEs moved
    down, as its planes are LAST's in the first P-frame): M9's proxies
    with and without GOLDEN, tune SQ's per-block lam_bits, a column
    shard's LEFT edge, ALTREF (its ZERO, NEW and MVs the real LAST's,
    rolled), SSEs above 2^24 a few apart, and all-tie inputs at B = 2,040
    (every
    candidate and reference of equal cost, with the tables, with lam_bits
    0 and with the proxies at lam 0: LAST's ZERO must win). Returns
    [(label, args)]."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    a = list(md_args)
    rows, cols = a[7], a[8]
    rates = a[14]
    b = rows * cols
    # the first P-frame's GOLDEN is its LAST (the keyframe): its SSEs moved
    # down by up to a few rates, so that GOLDEN wins where they cross
    shift = torch.from_numpy(rng.integers(-3000, 20_000, (2, b))).to(dev)
    gold = (a[16] - shift).clamp(min=0).to(torch.int32).contiguous()
    a[16] = gold
    cases = [("M9 proxies", (*a[:14], None, None, None, None)),
             ("proxies with GOLDEN, its SSEs moved", (*a[:14], None, None,
                                                      gold, None)),
             ("GOLDEN's SSEs moved", tuple(a))]
    scale = torch.from_numpy(rng.uniform(0.5, 2.0, b).astype(np.float32))
    lam_vec = (scale * np.float32(rates["lam_bits"])).to(dev).contiguous()
    cases.append(("tune SQ per-block lam_bits",
                  (*a[:14], dict(rates, lam_bits=lam_vec), *a[15:])))
    edge = torch.stack([a[4], a[5]], dim=-1).reshape(rows, cols, 2)[:, -1]
    cases.append(("a shard's left_edge",
                  (*a[:15], edge.flip(0).contiguous(), *a[16:])))
    alt = tuple(t.roll(k).contiguous() for t, k in zip(a[2:6], (7, 3, 11, 5)))
    cases.append(("ALTREF with GOLDEN", (*a[:17], alt)))
    big = torch.from_numpy(rng.integers(1 << 24, 66_300_000, b)).to(dev)
    sses = [(big + k).to(torch.int32).contiguous() for k in range(6)]
    cases.append(("SSEs above 2^24", (
        *a[:2], sses[0], sses[1], *a[4:16],
        torch.stack([sses[2], sses[3]]).contiguous(),
        (sses[4], sses[5], *alt[2:]))))
    # all ties: equal map scores and SSEs, equal rates, equal signalling
    d = a[0].shape[1]
    x = 4 * 1_000_003
    src2m = torch.full((b,), 300_000, dtype=torch.int32, device=dev)
    ssem = torch.full((b, d, d), x // 4 - 300_000, dtype=torch.int32,
                      device=dev)
    full = torch.full((b,), x, dtype=torch.int32, device=dev)
    m = 60
    tie = {"mode_cost": np.full(4, 300, np.int32),
           "joint_cost": np.zeros(4, np.int32),
           "nmv_row": np.zeros(2 * m + 1, np.int32),
           "nmv_col": np.zeros(2 * m + 1, np.int32),
           "ref_cost": np.full(3, 150, np.int32), "mv_cost_max": m}
    tie_args = (ssem, src2m, full, full, *a[4:7], *a[7:13], a[13])
    tie_alt = (full, full, a[5], a[4])
    tie_gold = torch.stack([full, full]).contiguous()
    for lam_bits in (1234.5, 0.0):
        up = P.upload_rate_tabs(dict(tie, lam_bits=np.float32(lam_bits)),
                                dev)
        cases.append((f"all ties, rate tables, lam_bits {lam_bits}",
                      (*tie_args, up, None, tie_gold, tie_alt)))
    cases.append(("all ties, proxies at lam 0",
                  (*tie_args[:12], _row(dev, lam=0), a[13], None, None,
                   tie_gold, None)))
    return cases


def md_window_kernel_phase(dev, real):
    """mode_decide, extract_windows and extend_borders (CUDA) against
    their plain versions on the card, bit for bit (values, dtypes,
    shapes): the 1080p M8 P-frame's real calls (``_real_m8_inputs``: the
    32 zone's decision with GOLDEN and the rate tables, its search window
    site (MC cuts none), the keyframe's and the P-frame's borders); the
    made-up decisions of ``_md_made_up`` (ties must go to LAST's ZERO);
    the 720p strip geometry's real calls (a keyframe and an M8 P-frame
    through the public encoder, the 32 zone's and the strip's decisions
    and search windows recorded); 4K made-up planes (the 32 zone's and the
    strip's search sites, the borders) and 1080p planes at odd crops. Each
    kernel's registers, spills and resident CTAs per SM printed; call,
    device, plain, library and bound times at the 1080p M8 shapes (the
    entries), 720p and 4K (their "strip_parts"); extract_windows' call
    beside unfold(...).contiguous()'s and extend_borders' beside two
    index_selects a plane at every shape, in turns ("call_vs_library").
    Returns {name: entry}."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.utils.yuv import panning_frames

    occupancy = {"mode_decide": lambda key, d: K.mode_decide_occupancy(d),
                 "extract_windows": lambda key, d: K.windows_occupancy(
                     "extract_windows", d),
                 "extend_borders": lambda key, d: K.windows_occupancy(
                     "extend_borders", d)}
    for name in MD_WINDOW_WRAPPERS:
        _kernel_resources(dev, name, None, occupancy[name],
                          threads=MD_WINDOW_THREADS[name],
                          lib=MD_WINDOW_SOURCES[name].split("/")[-1][:-3])
    errs = dict.fromkeys(MD_WINDOW_WRAPPERS, 0)

    def held(label, name, args):
        kernel, plain, _ = _md_window_fns(name, args)
        got, want = list(kernel()), list(plain())
        for x, y in zip(got, want, strict=True):
            if x.dtype != y.dtype or x.shape != y.shape:
                raise AssertionError(f"{name} [{label}]: {x.dtype} "
                                     f"{tuple(x.shape)} against the plain "
                                     f"version's {y.dtype} {tuple(y.shape)}")
        errs[name] = max(errs[name], _check(name, label, got, want))
        return got

    against_library = {"extract_windows": [], "extend_borders": []}
    library_name = {"extract_windows": "unfold(...).contiguous()",
                    "extend_borders": "two index_selects a plane"}

    def timed(name, label, args, count=1):
        kernel, plain, library = _md_window_fns(name, args)
        part = _timed(name, label, kernel, plain, 5,
                      _md_window_bound(name, args), WRAPPER_KERNELS[name],
                      count)
        lib_ms = None if library is None else _cuda_time_ms(library, 20)
        if lib_ms is not None:
            print(f"kernel {name} {label}: the PyTorch calls' time "
                  f"{lib_ms:.4f} ms (CUDA events, median)")
        if name in against_library:
            k_ms, l_ms = _calls_in_turns(kernel, library, 100)
            print(f"kernel {name} {label}: in turns, the kernel's call "
                  f"{k_ms:.4f} ms, {library_name[name]} {l_ms:.4f} ms "
                  f"(CUDA events, medians of 100 each): "
                  f"{'no slower' if k_ms <= l_ms else 'slower'}")
            against_library[name].append({"shape": label, "ms": k_ms,
                                          "library_ms": l_ms})
        return part, lib_ms

    m8 = {}
    for name, args in real:
        m8.setdefault(name, []).append(args)
    md_args = m8["mode_decide"][0]
    held("1080p M8 P-frame, real, GOLDEN and rate tables", "mode_decide",
         md_args)
    if len(m8["extract_windows"]) != 1:
        raise AssertionError(f"the 1080p M8 P-frame cut "
                             f"{len(m8['extract_windows'])} window sets")
    held("1080p M8 P-frame search site, real (1 set)", "extract_windows",
         m8["extract_windows"][0])
    for label, args in zip(("keyframe", "P-frame"), m8["extend_borders"]):
        held(f"1080p {label}, real", "extend_borders", args)
    rng = np.random.default_rng(47)
    for label, args in _md_made_up(dev, md_args, rng):
        got = held(label, "mode_decide", args)
        if label.startswith("all ties") and any(t.any() for t in got):
            raise AssertionError(f"mode_decide [{label}]: a tie did not go "
                                 "to LAST's ZERO")
        print(f"kernel mode_decide [{label}]: blocks by reference "
              f"{[int((got[2] == i).sum()) for i in range(3)]}")
    planes = m8["extend_borders"][1][0]
    held("1080p planes at odd crops", "extend_borders",
         (planes, ((1917, 1079), (959, 539), (1, 1))))

    # 720p (the strip) real; 4K made-up
    strip_calls = []
    w, h = STRIP_GEOMS["720p"]
    with _recording(MD_WINDOW_WRAPPERS, strip_calls, [True]):
        enc = _make_encoder(dev, 8, (w, h))
        for frame in panning_frames(w, h, 2, seed=1):
            enc.send_picture(frame)
        enc.flush()
        enc.close()
    s720 = {}
    for name, args in strip_calls:
        s720.setdefault(name, []).append(args)
    if {k: len(v) for k, v in s720.items()} != {
            "extend_borders": 2, "extract_windows": 2, "mode_decide": 2}:
        raise AssertionError(f"the 720p keyframe and P-frame made these "
                             f"calls: { {k: len(v) for k, v in s720.items()} }")
    strip_parts = {k: [] for k in MD_WINDOW_WRAPPERS}
    for label, args in zip(("32 zone", "strip"), s720["mode_decide"]):
        held(f"720p M8 {label}, real", "mode_decide", args)
        strip_parts["mode_decide"].append(timed(
            "mode_decide", f"720p M8 {label} B={args[4].shape[0]}", args)[0])
    for label, args in zip(("32 zone search", "strip search"),
                           s720["extract_windows"]):
        held(f"720p M8 {label}, real", "extract_windows", args)
        strip_parts["extract_windows"].append(timed(
            "extract_windows", f"720p M8 {label} ({len(args[0])} sets, "
            f"B={args[1] * args[2]})", args)[0])
    held("720p P-frame, real", "extend_borders", s720["extend_borders"][1])
    strip_parts["extend_borders"].append(timed(
        "extend_borders", "720p P-frame", s720["extend_borders"][1])[0])
    g4 = P.make_geom(*STRIP_GEOMS["4K"])
    shapes = ((g4.pad_h, g4.pad_w), (g4.pad_h // 2, g4.pad_w // 2),
              (g4.pad_h // 2, g4.pad_w // 2))
    raw = [torch.from_numpy(rng.integers(0, 256, shp, dtype=np.uint8)).to(dev)
           for shp in shapes]
    eb4 = (tuple(raw), P.recon_crops(g4))
    held("4K recon, made-up", "extend_borders", eb4)
    strip_parts["extend_borders"].append(timed(
        "extend_borders", "4K recon, made-up", eb4)[0])
    last = K.extend_borders(raw, P.recon_crops(g4), P.BORDER)
    for label, (y0, rows, cols, n) in (
            ("32 zone", (0, g4.rows32, g4.cols32, 32)),
            ("strip", (g4.strip_y, 1, g4.cols16, 16))):
        search = ([(last[0], n, y0, P.WIN_R)], rows, cols)
        held(f"4K {label} search, made-up", "extract_windows", search)
        strip_parts["extract_windows"].append(timed(
            "extract_windows", f"4K {label} search (1 set, B={rows * cols}),"
            " made-up", search)[0])
        del search
    # several sets of mixed sides in one launch (the contract takes up to
    # WINDOW_JOBS): 1080p chroma sets of 66 x 66 (a byte a lane), a luma
    # set, and sets read one byte into their plane's storage
    y8, u8, v8 = K.extend_borders(*m8["extend_borders"][1][:2], P.BORDER)
    moved = torch.empty(y8.numel() + 1, dtype=torch.uint8, device=dev)
    moved[1:] = y8.reshape(-1)
    moved = moved[1:].view(y8.shape)
    mixed = ([(u8, 16, 0, P.CHROMA_WIN_R), (v8, 16, 0, P.CHROMA_WIN_R),
              (y8, 32, 0, P.WIN_R), (moved, 32, 0, P.WIN_R),
              (moved, 32, 0, 39)], 34, 60)
    held("1080p mixed sets, unaligned rows", "extract_windows", mixed)
    del raw, last, moved, mixed, y8, u8, v8
    if any(errs.values()):
        raise AssertionError(f"a decision or window call disagrees: {errs}")

    entries = {}
    timings = {
        "mode_decide": [("1080p M8 zone, real, GOLDEN", md_args)],
        "extract_windows": [("1080p M8 search site, real (1 set)",
                             m8["extract_windows"][0])],
        "extend_borders": [("1080p P-frame, real",
                            m8["extend_borders"][1])]}
    for name in MD_WINDOW_WRAPPERS:
        parts, lib = [], []
        for label, args in timings[name]:
            part, lib_ms = timed(name, label, args)
            parts.append(part)
            lib.append(lib_ms)
        entry = _entry(name, MD_WINDOW_SOURCES[name],
                       MD_WINDOW_REPLACES[name], errs[name], parts)
        if name != "mode_decide":
            entry["library_ms"] = sum(lib)
        entry["strip_parts"] = [_part(p) for p in strip_parts[name]]
        entries[name] = entry
    for name, calls in against_library.items():
        entries[name]["call_vs_library"] = calls
        slower = [c["shape"] for c in calls if c["ms"] > c["library_ms"]]
        print(f"kernel {name}: the call no slower than {library_name[name]} "
              f"at {len(calls) - len(slower)} of {len(calls)} shapes; slower "
              f"at {slower}")
    return entries


def _part(p):
    """A ``_timed`` part as the JSON line has it."""
    count, label, ms, plain_ms, bound, device_ms, host_ms = p
    return {"shape": label, "per_frame": count, "ms": ms, "plain_ms": plain_ms,
            "device_ms": device_ms, "host_ms": host_ms, "bound_ms": bound[0],
            "bound_by": bound[1]}


def _cuda_time_once(fn) -> float:
    """Device time of one call from CUDA events (for a plain version too
    slow to repeat; it has run before, so it is warm)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _real_strip_inputs(dev):
    """The real inputs of the strip's kernels: the first two frames of the
    720p clip (a keyframe and an M8 P-frame) through the public encoder,
    the strip zone's calls recorded: the P-frame's sse_map_search and
    quarter-pel search at n=16 r=40, its other launches on the strip's 80
    blocks (the transforms of Y at 16 and U, V at 8, the recon SSE, ZERO's
    and GOLDEN's SSE read in place), and the keyframe strip's ADST_DCT
    transforms (its V and D63 candidates). Returns {"sse", "sp": the
    argument tuple; "adst", "tr", "be", "bea": lists of them}."""
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.utils.yuv import panning_frames

    w, h = STRIP_GEOMS["720p"]
    names = {"sse": "sse_map_search", "sp": "subpel_search",
             "tr": "transform_recon", "be": "block_energy",
             "bea": "block_energy_at"}
    calls = {k: [] for k in names}
    real = {k: getattr(P, name) for k, name in names.items()}

    def recorded(key, fn):
        def call(*args):
            calls[key].append(_held(names[key], args))
            return fn(*args)
        return call

    for k, name in names.items():
        setattr(P, name, recorded(k, real[k]))
    enc = _make_encoder(dev, 8, (w, h))
    for frame in panning_frames(w, h, 2, seed=1):
        enc.send_picture(frame)
    enc.flush()
    enc.close()
    for k, name in names.items():
        setattr(P, name, real[k])
    torch.cuda.synchronize()
    calls["tr"] = [_tr_ints(c) for c in calls["tr"]]
    b = STRIP_B["720p"]
    adst = int(T.TxType.ADST_DCT)
    # the strip's calls are those of its 80 blocks (the 32 zone has 880)
    strip = {k: [c for c in v if c[0].shape[0] == b] for k, v in calls.items()}
    out = {"sse": [c for c in strip["sse"] if c[2:4] == (16, STRIP_R)],
           "sp": [c for c in strip["sp"] if c[4:] == (16, STRIP_R)],
           "adst": [c for c in strip["tr"]
                    if len(c) == 6 and int(c[5]) == adst],
           "tr": [c for c in strip["tr"] if len(c) == 5],
           "be": strip["be"], "bea": strip["bea"]}
    counts = {k: len(v) for k, v in out.items()}
    # DCT_DCT transforms: the keyframe strip's chroma (2), then the
    # P-frame strip's Y, U, V
    if counts != {"sse": 1, "sp": 1, "adst": 2, "tr": 5, "be": 1, "bea": 2}:
        raise AssertionError(f"the 720p keyframe and P-frame made these "
                             f"calls on the strip's {b} blocks: {counts}")
    out["sse"], out["sp"], out["tr"] = out["sse"][0], out["sp"][0], \
        out["tr"][2:]
    return out


def _kf_bound(nbytes, nb, fp64_ops_per_s):
    """kframe_wave's bound: ``nbytes`` moved, and nb blocks' float64
    operations at ``fp64_ops_per_s`` and integer ones, as operations at
    ALU_OPS_PER_S."""
    return _bound(nbytes, nb * (KF_FP64_OPS * ALU_OPS_PER_S / fp64_ops_per_s
                                + KF_INT_OPS), ALU_OPS_PER_S)


def strip_kernel_phase(dev):
    """The kernels at the strip geometries' shapes against their plain
    versions on the card, bit for bit, each instance's resources printed:
    sse_map_search at n=16 r=40 with its map (its level opts in to 95,684
    bytes of shared memory) for B=80 and B=240 (made-up windows with a
    planted match, ties and the largest operands) and on the real strip of
    a 720p P-frame; subpel_search at n=16 r=40 on the same real windows
    and made-up batches of both sizes (ties, corners, checkerboards);
    transform_recon's ADST_DCT instance at n=16 on the real 720p keyframe
    strip's V and D63 candidates, on 4K strip blocks against their V and
    D63 predictions at TR_QINDICES, +-255 and zero residuals, one level at
    each place of the ADST_DCT scan; the strip zone's other launches on
    the real 720p P-frame (its DCT_DCT transforms of Y at 16 and U, V at
    8, its recon SSE, ZERO's and GOLDEN's SSE read in place); kframe_wave
    on the 720p and 4K 32 zones (a row of 120 blocks at 4K; every launch's
    error word 0). Each timed at its strip shapes. Returns {kernel: [its
    strip parts]}."""
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.pipeline.presets import qp_to_qindex
    from tpu_vp9_torch.utils.yuv import panning_frames

    n, r = 16, STRIP_R
    d, sw = 2 * r + 1, n + 2 * r + 8
    real = _real_strip_inputs(dev)
    sse_real, sp_real, tr_real = real["sse"], real["sp"], real["adst"]
    parts = {k: [] for k in ("sse_map_search", "subpel_search",
                             "transform_recon", "kframe_wave",
                             "block_energy")}
    errs = dict.fromkeys(parts, 0)

    # the strip zone's other launches, on the real 720p P-frame: its
    # transforms (Y at 16, U and V at 8; DCT_DCT), the recon SSE, and
    # ZERO's and GOLDEN's SSE read in place
    for i, (src, pred, dq, aq, nn) in enumerate(real["tr"]):
        err = _tr_case(f"720p P-frame's strip {'YUV'[i]}", src, pred, dq,
                       aq, nn)[0]
        errs["transform_recon"] = max(errs["transform_recon"], err)
        if i < 2:  # Y, and U standing for both chroma planes
            b = src.shape[0]
            sc = _row(dev, dq, aq)
            parts["transform_recon"].append(_timed(
                "transform_recon", f"720p strip {'YU'[i]} B={b} n={nn}",
                lambda: K.transform_recon(src, pred, sc, nn),
                lambda: P.transform_recon_ref(src, pred, dq, aq, nn), 5,
                _tr_bound(b, nn), "transform_recon_kernel", 1 + i))
    (src, rec, nn), = real["be"]
    b = src.shape[0]
    errs["block_energy"] = _check("block_energy", "720p P-frame's strip",
                                  K.block_energy(src, rec, nn),
                                  K.block_energy_ref(src, rec, nn))
    parts["block_energy"].append(_timed(
        "block_energy", f"720p strip recon B={b} n={nn}",
        lambda: K.block_energy(src, rec, nn),
        lambda: K.block_energy_ref(src, rec, nn), 20,
        _bound(2 * b * nn * nn + 8 * b, 5 * b * nn * nn, ALU_OPS_PER_S),
        "block_energy_kernel", 1))
    for src, plane, y0, x0, nn in real["bea"]:
        c, b = y0.shape
        label = "ZERO" if c == 1 else "GOLDEN"
        errs["block_energy"] = max(errs["block_energy"], _check(
            "block_energy_at", f"720p P-frame's strip {label}",
            K.block_energy_at(src, plane, y0, x0, nn),
            K.block_energy_at_ref(src, plane, y0, x0, nn)))
        parts["block_energy"].append(_timed(
            "block_energy_at", f"720p strip {label} B={b} n={nn} C={c}",
            lambda: K.block_energy_at(src, plane, y0, x0, nn),
            lambda: K.block_energy_at_ref(src, plane, y0, x0, nn), 20,
            _bound(b * nn * nn * (1 + c) + 16 * c * b, 5 * c * b * nn * nn,
                   ALU_OPS_PER_S), "block_energy_at_kernel", 1))

    # sse_map_search: the flat +-40 search of the strip
    ctas, dyn, threads = K.sse_map_search_occupancy(n, r, dev)
    _print_resources(f"sse_map_search uint8 n={n} r={r} (strips of 9)",
                     _ptxas_instances("sse_search")[("h", n, 9)], ctas, dyn,
                     threads)

    def sse_bound(b):
        # reads blocks and windows, writes the winner and the map; a
        # multiply and an add per candidate pixel at the 8-bit rate
        return _bound(b * (n * n + sw * sw + 8 + 4 * d * d),
                      2 * b * d * d * n * n, INT8_OPS_PER_S)

    for label, b in STRIP_B.items():
        s_np, w_np = _sse_inputs(n, r, False, seed=b, b=b)
        s = torch.from_numpy(s_np).to(dev)
        w = torch.from_numpy(w_np).to(dev)
        for with_map in (True, False):
            got = K.sse_map_search(s, w, n, r, want_map=with_map)
            errs["sse_map_search"] = max(errs["sse_map_search"], _check(
                "sse_map_search", f"made-up B={b} n={n} r={r} map="
                f"{with_map}", got, K.sse_map_search_ref(s, w, n, r,
                                                         with_map)))
        rel = K.sse_map_search_ref(s, w, n, r)[2].reshape(b, -1)
        if not (bool((rel[0].min() < 0).item()) and int(got[0][1]) == -r
                and int(got[1][1]) == -r and int(rel[5, 0]) == n * n * 255 ** 2
                and int(rel[7, 0]) == -n * n * 255 ** 2):
            raise AssertionError("sse_map_search n=16 r=40: the planted "
                                 "match, the tie or the largest operands "
                                 "came out wrong")
        parts["sse_map_search"].append(_timed(
            "sse_map_search", f"strip {label} made-up B={b} n={n} r={r} map",
            lambda: K.sse_map_search(s, w, n, r),
            lambda: K.sse_map_search_ref(s, w, n, r), 3, sse_bound(b),
            "sse_search_kernel", 1))
    errs["sse_map_search"] = max(errs["sse_map_search"], _check(
        "sse_map_search", "the 720p P-frame's strip", K.sse_map_search(
            *sse_real), K.sse_map_search_ref(*sse_real)))
    parts["sse_map_search"].append(_timed(
        "sse_map_search", f"strip 720p real P-frame B={STRIP_B['720p']} map",
        lambda: K.sse_map_search(*sse_real),
        lambda: K.sse_map_search_ref(*sse_real), 3,
        sse_bound(STRIP_B["720p"]), "sse_search_kernel", 1))

    # subpel_search on the strip's +-40 windows
    _print_resources(f"subpel_search n={n}",
                     _ptxas_instances("subpel_search")[n],
                     *K.subpel_search_occupancy(n, dev), 128)
    rng = np.random.default_rng(37)
    errs["subpel_search"] = _check(
        "subpel_search", "the 720p P-frame's strip", K.subpel_search(*sp_real),
        P.subpel_search_ref(*sp_real))
    for b in STRIP_B.values():
        for label, wins, src, dyx, tie_sse in _sp_made_up(rng, dev, b, n, r):
            args = (torch.from_numpy(wins).to(dev),
                    torch.from_numpy(src).to(dev), dyx[0].contiguous(),
                    dyx[1].contiguous(), n, r)
            got = K.subpel_search(*args)
            errs["subpel_search"] = max(errs["subpel_search"], _check(
                "subpel_search", f"{label} B={b} n={n} r={r}", got,
                P.subpel_search_ref(*args)))
            if tie_sse is not None and not (
                    torch.equal(got[0], args[2] * 8 - 6)
                    and torch.equal(got[1], args[3] * 8 - 6)
                    and bool((got[2] == tie_sse).all())):
                raise AssertionError(f"subpel_search: ties ({label}) did "
                                     "not go to the first offset")
            if label == "random":
                made_up = args
        parts["subpel_search"].append(_timed(
            "subpel_search", f"strip made-up B={b} n={n} r={r}",
            lambda: K.subpel_search(*made_up),
            lambda: P.subpel_search_ref(*made_up), 3, _sp_bound(b, n),
            "subpel_search_kernel", 1))
    parts["subpel_search"].append(_timed(
        "subpel_search", f"strip 720p real P-frame B={STRIP_B['720p']}",
        lambda: K.subpel_search(*sp_real),
        lambda: P.subpel_search_ref(*sp_real), 3,
        _sp_bound(STRIP_B["720p"], n), "subpel_search_kernel", 1))

    # transform_recon's ADST_DCT instance
    adst = int(T.TxType.ADST_DCT)
    _print_resources("transform_recon n=16 ADST_DCT",
                     _ptxas_instances("transform_recon")[(n, adst)],
                     *K.transform_recon_occupancy(n, dev, adst), 128)
    tr_err = 0
    for (src, pred, dc_q, ac_q, nn, tt), mode in zip(tr_real, ("V", "D63")):
        tr_err = max(tr_err, _tr_case(f"720p keyframe strip's {mode}", src,
                                      pred, dc_q, ac_q, nn, tt)[0])
    w4, h4 = STRIP_GEOMS["4K"]
    g4 = P.make_geom(w4, h4)
    frame = next(panning_frames(w4, h4, 1, seed=1))
    y4 = torch.from_numpy(P.pad_plane(np.asarray(frame.y), g4.pad_h,
                                      g4.pad_w)).to(dev)
    src4 = P._extract_blocks(y4, g4.strip_y, 1, g4.cols16, n).contiguous()
    preds = P._strip_intra_preds(y4, g4.strip_y, g4.cols16, n,
                                 P.KF_STRIP_MODES)
    b4 = src4.shape[0]
    ext = torch.from_numpy(rng.choice([0, 255], (b4, n, n))
                           .astype(np.uint8)).to(dev)
    # (the 8191 level clip is out of reach at n=16: qindex 0's step is 4,
    # not halved as at 32, so +-255 residuals give levels near 2,250)
    for q in TR_QINDICES:
        dc_q, ac_q = T.dc_quant(q), T.ac_quant(q)
        for i, mode in ((0, "V"), (2, "D63")):
            pred = preds[:, i].to(torch.uint8).contiguous()
            tr_err = max(tr_err, _tr_case(
                f"4K strip against its {mode} prediction", src4, pred, dc_q,
                ac_q, n, adst)[0])
        tr_err = max(tr_err, _tr_case("+-255 residuals", ext, 255 - ext, dc_q,
                                      ac_q, n, adst)[0])
    dc_q, ac_q = T.dc_quant(TR_LONE_QINDEX), T.ac_quant(TR_LONE_QINDEX)
    err, got = _tr_case("zero residuals", src4, src4.clone(), dc_q, ac_q, n,
                        adst)
    tr_err = max(tr_err, err)
    if int(got[1].abs().max()) or int(got[0].abs().max()):
        raise AssertionError("transform_recon ADST_DCT: a zero residual has "
                             "levels")
    nn = n * n
    scan = torch.as_tensor(np.asarray(T.scan_order(
        P.txfm.TX_SIZE[n], T.TxType.ADST_DCT)[0]), device=dev)
    levels = torch.zeros((nn, nn), dtype=torch.int32, device=dev)
    levels[torch.arange(nn, device=dev), scan] = TR_LONE_LEVEL
    levels[0, scan[0]] = 4
    flat = torch.full((nn, n, n), 128, dtype=torch.uint8, device=dev)
    lone = P.recon_from_levels(levels.reshape(nn, n, n), flat, dc_q, ac_q, n,
                               adst)[1]
    err, got = _tr_case("one level at each ADST_DCT scan place", lone, flat,
                        dc_q, ac_q, n, adst)
    tr_err = max(tr_err, err)
    print(f"transform_recon ADST_DCT: the lone levels reach "
          f"{len(set(got[1].tolist()))} of {nn} eob values")
    errs["transform_recon"] = tr_err
    qidx = qp_to_qindex(QP)
    dc_q, ac_q = T.dc_quant(qidx), T.ac_quant(qidx)
    pred4 = preds[:, 0].to(torch.uint8).contiguous()
    for label, (src, pred, dq, aq) in (
            ("720p real keyframe strip, V", tr_real[0][:4]),
            ("4K strip against V", (src4, pred4, dc_q, ac_q))):
        b = src.shape[0]
        sc = _row(dev, dq, aq)
        parts["transform_recon"].append(_timed(
            "transform_recon", f"{label} B={b} n={n} ADST_DCT",
            lambda: K.transform_recon(src, pred, sc, n, adst),
            lambda: P.transform_recon_ref(src, pred, dq, aq, n, adst), 5,
            _tr_bound(b, n), "transform_recon_kernel", 2))

    # kframe_wave on the strip geometries' 32 zones
    _kernel_resources(dev, "kframe_wave", None,
                      lambda k, dv: K.kframe_wave_occupancy(dv), threads=256)
    kf_err = 0
    lam = max(1, (ac_q ** 2) >> 6)
    for label, (w, h) in STRIP_GEOMS.items():
        g = P.make_geom(w, h)
        frame = next(panning_frames(w, h, 1, seed=1))
        shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
                  (g.pad_h // 2, g.pad_w // 2))
        pan = [P.pad_plane(np.asarray(p), *shp)
               for p, shp in zip((frame.y, frame.u, frame.v), shapes)]
        # the plain version of 4K's 186 diagonals takes seconds: two qindex
        # values there, four at 720p
        for q in (qidx, *KF_QINDICES) if label == "720p" else (qidx, 10):
            kf_err = max(kf_err, _kf_case(dev, f"panning frame {label}", g,
                                          pan, q)[0])
        ts = [torch.from_numpy(p).to(dev) for p in pan]
        status = []
        sc = _row(dev, dc_q, ac_q, lam)

        def call():
            return K.kframe_wave(*ts, g, sc, status)

        ms = _cuda_time_ms(call, 10)
        plain_ms = _cuda_time_once(lambda: P.kframe_wave_ref(
            *ts, g, dc_q, ac_q, lam))
        device_ms = _device_ms(call, "kframe_wave_kernel", reps=10)
        host_ms = _host_ms(call, reps=10)
        torch.cuda.synchronize()
        for word in status:
            K.kf_check_status(word)
        nb = g.n_blocks32
        nbytes = sum(t.numel() for t in ts) + nb * 1536 * 3 + 16 * nb
        bound = _kf_bound(nbytes, nb, FP64_OPS_PER_S)
        shown = "not measured" if device_ms is None else f"{device_ms:.4f} ms"
        print(f"kernel kframe_wave {label} keyframe ({g.rows32} x {g.cols32} "
              f"blocks, one launch): call {ms:.4f} ms (CUDA events, "
              f"median); device {shown} (profiler); host {host_ms:.4f} ms "
              f"per call; plain {plain_ms:.4f} ms (one call); bound "
              f"{bound[0]:.5f} ms by {bound[1]}; {len(status)} launches, "
              "every error word 0")
        parts["kframe_wave"].append(
            (1, f"{label} keyframe, one launch", ms, plain_ms, bound,
             device_ms, host_ms))
    errs["kframe_wave"] = kf_err
    if any(errs.values()):
        raise AssertionError(f"a strip shape disagrees: {errs}")
    return {k: [_part(p) for p in v] for k, v in parts.items()}


def _psnr(a, b) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _dims(frames):
    """(width, height) of a clip."""
    h, w = frames[0].y.shape
    return w, h


def _make_encoder(device, enc_mode, dims=(WIDTH, HEIGHT), rc=None, **cfg):
    """The public encoder in low delay at the default intra period: CQP at
    QP, or ``rc`` = (RC_VBR or RC_CBR, target bits per second), with the
    default VBV (twice the target at CBR); ``cfg``: more EncoderConfig
    fields (tune, tpu_realtime, speed_control, intra_period)."""
    from tpu_vp9_torch.api import Vp9Encoder
    from tpu_vp9_torch.config import (
        EncoderConfig, PredStructure, RateControlMode,
    )

    mode, tbr = rc or (RateControlMode.CQP, None)
    enc = Vp9Encoder(device=device)
    # recon_file keeps get_recon on the realtime path; nothing is written
    enc.set_parameter(EncoderConfig(
        source_width=dims[0], source_height=dims[1], enc_mode=enc_mode,
        pred_structure=PredStructure.LOW_DELAY_P,
        rate_control_mode=RateControlMode(mode), qp=QP, frame_rate=RC_FPS,
        recon_file="unused.yuv",
        **({} if tbr is None else {"target_bit_rate": tbr}), **cfg))
    enc.init()
    return enc


def _capture(enc):
    """(packet, recon) pairs in emission order: the realtime session emits
    a packet one or two sends after its picture, sometimes two at once."""
    got = []
    emit = enc._emit

    def hook(pkt):
        emit(pkt)
        got.append((pkt, enc.get_recon()))

    enc._emit = hook
    return got


def _encode(device, frames, enc_mode, rc=None, on_send=None, **cfg):
    """Encode frames one by one (``cfg``: more EncoderConfig fields;
    ``on_send(enc)`` after each send). Returns (packets, recons, per-send
    rows (index, seconds, {stage: seconds} from the tracer's spans), the
    encoder, seconds from the first P-frame's send to the end of flush)."""
    from tpu_vp9_torch.utils import trace

    enc = _make_encoder(device, enc_mode, _dims(frames), rc, **cfg)
    got = _capture(enc)
    rows = []
    t_p = None
    for idx, frame in enumerate(frames):
        trace.reset()
        if idx == 1:
            t_p = time.perf_counter()
        tf = time.perf_counter()
        enc.send_picture(frame)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        stages = {k: v["total_s"] for k, v in trace.summary().items()
                  if k != "notices"}
        rows.append((idx, time.perf_counter() - tf, stages))
        if on_send is not None:
            on_send(enc)
    enc.flush()
    p_seconds = time.perf_counter() - t_p
    while enc.get_packet() is not None:
        pass
    if [p.pts for p, _ in got] != list(range(len(frames))):
        raise AssertionError(f"packets out of order: {[p.pts for p, _ in got]}")
    return ([p for p, _ in got], [r for _, r in got], rows, enc, p_seconds)


def _decode_check(pkts, recons, frames):
    """Decode the IVF with the port's decoder; bit-exact to the recon; Y
    PSNR per frame."""
    from tpu_vp9_torch.bitstream.ivf import write_ivf_frame, write_ivf_header
    from tpu_vp9_torch.decoder.decoder import decode_ivf

    buf = io.BytesIO()
    write_ivf_header(buf, *_dims(frames), 30, 1, len(pkts))
    for p in pkts:
        write_ivf_frame(buf, p.data, p.pts)
    buf.seek(0)
    decoded = list(decode_ivf(buf))
    if len(decoded) != len(pkts):
        raise AssertionError(f"decoded {len(decoded)} of {len(pkts)} frames")
    psnrs = []
    for idx, ((y, u, v, _), rec, src) in enumerate(zip(decoded, recons,
                                                        frames)):
        for plane, want in zip((y, u, v), rec):
            if not np.array_equal(plane, want):
                raise AssertionError(f"decoded frame {idx} differs from the "
                                     "encoder's recon")
        psnrs.append(_psnr(y, src.y))
    if not all(np.isfinite(p) and p > 20 for p in psnrs):
        raise AssertionError(f"implausible Y PSNR {psnrs}")
    return psnrs


def _kernel_fns():
    from tpu_vp9_torch.ops import cuda_kernels as K

    return {"sad_full_search": K.sad_full_search,
            "block_energy": K.block_energy,
            "block_energy_at": K.block_energy_at,
            "sse_map_search": K.sse_map_search,
            "hier_search_fused": K.hier_search_fused,
            "txq_cost": K.txq_cost,
            "loop_filter": K.loop_filter,
            "kframe_wave": K.kframe_wave,
            "transform_recon": K.transform_recon,
            "subpel_search": K.subpel_search,
            "openloop_modes": K.openloop_modes,
            "mc_predict": K.mc_predict,
            "aq_scale": K.aq_scale,
            **{w: getattr(K, w) for w in DESCENT_WRAPPERS},
            **{w: getattr(K, w) for w in MD_WINDOW_WRAPPERS}}


def _reset_counts():
    for fn in _kernel_fns().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _kernel_fns().items()}


def _stage_means(rows):
    stage_ms = {}
    for _, _, stages in rows:
        for name, s in stages.items():
            stage_ms[name] = stage_ms.get(name, 0.0) + 1000 * s / len(rows)
    return ", ".join(f"{k} {v:.1f} ms" for k, v in
                     sorted(stage_ms.items(), key=lambda kv: -kv[1]))


# the spans that divide a P-frame send on the calling thread (the native
# serializer runs on the session's worker, beside them)
SEND_SPANS = ("rt_device_step", "rt_stage", "rt_rate_args", "api_scene_cut",
              "api_frame_qindex", "rt_d2h_transfer")
# with a rate controller the previous frame's native serialization runs
# inline, inside the send
RC_SPANS = SEND_SPANS + ("rt_serialize_native",)


def _send_split(rows, spans=SEND_SPANS):
    """A P-frame send's mean host time split by ``spans``, and what none
    of them covers."""
    send = 1000 * statistics.mean(r[1] for r in rows)
    means = {k: 1000 * statistics.mean(r[2].get(k, 0.0) for r in rows)
             for k in spans}
    return (f"send {send:.1f} ms split (mean, host clock): "
            + ", ".join(f"{k} {v:.2f}" for k, v in means.items())
            + f"; outside them {send - sum(means.values()):.1f} ms")


def _stream_line(label, pkts, psnrs):
    """Bytes per frame and Y PSNR over a stream (or its first frames)."""
    total = sum(len(p.data) for p in pkts)
    p_bytes = statistics.mean(len(p.data) for p in pkts if not p.is_keyframe)
    return (f"{label}: Y PSNR mean {statistics.mean(psnrs):.3f} dB "
            f"(P-frames {statistics.mean(psnrs[1:]):.3f}); "
            f"{total / len(pkts):.1f} B/frame ({p_bytes:.1f} B per P-frame) "
            f"over {len(pkts)} frames")


def _path_launches(geom, enc_mode, aq=False):
    """Launches per P-frame and per keyframe by wrapper, at ``geom``; with
    ``aq`` (M8 at tune SQ) one more block_energy a zone (the exact sums of
    its lambda scale) and one aq_scale (the scale), and no txq_cost (the
    tune OQ phase's own calls)."""
    if geom.strip:
        per_p = M8_STRIP_LAUNCHES if enc_mode == 8 else M9_STRIP_LAUNCHES
        per_key = KEY_STRIP_LAUNCHES
    else:
        per_p = M8_LAUNCHES if enc_mode == 8 else M9_LAUNCHES
        per_key = KEY_LAUNCHES
    if aq:
        per_p = {**per_p, "txq_cost": 0,
                 "block_energy": per_p["block_energy"] + 1 + geom.strip,
                 "aq_scale": 1 + geom.strip}
    return per_p, per_key


def realtime_end_to_end_phase(dev, frames, enc_mode, tag=None, tune=None):
    """M8 or M9 end to end through the public Vp9Encoder at the clip's
    size, with the launch counts of the run. For M8 at 1080p (tune OQ),
    txq_cost also runs inside the counted window, at its own entry point,
    on every P-frame's residual. At a strip geometry no parent may split
    (the descent is off there). ``tune`` TUNE_SQ: M8 with the adaptive
    lambda."""
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.pipeline.presets import qp_to_qindex
    from tpu_vp9_torch.utils import trace

    tag = tag or f"m{enc_mode}"
    width, height = _dims(frames)
    geom = P.make_geom(width, height)
    aq = enc_mode == 8 and tune == TUNE_SQ
    trace.enable(True)
    _reset_counts()
    pkts, recons, rows, enc, p_seconds = _encode(
        dev, frames, enc_mode, **({} if tune is None else {"tune": tune}))
    if enc._rt.aq != aq:
        raise AssertionError(f"{tag}: the session's aq is {enc._rt.aq}")
    n_p = sum(not p.is_keyframe for p in pkts)
    if enc_mode == 8 and not geom.strip and not aq:
        qidx = qp_to_qindex(QP)
        dc_q, ac_q = float(T.dc_quant(qidx)), float(T.ac_quant(qidx))
        proxies = []
        for i in range(1, len(frames)):
            for n in (32, 16):
                dist, rate = K.txq_cost(
                    _residual_blocks(dev, frames[i], recons[i - 1], n),
                    dc_q, ac_q, n)
                proxies.append((i, n, float(dist.sum()), float(rate.sum())))
        torch.cuda.synchronize()
        i, n, dist, rate = proxies[-2]
        print(f"m8: txq_cost on frame {i}'s residual against frame "
              f"{i - 1}'s recon, n={n}: distortion {dist:.1f}, rate proxy "
              f"{rate:.1f}; n=16: distortion {proxies[-1][2]:.1f}, rate "
              f"proxy {proxies[-1][3]:.1f} (the coded frame took "
              f"{len(pkts[i].data)} bytes)")
        if not all(np.isfinite(v) for p in proxies for v in p[2:]):
            raise AssertionError("txq_cost: non-finite proxy")
    counts = _read_counts()
    n_k = len(pkts) - n_p
    print(f"{tag}: {len(pkts)} frames ({n_k} key, {n_p} P) at "
          f"{width}x{height} M{enc_mode} low-delay CQP qp {QP}: launches "
          f"{counts}")
    per_p, per_key = _path_launches(geom, enc_mode, aq)
    print(f"{tag}: launches per P-frame {per_p}, per keyframe {per_key}")
    want = {"sad_full_search": 0, "kframe_wave": 0, "openloop_modes": 0,
            **{k: v * n_p for k, v in per_p.items()}}
    for k, v in per_key.items():
        want[k] += v * n_k
    if n_p == 0 or n_k == 0 or counts != want:
        raise AssertionError(f"launches {counts} != {want} for {n_k} "
                             f"keyframes and {n_p} P-frames")
    tally = enc._rt.tally
    n_split, n_gold = tally["split32"], tally["golden32"]
    if tally["p_frames"] != n_p:
        raise AssertionError(f"the session tallied {tally['p_frames']} of "
                             f"{n_p} P-frames")
    print(f"{tag}: {n_split} parents split and {n_gold} blocks chose GOLDEN "
          f"over {n_p} P-frames of {geom.n_blocks32} 32x32 blocks")
    if geom.strip and n_split:
        raise AssertionError(f"{tag}: a parent split at a strip geometry")
    if enc_mode == 8 and not geom.strip:
        interval = enc._rt.golden_interval
        if n_split == 0 or n_p <= interval:
            raise AssertionError(f"{tag}: no parent split, or no GOLDEN "
                                 "refresh inside the clip")
        print(f"{tag}: GOLDEN refreshed {n_p // interval} times (every "
              f"{interval} P-frames)")
    psnrs = _decode_check(pkts, recons, frames)
    print(_stream_line(f"{tag}: decode bit-exact to recon", pkts, psnrs))
    if len(pkts) > M9_FRAMES:
        print(_stream_line(f"{tag}: its first {M9_FRAMES} frames",
                           pkts[:M9_FRAMES], psnrs[:M9_FRAMES]))
    print(f"{tag}: keyframe send {rows[0][1] * 1000:.1f} ms; "
          f"{n_p / p_seconds:.3f} fps over the P-frames (first P send to "
          f"end of flush, {p_seconds:.3f} s)")
    print(f"{tag}: per P-frame send (host clock, steady state): mean "
          f"{1000 * statistics.mean(r[1] for r in rows[2:]):.1f} ms; spans "
          + _stage_means(rows[2:]))
    print(f"{tag}: " + _send_split(rows[2:]))
    trace.enable(False)
    step_ms = _step_time(enc._rt, frames[-1])
    print(f"{tag}: device step alone {step_ms:.3f} ms per P-frame "
          f"({1000 / step_ms:.2f} steps/s; host clock over 10 steps, "
          "synchronized)")
    fps = enc._rt.measure_step_fps(frames[-1], iters=10,
                                   qindex=qp_to_qindex(QP))
    print(f"{tag}: RtSession.measure_step_fps: {fps:.2f} steps/s "
          f"({1000 / fps:.3f} ms a step; 10 steps on a copy of the "
          "references, zero previous MVs, synchronized)")
    enc.close()
    return pkts, recons, counts


def _step_time(sess, frame) -> float:
    """Mean host-clock time of the session's step over 10 steps that run
    on its own references, synchronized before and after."""
    from tpu_vp9_torch.pipeline.presets import qp_to_qindex

    src = sess.stage(frame)
    args = sess.step_args(qp_to_qindex(QP))
    outs, refs = sess._step(*src, *sess._refs, *args)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        outs, refs = sess._step(*src, *refs, *args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 100


def _short(key: str) -> str:
    """A device op's name without its template arguments' namespaces."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::",
                 "at::", "std::"):
        key = key.replace(junk, "")
    return key[:90]


@contextlib.contextmanager
def _count_stage_launches(acc):
    """While active, every stage of the P-frame step adds its wrappers'
    launches to ``acc[stage][wrapper]``."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    real = P._stage

    @contextlib.contextmanager
    def counting(name):
        before = _read_counts()
        with real(name):
            yield
        mine = acc.setdefault(name, {})
        for k, v in _read_counts().items():
            if v != before[k]:
                mine[k] = mine.get(k, 0) + v - before[k]

    P._stage = counting
    yield
    P._stage = real


def _profile(dev, run, label, need=()):
    """Device-side records (kernels, copies) of ``run`` under
    torch.profiler, against its host-clock time; and the device time of
    each ``step_*`` stage range of the P-frame step. A range's device time
    is that of its PyTorch ops: kernels launched through ctypes are not
    attributed to it, so each stage's hand kernels are added from the
    launches its wrappers counted and the kernels' own records. Returns
    whether the profile holds a record of every wrapper's kernel in
    ``need``. Inside the profile, before ``run``, the card runs
    WARM_SPINS short spin kernels and the host waits WARM_WAIT_S: a
    profile that starts with the work itself lost the work's first device
    records (a keyframe send's uploads and its kframe_wave launch, after
    the earlier phases of this script); the spins are left out of what is
    reported."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stage_launches = {}
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            _count_stage_launches(stage_launches):
        for _ in range(WARM_SPINS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize(dev)
        time.sleep(WARM_WAIT_S)
        tf = time.perf_counter()
        run()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - tf) * 1000
    averages = prof.key_averages()
    # a CPU op's device time repeats its children's; CUPTI's own buffer
    # requests are not the program's work; a stage range's device-side
    # record spans its first to its last kernel, idle gaps included
    events = [e for e in averages
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.key.startswith(("Activity Buffer", "step_"))
              and "spin_kernel" not in e.key]
    if not events:
        print(f"profile {label}: the profiler recorded no device time "
              "(device busy share not measured)")
        return False
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile {label}: device busy {busy_ms:.3f} ms of {wall_ms:.1f} "
          f"ms host clock ({100 * busy_ms / wall_ms:.3f}% busy); "
          f"{sum(e.count for e in events)} device ops; top:")
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x{e.count:<6} "
              f"{_short(e.key)}")
    per_launch = {}  # wrapper -> its kernel's mean device ms per launch
    for wrapper, key in WRAPPER_KERNELS.items():
        mine = [e for e in events if key in e.key]
        if mine:
            per_launch[wrapper] = (
                sum(e.self_device_time_total for e in mine) / 1e3
                / sum(e.count for e in mine))
            print(f"  kernel {key} ({wrapper}): {per_launch[wrapper]:.4f} "
                  f"ms per launch (device) over "
                  f"{sum(e.count for e in mine)} launches")
            if len(mine) > 1:  # instances of a template, by block size
                for e in mine:
                    print(f"    {e.self_device_time_total / 1e3 / e.count:.4f}"
                          f" ms per launch over {e.count}: {_short(e.key)}")
    missing = [w for w in need if w not in per_launch]
    if missing:
        print(f"profile {label}: no record of the kernels of {missing}; "
              "the profile is not used")
        return False
    # the host-side stage ranges: the device time of their PyTorch ops,
    # and of their hand kernels (launches counted by the wrappers, times
    # the kernel's mean device time in this profile)
    stages = sorted((e for e in averages if e.key.startswith("step_")
                     and e.device_type == DeviceType.CPU),
                    key=lambda e: -e.cpu_time_total)
    for e in stages:
        hand = stage_launches.get(e.key, {})
        if all(w in per_launch for w in hand):
            hand_ms = sum(n * per_launch[w] for w, n in hand.items())
            shown = (f"{hand_ms:.3f} ms in hand kernels {hand}, "
                     f"{(e.device_time_total / 1e3 + hand_ms):.3f} ms "
                     "together" if hand else "no hand kernel")
        else:
            shown = f"hand kernels {hand} not in the profile: not measured"
        print(f"  stage {e.key}: host {e.cpu_time_total / 1e3:.3f} ms, "
              f"device {e.device_time_total / 1e3:.3f} ms in PyTorch ops + "
              f"{shown}, over {e.count} calls (host clock under the "
              "profiler)")
    return True


def _profile_until_complete(dev, runs, label, need):
    """``_profile`` of each of ``runs`` in turn until one holds a record of
    every kernel of ``need``; raises if none does."""
    for k, run in enumerate(runs):
        if _profile(dev, run, f"{label} (try {k + 1})", need):
            return
    raise AssertionError(f"{label}: {len(runs)} profiles, none with a "
                         f"record of every kernel of {sorted(need)}")


def realtime_profile_phase(dev, frames, enc_mode, per=3, label="1080p",
                           rc=None):
    """Key and ``per`` - 1 P-frames to warm up, then ``per`` P-frame sends
    (each issues its step and fetches the previous frame, and serializes it
    or hands it on) under the profiler, and ``per`` more if that profile
    lacks a hand kernel's record."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    enc = _make_encoder(dev, enc_mode, _dims(frames), rc)
    for frame in frames[:per]:
        enc.send_picture(frame)
    torch.cuda.synchronize(dev)
    launches = _path_launches(P.make_geom(*_dims(frames)), enc_mode)[0]
    need = [w for w, n in launches.items() if n and w != "txq_cost"]

    def run(first):
        def sends():
            for frame in frames[first:first + per]:
                enc.send_picture(frame)
        return sends

    _profile_until_complete(dev, [run(per), run(2 * per)],
                            f"m{enc_mode} {per} {label} P-frames", need)
    enc.flush()
    enc.close()


def keyframe_phase(dev, frames):
    """Four device keyframes at 1080p through the port's RtSession (M8's
    flags, intra_period 0: every frame a keyframe), the first a warm-up:
    launches, decode bit-exact to the recon, the send time and its split by
    the spans kf_device_step (the step, synchronized), kf_d2h_transfer and
    kf_serialize; then one more keyframe send under the profiler."""
    from types import SimpleNamespace

    from tpu_vp9_torch.pipeline.presets import qp_to_qindex
    from tpu_vp9_torch.pipeline.realtime import RtSession
    from tpu_vp9_torch.utils import trace

    qidx = qp_to_qindex(QP)
    sess = RtSession(WIDTH, HEIGHT, device=dev, intra_period=0,
                     want_recon=True, split16=True, golden=True)
    trace.enable(True)
    _reset_counts()
    rows, efs = [], []
    for idx, frame in enumerate(frames[:4]):
        trace.reset()
        tf = time.perf_counter()
        efs += sess.send(frame, qindex=qidx)
        torch.cuda.synchronize()
        stages = {k: v["total_s"] for k, v in trace.summary().items()
                  if k != "notices"}
        rows.append((idx, time.perf_counter() - tf, stages))
    counts = _read_counts()
    trace.enable(False)
    want = {**dict.fromkeys(counts, 0),
            **{k: 4 * v for k, v in KEY_LAUNCHES.items()}}
    print(f"keyframes: 4 device keyframes at {WIDTH}x{HEIGHT} qp {QP}: "
          f"launches {counts}")
    if counts != want or [e.is_keyframe for e in efs] != [True] * 4:
        raise AssertionError(f"launches {counts} != {want}, or not four "
                             "keyframes")
    cw, ch = (WIDTH + 1) >> 1, (HEIGHT + 1) >> 1
    recons = [[e.state.planes[p].recon[:h, :w] for p, (h, w) in
               enumerate(((HEIGHT, WIDTH), (ch, cw), (ch, cw)))]
              for e in efs]
    psnrs = _decode_check([SimpleNamespace(data=e.payload, pts=e.pts)
                           for e in efs], recons, frames[:4])
    print(f"keyframes: decode bit-exact to recon; Y PSNR mean "
          f"{statistics.mean(psnrs):.3f} dB; "
          f"{statistics.mean(len(e.payload) for e in efs):.1f} B/keyframe")
    print(f"keyframes: send {rows[0][1] * 1000:.1f} ms the first (warm-up), "
          f"mean of the next three "
          f"{1000 * statistics.mean(r[1] for r in rows[1:]):.1f} ms; spans "
          + _stage_means(rows[1:]))
    _profile_until_complete(
        dev, [lambda f=f: sess.send(f, qindex=qidx) for f in frames[4:7]],
        "one 1080p keyframe send", list(KEY_LAUNCHES))
    sess.flush()
    sess.close()


def m7_profile_phase(dev, frames):
    enc = _make_encoder(dev, 7)
    enc.send_picture(frames[0])
    _profile(dev, lambda: enc.send_picture(frames[1]), "m7 one 1080p P-frame")


def m7_end_to_end_phase(dev, frames):
    from tpu_vp9_torch.utils import trace

    trace.enable(True)
    _reset_counts()
    pkts, recons, rows, _, p_seconds = _encode(dev, frames, 7)
    counts = _read_counts()
    n_p = sum(not p.is_keyframe for p in pkts)
    print(f"m7: {len(pkts)} frames ({n_p} P) at {WIDTH}x{HEIGHT} M7 "
          f"low-delay CQP qp {QP}: launches {counts}")
    if n_p == 0 or counts != {**dict.fromkeys(counts, 0),
                              "sad_full_search": n_p}:
        raise AssertionError(f"launches {counts} != one sad_full_search for "
                             f"each of {n_p} P-frames")
    psnrs = _decode_check(pkts, recons, frames)
    total = sum(len(p.data) for p in pkts)
    print(f"m7: decode bit-exact to recon; Y PSNR mean "
          f"{statistics.mean(psnrs):.3f} dB; {total / len(pkts):.1f} "
          f"B/frame; {n_p / p_seconds:.3f} fps over the P-frames; P-frame "
          f"mean {1000 * statistics.mean(r[1] for r in rows[1:]):.1f} ms; "
          "spans " + _stage_means(rows[1:]))
    trace.enable(False)
    return pkts, counts


def same_bytes_phase(label, frames, cuda_pkts, enc_mode):
    pkts = _encode("cpu", frames[:CPU_FRAMES], enc_mode)[0]
    for idx, (a, b) in enumerate(zip(pkts, cuda_pkts)):
        if a.data != b.data:
            raise AssertionError(f"{label} frame {idx}: CPU and CUDA packets "
                                 "differ")
    print(f"{label} same bytes: the first {CPU_FRAMES} packets are identical "
          "on cpu and cuda")


def _want_launches(geom, enc_mode, n_p, n_k, counts):
    """Launches by wrapper for ``n_p`` P-frames and ``n_k`` keyframes of
    the realtime session at ``geom`` (no txq_cost: no encode path calls
    it)."""
    per_p, per_key = _path_launches(geom, enc_mode)
    want = {**dict.fromkeys(counts, 0),
            **{k: v * n_p for k, v in per_p.items() if k != "txq_cost"}}
    for k, v in per_key.items():
        want[k] += v * n_k
    return want


def rc_phase(dev, frames, tag, enc_mode, rc_mode, tbr):
    """Low delay at VBR or CBR through the public encoder: the session
    holds the controller and serializes inline; launches per P-frame and
    keyframe as at CQP; decode bit-exact; the qindex of every frame, the
    achieved bitrate against the target, VBV violations, bytes, PSNR, fps
    over the P-frames and the send split by RC_SPANS."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.utils import trace

    geom = P.make_geom(*_dims(frames))
    trace.enable(True)
    _reset_counts()
    pkts, recons, rows, enc, p_seconds = _encode(dev, frames, enc_mode,
                                                 (rc_mode, tbr))
    counts = _read_counts()
    trace.enable(False)
    rc = enc._rc
    if enc._rt.rc is not rc or enc._rt._ser_async:
        raise AssertionError(f"{tag}: the session does not hold the "
                             "controller, or serializes on a worker")
    n_p = sum(not p.is_keyframe for p in pkts)
    n_k = len(pkts) - n_p
    want = _want_launches(geom, enc_mode, n_p, n_k, counts)
    print(f"{tag}: {len(pkts)} frames ({n_k} key, {n_p} P) at "
          f"{geom.width}x{geom.height} M{enc_mode} low-delay "
          f"{'CBR' if rc_mode == RC_CBR else 'VBR'} {tbr} b/s at {RC_FPS} "
          f"fps: launches {counts}")
    if n_p == 0 or n_k == 0 or counts != want:
        raise AssertionError(f"launches {counts} != {want} for {n_k} "
                             f"keyframes and {n_p} P-frames")
    if rc.frames_coded != len(pkts):
        raise AssertionError(f"{tag}: the controller was fed "
                             f"{rc.frames_coded} times for {len(pkts)} frames")
    qidx = [p.qindex for p in pkts]
    if len(set(qidx)) < 3:
        raise AssertionError(f"{tag}: the controller hardly moved the "
                             f"qindex: {qidx}")
    psnrs = _decode_check(pkts, recons, frames)
    rate = rc.total_bits * RC_FPS / len(pkts)
    print(f"{tag}: qindex per frame min {min(qidx)} max {max(qidx)}: {qidx}")
    print(f"{tag}: {rate:.1f} b/s achieved against a target of {tbr} "
          f"({100 * rate / tbr:.3f}%); VBV violations {rc.vbv_violations} "
          f"(buffer {rc.buffer_size:.0f} bits, its level at the end "
          f"{rc.buffer_level:.0f})")
    print(_stream_line(f"{tag}: decode bit-exact to recon", pkts, psnrs))
    print(f"{tag}: keyframe send {rows[0][1] * 1000:.1f} ms; "
          f"{n_p / p_seconds:.3f} fps over the P-frames (first P send to "
          f"end of flush, {p_seconds:.3f} s)")
    print(f"{tag}: " + _send_split(rows[2:], RC_SPANS))
    enc.close()
    return pkts, counts


def rc_same_bytes_phase(tag, frames, cuda_pkts, enc_mode, rc_mode, tbr):
    """The first RC_SAME_FRAMES frames again with device="cpu": the same
    packets and qindexes."""
    t0 = time.perf_counter()
    pkts = _encode("cpu", frames[:RC_SAME_FRAMES], enc_mode,
                   (rc_mode, tbr))[0]
    if len(pkts) != RC_SAME_FRAMES:
        raise AssertionError(f"{tag}: {len(pkts)} CPU packets")
    for idx, (a, b) in enumerate(zip(pkts, cuda_pkts)):
        if (a.data, a.qindex) != (b.data, b.qindex):
            raise AssertionError(f"{tag} frame {idx}: CPU and CUDA packets "
                                 "or qindexes differ")
    print(f"{tag} same bytes: the first {RC_SAME_FRAMES} packets and "
          f"qindexes are identical on cpu ({time.perf_counter() - t0:.1f} s) "
          "and cuda")


def staged_4k_phase(dev):
    """bench.py's 4K field: a session fed Frame420s, then the same session
    fed the P-frames staged on the card (counted: launches per P-frame and
    keyframe asserted; the same packets), single-stream fps over the last
    STAGED_FRAMES - 3 sends and the flush; then two sessions interleaved on
    the staged frames (the same packets each), their aggregate fps."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.pipeline.realtime import RtSession
    from tpu_vp9_torch.utils.yuv import synthetic_frames

    w, h = STAGED_DIMS
    q = STAGED_QINDEX
    frames = list(synthetic_frames(w, h, STAGED_FRAMES, seed=0, motion=True))

    def session():
        return RtSession(w, h, device=dev, intra_period=-1, want_recon=False,
                         golden=True)

    def payloads(efs):
        return [e.payload for e in efs]

    ref = session()
    want_out = []
    for frame in frames:
        want_out += ref.send(frame, qindex=q)
    want_out += ref.flush()
    ref.close()
    sess = session()
    _reset_counts()
    out = sess.send(frames[0], qindex=q)
    staged = [sess.stage(f) for f in frames[1:]]
    for src in staged[:2]:
        out += sess.send(src, qindex=q)
    t0 = time.perf_counter()
    for src in staged[2:]:
        out += sess.send(src, qindex=q)
    out += sess.flush()
    single = len(staged[2:]) / (time.perf_counter() - t0)
    counts = _read_counts()
    sess.close()
    want = _want_launches(P.make_geom(w, h), 8, STAGED_FRAMES - 1, 1, counts)
    print(f"4K staged: {STAGED_FRAMES} frames (1 key) at {w}x{h}, GOLDEN, "
          f"qindex {q}, staged P-frames: launches {counts}")
    if counts != want:
        raise AssertionError(f"launches {counts} != {want}")
    if payloads(out) != payloads(want_out):
        raise AssertionError("4K staged: the packets of staged input differ "
                             "from those of Frame420 input")
    pair = (session(), session())
    outs = ([], [])
    for s, o in zip(pair, outs):
        o += s.send(frames[0], qindex=q)
        for src in staged[:2]:
            o += s.send(src, qindex=q)
    t0 = time.perf_counter()
    for src in staged[2:]:
        for s, o in zip(pair, outs):
            o += s.send(src, qindex=q)
    for s, o in zip(pair, outs):
        o += s.flush()
    dual = 2 * len(staged[2:]) / (time.perf_counter() - t0)
    for s in pair:
        s.close()
    if any(payloads(o) != payloads(want_out) for o in outs):
        raise AssertionError("4K dual: a session's packets differ")
    total = sum(len(p) for p in payloads(out))
    print(f"4K staged: packets identical to Frame420 input and in both "
          f"interleaved sessions; {total / len(out):.1f} B/frame; "
          f"single stream {single:.3f} fps, dual (two sessions "
          f"interleaved) {dual:.3f} fps aggregate (host clock over "
          f"{len(staged[2:])} sends each and the flush)")
    return counts


def rc_phases(dev, paths):
    """Rate control in low delay (RC_CASES, the CBR one also profiled) and
    the 4K staged field; each path's counts set to 0 just before it and
    read just after, into ``paths``."""
    from tpu_vp9_torch.utils.yuv import panning_frames

    frames = list(panning_frames(WIDTH, HEIGHT, RC_FRAMES, seed=1))
    for tag, enc_mode, rc_mode, tbr in RC_CASES:
        pkts, paths[tag] = rc_phase(dev, frames, tag, enc_mode, rc_mode, tbr)
        rc_same_bytes_phase(tag, frames, pkts, enc_mode, rc_mode, tbr)
        if rc_mode == RC_CBR:
            realtime_profile_phase(dev, frames, enc_mode, 3, "1080p CBR",
                                   (rc_mode, tbr))
    del frames
    paths["4K staged"] = staged_4k_phase(dev)


# random access, the encoder's default configuration (4 hierarchical
# levels: mini-GOPs of 16), through the public encoder: a key and two
# mini-GOPs at 1080p, a key and one at 720p; the same-bytes run's frames
# and mini-GOP (the CPU's plain versions take seconds a 720p P-frame)
RA_FRAMES = {"1080p": 33, "720p": 17}
RA_SAME_FRAMES, RA_SAME_GOP = 5, 4
# the spans that divide an RA P-frame's encode (the send that completes a
# mini-GOP encodes all of it) and a keyframe's
RA_SPANS = ("rt_stage", "ra_rate_args", "ra_device_step", "ra_d2h_transfer",
            "ra_serialize")
# the wrappers recorded in one RA P-frame step with GOLDEN and ALTREF, for
# the kernel checks at its shapes
RA_RECORDED = ("hier_search", "subpel_search", "sse_map_search",
               "transform_recon", "block_energy_at", "block_energy",
               *MD_WINDOW_WRAPPERS, *DECIDED_MC)


def _ra_launches(geom, golden: bool, altref: bool):
    """Launches of one random-access P-frame step by wrapper: each zone
    (the 32 grid; at a strip geometry the strip too) searches LAST
    (hier_search_fused, the strip sse_map_search), quarter-pel searches
    it, decides its modes and compensates Y, U and V in one MC launch
    (every reference's planes read in place by ref_sel), transforms Y, U
    and V, takes its recon SSE and ZERO's SSE in place and cuts its search
    windows in one launch (LAST's); GOLDEN adds its two candidates' SSEs
    (one block_energy_at), ALTREF its own search windows, search,
    quarter-pel search and ZERO SSE; without a strip the descent adds the
    children's search, quarter-pel search, decision and MC (one launch)
    and three transforms, and its gathers (the children's ZERO SSE with
    them), pack (their recon SSE with it) and split merge (one launch
    each); the loop filter and the borders are one launch each."""
    c = dict.fromkeys(ENTRY_WRAPPERS["sse_map_search"]
                      + ENTRY_WRAPPERS["block_energy"], 0)
    c.update({"sad_full_search": 0, "txq_cost": 0, "kframe_wave": 0,
              "subpel_search": 0, "transform_recon": 0, "loop_filter": 1,
              "openloop_modes": 0, "mc_predict": 0, "aq_scale": 0,
              **NO_DESCENT, "mode_decide": 0, "extract_windows": 0,
              **BORDERS})
    for n in (32, 16) if geom.strip else (32,):
        c["hier_search_fused" if n == 32 else "sse_map_search"] += \
            1 + altref
        c["subpel_search"] += 1 + altref
        c["mc_predict"] += 1  # with the zone's decision at its head
        c["extract_windows"] += 1 + altref
        c["transform_recon"] += 3
        c["block_energy"] += 1
        c["block_energy_at"] += 1 + golden + altref
    if not geom.strip:
        for k, v in (("sse_map_search", 1), ("subpel_search", 1),
                     ("mc_predict", 1), ("transform_recon", 3),
                     *DESCENT_LAUNCHES.items()):
            c[k] += v
    return c


def _make_ra_encoder(device, dims, intra_period=-2):
    """The public encoder at the default configuration (random access,
    enc_mode 9, 4 levels, CQP) at qp QP; ``intra_period`` -2 is the
    default's own (about one second)."""
    from tpu_vp9_torch.api import Vp9Encoder
    from tpu_vp9_torch.config import EncoderConfig

    enc = Vp9Encoder(device=device)
    enc.set_parameter(EncoderConfig(source_width=dims[0],
                                    source_height=dims[1], qp=QP,
                                    intra_period=intra_period))
    enc.init()
    if enc._ra_dev is None or enc._ra_dev.gop_len != 16:
        raise AssertionError("the default configuration did not take the "
                             "random-access session with mini-GOPs of 16")
    return enc


@contextlib.contextmanager
def _recording(names, calls, active):
    """While ``active[0]``, the step's calls of the ``tpu_encdec`` functions
    ``names`` append (name, arguments) to ``calls``; the arguments a call
    writes in place (``IN_PLACE_ARGS``) are recorded as copies taken before
    it, and so are the row of scalars and the rate tables (``_held``). A
    decision folded into MC (``FOLDED``), which the step no longer calls,
    is recorded from its merged dispatch's call: its first arguments, the
    decision's own (``FOLDED_INTO``)."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    targets = {}
    for k in names:
        target, cut = FOLDED_INTO.get(k, (k, None))
        targets.setdefault(target, []).append((k, cut))
    real = {t: getattr(P, t) for t in targets}

    def recorded(target, fn):
        def call(*args):
            if active[0]:
                for name, cut in targets[target]:
                    at = IN_PLACE_ARGS.get(name, ())
                    calls.append((name, _held(name, tuple(
                        a.clone() if i in at else a
                        for i, a in enumerate(args[:cut])))))
            return fn(*args)
        return call

    for t in targets:
        setattr(P, t, recorded(t, real[t]))
    try:
        yield
    finally:
        for t in targets:
            setattr(P, t, real[t])


def ra_end_to_end_phase(dev, frames, tag, record=False):
    """Random access at the default configuration through the public
    encoder, at the clip's size (intra period -1: a key and whole
    mini-GOPs of 16): packets in display order with DTS = decode order -
    15; every frame decoded by the port's decoder, every reference the
    session keeps equal to the decoder's picture of that poc; launches
    asserted for each step against its (GOLDEN, ALTREF) variant; the
    overhang row's split32 0 in every frame; Y PSNR, bytes per frame, fps
    over the P-frames and their spans. With ``record`` the first step
    with GOLDEN and ALTREF records its kernel calls (``RA_RECORDED``).
    Returns (the run's launches, the recorded calls)."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.utils import trace

    width, height = _dims(frames)
    geom = P.make_geom(width, height)
    enc = _make_ra_encoder(dev, (width, height), intra_period=-1)
    sess = enc._ra_dev
    steps, kept, calls, active = [], {}, [], [False]
    real_step_for, real_frame = sess._step_for, sess._encode_frame

    def step_for(golden, altref):
        step = real_step_for(golden, altref)

        def call(*args):
            active[0] = record and golden and altref and not calls
            before = _read_counts()
            out = step(*args)
            active[0] = False
            steps.append(((golden, altref), {
                k: v - before[k] for k, v in _read_counts().items()}))
            return out
        return call

    def encode_frame(gf, n_layers):
        out = real_frame(gf, n_layers)
        if gf.is_ref:  # the device planes, copied out after the run
            kept[gf.poc] = sess.planes_of[gf.poc]
        return out

    sess._step_for, sess._encode_frame = step_for, encode_frame
    got = []
    emit = enc._emit
    enc._emit = lambda pkt: (emit(pkt), got.append(pkt))
    trace.enable(True)
    trace.reset()
    _reset_counts()
    t_p = None
    with _recording(RA_RECORDED if record else (), calls, active):
        for idx, frame in enumerate(frames):
            if idx == 2:  # the key is held one frame and coded at send 1
                torch.cuda.synchronize()
                t_p = time.perf_counter()
            enc.send_picture(frame)
            if idx == 1:  # the keyframe's planes, coded at this send
                kept[0] = sess.planes_of[0]
        enc.flush()
        torch.cuda.synchronize()
    p_seconds = time.perf_counter() - t_p
    spans = {k: v["total_s"] for k, v in trace.summary().items()
             if k != "notices"}
    trace.enable(False)
    counts = _read_counts()
    enc.close()
    n = len(frames)
    n_p = n - 1
    if [p.pts for p in got] != list(range(n)) or \
            [p.dts for p in got] != [i - 15 for i in range(n)]:
        raise AssertionError(f"{tag}: packets (pts, dts) "
                             f"{[(p.pts, p.dts) for p in got]}")
    if [p.is_keyframe for p in got] != [True] + [False] * n_p:
        raise AssertionError(f"{tag}: keyframes at the wrong places")
    # launches: each step against its variant, the keyframe, the total
    per_key = KEY_STRIP_LAUNCHES if geom.strip else KEY_LAUNCHES
    want = dict.fromkeys(counts, 0)
    variants = {}
    for variant, delta in steps:
        expect = _ra_launches(geom, *variant)
        if delta != expect:
            raise AssertionError(f"{tag}: a step {variant} launched {delta}, "
                                 f"not {expect}")
        variants[variant] = variants.get(variant, 0) + 1
        for k, v in expect.items():
            want[k] += v
    for k, v in per_key.items():
        want[k] += v
    if len(steps) != n_p or counts != want:
        raise AssertionError(f"{tag}: {len(steps)} steps, launches {counts} "
                             f"!= {want}")
    print(f"{tag}: {n} frames (1 key, {n_p} P) at {width}x{height}, the "
          f"default configuration (random access, 4 levels, enc_mode 9) "
          f"CQP qp {QP}, intra period -1: launches {counts}")
    for variant, k in sorted(variants.items()):
        print(f"{tag}: {k} steps with (GOLDEN, ALTREF) = {variant}: "
              f"launches each {_ra_launches(geom, *variant)}")
    print(f"{tag}: per keyframe {per_key}")
    tally = sess.tally
    if tally["p_frames"] != n_p or tally["split_overhang"]:
        raise AssertionError(f"{tag}: tally {tally}")
    if geom.strip and tally["split32"]:
        raise AssertionError(f"{tag}: a parent split at a strip geometry")
    print(f"{tag}: over {n_p} P-frames of {geom.n_blocks32} 32x32 blocks: "
          f"{tally['golden32']} chose GOLDEN, {tally['altref32']} ALTREF; "
          f"{tally['split32']} parents split, {tally['split_not_last']} of "
          f"them GOLDEN or ALTREF parents (their children LAST blocks, with "
          f"LAST's chroma); the overhang row split in no frame")
    # decode: every frame; every kept reference the decoder's picture
    from tpu_vp9_torch.bitstream.ivf import write_ivf_frame, write_ivf_header
    from tpu_vp9_torch.decoder.decoder import decode_ivf

    buf = io.BytesIO()
    write_ivf_header(buf, width, height, 30, 1, len(got))
    for p in got:
        write_ivf_frame(buf, p.data, p.pts)
    buf.seek(0)
    decoded = list(decode_ivf(buf))
    if len(decoded) != n:
        raise AssertionError(f"{tag}: decoded {len(decoded)} of {n} frames")
    b = P.BORDER
    for poc, planes in kept.items():
        for k, plane in enumerate(planes):
            hh, ww = (height, width) if k == 0 else ((height + 1) >> 1,
                                                     (width + 1) >> 1)
            want_p = plane[b:b + hh, b:b + ww].cpu().numpy()
            if not np.array_equal(decoded[poc][k], want_p):
                raise AssertionError(f"{tag}: the decoder's poc {poc} plane "
                                     f"{k} differs from the session's "
                                     "reference")
    psnrs = [_psnr(y, f.y) for (y, _, _, _), f in zip(decoded, frames)]
    if not all(np.isfinite(p) and p > 20 for p in psnrs):
        raise AssertionError(f"{tag}: implausible Y PSNR {psnrs}")
    total = sum(len(p.data) for p in got)
    print(f"{tag}: decoded all {n} frames, the {len(kept)} kept references "
          f"bit-exact; Y PSNR mean {statistics.mean(psnrs):.3f} dB "
          f"(P-frames {statistics.mean(psnrs[1:]):.3f}); "
          f"{total / n:.1f} B/frame ({(total - len(got[0].data)) / n_p:.1f} "
          f"per P-frame)")
    p_ms = 1000 * p_seconds / n_p
    split = ", ".join(f"{k} {1000 * spans.get(k, 0.0) / n_p:.2f}"
                      for k in RA_SPANS)
    covered = 1000 * sum(spans.get(k, 0.0) for k in RA_SPANS) / n_p
    print(f"{tag}: {n_p / p_seconds:.3f} fps over the {n_p} P-frames "
          f"({p_seconds:.3f} s from the send after the keyframe's to the "
          f"end of flush): {p_ms:.1f} ms a P-frame, split (host clock, "
          f"mean over the P-frames) {split}; outside them "
          f"{p_ms - covered:.1f} ms")
    print(f"{tag}: keyframe spans (ms): " + ", ".join(
        f"{k} {1000 * spans.get(k, 0.0):.1f}" for k in
        ("kf_device_step", "kf_d2h_transfer", "kf_serialize")))
    stages = sorted(((k, v) for k, v in spans.items()
                     if k.startswith("step_")), key=lambda kv: -kv[1])
    print(f"{tag}: step stages per P-frame (host clock): " + ", ".join(
        f"{k} {1000 * v / n_p:.1f} ms" for k, v in stages))
    return counts, calls


def _ra_calls(calls):
    """The recorded calls of a 1080p RA step with GOLDEN and ALTREF, by role:
    hier_search (LAST's, ALTREF's), subpel_search (the zone's LAST,
    ALTREF, the children's), sse_map_search (the children's),
    block_energy_at (LAST's ZERO, GOLDEN's two in one call, ALTREF's ZERO;
    the children's is descent_gather's), transform_recon (the zone's Y, U,
    V, the children's U, V, Y), block_energy (the zone's; the children's
    is descent_pack's),
    mode_decide (the zone's, from its decided MC call), extract_windows
    (LAST's search site, ALTREF's), extend_borders (the recon's), the
    decided MC calls mode_decide_mc (the zone's) and descent_decide_mc
    (the children's)."""
    by = {}
    for name, args in calls:
        by.setdefault(name, []).append(
            _tr_ints(args) if name == "transform_recon" else args)
    shape = {k: [tuple(v.shape if isinstance(v, torch.Tensor) else v
                       for v in a if isinstance(v, (torch.Tensor, int)))
                 for a in by.get(k, [])] for k in RA_RECORDED}
    want_counts = {"hier_search": 2, "subpel_search": 3,
                   "sse_map_search": 1, "transform_recon": 6,
                   "block_energy_at": 3, "block_energy": 1,
                   "mode_decide": 1, "extract_windows": 2,
                   "extend_borders": 1, "mode_decide_mc": 1,
                   "descent_decide_mc": 1}
    if {k: len(by.get(k, [])) for k in RA_RECORDED} != want_counts:
        raise AssertionError(f"the recorded RA step made these calls: "
                             f"{shape}")
    return by


def ra_kernel_phase(dev, calls, kernels):
    """The kernels at the random-access path's new shapes, on a real 1080p
    RA P-frame step with GOLDEN and ALTREF (recorded in the end-to-end
    phase), against their plain versions on the card, bit for bit
    (transform_recon's level flips bounded as in its own phase): the
    descent over every parent, 8,160 children (sse_map_search n=16 r=8
    with its map, subpel_search n=16 r=8, transform_recon at 16 and 8;
    their ZERO SSE is descent_gather's, their recon SSE descent_pack's),
    ALTREF's own search (hier_search_fused, its ZERO SSE and
    subpel_search at n=32 r=4), and the decided MC calls (the zone's with
    GOLDEN and ALTREF, the 8,160 children's) against their plain
    compositions and the two launches each replaces. Each timed; the parts
    go to the kernels' entries as "ra_parts"."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    by = _ra_calls(calls)
    parts = {k: [] for k in ("sse_map_search", "subpel_search",
                             "transform_recon", "block_energy")}
    errs = dict.fromkeys(parts, 0)

    def held(entry, name, label, kernel_fn, plain_fn, bound, key, reps=5):
        errs[entry] = max(errs[entry], _check(name, label, kernel_fn(),
                                              plain_fn()))
        parts[entry].append(_timed(name, label, kernel_fn, plain_fn, reps,
                                   bound, key, 1))

    # ALTREF's search of the 32 grid: both levels fused, then quarter-pel
    src, wins, n = by["hier_search"][1]
    b = src.shape[0]
    ops = 2 * b * (37 * 37 * 16 * 16
                   + 9 * 9 * 32 * 32 * ALU_OPS_PER_S / INT8_OPS_PER_S)
    held("sse_map_search", "hier_search_fused",
         f"1080p RA ALTREF fused B={b} n=32",
         lambda: K.hier_search_fused(src, wins, n),
         lambda: K.hier_search_ref(src, wins, n),
         _bound(b * (120 * 120 + 32 * 32 + 4 * 37 * 37 + 48 * 48 + 20), ops,
                ALU_OPS_PER_S), "hier_search_kernel", 3)
    for label, args in (("ALTREF zone", by["subpel_search"][1]),
                        ("children", by["subpel_search"][2])):
        b, n = args[1].shape[0], args[4]
        held("subpel_search", "subpel_search",
             f"1080p RA {label} B={b} n={n} r={args[5]}",
             lambda a=args: K.subpel_search(*a),
             lambda a=args: P.subpel_search_ref(*a), _sp_bound(b, n),
             "subpel_search_kernel")
    # the children's search, with its map
    s, w, n, r = by["sse_map_search"][0]
    b = s.shape[0]
    d, sw = 2 * r + 1, n + 2 * r + 8
    held("sse_map_search", "sse_map_search",
         f"1080p RA children B={b} n={n} r={r} map",
         lambda: K.sse_map_search(s, w, n, r),
         lambda: K.sse_map_search_ref(s, w, n, r),
         _bound(b * (n * n + sw * sw + 8 + 4 * d * d),
                2 * b * d * d * n * n, INT8_OPS_PER_S), "sse_search_kernel")
    # the children's transforms (U, V at 8, Y at 16), U standing for V
    tr_err = 0
    for i, (label, args) in enumerate(zip(("U", "V", "Y"),
                                          by["transform_recon"][3:])):
        src, pred, dq, aq, nn = args
        tr_err = max(tr_err, _tr_case(f"1080p RA children {label}", src,
                                      pred, dq, aq, nn)[0])
        if label != "V":
            b = src.shape[0]
            parts["transform_recon"].append(_timed(
                "transform_recon", f"1080p RA children {label} B={b} n={nn}",
                lambda a=_tr_row(args): K.transform_recon(*a),
                lambda a=args: P.transform_recon_ref(*a), 5,
                _tr_bound(b, nn), "transform_recon_kernel",
                2 if label == "U" else 1))
    errs["transform_recon"] = tr_err
    # ZERO's SSE read in place: ALTREF's at n=32 (the children's is
    # descent_gather's)
    for label, (src, plane, y0, x0, nn) in (
            ("ALTREF ZERO", by["block_energy_at"][2]),):
        c, b = y0.shape
        held("block_energy", "block_energy_at",
             f"1080p RA {label} B={b} n={nn} C={c}",
             lambda a=(src, plane, y0, x0, nn): K.block_energy_at(*a),
             lambda a=(src, plane, y0, x0, nn): K.block_energy_at_ref(*a),
             _bound(b * nn * nn * (1 + c) + 16 * c * b, 5 * c * b * nn * nn,
                    ALU_OPS_PER_S), "block_energy_at_kernel", 20)
    # the decision with GOLDEN and ALTREF, ALTREF's search windows and the
    # borders
    for name, label, args in (
            ("mode_decide", "1080p RA zone, LAST, GOLDEN and ALTREF",
             by["mode_decide"][0]),
            ("extract_windows", "1080p RA ALTREF search site (1 set)",
             by["extract_windows"][1]),
            ("extend_borders", "1080p RA recon", by["extend_borders"][0])):
        kernel, plain, _ = _md_window_fns(name, args)
        errs[name] = max(errs.get(name, 0),
                         _check(name, label, list(kernel()), list(plain())))
        parts.setdefault(name, []).append(_timed(
            name, label, kernel, plain, 5, _md_window_bound(name, args),
            WRAPPER_KERNELS[name], 1))
    # the decisions in their MC launches: the zone with all three
    # references, the children of every parent
    for name, label in (("mode_decide_mc", "1080p RA zone n=32, decided, "
                         "LAST, GOLDEN and ALTREF"),
                        ("descent_decide_mc", "1080p RA children n=16, "
                         "decided")):
        args = by[name][0]
        kernel, plain, two = _dmc_fns(name, args)
        got = kernel()
        errs["mc_predict"] = max(errs.get("mc_predict", 0),
                                 _check(name, label, got, plain()),
                                 _check(name, f"{label}, against the two "
                                        "launches", got, two()))
        parts.setdefault("mc_predict", []).append(_timed(
            "mc_predict", f"{label} B={args[1].shape[0]}", kernel, plain, 3,
            _dmc_bound(name, args, got), "mc_predict_kernel", 1))
    if any(errs.values()):
        raise AssertionError(f"an RA shape disagrees: {errs}")
    for name, v in parts.items():
        kernels[name]["ra_parts"] = [_part(p) for p in v]


def ra_profile_phase(dev, frames, label):
    """Random access at the default configuration: the key and the first
    mini-GOP to warm up, then the second mini-GOP's 16 sends (the last
    encodes all 16 P-frames) under the profiler; a second encoder does it
    again if that profile lacks a hand kernel's record."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    geom = P.make_geom(*_dims(frames))
    need = [w for w, n in _ra_launches(geom, True, True).items() if n]
    for k in range(2):
        enc = _make_ra_encoder(dev, _dims(frames), intra_period=-1)
        for frame in frames[:17]:
            enc.send_picture(frame)
        torch.cuda.synchronize(dev)

        def sends():
            for frame in frames[17:33]:
                enc.send_picture(frame)

        ok = _profile(dev, sends, f"{label} RA one mini-GOP, 16 P-frames "
                      f"(try {k + 1})", need)
        enc.flush()
        enc.close()
        if ok:
            return
    raise AssertionError(f"{label} RA: two profiles, neither with a record "
                         f"of every kernel of {need}")


def ra_same_bytes_phase(dev, frames):
    """The port's random-access session on the CPU (the plain versions)
    and on the card: identical packets, on the first RA_SAME_FRAMES
    frames with mini-GOPs of RA_SAME_GOP (a key and one mini-GOP with
    GOLDEN and ALTREF steps)."""
    from tpu_vp9_torch.pipeline.presets import qp_to_qindex
    from tpu_vp9_torch.pipeline.ra_device import DeviceRaSession

    width, height = _dims(frames)
    out = []
    for device in (dev, "cpu"):
        sess = DeviceRaSession(width, height, device=device,
                               gop_len=RA_SAME_GOP,
                               base_qindex=qp_to_qindex(QP))
        pkts = []
        t0 = time.perf_counter()
        for frame in frames[:RA_SAME_FRAMES]:
            pkts += sess.push(frame)
        pkts += sess.flush()
        sess.close()
        out.append((pkts, time.perf_counter() - t0))
    (a, ta), (b, tb) = out
    if [(p.pts, p.data) for p in a] != [(p.pts, p.data) for p in b]:
        raise AssertionError(f"{width}x{height} RA: CPU and CUDA packets "
                             "differ")
    print(f"{width}x{height} RA same bytes: the {len(a)} packets of the "
          f"first {RA_SAME_FRAMES} frames with mini-GOPs of {RA_SAME_GOP} "
          f"are identical on cpu ({tb:.1f} s) and cuda ({ta:.1f} s)")


def ra_phases(dev, kernels, paths):
    """Random access, the default configuration: 1080p (the overhang
    geometry, every parent descended) with the kernel checks at its new
    shapes and a profile, then 720p (a strip geometry, the descent off);
    the same bytes on the CPU at both. Each path's counts are set to 0
    just before it and read just after, into ``paths``."""
    from tpu_vp9_torch.utils.yuv import panning_frames

    frames = list(panning_frames(WIDTH, HEIGHT, RA_FRAMES["1080p"], seed=1))
    paths["1080p ra"], calls = ra_end_to_end_phase(dev, frames, "1080p ra",
                                                   record=True)
    ra_kernel_phase(dev, calls, kernels)
    del calls
    ra_profile_phase(dev, frames, "1080p")
    ra_same_bytes_phase(dev, frames)
    frames = list(panning_frames(*STRIP_GEOMS["720p"], RA_FRAMES["720p"],
                                 seed=1))
    paths["720p ra"] = ra_end_to_end_phase(dev, frames, "720p ra")[0]
    ra_same_bytes_phase(dev, frames)


# ---------------------------------------------------------------------------
# The low-delay host route: the open-loop keyframe hints, enc_mode 8 and 9
# at tpu_realtime 0, the fallback of a rejected geometry, speed control on
# the host route, and the adaptive lambda (tune SQ) of the M8 step
# ---------------------------------------------------------------------------


def _ol_tie_plane(h, w):
    """A plane of 100 where every block (r, c) with r and c odd has DC, V
    and TM tie at the least cost at OL_TIE_QINDEX (lam 32): the column
    c*32+31 is 101 from the row above the block to its last row, so the
    block repeats its above row (V and TM exact: cost 32) and DC, 100,
    misses 32 pixels by one (cost 32)."""
    p = np.full((h, w), 100, np.uint8)
    for r in range(1, h // 32, 2):
        for c in range(1, w // 32, 2):
            p[r * 32 - 1:r * 32 + 32, c * 32 + 31] = 101
    return p


def _ol_extreme_planes(h, w):
    """Made-up planes of the largest SSEs and of TM clamping: a 0/255
    checkerboard; and blocks of full-range noise (TM clamps there and in
    the next block column, which takes the noise as its left edge) in
    every fourth block column, a gentle gradient around 116 elsewhere (TM
    in closed form from the fourth column on)."""
    y, x = np.mgrid[0:h, 0:w]
    checker = (255 * ((x + y) & 1)).astype(np.uint8)
    rng = np.random.default_rng(23)
    mixed = (100 + (x % 64 + y % 64) // 4 + rng.integers(0, 3, (h, w))
             ).astype(np.uint8)
    noise = (x // 32) % 4 == 0
    mixed[noise] = rng.integers(0, 256, int(noise.sum()), dtype=np.uint8)
    return [("checkerboard", checker), ("TM both ways", mixed)]


def _ol_bound(h, w):
    """openloop_modes' bound on an (h, w) plane: reads the plane and the
    constant words (the 768 directional words, 8 index bytes a pixel),
    writes 12 int32 a block; OL_OPS_PER_BLOCK integer operations a block
    off the tensor cores."""
    b = (h // 32) * (w // 32)
    return _bound(h * w + 4 * 768 + 8 * 1024 + 48 * b, OL_OPS_PER_BLOCK * b,
                  ALU_OPS_PER_S)


def _ol_view_check(plane, dev):
    """openloop_modes on two views of ``plane``: a contiguous plane one
    byte into its storage (not 16-byte aligned), which the wrapper copies
    before the launch, bit for bit against the plain version at
    OL_QINDICES; and its columns sliced out of a plane 64 columns wider
    (not contiguous), which the wrapper refuses, as every wrapper does."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    h, w = plane.shape
    t = torch.from_numpy(np.ascontiguousarray(plane)).to(dev)
    flat = torch.zeros(h * w + 1, dtype=torch.uint8, device=dev)
    flat[1:] = t.reshape(-1)
    view = flat[1:].view(h, w)
    if not view.is_contiguous() or view.data_ptr() % 16 == 0:
        raise AssertionError("openloop_modes: the unaligned view is not "
                             "contiguous or is aligned")
    max_err = 0
    for q in OL_QINDICES:
        max_err = max(max_err, _check(
            "openloop_modes", f"{w}x{h} one byte into its storage qindex {q}",
            K.openloop_modes(view, q), K.openloop_modes_ref(t, q)))
    wide = torch.zeros((h, w + 64), dtype=torch.uint8, device=dev)
    wide[:, 32:32 + w] = t
    launches = K.openloop_modes.launches
    try:
        K.openloop_modes(wide[:, 32:32 + w], 120)
    except ValueError as err:
        print(f"openloop_modes [{w}x{h} column slice of a wider plane]: "
              f"refused ({err})")
    else:
        raise AssertionError("openloop_modes took a plane not contiguous")
    if K.openloop_modes.launches != launches:
        raise AssertionError("openloop_modes launched on a refused plane")
    return max_err


def openloop_kernel_phase(dev):
    """openloop_modes against its plain version on the card, modes, SSEs
    and least costs bit for bit: 2560x1440 (a panning frame, made-up
    content, a 0/255 checkerboard and a plane whose blocks take TM both
    ways), 1024x768 (a panning frame and the tie plane, whose tied blocks
    must take DC) at OL_QINDICES, the tie plane also at OL_TIE_QINDEX; an
    unaligned view it copies and a column slice it refuses
    (``_ol_view_check``); the blocks that take each TM branch; its ptxas
    report and resident CTAs per SM; timed at 2560x1440 and 1024x768, the
    design's own operation count printed beside the bound."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.utils.yuv import panning_frames

    rng = np.random.default_rng(17)
    planes = []
    for label, (w, h) in OL_DIMS.items():
        planes.append((f"{label} panning",
                       next(panning_frames(w, h, 1, seed=1)).y))
    w, h = OL_DIMS["1440p"]
    planes.append(("1440p made-up", rng.integers(0, 256, (h, w),
                                                 dtype=np.uint8)))
    planes += [(f"1440p {label}", p) for label, p in _ol_extreme_planes(h, w)]
    w, h = OL_DIMS["768p"]
    planes.append(("768p ties", _ol_tie_plane(h, w)))
    max_err = 0
    bias = torch.tensor(K.KF_MODE_BIAS, dtype=torch.int64, device=dev)
    for label, plane in planes:
        t = torch.from_numpy(np.ascontiguousarray(plane)).to(dev)
        ties = "ties" in label
        exact = K.openloop_tm_exact(t)
        print(f"openloop_modes [{label}]: TM in closed form in "
              f"{int(exact.sum())} blocks, pixel by pixel in "
              f"{int((~exact).sum())}")
        if label == "1440p TM both ways" and (exact.all() or not exact.any()):
            raise AssertionError("openloop_modes: the plane meant to take TM "
                                 "both ways takes one")
        for q in OL_QINDICES + ((OL_TIE_QINDEX,) if ties else ()):
            got = K.openloop_modes(t, q)
            want = K.openloop_modes_ref(t, q)
            max_err = max(max_err, _check(
                "openloop_modes", f"{label} {t.shape[1]}x{t.shape[0]} "
                f"qindex {q}", got, want))
            won = torch.bincount(got[0].reshape(-1).long(), minlength=10)
            print(f"openloop_modes [{label} qindex {q}]: blocks each mode "
                  f"won (DC, V, H, D45, D135, D117, D153, D207, D63, TM): "
                  f"{won.tolist()}")
            if ties and q == OL_TIE_QINDEX:
                cost = want[1][1::2, 1::2].long() + bias * K.openloop_lam(q)
                tied = ((cost[..., 0] == cost[..., 1])
                        & (cost[..., 0] == cost[..., 9])
                        & (cost[..., 0] == cost.min(dim=-1).values))
                if not bool(tied.all()) or bool((got[0][1::2, 1::2]).any()):
                    raise AssertionError("openloop_modes: a tied block did "
                                         "not go to DC")
                print(f"openloop_modes [{label}]: {int(tied.sum())} blocks "
                      "tie DC, V and TM at the least cost; every one took DC")
    max_err = max(max_err, _ol_view_check(planes[0][1], dev))
    _kernel_resources(dev, "openloop_modes", None,
                      lambda n, d: K.openloop_modes_occupancy(d),
                      threads=128)
    parts = []
    for k, (label, (w, h)) in enumerate(OL_DIMS.items()):
        t = torch.from_numpy(np.ascontiguousarray(planes[k][1])).to(dev)
        b = (h // 32) * (w // 32)
        # one launch a keyframe; the 1024x768 shape is printed, not summed
        parts.append(_timed(
            "openloop_modes", f"{w}x{h} B={b}",
            lambda t=t: K.openloop_modes(t, 120),
            lambda t=t: K.openloop_modes_ref(t, 120), 5, _ol_bound(h, w),
            "openloop_modes_kernel", count=int(label == "1440p")))
        ops = OL_DESIGN_OPS
        int_ms = 1e3 * (ops["integer"] + ops["dp4a"]) * b / INT32_OPS_PER_S
        shfl_ms = 1e3 * ops["shuffle and reduction"] * b / SHFL_OPS_PER_S
        print(f"openloop_modes {w}x{h}: the bound counts the function's work "
              f"as the first kernel did it, {OL_OPS_PER_BLOCK * b:.3g} "
              "integer operations; the present kernel's own count (not a "
              "bound): " + ", ".join(f"{n * b:.3g} {kind}" for kind, n in
                                     ops.items())
              + f"; at the SM's rates (not a bound): integer and dp4a "
              f"{int_ms:.5f} ms, shuffles and reductions {shfl_ms:.5f} ms")
    return _entry("openloop_modes", "tpu_vp9_torch/csrc/openloop_modes.cu",
                  "tpu_vp9/pipeline/tpu_intra.py:80", max_err, parts)


def _encoded_frames_check(efs, frames):
    """Decode ``pipeline/encoder``'s EncodedFrames; bit-exact to their
    recon; Y PSNR per frame."""
    from types import SimpleNamespace

    w, h = _dims(frames)
    cw, ch = (w + 1) >> 1, (h + 1) >> 1
    recons = [(e.state.planes[0].recon[:h, :w],
               e.state.planes[1].recon[:ch, :cw],
               e.state.planes[2].recon[:ch, :cw]) for e in efs]
    pkts = [SimpleNamespace(data=e.payload, pts=e.pts) for e in efs]
    return _decode_check(pkts, recons, frames)


def openloop_e2e_phase(dev, kernels, paths):
    """encode_video at 2560x1440, enc_mode 8, one frame: its keyframe's
    hints from openloop_modes (one launch), the stream decoded bit-exactly
    to its recon; the encode's time."""
    from tpu_vp9_torch.config import EncoderConfig
    from tpu_vp9_torch.pipeline.encoder import encode_video
    from tpu_vp9_torch.utils.yuv import panning_frames

    w, h = OL_DIMS["1440p"]
    frames = list(panning_frames(w, h, 1, seed=1))
    cfg = EncoderConfig(source_width=w, source_height=h, enc_mode=8, qp=QP)
    _reset_counts()
    t0 = time.perf_counter()
    efs = encode_video(frames, cfg, device=dev)
    seconds = time.perf_counter() - t0
    counts = _read_counts()
    if counts != {**dict.fromkeys(counts, 0), "openloop_modes": 1}:
        raise AssertionError(f"encode_video {w}x{h} M8: launches {counts}, "
                             "want one openloop_modes")
    psnrs = _encoded_frames_check(efs, frames)
    print(f"encode_video {w}x{h} M8, one keyframe with the kernel's hints: "
          f"{seconds:.3f} s; {len(efs[0].payload)} B; Y PSNR "
          f"{psnrs[0]:.3f} dB; decode bit-exact to recon; launches {counts}")
    kernels["openloop_modes"]["launches"] = counts["openloop_modes"]
    paths["1440p m8 encode_video"] = counts


def host_route_phase(dev, frames, enc_mode, paths):
    """Vp9Encoder(enc_mode, LOW_DELAY_P, tpu_realtime=0) on the first
    HOST_FRAMES of the 1080p clip: no realtime session, one
    sad_full_search a P-frame and no other launch, decode bit-exact; bytes,
    PSNR, fps, the P-frames' device_me span and the keyframe's hint time
    (``openloop_mode_hints_np``, wrapped here)."""
    from tpu_vp9_torch.codec import intra_frame
    from tpu_vp9_torch.utils import trace

    tag = f"1080p m{enc_mode} host"
    hint_s = []
    real = intra_frame.openloop_mode_hints_np

    def timed_hints(*args):
        t0 = time.perf_counter()
        out = real(*args)
        hint_s.append(time.perf_counter() - t0)
        return out

    intra_frame.openloop_mode_hints_np = timed_hints
    trace.enable(True)
    _reset_counts()
    try:
        pkts, recons, rows, enc, p_seconds = _encode(
            dev, frames[:HOST_FRAMES], enc_mode, tpu_realtime=0)
    finally:
        intra_frame.openloop_mode_hints_np = real
    counts = _read_counts()
    trace.enable(False)
    n_p = sum(not p.is_keyframe for p in pkts)
    if enc._rt is not None or enc._ra_dev is not None:
        raise AssertionError(f"{tag}: a device session was made")
    if n_p == 0 or counts != {**dict.fromkeys(counts, 0),
                              "sad_full_search": n_p}:
        raise AssertionError(f"{tag}: launches {counts} != one "
                             f"sad_full_search for each of {n_p} P-frames")
    if len(hint_s) != 1:
        raise AssertionError(f"{tag}: {len(hint_s)} hint computations for "
                             "one keyframe")
    psnrs = _decode_check(pkts, recons, frames[:HOST_FRAMES])
    me = statistics.mean(r[2].get("device_me", 0.0) for r in rows[1:])
    print(f"{tag}: launches {counts}")
    print(_stream_line(f"{tag}: decode bit-exact to recon", pkts, psnrs))
    print(f"{tag}: {n_p / p_seconds:.3f} fps over the P-frames; keyframe "
          f"send {1000 * rows[0][1]:.1f} ms, its hints "
          f"(openloop_mode_hints_np) {1000 * hint_s[0]:.1f} ms; P-frame "
          f"mean {1000 * statistics.mean(r[1] for r in rows[1:]):.1f} ms, "
          f"device_me {1000 * me:.2f} ms; spans " + _stage_means(rows[1:]))
    paths[tag] = counts
    enc.close()


def host_fallback_phase(dev, paths):
    """640x360 (mi_rows 45: the realtime step rejects it) at enc_mode 8
    and the default tpu_realtime: the JAX package's notice, the host
    route, decode bit-exact, fps; at tpu_realtime 1 a RuntimeError."""
    from tpu_vp9_torch import api
    from tpu_vp9_torch.utils.yuv import panning_frames

    w, h = FALLBACK_DIMS
    tag = f"{w}x{h} m8 fallback"
    frames = list(panning_frames(w, h, FALLBACK_FRAMES, seed=1))
    notices = []
    real = api.notice
    api.notice = notices.append
    _reset_counts()
    try:
        pkts, recons, rows, enc, p_seconds = _encode(dev, frames, 8)
    finally:
        api.notice = real
    counts = _read_counts()
    if (len(notices) != 1 or "falling back to host encode" not in notices[0]
            or enc._rt is not None):
        raise AssertionError(f"{tag}: notices {notices}, session {enc._rt}")
    psnrs = _decode_check(pkts, recons, frames)
    print(f"{tag}: notice '{notices[0]}'; launches {counts}")
    print(_stream_line(f"{tag}: decode bit-exact to recon", pkts, psnrs))
    print(f"{tag}: {sum(not p.is_keyframe for p in pkts) / p_seconds:.3f} "
          "fps over the P-frames")
    try:
        _make_encoder(dev, 8, FALLBACK_DIMS, tpu_realtime=1)
    except RuntimeError as exc:
        print(f"{tag}: tpu_realtime=1 raises RuntimeError: {exc}")
    else:
        raise AssertionError(f"{tag}: tpu_realtime=1 did not raise")
    paths[tag] = counts


def speed_control_phase(dev, paths):
    """720p M7 with speed control at 30 fps, intra period 9: the host
    route falls behind, so the controller steps above 7 at its first check
    (after frame SC_CHECK - 1); the keyframe at SC_INTRA_PERIOD + 1 is the
    first to take hints; one sad_full_search a P-frame; decode
    bit-exact; the mode after every send."""
    from tpu_vp9_torch.codec import intra_frame
    from tpu_vp9_torch.utils.yuv import panning_frames

    tag = f"{SC_DIMS[1]}p m7 speed control"
    frames = list(panning_frames(*SC_DIMS, SC_FRAMES, seed=1))
    modes, hinted = [], []
    real = intra_frame.openloop_mode_hints_np

    def spy(*args):
        hinted.append(len(modes))
        return real(*args)

    intra_frame.openloop_mode_hints_np = spy
    _reset_counts()
    try:
        pkts, recons, rows, enc, p_seconds = _encode(
            dev, frames, 7, on_send=lambda e: modes.append(e._sc.mode),
            speed_control=True, intra_period=SC_INTRA_PERIOD)
    finally:
        intra_frame.openloop_mode_hints_np = real
    counts = _read_counts()
    n_p = sum(not p.is_keyframe for p in pkts)
    print(f"{tag}: the mode after each send {modes}; keyframes at "
          f"{[i for i, p in enumerate(pkts) if p.is_keyframe]} with hints "
          f"at {hinted}; launches {counts}")
    if modes[SC_CHECK - 2] != 7 or modes[SC_CHECK - 1] <= 7:
        raise AssertionError(f"{tag}: the mode did not step at frame "
                             f"{SC_CHECK}")
    if hinted != [SC_INTRA_PERIOD + 1]:
        raise AssertionError(f"{tag}: hints at {hinted}")
    if counts != {**dict.fromkeys(counts, 0), "sad_full_search": n_p}:
        raise AssertionError(f"{tag}: launches {counts}")
    psnrs = _decode_check(pkts, recons, frames)
    print(_stream_line(f"{tag}: decode bit-exact to recon", pkts, psnrs))
    print(f"{tag}: {n_p / p_seconds:.3f} fps over the P-frames")
    paths[tag] = counts


def _recording_scales(calls):
    """Install a wrapper of the step's ``aq_scale`` dispatch that appends
    each call's inputs and per-block lambda vector, as copies (no wait),
    to ``calls``; returns the original."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    real = P.aq_scale

    def rec(src_sum, src2, n, scalars):
        out = real(src_sum, src2, n, scalars)
        calls.append((src_sum.clone(), src2.clone(), n, scalars.clone(),
                      out.clone()))
        return out

    P.aq_scale = rec
    return real


def _aq_vectors(calls, label):
    """The recorded aq_scale calls' lambda vectors (numpy) and their
    scales (each over its frame's lam_bits), every vector held against
    the plain version on its own inputs bit for bit (on the card: the
    kernel's float64 log and exp against the host's; a difference raises
    with its count)."""
    from tpu_vp9_torch.ops import cuda_kernels as K
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    k = K.RATE_SCALARS.index("lam_bits")
    vectors, scales, differ = [], [], 0
    for src_sum, src2, n, scalars, out in calls:
        want = P.aq_scale_ref(src_sum, src2, n, scalars)
        differ += int((out != want).sum())
        lam = float(scalars[k:k + 1].view(torch.float32).item())
        vectors.append(out.cpu().numpy())
        scales.append(vectors[-1] / lam)
    print(f"kernel aq_scale [{label}]: {len(calls)} zones' lambda vectors "
          f"against aq_scale_ref: {differ} values differ")
    if differ:
        raise AssertionError(f"aq_scale [{label}]: {differ} values differ "
                             "from the plain version's")
    return vectors, scales


def aq_phase(dev, frames, tag, paths, same=False):
    """M8 at tune SQ through the public encoder: launches per P-frame
    (``_path_launches`` with aq), decode bit-exact, fps and the send split
    (``realtime_end_to_end_phase``), B/frame and Y PSNR beside tune OQ's on
    the same frames, every zone's lambda vector against the plain version
    on its inputs (``_aq_vectors``); with ``same`` the first
    AQ_SAME_FRAMES again on the CPU: identical packets and identical
    lambda vectors."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    calls = []
    real = _recording_scales(calls)
    try:
        pkts, recons, paths[tag] = realtime_end_to_end_phase(
            dev, frames, 8, tag, tune=TUNE_SQ)
    finally:
        P.aq_scale = real
    vectors, scales = _aq_vectors(calls, f"{tag}, every zone of the run")
    oq, oq_recons = _encode(dev, frames, 8)[:2]
    psnr_sq = [_psnr(r[0], f.y) for r, f in zip(recons, frames)]
    psnr_oq = [_psnr(r[0], f.y) for r, f in zip(oq_recons, frames)]
    print(_stream_line(f"{tag}: tune SQ", pkts, psnr_sq))
    print(_stream_line(f"{tag}: tune OQ, the same frames", oq, psnr_oq))
    # the encode's vectors, one a zone of each P-frame (the step timings
    # after it recorded theirs too)
    zones = 1 + P.make_geom(*_dims(frames)).strip
    n_zones = zones * sum(not p.is_keyframe for p in pkts)
    vectors, scales = vectors[:n_zones], scales[:n_zones]
    spread = np.concatenate(scales)
    moved = sum(a.data != b.data for a, b in zip(pkts, oq))
    print(f"{tag}: {len(scales)} scale vectors, scale min {spread.min():.4f} "
          f"max {spread.max():.4f}; {moved} of {len(pkts)} packets differ "
          "from tune OQ's")
    if not same:
        return
    cpu_calls = []
    real = _recording_scales(cpu_calls)
    t0 = time.perf_counter()
    try:
        cpu = _encode("cpu", frames[:AQ_SAME_FRAMES], 8, tune=TUNE_SQ)[0]
    finally:
        P.aq_scale = real
    cpu_s = time.perf_counter() - t0
    cpu_scales = [c[4].numpy() for c in cpu_calls]
    for idx, (a, b) in enumerate(zip(cpu, pkts)):
        if a.data != b.data:
            raise AssertionError(f"{tag} frame {idx}: CPU and CUDA packets "
                                 "differ")
    want = vectors[:len(cpu_scales)]
    if len(cpu_scales) != AQ_SAME_FRAMES - 1 or any(
            a.tobytes() != b.tobytes() for a, b in zip(cpu_scales, want)):
        raise AssertionError(f"{tag}: CPU and CUDA lambda vectors differ")
    print(f"{tag} same bytes: the first {AQ_SAME_FRAMES} packets and the "
          f"{len(cpu_scales)} lambda vectors are identical on cpu "
          f"({cpu_s:.1f} s) and cuda")


def host_phases(dev, kernels, paths, frames):
    """The host route's phases on the 1080p clip ``frames``: the open-loop
    hints end to end, enc_mode 8 and 9 at tpu_realtime 0, the 640x360
    fallback, speed control at 720p M7, and tune SQ at 1080p (CPU and
    CUDA compared) and 720p; each path's counts set to 0 just before it
    and read just after, into ``paths``."""
    from tpu_vp9_torch.utils.yuv import panning_frames

    openloop_e2e_phase(dev, kernels, paths)
    for enc_mode in (8, 9):
        host_route_phase(dev, frames, enc_mode, paths)
    host_fallback_phase(dev, paths)
    speed_control_phase(dev, paths)
    aq_phase(dev, frames, "1080p m8 sq", paths, same=True)
    aq_phase(dev, list(panning_frames(*STRIP_GEOMS["720p"], AQ_720P_FRAMES,
                                      seed=1)), "720p m8 sq", paths)


# ---------------------------------------------------------------------------
# The host random-access engine (gop.RaEncoder through the public encoder)
# and the multi-process routes: GOP-parallel workers, -nch, -distributed
# ---------------------------------------------------------------------------

RA_HOST_FRAMES = 17  # a key and one 16-frame pyramid
RA_HOST_SAME_DIMS, RA_HOST_SAME_FRAMES, RA_HOST_SAME_LEVELS = (1280, 720), 5, 2
CIF_DIMS, CIF_FRAMES = (352, 288), 17  # bench.py's CIF fields
RA_FALLBACK_FRAMES = 17
# the host engine's spans of an inter frame (device_me: the full-pel
# search on the card, from 1280x720 up)
RA_HOST_SPANS = ("device_me", "mode_decision", "batch_txfm", "serialize")
# GOP-parallel: 1080p RA at M8, a key and one full pyramid a chunk
GOP_INTRA_PERIOD, GOP_CHUNKS, GOP_WORKERS = 16, 4, (1, 2, 4)
NCH_DIMS, NCH_FRAMES = (1280, 720), 9
DIST_DIMS, DIST_FRAMES, DIST_INTRA_PERIOD = (1280, 720), 18, 8
PROC_TIMEOUT = 300  # seconds for a CLI or rank process


def _launched(counts):
    """The wrappers of ``counts`` that launched, with their counts."""
    return {k: v for k, v in counts.items() if v} or "none"


def _ra_host_encode(device, frames, enc_mode, levels=4, **cfg):
    """The public encoder in random access on its host engine (``cfg``:
    more EncoderConfig fields, tpu_realtime 0 unless given), every frame
    sent, flushed and drained. Returns (packets, the engine's recon of
    each packet's poc, the encoder, seconds of the sends up to the key's
    packet, seconds of the rest and the flush)."""
    from tpu_vp9_torch.api import Vp9Encoder
    from tpu_vp9_torch.config import EncoderConfig

    enc = Vp9Encoder(device=device)
    enc.set_parameter(EncoderConfig(**{
        "source_width": _dims(frames)[0], "source_height": _dims(frames)[1],
        "enc_mode": enc_mode, "qp": QP, "frame_rate": 30,
        "intra_period": -1, "hierarchical_levels": levels,
        "tpu_realtime": 0, **cfg}))
    enc.init()
    if enc._ra is None or enc._ra_dev is not None or enc._rt is not None:
        raise AssertionError("the host random-access engine was not taken")
    enc._ra.keep_recon = True
    pkts = []
    t0 = time.perf_counter()
    key_s = None
    for fr in frames:
        enc.send_picture(fr)
        while (p := enc.get_packet()) is not None:
            pkts.append(p)
        if key_s is None and pkts:
            torch.cuda.synchronize()
            key_s = time.perf_counter() - t0
            t1 = time.perf_counter()
    enc.flush()
    while (p := enc.get_packet()) is not None:
        pkts.append(p)
    torch.cuda.synchronize()
    rest_s = time.perf_counter() - t1
    if [p.pts for p in pkts] != list(range(len(frames))):
        raise AssertionError(f"packets out of display order: "
                             f"{[p.pts for p in pkts]}")
    recons = [enc._ra.recon_log[p.pts] for p in pkts]
    return pkts, recons, enc, key_s, rest_s


def _ra_host_line(tag, pkts, psnrs, n_inter, rest_s):
    total = sum(len(p.data) for p in pkts)
    return (f"{tag}: {n_inter / rest_s:.3f} fps over the {n_inter} inter "
            f"frames ({rest_s:.2f} s); {total / len(pkts):.1f} B/frame; Y "
            f"PSNR mean {statistics.mean(psnrs):.3f} dB over "
            f"{len(pkts)} frames; decode bit-exact to recon")


def ra_host_m7_phase(dev, paths):
    """1080p random access at M7 on the host engine, a key and one
    16-frame pyramid: exactly one sad_full_search an inter frame (the
    hidden ALTREFs included) and no other launch; decode bit-exact; fps
    over the inter frames, B/frame, Y PSNR, the inter frames' span split.
    Then 1280x720 on RA_HOST_SAME_FRAMES with RA_HOST_SAME_LEVELS levels on
    the CPU and the card: identical packets."""
    from tpu_vp9_torch.utils import trace
    from tpu_vp9_torch.utils.yuv import panning_frames

    tag = "1080p m7 ra host"
    frames = list(panning_frames(WIDTH, HEIGHT, RA_HOST_FRAMES, seed=1))
    trace.enable(True)
    trace.reset()
    _reset_counts()
    pkts, recons, enc, key_s, rest_s = _ra_host_encode(dev, frames, 7)
    counts = _read_counts()
    spans = {k: v["total_s"] for k, v in trace.summary().items()
             if k != "notices"}
    trace.enable(False)
    n_inter = len(frames) - 1
    if counts != {**dict.fromkeys(counts, 0), "sad_full_search": n_inter}:
        raise AssertionError(f"{tag}: launches {counts}, want one "
                             f"sad_full_search for each of {n_inter} "
                             "inter frames")
    psnrs = _decode_check(pkts, recons, frames)
    print(f"{tag}: launches {counts}")
    print(_ra_host_line(tag, pkts, psnrs, n_inter, rest_s)
          + f"; key {1000 * key_s:.1f} ms (held one frame)")
    print(f"{tag}: inter-frame spans (mean of {n_inter}, host clock): "
          + ", ".join(f"{k} {1000 * spans.get(k, 0.0) / n_inter:.1f} ms"
                      for k in RA_HOST_SPANS)
          + f"; per inter frame {1000 * rest_s / n_inter:.1f} ms")
    paths[tag] = counts
    enc.close()
    same = list(panning_frames(*RA_HOST_SAME_DIMS, RA_HOST_SAME_FRAMES,
                               seed=1))
    cuda = _ra_host_encode(dev, same, 7, RA_HOST_SAME_LEVELS)[0]
    t0 = time.perf_counter()
    cpu = _ra_host_encode("cpu", same, 7, RA_HOST_SAME_LEVELS)[0]
    cpu_s = time.perf_counter() - t0
    if [p.data for p in cpu] != [p.data for p in cuda]:
        raise AssertionError(f"{RA_HOST_SAME_DIMS} m7 ra host: CPU and CUDA "
                             "packets differ")
    print(f"{RA_HOST_SAME_DIMS[1]}p m7 ra host same bytes: "
          f"{len(cuda)} packets ({RA_HOST_SAME_LEVELS} levels) identical on "
          f"cpu ({cpu_s:.1f} s) and cuda")


def ra_host_cif_phase(dev, paths):
    """bench.py's CIF fields through the port: random access at M8 with
    tpu_realtime 0 (its host engine) and at M0 (full RDO), each on the
    same 17 synthetic frames, a key and one pyramid: fps, B/frame, Y PSNR,
    decode bit-exact."""
    from tpu_vp9_torch.utils.yuv import synthetic_frames

    frames = list(synthetic_frames(*CIF_DIMS, CIF_FRAMES, seed=0,
                                   motion=True))
    for mode in (8, 0):
        tag = f"cif m{mode} ra host"
        _reset_counts()
        pkts, recons, enc, key_s, rest_s = _ra_host_encode(dev, frames, mode)
        paths[tag] = _read_counts()
        psnrs = _decode_check(pkts, recons, frames)
        print(_ra_host_line(tag, pkts, psnrs, len(frames) - 1, rest_s)
              + f"; key {1000 * key_s:.1f} ms; all {len(frames)} frames "
              f"{len(frames) / (key_s + rest_s):.3f} fps; launches "
              f"{paths[tag]}")
        enc.close()


def ra_host_fallback_phase(dev, paths):
    """640x360 at the default configuration (random access, enc_mode 9,
    4 levels, tpu_realtime auto): the device session rejects mi_rows 45,
    so the host engine takes it with the JAX package's notice; fps,
    B/frame, decode bit-exact."""
    from tpu_vp9_torch import api
    from tpu_vp9_torch.utils.yuv import panning_frames

    w, h = FALLBACK_DIMS
    tag = f"{w}x{h} ra fallback"
    frames = list(panning_frames(w, h, RA_FALLBACK_FRAMES, seed=1))
    notices = []
    real = api.notice
    api.notice = notices.append
    _reset_counts()
    try:
        pkts, recons, enc, key_s, rest_s = _ra_host_encode(
            dev, frames, 9, tpu_realtime=-1)
    finally:
        api.notice = real
    paths[tag] = _read_counts()
    if (len(notices) != 1
            or not notices[0].startswith("device RA session unavailable")
            or not notices[0].endswith("; host RA engine")):
        raise AssertionError(f"{tag}: notices {notices}")
    psnrs = _decode_check(pkts, recons, frames)
    print(f"{tag}: notice '{notices[0]}'; launches {paths[tag]}")
    print(_ra_host_line(tag, pkts, psnrs, len(frames) - 1, rest_s))
    enc.close()


def gop_parallel_phase(dev, paths):
    """1080p random access at M8 (the device session) with intra period
    GOP_INTRA_PERIOD, GOP_CHUNKS chunks of a key and one full pyramid:
    the sequential encode, then encode_gop_parallel with each of
    GOP_WORKERS (1 runs the chunks in this process; more spawn workers on
    the one card): identical packets; fps of each; each spawned worker's
    peak device memory and its own launch counts, from its reports."""
    from tpu_vp9_torch.api import Vp9Encoder
    from tpu_vp9_torch.config import EncoderConfig
    from tpu_vp9_torch.pipeline.gop_parallel import encode_gop_parallel
    from tpu_vp9_torch.utils.yuv import panning_frames

    n = GOP_CHUNKS * (GOP_INTRA_PERIOD + 1)
    frames = list(panning_frames(WIDTH, HEIGHT, n, seed=1))
    cfg = EncoderConfig(source_width=WIDTH, source_height=HEIGHT,
                        enc_mode=8, qp=QP,
                        intra_period=GOP_INTRA_PERIOD).derive()
    _reset_counts()
    t0 = time.perf_counter()
    enc = Vp9Encoder(device=dev)
    enc.set_parameter(cfg)
    enc.init()
    if enc._ra_dev is None:
        raise AssertionError("1080p m8 ra: the device session was not taken")
    seq = []
    for fr in frames:
        enc.send_picture(fr)
    enc.flush()
    while (p := enc.get_packet()) is not None:
        seq.append((p.data, p.pts, p.dts, p.is_keyframe, p.qindex))
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    enc.close()
    paths["1080p m8 ra sequential"] = _read_counts()
    print(f"1080p m8 ra gop-parallel: sequential {n} frames "
          f"{n / seq_s:.3f} fps ({seq_s:.2f} s, init included); "
          f"{sum(p[3] for p in seq)} keys; launches "
          f"{_launched(paths['1080p m8 ra sequential'])}")
    for workers in GOP_WORKERS:
        tag = f"1080p m8 ra gop-parallel x{workers}"
        reports = []
        _reset_counts()
        t0 = time.perf_counter()
        par = encode_gop_parallel(frames, cfg, workers=workers, device=dev,
                                  reports=reports)
        par_s = time.perf_counter() - t0
        paths[tag] = _read_counts()
        if par != seq:
            raise AssertionError(f"{tag}: packets differ from the "
                                 "sequential encode's")
        # the chunks' kernels ran where the chunks ran: in this process
        # for one worker, else in the spawned workers and never here
        mine = sum(paths[tag].values())
        if [r["start"] for r in reports] != list(range(0, n, n // GOP_CHUNKS)) \
                or not all(sum(r["launches"].values()) for r in reports) \
                or (mine == 0) != (workers > 1):
            raise AssertionError(f"{tag}: reports {reports}, this process's "
                                 f"launches {paths[tag]}")
        peak, busy = {}, {}
        for r in reports:
            peak[r["pid"]] = max(peak.get(r["pid"], 0), r["peak_bytes"] or 0)
            busy[r["pid"]] = busy.get(r["pid"], 0.0) + r["seconds"]
            print(f"{tag}: worker {r['pid']} chunk at frame {r['start']}: "
                  f"{r['seconds']:.2f} s, its launches "
                  f"{_launched(r['launches'])}")
        print(f"{tag}: {n / par_s:.3f} fps ({par_s:.2f} s, worker start "
              f"included); inside the workers {n / max(busy.values()):.3f} "
              f"fps (the busiest worker's chunks {max(busy.values()):.2f} s); "
              "packets identical to the sequential encode; peak device "
              "memory by worker (GiB): "
              + ", ".join(f"{pid} {b / 2 ** 30:.3f}"
                          for pid, b in peak.items())
              + f"; this process's launches {_launched(paths[tag])}")


def _clip(tmp, dims, n):
    from tpu_vp9_torch.utils.yuv import panning_frames, write_y4m

    frames = list(panning_frames(*dims, n, seed=1))
    path = f"{tmp}/clip_{dims[0]}x{dims[1]}.y4m"
    with open(path, "wb") as fh:
        write_y4m(fh, frames)
    return frames, path


def _run_procs(cmds):
    """Start every command at once; wait for each (PROC_TIMEOUT s at most,
    then kill them all and fail); return their stdout texts."""
    import subprocess

    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=PROC_TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for c, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"{' '.join(c)} exited {p.returncode}: "
                                 f"{err[-3000:]}")
    return [out for out, _ in outs]


def _ivf_payloads(path):
    from tpu_vp9_torch.bitstream.ivf import read_ivf

    with open(path, "rb") as fh:
        return [f.payload for f in read_ivf(fh)]


def nch_phase(tmp, device):
    """``-nch 2`` through the CLI at 720p, the default configuration: two
    channel processes, each on ``device``; both outputs decode, every
    frame."""
    from tpu_vp9_torch.decoder.decoder import decode_ivf

    _, clip = _clip(tmp, NCH_DIMS, NCH_FRAMES)
    t0 = time.perf_counter()
    out = _run_procs([[sys.executable, "-m", "tpu_vp9_torch.app", "-i", clip,
                       "-b", f"{tmp}/nch.ivf", "-q", str(QP), "-nch", "2",
                       "-device", str(device)]])[0]
    seconds = time.perf_counter() - t0
    for ch in (0, 1):
        with open(f"{tmp}/nch.ch{ch}.ivf", "rb") as fh:
            got = len(list(decode_ivf(fh)))
        if got != NCH_FRAMES:
            raise AssertionError(f"-nch 2: channel {ch} decoded {got} of "
                                 f"{NCH_FRAMES} frames")
    lines = [ln for ln in out.splitlines() if ln.startswith("SUMMARY")]
    print(f"720p -nch 2: both channels decode, {NCH_FRAMES} frames each, "
          f"{seconds:.1f} s with the processes' start; " + " | ".join(lines))


def distributed_phase(tmp, device):
    """``-distributed`` with 2 local processes through the CLI at 720p,
    intra period DIST_INTRA_PERIOD, DIST_FRAMES frames (a chunk each), on
    ``device``: each process writes the sequential encode's packets."""
    import socket

    from tpu_vp9_torch.api import Vp9Encoder
    from tpu_vp9_torch.config import EncoderConfig

    frames, clip = _clip(tmp, DIST_DIMS, DIST_FRAMES)
    enc = Vp9Encoder(device=device)
    enc.set_parameter(EncoderConfig(
        source_width=DIST_DIMS[0], source_height=DIST_DIMS[1], qp=QP,
        intra_period=DIST_INTRA_PERIOD))
    enc.init()
    for fr in frames:
        enc.send_picture(fr)
    enc.flush()
    seq = []
    while (p := enc.get_packet()) is not None:
        seq.append(p.data)
    enc.close()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    outs = _run_procs([
        [sys.executable, "-m", "tpu_vp9_torch.app", "-i", clip, "-b",
         f"{tmp}/dist{r}.ivf", "-q", str(QP), "-intra-period",
         str(DIST_INTRA_PERIOD), "-distributed", f"127.0.0.1:{port},2,{r}",
         "-device", str(device)]
        for r in (0, 1)])
    seconds = time.perf_counter() - t0
    for r in (0, 1):
        if _ivf_payloads(f"{tmp}/dist{r}.ivf") != seq:
            raise AssertionError(f"-distributed: rank {r}'s packets differ "
                                 "from the sequential encode's")
    lines = [ln for o in outs for ln in o.splitlines()
             if ln.startswith("SUMMARY")]
    print(f"720p -distributed 2 processes (gloo on 127.0.0.1): each wrote "
          f"the sequential encode's {len(seq)} packets, {seconds:.1f} s with "
          "the processes' start; " + " | ".join(lines))


def ra_host_phases(dev, paths):
    """The host random-access engine (1080p M7 with the CPU and CUDA
    comparison at 720p, bench.py's CIF M8 and M0 fields, the 640x360
    fallback), then GOP-parallel at 1080p with 1, 2 and 4 workers,
    ``-nch 2`` and ``-distributed`` with 2 processes at 720p. Each
    in-process path's counts are set to 0 just before it and read just
    after, into ``paths``."""
    import tempfile

    from tpu_vp9_torch.ops import _build

    ra_host_m7_phase(dev, paths)
    ra_host_cif_phase(dev, paths)
    ra_host_fallback_phase(dev, paths)
    gop_parallel_phase(dev, paths)
    # the clips and streams of the CLI runs, in the checkout's build dir
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        nch_phase(tmp, dev)
        distributed_phase(tmp, dev)


# the tile-column sharded step: the meshes its phase runs on one card
# (rows of devices; (2, 2) is two frames over two tiles each), the clip of
# the API phase, and the shard counts whose step time it prints
MESH_STEP_SHAPES = {"1080p": ((1, 2), (1, 4), (2, 2)), "720p": ((1, 2),
                                                                 (1, 4))}
MESH_FRAMES = 10
MESH_TIMED = (1, 2, 4)
# launches of one shard's zone with GOLDEN (the 32 grid: the fused search,
# the quarter-pel search, ZERO and GOLDEN's candidates, the window launch,
# the decision and MC in one launch, the recon distortion, three
# transforms); a strip
# geometry adds the strip zone's (its flat search in place of the fused
# one); one loop filter a frame (the sharded step's references come back
# without borders)
MESH_ZONE_LAUNCHES = {"hier_search_fused": 1, "subpel_search": 1,
                      "block_energy_at": 2, "block_energy": 1,
                      "transform_recon": 3, "mc_predict": 1,
                      **ZONE_MD_WINDOWS}
MESH_STRIP_LAUNCHES = {"sse_map_search": 1, "subpel_search": 1,
                       "block_energy_at": 2, "block_energy": 1,
                       "transform_recon": 3, "mc_predict": 1,
                       **ZONE_MD_WINDOWS}


def _mesh_cases(dev, dims):
    """Real inputs of the step at ``dims``: the first three frames of
    panning_frames(seed=1), the first a device keyframe, the second a
    P-frame of the single-device step with GOLDEN (LAST and GOLDEN the
    key), the third its P-frame with LAST the key and GOLDEN the second's
    recon (so that GOLDEN, the nearer picture, wins blocks) and the
    second's MVs as the previous MVs. Returns (geom, the scalars, the
    rate tables, [((src, last, gold, prev_mv32, prev_mv16), the
    single-device step's outputs, its references)] for the second and
    third frames)."""
    from tpu_vp9_torch.bitstream import tables as T
    from tpu_vp9_torch.ops.loopfilter import (
        pick_filter_level, sharpness_limits,
    )
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.pipeline.presets import qp_to_qindex
    from tpu_vp9_torch.utils.yuv import panning_frames

    g = P.make_geom(*dims)
    q = qp_to_qindex(QP)
    shapes = ((g.pad_h, g.pad_w), (g.pad_h // 2, g.pad_w // 2),
              (g.pad_h // 2, g.pad_w // 2))

    def stage(fr):
        return tuple(torch.from_numpy(P.pad_plane(np.asarray(p), *shp))
                     .to(dev) for p, shp in zip((fr.y, fr.u, fr.v), shapes))

    lim, mblim = sharpness_limits(0)
    lam = max(1, (T.ac_quant(q) ** 2) >> 6)
    kf = pick_filter_level(q, True)
    lf = pick_filter_level(q, False)
    frames = list(panning_frames(*dims, 3, seed=1))
    _, key = P.make_kframe_step(g, dev)(
        *stage(frames[0]), _row(dev, T.dc_quant(q), T.ac_quant(q), lam, kf,
                                int(lim[kf]), int(mblim[kf])))
    # the steps' argument: one row of scalars
    scal = (_row(dev, T.dc_quant(q), T.ac_quant(q), lam, lf, int(lim[lf]),
                 int(mblim[lf])),)
    rates = P.upload_rate_tabs(
        P.make_rate_tabs(T.default_frame_context(), q), dev)
    step = P.make_pframe_step(g, dev, golden=True)
    zero16 = torch.zeros((g.cols16 if g.strip else 1, 2), dtype=torch.int32,
                         device=dev)
    case1 = (stage(frames[1]), key, key,
             torch.zeros((g.n_blocks32, 2), dtype=torch.int32, device=dev),
             zero16)
    out1, refs1 = step(*case1[0], *case1[1], *case1[2], *case1[3:], *scal,
                       rates)
    case2 = (stage(frames[2]), key, refs1, out1["m32"]["mv"].to(torch.int32),
             out1["m16"]["mv"].to(torch.int32) if g.strip else zero16)
    out2, refs2 = step(*case2[0], *case2[1], *case2[2], *case2[3:], *scal,
                       rates)
    torch.cuda.synchronize()
    return g, scal, rates, [(case1, out1, refs1), (case2, out2, refs2)]


def _shard_major(arr, g, n_tiles):
    """Raster 32-grid order -> the shards' raster orders, left to right."""
    lead = tuple(arr.shape[1:])
    return arr.reshape(g.rows32, n_tiles, g.cols32 // n_tiles, *lead) \
        .transpose(0, 1).reshape(-1, *lead)


def _sharded_args(g, cases, scal, rates, n_tiles):
    """The sharded step's arguments for the frames of ``cases``."""
    from tpu_vp9_torch.pipeline.tpu_encdec import BORDER as B

    def planes(j, i, unbordered):
        return torch.stack([c[0][j][i][B:-B, B:-B] if unbordered
                            else c[0][j][i] for c in cases])

    return ([planes(0, i, False) for i in range(3)]
            + [planes(1, i, True) for i in range(3)]
            + [torch.stack([_shard_major(c[0][3], g, n_tiles)
                            for c in cases]),
               torch.stack([c[0][4] for c in cases]), *scal]
            + [planes(2, i, True) for i in range(3)] + [rates])


def mesh_step_phase(dev, dims, label, paths):
    """The sharded step (``make_pframe_step_sharded``) on meshes that
    repeat the one card, held bit for bit against the single-device step
    with GOLDEN and the rate tables on the same real inputs: every
    per-block array, the gathered recon, the filtered references,
    distortion and rate; the launches of each mesh asserted (each shard's
    zones at their shard-local batch, one loop filter a frame). Each
    mesh's counts go to ``paths``."""
    from tpu_vp9_torch.pipeline import tpu_shard as S
    from tpu_vp9_torch.pipeline.tpu_encdec import ZONE_KEYS

    g, scal, rates, cases = _mesh_cases(dev, dims)
    for shape in MESH_STEP_SHAPES[label]:
        n_frame, n_tiles = shape
        mesh = [[dev] * n_tiles for _ in range(n_frame)]
        use = cases[-n_frame:]
        step = S.make_pframe_step_sharded(g, mesh, n_tiles, golden=True)
        args = _sharded_args(g, use, scal, rates, n_tiles)
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        outs, refs = step(*args)
        torch.cuda.synchronize()
        ms = 1000 * (time.perf_counter() - t0)
        counts = _read_counts()
        for f, (_, want, want_refs) in enumerate(use):
            for k in ZONE_KEYS:
                if not torch.equal(outs[k][f], _shard_major(want["m32"][k],
                                                            g, n_tiles)):
                    raise AssertionError(f"{label} mesh {shape}: {k} differs "
                                         "from the single-device step's")
                if g.strip and not torch.equal(outs[f"m16_{k}"][f],
                                               want["m16"][k]):
                    raise AssertionError(f"{label} mesh {shape}: the strip's "
                                         f"{k} differs")
            zones = [want["m32"]] + ([want["m16"]] if g.strip else [])
            for k in ("rec_y", "rec_u", "rec_v"):
                if not torch.equal(outs[k][f],
                                   torch.cat([z[k] for z in zones])):
                    raise AssertionError(f"{label} mesh {shape}: the gathered "
                                         f"{k} differs")
            for i, k in enumerate(("rec_y", "rec_u", "rec_v")):
                if not torch.equal(refs[i][f], want[k]):
                    raise AssertionError(f"{label} mesh {shape}: the filtered "
                                         f"{k} differs")
            for k in ("dist", "rate"):
                if int(outs[k][f]) != sum(int(z[k]) for z in zones):
                    raise AssertionError(f"{label} mesh {shape}: {k} differs")
        want_counts = dict.fromkeys(counts, 0)
        for table in (MESH_ZONE_LAUNCHES,) + ((MESH_STRIP_LAUNCHES,)
                                              if g.strip else ()):
            for k, v in table.items():
                want_counts[k] += v * n_tiles * n_frame
        want_counts["loop_filter"] = n_frame
        if counts != want_counts:
            raise AssertionError(f"{label} mesh {shape}: launches {counts}, "
                                 f"want {want_counts}")
        paths[f"{label} mesh step {shape[0]}x{shape[1]}"] = counts
        golden = sum(int((want["m32"]["ref"] == 1).sum())
                     for _, want, _ in use)
        if golden == 0:
            raise AssertionError(f"{label} mesh {shape}: no block took "
                                 "GOLDEN; the check would not reach it")
        print(f"mesh step {label} {shape} on one card: bit-equal to the "
              f"single-device step in every output ({n_frame} frame(s), "
              f"GOLDEN in {golden} blocks); launches "
              f"{ {k: v for k, v in counts.items() if v} }; first call "
              f"{ms:.1f} ms (host clock, synchronized)")
    return g, scal, rates, cases


def mesh_step_times(dev, label, g, scal, rates, cases):
    """Host-clock time of one P-frame step (10 after a warm-up,
    synchronized) with 1, 2 and 4 shards on the one card, beside the
    single-device step's (GOLDEN and the rate tables, no descent); and
    one 2- and one 4-shard step under the profiler, for the kernels'
    device time at the shards' shapes."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.pipeline import tpu_shard as S

    case = cases[-1][0]
    single = P.make_pframe_step(g, dev, golden=True)

    def timed(run):
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            run()
        torch.cuda.synchronize()
        return 100 * (time.perf_counter() - t0)

    times = {"single": timed(lambda: single(*case[0], *case[1], *case[2],
                                            *case[3:], *scal, rates))}
    runs = {}
    for n in MESH_TIMED:
        step = S.make_pframe_step_sharded(g, [[dev] * n], n, golden=True)
        args = _sharded_args(g, cases[-1:], scal, rates, n)
        runs[n] = functools.partial(step, *args)
        times[f"{n} shard(s)"] = timed(runs[n])
    print(f"mesh step time {label}, one card (host clock, mean of 10, "
          "synchronized): " + ", ".join(f"{k} {v:.2f} ms"
                                       for k, v in times.items()))
    need = ("hier_search_fused", "subpel_search", "block_energy",
            "block_energy_at", "transform_recon", "mc_predict",
            "loop_filter") + \
        (("sse_map_search",) if g.strip else ())
    for n in MESH_TIMED[1:]:
        _profile_until_complete(dev, [runs[n]] * 3,
                                f"mesh step {label} {n} shards", need)
    return times


def mesh_api_phase(dev, paths):
    """The public encoder at 1080p M8 low delay with tpu_mesh_shape=(1, 1):
    the sharded session (no GOLDEN, no descent, as in the JAX package),
    its packets equal to RtSession(split16=False, golden=False)'s on the
    card, decoded bit-exact, its launches asserted (counts to ``paths``);
    fps over the P-frames. Then a mesh wider than the machine at
    tpu_realtime 1 must raise RuntimeError, and where the machine has two
    cards or more a (1, count) mesh across them must give the one card's
    packets."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.pipeline.realtime import RtSession
    from tpu_vp9_torch.utils import trace
    from tpu_vp9_torch.utils.yuv import panning_frames

    frames = list(panning_frames(WIDTH, HEIGHT, MESH_FRAMES, seed=1))
    # the qindex and key of every send, which the reference session replays
    sends = []
    real_send = RtSession.send

    def recording(sess, frame, qindex=100, force_keyframe=False):
        sends.append((qindex, force_keyframe))
        return real_send(sess, frame, qindex, force_keyframe)

    RtSession.send = recording
    trace.enable(True)
    _reset_counts()
    try:
        pkts, recons, rows, enc, p_s = _encode(dev, frames, 8,
                                               tpu_mesh_shape=(1, 1))
    finally:
        RtSession.send = real_send
        trace.enable(False)
    torch.cuda.synchronize()
    counts = _read_counts()
    rt = enc._rt
    if rt is None or rt.mesh_shape != (1, 1) or rt.golden or rt.split16:
        raise AssertionError("tpu_mesh_shape=(1, 1) did not take the sharded "
                             "session without GOLDEN and the descent")
    n_k = sum(p.is_keyframe for p in pkts)
    want = _want_launches(P.make_geom(WIDTH, HEIGHT), 9,
                          len(pkts) - n_k, n_k, counts)
    if counts != want:
        raise AssertionError(f"mesh (1, 1): launches {counts}, want {want}")
    paths["1080p m8 mesh 1x1"] = counts
    sess = RtSession(WIDTH, HEIGHT, device=dev,
                     intra_period=enc._cfg.intra_period, want_recon=False,
                     split16=False, golden=False)
    ref = []
    for fr, (qindex, key) in zip(frames, sends):
        ref.extend(sess.send(fr, qindex=qindex, force_keyframe=key))
    ref.extend(sess.flush())
    sess.close()
    if [p.data for p in pkts] != [ef.payload for ef in ref]:
        raise AssertionError("mesh (1, 1) packets differ from the "
                             "single-device session's")
    psnrs = _decode_check(pkts, recons, frames)
    print(_stream_line("1080p m8 mesh (1, 1)", pkts, psnrs))
    print(f"1080p m8 mesh (1, 1): {(len(frames) - 1) / p_s:.3f} fps over "
          f"the {len(frames) - 1} P-frames (host clock); the packets equal "
          "RtSession(split16=False, golden=False)'s; "
          + _send_split(rows[2:]))
    count = torch.cuda.device_count()
    try:
        _make_encoder(dev, 8, tpu_mesh_shape=(1, count + 1), tpu_realtime=1)
    except RuntimeError as exc:
        if "mesh requests" not in str(exc):
            raise
        print(f"mesh (1, {count + 1}) at tpu_realtime 1 raised: {exc}")
    else:
        raise AssertionError(f"a mesh of {count + 1} on {count} card(s) did "
                             "not raise at tpu_realtime 1")
    if count < 2:
        print(f"mesh across cards: not run ({count} card on this machine; "
              "a (1, count) mesh needs two or more)")
        return
    wide, _, _, _, _ = _encode(dev, frames, 8, tpu_mesh_shape=(1, count))
    if [p.data for p in wide] != [p.data for p in pkts]:
        raise AssertionError(f"mesh (1, {count}) across the cards differs "
                             "from the one card's packets")
    print(f"mesh (1, {count}) across {count} cards: packets equal the one "
          "card's")


def mesh_phases(dev, paths):
    """The tile-column sharding phases: the step at 1080p and at the 720p
    strip geometry, the step times, the public encoder's mesh routes."""
    for label, dims in (("1080p", (WIDTH, HEIGHT)),
                        ("720p", STRIP_GEOMS["720p"])):
        found = mesh_step_phase(dev, dims, label, paths)
        mesh_step_times(dev, label, *found)
        del found
    mesh_api_phase(dev, paths)


def _clock_phases():
    """Make every ``*_phase`` function of this script print its wall time
    when it returns (its callers find it by its global name), and return
    the {name: seconds} they add to."""
    spent = {}

    def clocked(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter() - t0
                spent[name] = spent.get(name, 0.0) + dt
                print(f"chip_smoke: {name} took {dt:.1f} s")
        return call

    g = globals()
    for name, fn in list(g.items()):
        if name.endswith("_phase") and callable(fn):
            g[name] = clocked(name, fn)
    return spent


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    spent = _clock_phases()
    from tpu_vp9_torch import native
    from tpu_vp9_torch.ops import _build
    from tpu_vp9_torch.utils.device import card_info
    from tpu_vp9_torch.utils.yuv import panning_frames

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_info()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _build.build_all(LIBS)
    print(f"nvcc builds, in parallel: {time.perf_counter() - t0:.2f} s ("
          + ", ".join(f"{n} {_build.build_seconds[n]:.2f} s" for n in LIBS)
          + ")")
    for name in LIBS:
        print(_build.build_log(name).strip())
    t0 = time.perf_counter()
    if native.get_lib() is None:
        raise RuntimeError("the native host library did not build: "
                           f"{native.build_error}")
    print(f"native host library built and loaded: "
          f"{time.perf_counter() - t0:.2f} s")

    if "--ra" in sys.argv[1:]:
        ra_phases(dev, {k: {} for k in ENTRY_WRAPPERS}, {})
        print(f"chip_smoke: the random-access phases passed in "
              f"{time.perf_counter() - t_start:.1f} s (--ra: stopping)")
        return 0
    if "--rc" in sys.argv[1:]:
        rc_phases(dev, {})
        print(f"chip_smoke: the rate-control and staged phases passed in "
              f"{time.perf_counter() - t_start:.1f} s (--rc: stopping)")
        return 0
    if "--ra-host" in sys.argv[1:]:
        ra_host_phases(dev, {})
        print(f"chip_smoke: the host random-access and multi-process phases "
              f"passed in {time.perf_counter() - t_start:.1f} s (--ra-host: "
              "stopping)")
        print(card)
        return 0
    if "--mesh" in sys.argv[1:]:
        mesh_phases(dev, {})
        print(f"chip_smoke: the mesh phases passed in "
              f"{time.perf_counter() - t_start:.1f} s (--mesh: stopping)")
        print(card)
        return 0
    if "--host" in sys.argv[1:]:
        host_phases(dev, {"openloop_modes": openloop_kernel_phase(dev)}, {},
                    list(panning_frames(WIDTH, HEIGHT, M8_FRAMES, seed=1)))
        print(f"chip_smoke: the host-route phases passed in "
              f"{time.perf_counter() - t_start:.1f} s (--host: stopping)")
        return 0

    real, real_frames, real_recons = _real_m8_inputs(dev)
    kernels = {k["name"]: k for k in (
        sad_kernel_phase(dev), energy_kernel_phase(dev), sse_kernel_phase(dev),
        subpel_kernel_phase(dev, real["sp"]),
        mc_kernel_phase(dev, real["mc"]),
        transform_kernel_phase(dev, real["tr"], real_frames, real_recons),
        *descent_kernel_phase(dev, real["desc"], real["ecm"]).values(),
        *md_window_kernel_phase(dev, real["md"]).values(),
        kframe_kernel_phase(dev), loop_filter_kernel_phase(dev, real["lf"]),
        openloop_kernel_phase(dev))}
    kernels["mc_predict"] = decided_kernel_phase(dev, real,
                                                 kernels["mc_predict"])
    for name in FOLDED:
        kernels[name]["folded_into"] = "mc_predict"
    kernels["aq_scale"] = step_scalars_phase(dev, real_frames, real_recons)
    del real, real_frames, real_recons
    for name, parts in strip_kernel_phase(dev).items():
        kernels[name]["strip_parts"] = parts
    txq_synthetic_phase(dev)
    if "--kernels" in sys.argv[1:]:
        print(f"chip_smoke: the kernel phases passed in "
              f"{time.perf_counter() - t_start:.1f} s (--kernels: stopping "
              "before the encodes)")
        return 0
    frames = list(panning_frames(WIDTH, HEIGHT, M8_FRAMES, seed=1))
    m8_pkts, m8_recons, m8_counts = realtime_end_to_end_phase(dev, frames, 8)
    kernels["txq_cost"] = txq_kernel_phase(dev, frames, m8_recons)
    # the counts of the M8 run. No encode path of either package calls
    # txq_cost: its count is this script's own calls, two for each P-frame,
    # made inside the counted window after the encode
    for name in ("block_energy", "sse_map_search", "txq_cost", "loop_filter",
                 "kframe_wave", "transform_recon", "subpel_search",
                 "mc_predict", *DESCENT_WRAPPERS, *MD_WINDOW_WRAPPERS):
        kernels[name]["launches"] = sum(m8_counts[w]
                                        for w in ENTRY_WRAPPERS[name])
    realtime_profile_phase(dev, frames, 8)
    keyframe_phase(dev, frames)
    same_bytes_phase("m8", frames, m8_pkts, 8)
    m9_list = frames[:M9_FRAMES]
    m9_pkts, _, m9_counts = realtime_end_to_end_phase(dev, m9_list, 9)
    realtime_profile_phase(dev, m9_list, 9)
    same_bytes_phase("m9", m9_list, m9_pkts, 9)
    del m9_list, m8_pkts, m8_recons, m9_pkts
    paths = {"1080p m8": m8_counts, "1080p m9": m9_counts}
    # the strip geometries: 720p at M8 and M9, 4K at M8, each path's counts
    # set to 0 just before it and read just after
    for label, dims in STRIP_GEOMS.items():
        sframes = list(panning_frames(*dims, STRIP_FRAMES[label], seed=1))
        for mode in (8, 9) if label == "720p" else (8,):
            tag = f"{label} m{mode}"
            pkts, _, paths[tag] = realtime_end_to_end_phase(dev, sframes,
                                                            mode, tag)
            realtime_profile_phase(dev, sframes, mode,
                                   3 if label == "720p" else 2, label)
            if label == "720p":
                same_bytes_phase(tag, sframes, pkts, mode)
        del sframes, pkts
    host_phases(dev, kernels, paths, frames)
    # aq_scale's main path: tune SQ (the M8 run above takes no scale)
    kernels["aq_scale"]["launches"] = paths["1080p m8 sq"]["aq_scale"]
    rc_phases(dev, paths)
    ra_phases(dev, kernels, paths)
    ra_host_phases(dev, paths)
    mesh_phases(dev, paths)
    for name, k in kernels.items():
        k["launches_by_path"] = {
            path: sum(c[w] for w in ENTRY_WRAPPERS[name])
            for path, c in paths.items()}
    m7_frames = frames[:M7_FRAMES]
    m7_pkts, m7_counts = m7_end_to_end_phase(dev, m7_frames)
    kernels["sad_full_search"]["launches"] = m7_counts["sad_full_search"]
    m7_profile_phase(dev, m7_frames)
    same_bytes_phase("m7", m7_frames, m7_pkts, 7)
    if any(k["launches"] <= 0 for name, k in kernels.items()
           if name not in FOLDED):
        raise AssertionError("a kernel was not launched on its main path")
    alone = {name: kernels[name]["launches_by_path"] for name in FOLDED}
    if any(kernels[name]["launches"] or any(alone[name].values())
           for name in FOLDED):
        raise AssertionError(f"a decision folded into MC was launched on "
                             f"its own: {alone}")

    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s; the slowest: " + ", ".join(
              f"{k} {v:.1f} s" for k, v in sorted(
                  spent.items(), key=lambda kv: -kv[1])[:12]))
    print(card)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
