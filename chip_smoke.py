"""Smoke run of the tpu_vp9_torch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. the card, the software, and the build of every kernel (one nvcc per
     source, all started together) and of the native host library;
  2. kernels: first a keyframe and an M8 P-frame of the clip through the
     public encoder, the real inputs of the step's loop filter, transform
     and quarter-pel calls recorded; then sad_full_search, block_energy
     (on blocks and positioned, block_energy_at), sse_map_search (one
     level, and both levels fused, hier_search_fused), subpel_search,
     transform_recon, kframe_wave and loop_filter against their plain
     PyTorch versions on the card, bit for bit, at the shapes the 1080p
     paths give them (the M8 children's included), ties, negative minima
     and the largest operands included; subpel_search on the zone's and
     the children's real windows, on windows where all 49 offsets tie, at
     the largest SSE, on 0/255 checkerboards and with winners at +-r;
     transform_recon at its four path shapes on the step's real blocks,
     on source against the previous recon, on +-255 and zero residuals
     and on one nonzero level at each scan place, at four qindex values
     (the 8191 level clip reached), its level flips counted, after the
     ptxas report of each of its template instances (registers, spills,
     which fail the run, static shared memory) and its resident CTAs per
     SM from the CUDA runtime's occupancy query; kframe_wave
     on the first
     panning frame at four qindex values, on patches that make every intra
     mode win (the blocks each mode won printed), on a constant frame whose
     tied modes must all go to the first, on 0/255 blocks at qindex 0 (the
     8191 level clip) and at small geometries (a 1x1, a 1-row and a
     1-column grid among them), after its ptxas report (registers, spills,
     which fail the run) and its resident CTAs per SM, with its one-block
     latency and the chain of 93 of them beside its device time per
     keyframe;
     loop_filter on made-up planes that reach every class of the edge
     filter (the lanes of each class counted by the plain version and
     printed), without a split mask, with a random one and with all ones,
     at three levels, at small geometries, at geometries with the bottom
     16-pixel strip (720p, 4K and three small ones, no mask; the lanes
     of each class of the strip's own edges printed), and on the
     unfiltered recon, mask and level of the real keyframe and M8
     P-frame, timed at 1080p, 720p and 4K and by kind of CTA, after its
     ptxas report and resident CTAs per SM; the strip geometries' shapes
     (a 720p keyframe and M8 P-frame through the public encoder first,
     their strip calls recorded): sse_map_search at n=16 r=40 with its map
     (its level opting in to more shared memory) for B=80 and B=240 and on
     the real 720p strip, subpel_search at n=16 r=40 likewise,
     transform_recon's ADST_DCT instance on the real keyframe strip's V and
     D63 candidates and on 4K strip blocks at four qindex values, the
     strip zone's transforms and SSEs on the real 720p P-frame, and
     kframe_wave on the 720p and 4K 32 zones (every error word 0);
     txq_cost on made-up residuals within its tolerance; each timed per
     call with CUDA events and on the host clock, and per launch with the
     profiler;
  3. M8 end to end: a 1920x1080 M8 low-delay CQP encode (the device
     keyframe, rate tables, the GOLDEN anchor, the 32-against-16 descent)
     through the public Vp9Encoder; the keyframe must launch kframe_wave
     once (a CTA per block row) and loop_filter once; per P-frame the
     search entry points must launch twice (hier_search_fused, then
     sse_map_search for the children), subpel_search twice,
     transform_recon 6 times, the block_energy ones 5 times and
     loop_filter once; some parents must split; the stream must decode with
     the port's decoder to the encoder's own recon across two GOLDEN
     refreshes; fps, step time, the host-clock stage split and the send
     split by the spans rt_device_step, rt_stage, rt_rate_args,
     api_scene_cut, api_frame_qindex and rt_d2h_transfer. Inside the
     same counted window txq_cost runs at its own entry point on every
     P-frame's residual (source minus the previous frame's recon), at
     n=32 and n=16;
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
     subpel_search, transform_recon, block_energy_at and block_energy;
     ALTREF's hier_search_fused, ZERO SSE and subpel_search) against
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
        "openloop_modes")
# main-path shapes at 1080p. M7 searches 32x32 blocks at range 16 over
# the 33 whole block rows; the realtime step's 32-grid has 34 rows (the
# last overhangs the picture by 8 pixels) of 60 blocks; M8 descends a
# quarter of them, so it has as many 16x16 children as 32x32 parents
SAD_B, SAD_N, SAD_R = 33 * 60, 32, 16
M9_B = 34 * 60
# launches per P-frame of the step, by wrapper. M8: the fused two-level
# search of the 32 zone and the children's search; the recon distortion of
# the 32 zone and of the children (block_energy); the 32 zone's ZERO SSE,
# GOLDEN's ZERO and previous-MV SSE in one launch, and the children's ZERO
# SSE (block_energy_at): 2 search and 5 energy launches; the quarter-pel
# search of the zone and of the children; the transform of the zone's Y32,
# U16 and V16 and of the children's Y16, U8 and V8; the loop filter of all
# three planes, split mask included, is one launch. M9: the fused search,
# ZERO SSE, quarter-pel, the zone's three transforms, recon distortion and
# the loop filter (no mask).
M8_LAUNCHES = {"hier_search_fused": 1, "sse_map_search": 1,
               "block_energy": 2, "block_energy_at": 3, "txq_cost": 2,
               "loop_filter": 1, "transform_recon": 6, "subpel_search": 2}
M9_LAUNCHES = {"hier_search_fused": 1, "sse_map_search": 0,
               "block_energy": 1, "block_energy_at": 1, "txq_cost": 0,
               "loop_filter": 1, "transform_recon": 3, "subpel_search": 1}
# launches per keyframe (M8 and M9 alike): one kframe_wave for the whole
# 34 x 60 grid (its 93 anti-diagonals are its chain), and the loop filter
# of the three planes
KF_DIAGONALS = 34 + 60 - 1
KEY_LAUNCHES = {"kframe_wave": 1, "loop_filter": 1}
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
                  "openloop_modes": ("openloop_modes",)}
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
                   "openloop_modes": "openloop_modes_kernel"}
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
# (and GOLDEN) SSE, three transforms and recon distortion
M8_STRIP_LAUNCHES = {"hier_search_fused": 1, "sse_map_search": 1,
                     "block_energy": 2, "block_energy_at": 4, "txq_cost": 0,
                     "loop_filter": 1, "transform_recon": 6,
                     "subpel_search": 2}
M9_STRIP_LAUNCHES = {"hier_search_fused": 1, "sse_map_search": 1,
                     "block_energy": 2, "block_energy_at": 2, "txq_cost": 0,
                     "loop_filter": 1, "transform_recon": 6,
                     "subpel_search": 2}
# per keyframe at a strip geometry: the wave of the 32 zone, the strip's
# three luma candidates (V and D63 ADST_DCT, D45 DCT_DCT) and two chroma
# transforms, the candidates' recon SSE in one block_energy launch, and
# the loop filter
KEY_STRIP_LAUNCHES = {"kframe_wave": 1, "transform_recon": 5,
                      "block_energy": 1, "loop_filter": 1}
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
# and TM tie; ``_ol_tie_plane``); integer operations a 32x32 block (an
# upper estimate: per pixel and mode a prediction, a difference, a square
# and a sum, 7, 10 modes; the 768 distinct directional words filtered, 8
# each)
OL_DIMS = {"1440p": (2560, 1440), "768p": (1024, 768)}
OL_QINDICES, OL_TIE_QINDEX = (0, 120, 255), 45
OL_OPS_PER_BLOCK = 7 * 10 * 1024 + 8 * 768
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


def _device_ms(fn, kernel_key: str, reps: int = 20):
    """Device time per launch of the kernels whose name contains
    ``kernel_key`` over ``reps`` calls of ``fn``, from torch.profiler; None
    if the profiler recorded none in three tries."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # a profile now and then records no device event
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and kernel_key in e.key
                  and e.self_device_time_total > 0]
        if events:
            return (sum(e.self_device_time_total for e in events) / 1e3
                    / sum(e.count for e in events))
    return None


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
    versions at B=2040, n=32 (the 32 zone) and n=16 (the M8 children)."""
    from tpu_vp9_torch.ops import cuda_kernels as K

    rng = np.random.default_rng(3)
    max_err = 0
    parts = []
    for n, per_frame in ((32, 1), (16, 1), (8, 0), (64, 0)):
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
    # (C=2), the children's ZERO (n=16, C=1); other sizes checked only
    K.CHECK_STARTS = True  # the checks below also run the starts' check
    for n, c, per_frame in ((32, 1, 1), (32, 2, 1), (16, 1, 1), (16, 3, 0),
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
    got = K.kframe_wave(*ts, geom, dc_q, ac_q, lam)
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

    def call():
        return K.kframe_wave(*ts, g, dc_q, ac_q, lam, status)

    ms = _cuda_time_ms(call, 20)
    plain_ms = _cuda_time_ms(lambda: P.kframe_wave_ref(*ts, g, dc_q, ac_q,
                                                       lam), 2)
    device_ms = _device_ms(call, "kframe_wave_kernel", reps=20)
    host_ms = _host_ms(call, reps=20)
    g1 = P.make_geom(32, 32)
    one = [torch.from_numpy(p).to(dev) for p in _kf_planes(
        rng.integers(0, 256, (g1.pad_h, g1.pad_w), dtype=np.uint8))]
    block_ms = _device_ms(
        lambda: K.kframe_wave(*one, g1, dc_q, ac_q, lam, status),
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
    got = K.loop_filter(*planes, geom, lvl, lim, mblim, split)
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
    for name, bits in (("all", K.LF_ALL_PARTS), *K.LF_PARTS.items()):
        ms = _device_ms(lambda: K.loop_filter(*planes, geom, lvl, lim, mblim,
                                              split, parts=bits),
                        "loop_filter_kernel")
        shown.append(f"{name} " + ("not measured" if ms is None
                                   else f"{ms:.4f} ms"))
    print(f"kernel loop_filter on {label}, device time per launch by kind "
          f"of CTA alone: {', '.join(shown)}")


def _real_m8_inputs(dev):
    """The real inputs of three stages of the steps: the first two frames
    of the clip (a keyframe and an M8 P-frame) through the public encoder,
    the steps' calls of ``loop_filter_device`` (keyframe and P-frame),
    ``transform_recon`` and ``subpel_search`` (P-frame) recorded. Returns
    ({"lf": [(y, u, v, geom, lvl, lim, mblim, split32)], "tr": [(src,
    pred, dc_q, ac_q, n)], "sp": [(wins, src, dy, dx, n, r)]}, the two
    frames, their recon)."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P
    from tpu_vp9_torch.utils.yuv import panning_frames

    calls = {"lf": [], "tr": [], "sp": []}
    real_lf, real_tr, real_sp = (P.loop_filter_device, P.transform_recon,
                                 P.subpel_search)

    def record_lf(y, u, v, geom, lvl, lim, mblim, split32=None):
        calls["lf"].append((y, u, v, geom, lvl, lim, mblim, split32))
        return real_lf(y, u, v, geom, lvl, lim, mblim, split32=split32)

    def record_tr(*args):
        calls["tr"].append(args)
        return real_tr(*args)

    def record_sp(*args):
        calls["sp"].append(args)
        return real_sp(*args)

    P.loop_filter_device = record_lf
    P.transform_recon, P.subpel_search = record_tr, record_sp
    enc = _make_encoder(dev, 8)
    got = _capture(enc)
    frames = list(panning_frames(WIDTH, HEIGHT, 2, seed=1))
    for frame in frames:
        enc.send_picture(frame)
    enc.flush()
    P.loop_filter_device = real_lf
    P.transform_recon, P.subpel_search = real_tr, real_sp
    torch.cuda.synchronize()
    lf = calls["lf"]
    if len(lf) != 2 or lf[0][7] is not None or lf[1][7] is None:
        raise AssertionError(f"the keyframe and the M8 P-frame called the "
                             f"loop filter {len(lf)} times, or the "
                             "keyframe with a mask or the P-frame without")
    if ([c[4] for c in calls["tr"]] != [32, 16, 16, 8, 8, 16]
            or [c[4:] for c in calls["sp"]] != [(32, 4), (16, 8)]):
        raise AssertionError(
            "the M8 P-frame's transform and quarter-pel calls were "
            f"{[c[4] for c in calls['tr']]} and "
            f"{[c[4:] for c in calls['sp']]}")
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
            lambda: K.loop_filter(y, u, v, g, lvl, lim, mblim, mask),
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
               lambda: K.loop_filter(*planes, gs, lvl, lim, mblim),
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


def _ptxas_instances(name):
    """The template instances of kernel ``name`` in the ptxas report of
    its build (``_build/lib<name>.log``): {key: (registers, spill stores,
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
            r".*?Used (\d+) registers([^\n]*)", _build.build_log(name),
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


def _kernel_resources(dev, name, sizes, occupancy, threads=128):
    """Each template instance of kernel ``name`` (keyed as
    ``_ptxas_instances`` keys them: block size n, or (n, transform type)),
    or with ``sizes`` None its one kernel (key 0): its registers, spill
    bytes and static shared memory from the ptxas report of its build, and
    its resident CTAs of ``threads`` threads per SM and dynamic shared
    memory from the CUDA runtime's occupancy query (``occupancy(key,
    dev)``); printed, and raised on if an instance spills."""
    found = _ptxas_instances(name)
    want = [0] if sizes is None else sorted(sizes)
    if sorted(found) != want:
        raise AssertionError(f"{name}: the ptxas report has the instances "
                             f"{sorted(found)}, want {want}")
    for key in sorted(want, reverse=True):
        ctas, dyn = occupancy(key, dev)
        label = (name if sizes is None else f"{name} n={key}"
                 if isinstance(key, int) else f"{name} (n, type) {key}")
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

    got = K.transform_recon(src, pred, dc_q, ac_q, n, tx_type)
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
        parts.append(_timed(
            "transform_recon", f"{label} B={b} n={n}",
            lambda: K.transform_recon(src, pred, dc_q, ac_q, n),
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
            calls[key].append(args)
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
            parts["transform_recon"].append(_timed(
                "transform_recon", f"720p strip {'YU'[i]} B={b} n={nn}",
                lambda: K.transform_recon(src, pred, dq, aq, nn),
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
        parts["transform_recon"].append(_timed(
            "transform_recon", f"{label} B={b} n={n} ADST_DCT",
            lambda: K.transform_recon(src, pred, dq, aq, n, adst),
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

        def call():
            return K.kframe_wave(*ts, g, dc_q, ac_q, lam, status)

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
            "openloop_modes": K.openloop_modes}


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
    its lambda scale), and no txq_cost (the tune OQ phase's own calls)."""
    if geom.strip:
        per_p = M8_STRIP_LAUNCHES if enc_mode == 8 else M9_STRIP_LAUNCHES
        per_key = KEY_STRIP_LAUNCHES
    else:
        per_p = M8_LAUNCHES if enc_mode == 8 else M9_LAUNCHES
        per_key = KEY_LAUNCHES
    if aq:
        per_p = {**per_p, "txq_cost": 0,
                 "block_energy": per_p["block_energy"] + 1 + geom.strip}
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
               "transform_recon", "block_energy_at", "block_energy")


def _ra_launches(geom, golden: bool, altref: bool):
    """Launches of one random-access P-frame step by wrapper: each zone
    (the 32 grid; at a strip geometry the strip too) searches LAST
    (hier_search_fused, the strip sse_map_search), quarter-pel searches
    it, transforms Y, U and V, takes its recon SSE and ZERO's SSE in place;
    GOLDEN adds its two candidates' SSEs (one block_energy_at), ALTREF its
    own search, quarter-pel search and ZERO SSE; without a strip the
    descent adds the children's search, quarter-pel search, ZERO SSE,
    three transforms and recon SSE; the loop filter is one launch."""
    c = dict.fromkeys(ENTRY_WRAPPERS["sse_map_search"]
                      + ENTRY_WRAPPERS["block_energy"], 0)
    c.update({"sad_full_search": 0, "txq_cost": 0, "kframe_wave": 0,
              "subpel_search": 0, "transform_recon": 0, "loop_filter": 1,
              "openloop_modes": 0})
    for n in (32, 16) if geom.strip else (32,):
        c["hier_search_fused" if n == 32 else "sse_map_search"] += \
            1 + altref
        c["subpel_search"] += 1 + altref
        c["transform_recon"] += 3
        c["block_energy"] += 1
        c["block_energy_at"] += 1 + golden + altref
    if not geom.strip:
        for k, v in (("sse_map_search", 1), ("subpel_search", 1),
                     ("block_energy_at", 1), ("transform_recon", 3),
                     ("block_energy", 1)):
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
    ``names`` append (name, arguments) to ``calls``."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    real = {k: getattr(P, k) for k in names}

    def recorded(name, fn):
        def call(*args):
            if active[0]:
                calls.append((name, args))
            return fn(*args)
        return call

    for k in names:
        setattr(P, k, recorded(k, real[k]))
    try:
        yield
    finally:
        for k in names:
            setattr(P, k, real[k])


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
    """The recorded calls of a 1080p RA step with GOLDEN and ALTREF, by
    role: hier_search (LAST's, ALTREF's), subpel_search (the zone's
    LAST, ALTREF, the children's), sse_map_search (the children's),
    block_energy_at (LAST's ZERO, GOLDEN's two in one call, ALTREF's
    ZERO, the children's ZERO), transform_recon (the zone's Y, U, V, the children's
    U, V, Y), block_energy (the zone's, the children's)."""
    by = {}
    for name, args in calls:
        by.setdefault(name, []).append(args)
    shape = {k: [(a[0].shape[0],) + tuple(
        v for v in a[2:] if isinstance(v, int))
        for a in by.get(k, [])] for k in RA_RECORDED}
    want_counts = {"hier_search": 2, "subpel_search": 3,
                   "sse_map_search": 1, "transform_recon": 6,
                   "block_energy_at": 4, "block_energy": 2}
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
    with its map, subpel_search n=16 r=8, transform_recon at 16 and 8,
    block_energy_at's ZERO and block_energy's recon SSE at n=16), and
    ALTREF's own search (hier_search_fused, its ZERO SSE and
    subpel_search at n=32 r=4). Each timed; the parts go to the kernels'
    entries as "ra_parts"."""
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
                lambda a=args: K.transform_recon(*a),
                lambda a=args: P.transform_recon_ref(*a), 5,
                _tr_bound(b, nn), "transform_recon_kernel",
                2 if label == "U" else 1))
    errs["transform_recon"] = tr_err
    # ZERO's SSE read in place: ALTREF's at n=32, the children's at 16;
    # the children's recon SSE
    for label, (src, plane, y0, x0, nn) in (
            ("ALTREF ZERO", by["block_energy_at"][2]),
            ("children ZERO", by["block_energy_at"][3])):
        c, b = y0.shape
        held("block_energy", "block_energy_at",
             f"1080p RA {label} B={b} n={nn} C={c}",
             lambda a=(src, plane, y0, x0, nn): K.block_energy_at(*a),
             lambda a=(src, plane, y0, x0, nn): K.block_energy_at_ref(*a),
             _bound(b * nn * nn * (1 + c) + 16 * c * b, 5 * c * b * nn * nn,
                    ALU_OPS_PER_S), "block_energy_at_kernel", 20)
    src, rec, nn = by["block_energy"][1]
    b = src.shape[0]
    held("block_energy", "block_energy", f"1080p RA children recon B={b} "
         f"n={nn}", lambda: K.block_energy(src, rec, nn),
         lambda: K.block_energy_ref(src, rec, nn),
         _bound(2 * b * nn * nn + 8 * b, 5 * b * nn * nn, ALU_OPS_PER_S),
         "block_energy_kernel", 20)
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


def _ol_bound(h, w):
    """openloop_modes' bound on an (h, w) plane: reads the plane and the
    constant words (the 768 directional words, 8 index bytes a pixel),
    writes 12 int32 a block; OL_OPS_PER_BLOCK integer operations a block
    off the tensor cores."""
    b = (h // 32) * (w // 32)
    return _bound(h * w + 4 * 768 + 8 * 1024 + 48 * b, OL_OPS_PER_BLOCK * b,
                  ALU_OPS_PER_S)


def openloop_kernel_phase(dev):
    """openloop_modes against its plain version on the card, modes, SSEs
    and least costs bit for bit: 2560x1440 (a panning frame and made-up
    content), 1024x768 (a panning frame and the tie plane, whose tied
    blocks must take DC) at OL_QINDICES, the tie plane also at
    OL_TIE_QINDEX; its ptxas report and resident CTAs per SM; timed at
    2560x1440."""
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
    w, h = OL_DIMS["768p"]
    planes.append(("768p ties", _ol_tie_plane(h, w)))
    max_err = 0
    bias = torch.tensor(K.KF_MODE_BIAS, dtype=torch.int64, device=dev)
    for label, plane in planes:
        t = torch.from_numpy(np.ascontiguousarray(plane)).to(dev)
        ties = "ties" in label
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
    _kernel_resources(dev, "openloop_modes", None,
                      lambda n, d: K.openloop_modes_occupancy(d),
                      threads=256)
    parts = []
    for k, (label, (w, h)) in enumerate(OL_DIMS.items()):
        t = torch.from_numpy(np.ascontiguousarray(planes[k][1])).to(dev)
        # one launch a keyframe; the 1024x768 shape is printed, not summed
        parts.append(_timed(
            "openloop_modes", f"{w}x{h} B={(h // 32) * (w // 32)}",
            lambda t=t: K.openloop_modes(t, 120),
            lambda t=t: K.openloop_modes_ref(t, 120), 5, _ol_bound(h, w),
            "openloop_modes_kernel", count=int(label == "1440p")))
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


def _recording_scales(scales):
    """Install a wrapper of the step's ``_sb_lambda_scale`` that appends
    each scale vector (numpy) to ``scales``; returns the original."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    real = P._sb_lambda_scale

    def rec(src_sum, src2, n):
        out = real(src_sum, src2, n)
        scales.append(out.cpu().numpy())
        return out

    P._sb_lambda_scale = rec
    return real


def aq_phase(dev, frames, tag, paths, same=False):
    """M8 at tune SQ through the public encoder: launches per P-frame
    (``_path_launches`` with aq), decode bit-exact, fps and the send split
    (``realtime_end_to_end_phase``), B/frame and Y PSNR beside tune OQ's on
    the same frames; with ``same`` the first AQ_SAME_FRAMES again on the
    CPU: identical packets and identical scale vectors."""
    from tpu_vp9_torch.pipeline import tpu_encdec as P

    scales = []
    real = _recording_scales(scales)
    try:
        pkts, recons, paths[tag] = realtime_end_to_end_phase(
            dev, frames, 8, tag, tune=TUNE_SQ)
    finally:
        P._sb_lambda_scale = real
    oq, oq_recons = _encode(dev, frames, 8)[:2]
    psnr_sq = [_psnr(r[0], f.y) for r, f in zip(recons, frames)]
    psnr_oq = [_psnr(r[0], f.y) for r, f in zip(oq_recons, frames)]
    print(_stream_line(f"{tag}: tune SQ", pkts, psnr_sq))
    print(_stream_line(f"{tag}: tune OQ, the same frames", oq, psnr_oq))
    # the encode's vectors, one a zone of each P-frame (the step timings
    # after it recorded theirs too)
    zones = 1 + P.make_geom(*_dims(frames)).strip
    scales = scales[:zones * sum(not p.is_keyframe for p in pkts)]
    spread = np.concatenate(scales)
    moved = sum(a.data != b.data for a, b in zip(pkts, oq))
    print(f"{tag}: {len(scales)} scale vectors, scale min {spread.min():.4f} "
          f"max {spread.max():.4f}; {moved} of {len(pkts)} packets differ "
          "from tune OQ's")
    if not same:
        return
    cpu_scales = []
    real = _recording_scales(cpu_scales)
    t0 = time.perf_counter()
    try:
        cpu = _encode("cpu", frames[:AQ_SAME_FRAMES], 8, tune=TUNE_SQ)[0]
    finally:
        P._sb_lambda_scale = real
    cpu_s = time.perf_counter() - t0
    for idx, (a, b) in enumerate(zip(cpu, pkts)):
        if a.data != b.data:
            raise AssertionError(f"{tag} frame {idx}: CPU and CUDA packets "
                                 "differ")
    want = scales[:len(cpu_scales)]
    if len(cpu_scales) != AQ_SAME_FRAMES - 1 or any(
            a.tobytes() != b.tobytes() for a, b in zip(cpu_scales, want)):
        raise AssertionError(f"{tag}: CPU and CUDA scale vectors differ")
    print(f"{tag} same bytes: the first {AQ_SAME_FRAMES} packets and the "
          f"{len(cpu_scales)} scale vectors are identical on cpu "
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
# the quarter-pel search, ZERO and GOLDEN's candidates, the recon
# distortion, three transforms); a strip geometry adds the strip zone's
# (its flat search in place of the fused one); one loop filter a frame
MESH_ZONE_LAUNCHES = {"hier_search_fused": 1, "subpel_search": 1,
                      "block_energy_at": 2, "block_energy": 1,
                      "transform_recon": 3}
MESH_STRIP_LAUNCHES = {"sse_map_search": 1, "subpel_search": 1,
                       "block_energy_at": 2, "block_energy": 1,
                       "transform_recon": 3}


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
        *stage(frames[0]), T.dc_quant(q), T.ac_quant(q), lam, kf,
        int(lim[kf]), int(mblim[kf]))
    scal = (T.dc_quant(q), T.ac_quant(q), lam, lf, int(lim[lf]),
            int(mblim[lf]))
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
            "block_energy_at", "transform_recon", "loop_filter") + \
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
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
        transform_kernel_phase(dev, real["tr"], real_frames, real_recons),
        kframe_kernel_phase(dev), loop_filter_kernel_phase(dev, real["lf"]),
        openloop_kernel_phase(dev))}
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
                 "kframe_wave", "transform_recon", "subpel_search"):
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
    if any(k["launches"] <= 0 for k in kernels.values()):
        raise AssertionError("a kernel was not launched on its main path")

    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
