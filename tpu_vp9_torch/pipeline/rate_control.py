"""Rate control: CQP (libvpx-curve QP scaling), VBR, CBR + VBV.

Capability parity with the reference RC kernel
(``EbRateControlProcess.c``: CQP qp-scaling ``:44``, VBR ``:434/:1067``,
CBR ``:2243``, VBV ``:4378``) built on the exact libvpx curve math in
``rc_curves.py`` (bits_per_mb projection, rate-correction factors,
minq LUTs) — re-expressed as a compact per-frame controller suitable
for frame-parallel operation: all state lives in a small dataclass that
can be psum-merged across shards.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tpu_vp9_torch.config import EncoderConfig, RateControlMode
from tpu_vp9_torch.pipeline import rc_curves as C
from tpu_vp9_torch.pipeline.presets import qp_to_qindex


# per-temporal-layer share of the total bitrate, percent
# (EbRateControlProcess.h:33 rate_percentage_layer_array)
RATE_PCT_LAYER = (
    (100, 0, 0, 0, 0, 0),
    (70, 30, 0, 0, 0, 0),
    (70, 15, 15, 0, 0, 0),
    (55, 15, 15, 15, 0, 0),
    (40, 15, 15, 15, 15, 0),
    (30, 10, 15, 15, 15, 15),
)
FRAME_OVERHEAD_BITS = 200  # vp9_ratectrl.h


@dataclass
class RateControlState:
    cfg: EncoderConfig
    qindex: int = 100
    mbs: int = 0  # 16x16 macroblock count (libvpx bits_per_mb unit)
    target_bits_per_frame: float = 0.0
    buffer_level: float = 0.0  # VBV fullness (bits available to spend)
    buffer_size: float = 0.0
    optimal_level: float = 0.0
    total_bits: float = 0.0
    frames_coded: int = 0
    frames_since_key: int = 0
    vbv_violations: int = 0
    # libvpx-style per-frame-type rate correction factors
    corr_key: float = 1.0
    corr_inter: float = 1.0
    vbr_bits_off_target: float = 0.0
    _last: tuple = None  # (qindex, is_key, target) of the pending frame
    # lookahead (initial-RC) relative complexity per poc; 1.0 = average
    # (EbInitialRateControlProcess + eb_vp9_high_level_rc_input_picture
    # analogue: future-frame complexity shapes each frame's bit target)
    la_scale: dict = field(default_factory=dict)

    @classmethod
    def create(cls, cfg: EncoderConfig) -> "RateControlState":
        st = cls(cfg=cfg)
        st.qindex = qp_to_qindex(cfg.qp)
        st.mbs = max(1, ((cfg.source_width + 15) // 16)
                     * ((cfg.source_height + 15) // 16))
        if cfg.rate_control_mode != RateControlMode.CQP:
            fps = max(cfg.fps, 1.0)
            st.target_bits_per_frame = cfg.target_bit_rate / fps
            # CBR always runs a VBV; VBR only when one is configured
            # (vbv-maxrate/-bufsize flags work in both modes upstream)
            if (cfg.rate_control_mode == RateControlMode.CBR
                    or cfg.vbv_buf_size):
                st.buffer_size = cfg.vbv_buf_size or 2 * cfg.target_bit_rate
                st.optimal_level = st.buffer_size * 0.6
                st.buffer_level = st.buffer_size * 0.5
        return st

    def _layer_target(self, temporal_layer: int) -> float:
        """Per-frame bit target of a temporal layer: the layer's share
        of the bandwidth divided by its share of the frames
        (EbRateControlProcess.c:104-109 layer reset)."""
        avg = self.target_bits_per_frame
        hl = int(np.clip(self.cfg.hierarchical_levels, 0, 5))
        if temporal_layer < 0 or hl == 0:
            return avg
        tl = min(temporal_layer, hl)
        pct = RATE_PCT_LAYER[hl][tl] or 5
        gop = 1 << hl
        n_frames = 1 if tl == 0 else (1 << (tl - 1))
        return avg * (pct / 100.0) * gop / n_frames

    # -- q selection ---------------------------------------------------------

    def set_lookahead_scales(self, scales: dict) -> None:
        """Install per-poc relative-complexity multipliers from the
        lookahead window (replaces any previous window's entries)."""
        self.la_scale = dict(scales)

    def frame_qindex(self, is_keyframe: bool,
                     temporal_layer: int = -1, poc: int = -1,
                     staticness=None) -> int:
        """temporal_layer >= 0 engages the per-layer CQP ladder (RA
        pyramids); -1 = structure-agnostic (low-delay paths manage their
        own layer offsets).  poc indexes the lookahead complexity map.
        staticness = (non_moving_average_score, kf_zeromotion_pct) from
        picture analysis engages the adaptive keyframe qindex
        (QP_SCALING_MODE_1; I-slices only, EbPictureDecisionProcess.c:1928)."""
        lo = qp_to_qindex(self.cfg.min_qp_allowed)
        hi = qp_to_qindex(self.cfg.max_qp_allowed)
        if self.cfg.rate_control_mode == RateControlMode.CQP:
            if (is_keyframe and staticness is not None
                    and self.cfg.enable_qp_scaling):
                q = C.adaptive_kf_qindex(
                    qp_to_qindex(self.cfg.qp), staticness[0], staticness[1],
                    self.cfg.source_width, self.cfg.source_height)
            else:
                q = self._cqp_qindex(is_keyframe, temporal_layer)
            return int(np.clip(q, lo, hi))
        # VBR/CBR: project bits at q via the libvpx curve and pick the
        # lowest q meeting this frame's target (vp9_rc_regulate_q)
        target = self._frame_target(is_keyframe, temporal_layer)
        if not is_keyframe:
            target *= float(self.la_scale.get(poc, 1.0))
        # hard VBV: a frame may never spend more than the buffer holds
        # (vp9_rc_clamp_*frame_target_size + decoder-buffer constraint)
        if self.buffer_size > 0:
            target = min(target, max(self.buffer_level * 0.9,
                                     FRAME_OVERHEAD_BITS))
        target = max(target, FRAME_OVERHEAD_BITS)
        cf = self.corr_key if is_keyframe else self.corr_inter
        q = C.regulate_q(target, self.mbs, is_keyframe, cf, lo, hi)
        if not is_keyframe and temporal_layer > 0:  # noqa: SIM102
            # non-reference/enhancement frames ride above the regulated q
            q = min(hi, q + 4 * temporal_layer)
        self._last = (q, is_keyframe, target)
        return int(q)

    def _cqp_qindex(self, is_key: bool, temporal_layer: int) -> int:
        base = qp_to_qindex(self.cfg.qp)
        if not self.cfg.enable_qp_scaling:
            return base
        if not is_key and temporal_layer < 0:
            return base  # caller manages its own layer offsets
        return C.qp_scaling_qindex(
            base, is_key, temporal_layer, tune=int(self.cfg.tune),
            five_level=self.cfg.hierarchical_levels >= 4)

    def _frame_target(self, is_key: bool, temporal_layer: int) -> float:
        avg = self.target_bits_per_frame
        fps = max(self.cfg.fps, 1.0)
        if is_key:
            # calc_iframe_target_size_one_pass_cbr: frame 0 gets half
            # the starting buffer; later keys a frames-since-key-scaled
            # kf boost
            if self.frames_coded == 0 and self.buffer_size > 0:
                return self.buffer_level * 0.5
            kf_boost = max(32.0, 2.0 * fps - 16.0)
            if self.frames_since_key < fps / 2:
                kf_boost *= self.frames_since_key / (fps / 2)
            return avg * (16.0 + kf_boost) / 16.0
        if self.cfg.rate_control_mode == RateControlMode.CBR:
            # calc_pframe_target_size_one_pass_cbr: steer toward the
            # optimal buffer level, +-pct/200 per percent of deviation
            target = avg
            diff = self.optimal_level - self.buffer_level
            one_pct = 1.0 + self.optimal_level / 100.0
            shoot_pct = 50.0  # under/over_shoot_pct defaults
            if diff > 0:
                pct = min(diff / one_pct, shoot_pct)
                target -= target * pct / 200.0
            elif diff < 0:
                pct = min(-diff / one_pct, shoot_pct)
                target += target * pct / 200.0
            return max(target, max(avg / 16.0, FRAME_OVERHEAD_BITS))
        # VBR: per-layer share of the bandwidth + redistribution of the
        # accumulated over/undershoot (EbRateControlProcess.c:434 VBR
        # frame-level targets + rate_percentage_layer_array)
        target = self._layer_target(temporal_layer)
        target += self.vbr_bits_off_target * 0.08
        return max(target, FRAME_OVERHEAD_BITS)

    # -- feedback -------------------------------------------------------------

    def update(self, frame_bits: int, is_keyframe: bool) -> None:
        """Post-encode feedback (the packetization->RC edge):
        vp9_rc_update_rate_correction_factors + postencode_update."""
        self.total_bits += frame_bits
        self.frames_coded += 1
        self.frames_since_key = 0 if is_keyframe \
            else self.frames_since_key + 1
        if self.cfg.rate_control_mode == RateControlMode.CQP:
            return
        if self.buffer_size > 0 and frame_bits > self.buffer_level:
            self.vbv_violations += 1  # decoder buffer underflow
        if self._last is not None:
            q_used, was_key, _ = self._last
            cf = self.corr_key if was_key else self.corr_inter
            proj = max(C.projected_bits(q_used, self.mbs, was_key, cf), 1)
            ratio = frame_bits / proj
            # gradual correction (libvpx adjusts by up to a factor of 2)
            adj = float(np.clip(ratio, 0.5, 2.0))
            cf = float(np.clip(cf * (0.75 + 0.25 * adj),
                               C.MIN_BPB_FACTOR, C.MAX_BPB_FACTOR))
            if was_key:
                self.corr_key = cf
            else:
                self.corr_inter = cf
            self._last = None
        self.vbr_bits_off_target += self.target_bits_per_frame - frame_bits
        # clamp accumulated debt to ~one second of bits
        cap = self.target_bits_per_frame * max(self.cfg.fps, 1.0)
        self.vbr_bits_off_target = float(
            np.clip(self.vbr_bits_off_target, -cap, cap))
        if self.buffer_size > 0:
            # VBV accounting: fill at channel rate, drain by frame bits
            self.buffer_level += self.target_bits_per_frame - frame_bits
            self.buffer_level = float(
                np.clip(self.buffer_level, 0.0, self.buffer_size))
