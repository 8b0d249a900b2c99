"""libvpx rate-control curve math (exact re-derivation).

Parity reference: vendored ``VPX/vp9_ratectrl.c`` in SVT-VP9 —
``eb_vp9_convert_qindex_to_q`` (:158), ``get_minq_index`` (:90),
``init_minq_luts`` (:110), ``eb_vp9_rc_bits_per_mb`` (:183),
``vp9_compute_qdelta`` / ``vp9_compute_qdelta_by_rate`` — plus the
SVT-side CQP qp-scaling ``eb_vp9_qp_scaling_calc``
(``EbRateControlProcess.c:44``) with its delta_rate tables (:28-40).
All tables are formula-derived at import time, not copied.
"""

from __future__ import annotations

import numpy as np

from tpu_vp9_torch.bitstream import tables as T

MINQ, MAXQ = 0, 255

# q value per qindex: ac_quant(qindex)/4 for 8-bit
_QINDEX_TO_Q = np.array([T.ac_quant(i) / 4.0 for i in range(256)], np.float64)


def qindex_to_q(qindex: int) -> float:
    return float(_QINDEX_TO_Q[int(np.clip(qindex, 0, 255))])


def q_to_qindex(q_val: float) -> int:
    """Smallest qindex whose q >= q_val (eb_vp9_convert_q_to_qindex)."""
    i = int(np.searchsorted(_QINDEX_TO_Q, q_val))
    return min(i, 255)


def compute_qdelta(qstart: float, qtarget: float) -> int:
    """vp9_compute_qdelta: qindex delta moving q from qstart to qtarget."""
    start_index = MAXQ
    target_index = MAXQ
    for i in range(MINQ, MAXQ + 1):
        if _QINDEX_TO_Q[i] >= qstart:
            start_index = i
            break
    for i in range(MINQ, MAXQ + 1):
        if _QINDEX_TO_Q[i] >= qtarget:
            target_index = i
            break
    return target_index - start_index


def _get_minq_index(maxq: float, x3: float, x2: float, x1: float) -> int:
    minqtarget = min(((x3 * maxq + x2) * maxq + x1) * maxq, maxq)
    if minqtarget <= 2.0:
        return 0
    i = int(np.searchsorted(_QINDEX_TO_Q, minqtarget))
    return min(i, 255)


def _make_lut(x3, x2, x1):
    return np.array([_get_minq_index(_QINDEX_TO_Q[i], x3, x2, x1)
                     for i in range(256)], np.int32)


# init_minq_luts coefficients (vp9_ratectrl.c:110-126, 8-bit)
KF_LOW_MOTION_MINQ = _make_lut(0.000001, -0.0004, 0.150)
KF_HIGH_MOTION_MINQ = _make_lut(0.0000021, -0.00125, 0.45)
ARFGF_LOW_MOTION_MINQ = _make_lut(0.0000015, -0.0009, 0.30)
ARFGF_HIGH_MOTION_MINQ = _make_lut(0.0000021, -0.00125, 0.55)
INTER_MINQ = _make_lut(0.00000271, -0.00113, 0.70)
RTC_MINQ = _make_lut(0.00000271, -0.00113, 0.70)

# boost ranges (vp9_ratectrl.c statics)
KF_LOW, KF_HIGH = 300, 4800
GF_LOW, GF_HIGH = 400, 2000

# SVT delta-rate ladders per tune (EbRateControlProcess.c:28-40); index =
# temporal layer, entry = target q as a fraction of the base-layer q
DELTA_RATE_OQ_4L = (0.35, 0.70, 0.85, 1.00, 1.00, 1.00)
DELTA_RATE_OQ_5L = (0.30, 0.60, 0.80, 0.90, 1.00, 1.00)
DELTA_RATE_SQ = (0.35, 0.50, 0.75, 1.00, 1.00, 1.00)
DELTA_RATE_VMAF = (0.50, 0.70, 0.85, 1.00, 1.00, 1.00)


def qp_scaling_qindex(base_qindex: int, is_key: bool, temporal_layer: int,
                      tune: int = 1, five_level: bool = False) -> int:
    """CQP per-frame qindex (eb_vp9_qp_scaling_calc, qindex domain).

    Key frames target q*0.25; inter layers follow the tune's delta-rate
    ladder.  Returns a qindex clamped to [MINQ+1, MAXQ].
    """
    q = qindex_to_q(base_qindex)
    if is_key:
        delta = compute_qdelta(q, q * 0.25)
    else:
        tl = min(temporal_layer, 5)
        if tune == 0:  # SQ
            factor = DELTA_RATE_SQ[tl]
        elif tune == 2:  # VMAF
            factor = DELTA_RATE_VMAF[tl]
        else:  # OQ
            factor = (DELTA_RATE_OQ_5L if five_level
                      else DELTA_RATE_OQ_4L)[tl]
        delta = compute_qdelta(q, q * factor)
    return int(np.clip(base_qindex + delta, MINQ + 1, MAXQ))


NON_MOVING_SCORE_0 = 0
NON_MOVING_SCORE_1 = 10
NON_MOVING_SCORE_3 = 30
STATIC_KF_GROUP_THRESH = 99  # vp9_ratectrl.h:39


def zz_staticness(cur_y: np.ndarray, nxt_y: np.ndarray,
                  width: int, height: int):
    """(non_moving_average_score, kf_zeromotion_pct) from collocated
    64x64 zz-SAD between two luma planes.

    Mirrors compute_zz_sad + derive_picture_activity_statistics
    (EbMotionEstimationProcess.c:431-530 thresholds (64*64*{2,4,8}) >>
    non_moving_th_shift[resolution], EbSourceBasedOperationsProcess.c:
    70-113 averaging over complete SBs only).
    """
    px = width * height
    if px <= 1024 * 576:
        shift = 4
    elif px <= 1920 * 1088:
        shift = 2 if height < 1000 else 0  # 1080i range keeps shift 2
    else:
        shift = 0
    th = [((64 * 64 * m) >> shift) for m in (2, 4, 8)]
    scores = []
    nm_count = 0
    total = 0
    for y0 in range(0, height - 63, 64):
        for x0 in range(0, width - 63, 64):
            a = cur_y[y0:y0 + 64, x0:x0 + 64].astype(np.int32)
            b = nxt_y[y0:y0 + 64, x0:x0 + 64].astype(np.int32)
            zz = int(np.abs(a - b).sum())
            if zz < th[0]:
                s = NON_MOVING_SCORE_0
            elif zz < th[1]:
                s = NON_MOVING_SCORE_1
            elif zz < th[2]:
                s = 20
            else:
                s = NON_MOVING_SCORE_3
            if s < NON_MOVING_SCORE_1:
                nm_count += 1
            scores.append(s)
            total += 1
    if not total:
        return NON_MOVING_SCORE_3, 0
    return sum(scores) // total, (nm_count * 100) // total


def adaptive_kf_qindex(base_qindex: int, non_moving_avg: int,
                       kf_zeromotion_pct: int, width: int,
                       height: int) -> int:
    """Adaptive (QP_SCALING_MODE_1) keyframe qindex: libvpx
    active_best_quality from a kf_boost derived from content staticness.

    EbRateControlProcess.c:4592-4646 — kf_boost by cross-multiplication
    from non_moving_average_score over [kf_low=300, kf_high=4800],
    static-group /4 rule, small-format and zero-motion q adjustments.
    """
    active_worst = int(base_qindex)
    kf_boost = ((NON_MOVING_SCORE_3 - int(non_moving_avg))
                * (KF_HIGH - KF_LOW)) // NON_MOVING_SCORE_3 + KF_LOW
    active_best = get_kf_active_quality(active_worst, kf_boost)
    if kf_zeromotion_pct >= STATIC_KF_GROUP_THRESH:
        active_best //= 4
    active_best = min(active_worst, max(1, active_best))
    q_adj_factor = 1.0
    if width * height <= 352 * 288:
        q_adj_factor -= 0.25
    q_adj_factor += 0.05 - 0.001 * float(kf_zeromotion_pct)
    q_val = qindex_to_q(active_best)
    active_best += compute_qdelta(q_val, q_val * q_adj_factor)
    return int(np.clip(active_best, MINQ + 1, MAXQ))


def get_kf_active_quality(active_worst: int, kf_boost: int) -> int:
    """get_active_quality with the kf LUT pair (vp9_ratectrl.c)."""
    return _active_quality(active_worst, kf_boost, KF_LOW, KF_HIGH,
                           KF_LOW_MOTION_MINQ, KF_HIGH_MOTION_MINQ)


def get_gf_active_quality(active_worst: int, gf_boost: int) -> int:
    return _active_quality(active_worst, gf_boost, GF_LOW, GF_HIGH,
                           ARFGF_LOW_MOTION_MINQ, ARFGF_HIGH_MOTION_MINQ)


def _active_quality(q: int, boost: int, low: int, high: int,
                    low_lut, high_lut) -> int:
    if boost > high:
        return int(low_lut[q])
    if boost < low:
        return int(high_lut[q])
    offset = (high_lut[q] - low_lut[q]) * (boost - low) / (high - low)
    return int(high_lut[q] - offset)


MIN_BPB_FACTOR, MAX_BPB_FACTOR = 0.005, 50.0
BPER_MB_NORMBITS = 9  # bits_per_mb is normalized by << 9 (vp9_ratectrl.h)


def bits_per_mb(is_key: bool, qindex: int,
                correction_factor: float = 1.0) -> int:
    """eb_vp9_rc_bits_per_mb (vp9_ratectrl.c:183); result is in
    (bits << BPER_MB_NORMBITS) per 16x16 macroblock."""
    q = qindex_to_q(qindex)
    enumerator = 2700000 if is_key else 1800000
    enumerator += int(enumerator * q) >> 12
    return int(enumerator * correction_factor / q)


def regulate_q(target_bits: float, mbs: int, is_key: bool,
               correction_factor: float, best_q: int, worst_q: int) -> int:
    """vp9_rc_regulate_q: lowest qindex whose projected bits meet the
    per-frame target (bits_per_mb is monotonically decreasing in q)."""
    target_bpm = (target_bits * (1 << BPER_MB_NORMBITS)) / max(mbs, 1)
    for i in range(best_q, worst_q + 1):
        if bits_per_mb(is_key, i, correction_factor) <= target_bpm:
            return i
    return worst_q


def projected_bits(qindex: int, mbs: int, is_key: bool,
                   correction_factor: float) -> int:
    return (bits_per_mb(is_key, qindex, correction_factor) * mbs) \
        >> BPER_MB_NORMBITS
