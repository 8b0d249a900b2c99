"""Backward probability adaptation (frame_parallel_decoding_mode = 0).

After each frame, both encoder and decoder re-derive the stored frame
context from the *pre-forward-update* context plus the frame's symbol
counts (spec 9.2 adapt_coef_process / adapt_noncoef_process; reference
behavior: vp9_entropy.c eb_vp9_adapt_coef_probs:962,
vp9_entropymode.c eb_vp9_adapt_mode_probs:334,
vp9_entropymv.c eb_vp9_adapt_mv_probs:136).  Both sides must count the
same symbols and merge identically, or the streams desynchronize — the
round-trip recon oracle catches any divergence.

All merges are exact integer arithmetic on numpy arrays.
"""

from __future__ import annotations

import numpy as np

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream.tables import TxSize

MODE_MV_COUNT_SAT = 20
MODE_MV_MAX_UPDATE = 128
COEF_COUNT_SAT = 24
COEF_MAX_UPDATE = 112
COEF_MAX_UPDATE_AFTER_KEY = 128


def _get_prob(num, den):
    """Vectorized get_prob: clip(round(num*256/den), 1, 255); den==0 -> 128."""
    num = num.astype(np.int64)
    den = den.astype(np.int64)
    safe = np.maximum(den, 1)
    p = (num * 256 + (safe >> 1)) // safe
    p = np.clip(p, 1, 255)
    return np.where(den == 0, 128, p)


def _weighted(pre, prob, factor):
    return (pre.astype(np.int64) * (256 - factor) + prob * factor + 128) >> 8


def merge_probs(pre, ct0, ct1, count_sat, max_update):
    """Vectorized merge_probs (prob.h:72)."""
    ct0 = np.asarray(ct0, np.int64)
    ct1 = np.asarray(ct1, np.int64)
    den = ct0 + ct1
    prob = _get_prob(ct0, den)
    count = np.minimum(den, count_sat)
    factor = (max_update * count) // count_sat
    return _weighted(np.asarray(pre), prob, factor).astype(np.uint8)


def mode_mv_merge_probs(pre, ct0, ct1):
    """Vectorized mode_mv_merge_probs (prob.h:84); den==0 keeps pre."""
    ct0 = np.asarray(ct0, np.int64)
    ct1 = np.asarray(ct1, np.int64)
    den = ct0 + ct1
    prob = _get_prob(ct0, den)
    count = np.minimum(den, MODE_MV_COUNT_SAT)
    factor = (MODE_MV_MAX_UPDATE * count) // MODE_MV_COUNT_SAT
    out = _weighted(np.asarray(pre), prob, factor)
    return np.where(den == 0, np.asarray(pre), out).astype(np.uint8)


def tree_merge_probs(tree_name: str, pre_probs, leaf_counts):
    """Per-context tree merge (prob.c:25 tree_merge_probs_impl).

    pre_probs: (..., n_nodes); leaf_counts: (..., n_leaves) indexed by
    token value.  Returns adapted probs with the same shape as pre_probs.
    """
    tree = T.tbl(tree_name)
    pre = np.asarray(pre_probs)
    counts = np.asarray(leaf_counts, np.int64)
    out = pre.copy()

    def walk(i: int):
        l, r = int(tree[i]), int(tree[i + 1])
        lc = counts[..., -l] if l <= 0 else walk(l)
        rc = counts[..., -r] if r <= 0 else walk(r)
        out[..., i >> 1] = mode_mv_merge_probs(pre[..., i >> 1], lc, rc)
        return lc + rc

    walk(0)
    return out


def adapt_coef_probs(fc, pre_fc, counts, after_key: bool):
    """eb_vp9_adapt_coef_probs: 3-node model merge per (tx, plane, ref,
    band, ctx) from token + eob-branch counts."""
    update = COEF_MAX_UPDATE_AFTER_KEY if after_key else COEF_MAX_UPDATE
    for ts in TxSize:
        c = counts[("coef", ts)]
        eb = counts[("eob", ts)]
        n0 = c[..., 0]
        n1 = c[..., 1]
        n2 = c[..., 2:11].sum(axis=-1)
        neob = c[..., 11]
        pre = pre_fc.coef_probs[ts]
        out = pre.copy()
        out[..., 0] = merge_probs(pre[..., 0], neob, eb - neob,
                                  COEF_COUNT_SAT, update)
        out[..., 1] = merge_probs(pre[..., 1], n0, n1 + n2,
                                  COEF_COUNT_SAT, update)
        out[..., 2] = merge_probs(pre[..., 2], n1, n2,
                                  COEF_COUNT_SAT, update)
        fc.coef_probs[ts] = out


def _tx_branch_counts(tx_counts):
    """tx-size histograms -> per-node branch counts
    (eb_vp9_tx_counts_to_branch_counts_*)."""
    c = tx_counts.astype(np.int64)
    n = c.shape[-1]
    return [(c[..., k], c[..., k + 1 :].sum(axis=-1)) for k in range(n - 1)]


def adapt_mode_probs(fc, pre_fc, counts, tx_select: bool):
    """eb_vp9_adapt_mode_probs (inter frames only; no switchable interp,
    compound merges are identity via den==0 when a frame codes no
    compound blocks)."""
    fc.intra_inter_probs = mode_mv_merge_probs(
        pre_fc.intra_inter_probs, counts["intra_inter"][:, 0],
        counts["intra_inter"][:, 1])
    fc.comp_inter_probs = mode_mv_merge_probs(
        pre_fc.comp_inter_probs, counts["comp_inter"][:, 0],
        counts["comp_inter"][:, 1])
    fc.comp_ref_probs = mode_mv_merge_probs(
        pre_fc.comp_ref_probs, counts["comp_ref"][:, 0],
        counts["comp_ref"][:, 1])
    fc.single_ref_probs = np.stack([
        mode_mv_merge_probs(pre_fc.single_ref_probs[:, j],
                            counts["single_ref"][:, j, 0],
                            counts["single_ref"][:, j, 1])
        for j in range(2)], axis=1)
    fc.inter_mode_probs = tree_merge_probs(
        "inter_mode_tree", pre_fc.inter_mode_probs, counts["inter_mode"])
    fc.if_y_probs = tree_merge_probs(
        "intra_mode_tree", pre_fc.if_y_probs, counts["y_mode"])
    fc.if_uv_probs = tree_merge_probs(
        "intra_mode_tree", pre_fc.if_uv_probs, counts["uv_mode"])
    fc.partition_probs = tree_merge_probs(
        "partition_tree", pre_fc.partition_probs, counts["partition"])
    if tx_select:
        for name, attr in (("tx_p8", "tx_probs_8x8"),
                           ("tx_p16", "tx_probs_16x16"),
                           ("tx_p32", "tx_probs_32x32")):
            pre = getattr(pre_fc, attr)
            out = pre.copy()
            for k, (c0, c1) in enumerate(_tx_branch_counts(counts[name])):
                out[:, k] = mode_mv_merge_probs(pre[:, k], c0, c1)
            setattr(fc, attr, out)
    else:
        fc.tx_probs_8x8 = pre_fc.tx_probs_8x8.copy()
        fc.tx_probs_16x16 = pre_fc.tx_probs_16x16.copy()
        fc.tx_probs_32x32 = pre_fc.tx_probs_32x32.copy()
    fc.skip_probs = mode_mv_merge_probs(
        pre_fc.skip_probs, counts["skip"][:, 0], counts["skip"][:, 1])
    fc.interp_probs = pre_fc.interp_probs.copy()


def adapt_mv_probs(fc, pre_fc, counts, allow_hp: bool = False):
    """eb_vp9_adapt_mv_probs."""
    nmv, pre = fc.nmv, pre_fc.nmv
    nmv.joints = tree_merge_probs("mv_joint_tree", pre.joints,
                                  counts["mv_joints"])
    for i in range(2):
        comp, pc = nmv.comps[i], pre.comps[i]
        comp.sign = int(mode_mv_merge_probs(
            np.asarray(pc.sign), counts["mv_sign"][i, 0],
            counts["mv_sign"][i, 1]))
        comp.classes = tree_merge_probs("mv_class_tree", pc.classes,
                                        counts["mv_classes"][i])
        comp.class0 = tree_merge_probs("mv_class0_tree", pc.class0,
                                       counts["mv_class0"][i])
        comp.bits = mode_mv_merge_probs(pc.bits, counts["mv_bits"][i, :, 0],
                                        counts["mv_bits"][i, :, 1])
        comp.class0_fp = np.stack([
            tree_merge_probs("mv_fp_tree", pc.class0_fp[j],
                             counts["mv_class0_fp"][i, j])
            for j in range(2)])
        comp.fp = tree_merge_probs("mv_fp_tree", pc.fp, counts["mv_fp"][i])
        if allow_hp:
            comp.class0_hp = int(mode_mv_merge_probs(
                np.asarray(pc.class0_hp), counts["mv_class0_hp"][i, 0],
                counts["mv_class0_hp"][i, 1]))
            comp.hp = int(mode_mv_merge_probs(
                np.asarray(pc.hp), counts["mv_hp"][i, 0],
                counts["mv_hp"][i, 1]))
        else:
            comp.class0_hp = int(pc.class0_hp)
            comp.hp = int(pc.hp)


def inc_mv(counts, diff_mv) -> None:
    """eb_vp9_inc_mv for one coded MV difference (row, col) in q3 units.

    usehp is 0 in the current streams (allow_high_precision_mv off)."""
    row, col = int(diff_mv[0]), int(diff_mv[1])
    joint = (1 if col else 0) | (2 if row else 0)
    counts["mv_joints"][joint] += 1
    for i, v in ((0, row), (1, col)):
        if v == 0:
            continue
        s = 1 if v < 0 else 0
        counts["mv_sign"][i, s] += 1
        z = (-v if s else v) - 1
        from tpu_vp9_torch.codec.mv import _mv_class
        c, o = _mv_class(z)
        counts["mv_classes"][i, c] += 1
        d, f = o >> 3, (o >> 1) & 3
        if c == 0:
            counts["mv_class0"][i, d] += 1
            counts["mv_class0_fp"][i, d, f] += 1
        else:
            nbits = c  # CLASS0_BITS(1) - 1 + c
            for b in range(nbits):
                counts["mv_bits"][i, b, (d >> b) & 1] += 1
            counts["mv_fp"][i, f] += 1


def adapt_frame_context(pre_fc, counts, is_key: bool, after_key: bool,
                        tx_select: bool, final_fc=None):
    """Full per-frame adaptation; returns the new stored context.

    Key/intra-only frames adapt coefficient probs only (decoder flow:
    vp9_decodeframe adaptation block).

    final_fc: the frame's working context AFTER forward updates.  The
    saved context is cm->fc (forward-updated) with the adapted tables
    overwritten by merges FROM the pre-update context — on key frames
    only the coef tables are re-derived, so forward updates to e.g.
    skip probs persist into the saved context (libvpx saves *cm->fc
    after vp9_adapt_coef_probs).  Starting from pre_fc instead silently
    drops those updates and desyncs every following frame."""
    fc = (final_fc if final_fc is not None else pre_fc).copy()
    adapt_coef_probs(fc, pre_fc, counts, after_key=after_key and not is_key)
    if not is_key:
        adapt_mode_probs(fc, pre_fc, counts, tx_select)
        adapt_mv_probs(fc, pre_fc, counts)
    return fc


def new_mode_counts():
    """Zeroed non-coef symbol counters (inter frames)."""
    return {
        "intra_inter": np.zeros((4, 2), np.int64),
        "single_ref": np.zeros((5, 2, 2), np.int64),
        "comp_inter": np.zeros((5, 2), np.int64),
        "comp_ref": np.zeros((5, 2), np.int64),
        "inter_mode": np.zeros((7, 4), np.int64),
        "y_mode": np.zeros((4, 10), np.int64),
        "uv_mode": np.zeros((10, 10), np.int64),
        "partition": np.zeros((16, 4), np.int64),
        "tx_p8": np.zeros((2, 2), np.int64),
        "tx_p16": np.zeros((2, 3), np.int64),
        "tx_p32": np.zeros((2, 4), np.int64),
        "mv_joints": np.zeros(4, np.int64),
        "mv_sign": np.zeros((2, 2), np.int64),
        "mv_classes": np.zeros((2, 11), np.int64),
        "mv_class0": np.zeros((2, 2), np.int64),
        "mv_bits": np.zeros((2, 10, 2), np.int64),
        "mv_class0_fp": np.zeros((2, 2, 4), np.int64),
        "mv_fp": np.zeros((2, 4), np.int64),
        "mv_class0_hp": np.zeros((2, 2), np.int64),
        "mv_hp": np.zeros((2, 2), np.int64),
    }
