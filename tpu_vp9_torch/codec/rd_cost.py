"""Table-driven RD rate model for the mode-decision full loop.

The reference's full loop prices every candidate with real entropy-table
rates (``EbRateDistortionCost.c``: coeff token costs, nmv MV costs, mode
and reference-signaling costs) instead of hand-tuned constants.  This
module mirrors that: all costs are exact boolean-coder prices (1/256-bit
units, cost(bit, p) = -256*log2(P(bit))) derived from the frame's
FrameContext, with the coefficient token walk running in the native C++
library (``native_coeff_cost_batch`` mirrors ``boolenc_write_coeffs``).

Lambda follows the libvpx rdmult family: quadratic in the quantizer
step.  The scale constant is calibrated against the BD-rate harness
(tools/bd_rate.py) rather than copied, since our distortions are
pixel-domain SSE (libvpx uses shifted coefficient-domain error).
"""

from __future__ import annotations

import functools

import numpy as np

from tpu_vp9_torch.bitstream import tables as T

# -- bool-coder bit prices ---------------------------------------------------

PROB_COST = np.zeros(256, np.int32)
PROB_COST[1:] = np.round(
    -256.0 * np.log2(np.arange(1, 256) / 256.0)).astype(np.int32)
PROB_COST[0] = PROB_COST[1]


def bit_cost(bit: int, prob: int) -> int:
    return int(PROB_COST[256 - prob] if bit else PROB_COST[prob])


@functools.cache
def _tree_paths(tree_name: str):
    """token -> ((prob_idx, bit), ...) from a vp9 tree table."""
    tree = T.tbl(tree_name).astype(int)
    paths = {}

    def walk(i, path):
        for b in (0, 1):
            node = tree[i + b]
            p = path + ((i >> 1, b),)
            if node <= 0:
                paths[-node] = p
            else:
                walk(node, p)

    walk(0, ())
    return paths


def tree_token_costs(tree_name: str, probs) -> np.ndarray:
    """(n_tokens,) cost of each token under `probs` (1/256 bits)."""
    paths = _tree_paths(tree_name)
    out = np.zeros(max(paths) + 1, np.int64)
    for tok, path in paths.items():
        out[tok] = sum(bit_cost(b, int(probs[i])) for i, b in path)
    return out


# -- nmv component cost LUT --------------------------------------------------

MV_COST_MAX = 1023  # LUT covers |diff| <= 1023 (q3); larger clamps


def _mv_component_costs(comp) -> np.ndarray:
    """(2*MV_COST_MAX+1,) cost of a component diff value (index d +
    MV_COST_MAX), matching mv.py _write_mv_component (no high precision:
    the hp bit is not coded when allow_hp is off)."""
    class_costs = tree_token_costs("mv_class_tree", comp.classes)
    fp_costs = {d: tree_token_costs("mv_fp_tree", comp.class0_fp[d])
                for d in (0, 1)}
    fp_cost_gen = tree_token_costs("mv_fp_tree", comp.fp)
    sign_cost = (PROB_COST[int(comp.sign)],
                 PROB_COST[256 - int(comp.sign)])
    out = np.zeros(2 * MV_COST_MAX + 1, np.int64)
    for mag in range(1, MV_COST_MAX + 1):
        z = mag - 1
        if z >= 2 * 4096:
            c = 10
        else:
            n = z >> 3
            c = n.bit_length() - 1 if n > 0 else 0
        base = 0 if c == 0 else 2 << (c + 2)
        offset = z - base
        d = offset >> 3
        fr = (offset >> 1) & 3
        cost = int(class_costs[c])
        if c == 0:
            cost += bit_cost(d, int(comp.class0[0]))
            cost += int(fp_costs[d][fr])
        else:
            for i in range(c):
                cost += bit_cost((d >> i) & 1, int(comp.bits[i]))
            cost += int(fp_cost_gen[fr])
        out[MV_COST_MAX + mag] = cost + sign_cost[0]
        out[MV_COST_MAX - mag] = cost + sign_cost[1]
    return out


# -- per-frame cost tables ---------------------------------------------------


class FrameCosts:
    """All rate tables for one frame's RD decisions.

    fc: FrameContext in effect for this frame (the forward-probability
    chain state); qindex sets lambda.
    """

    def __init__(self, fc, qindex: int, lambda_scale: float = 1.0):
        self.fc = fc
        ac_q = T.ac_quant(qindex)
        # pixel-domain SSE per bit; effective pixel quant step ~ ac_q/8
        # (2-D transform gain), high-rate lambda* ~ 0.85 * step^2
        self.lambda_bits = max(1.0,
                               0.85 * (ac_q / 8.0) ** 2 * lambda_scale)
        self.joint_cost = tree_token_costs("mv_joint_tree", fc.nmv.joints)
        self.comp_cost = (_mv_component_costs(fc.nmv.comps[0]),
                          _mv_component_costs(fc.nmv.comps[1]))
        self.inter_mode_cost = np.stack([
            tree_token_costs("inter_mode_tree", fc.inter_mode_probs[c])
            for c in range(7)])
        self.skip_cost = np.stack(
            [(int(PROB_COST[int(p)]), int(PROB_COST[256 - int(p)]))
             for p in fc.skip_probs])
        self.intra_inter_cost = np.stack(
            [(int(PROB_COST[int(p)]), int(PROB_COST[256 - int(p)]))
             for p in fc.intra_inter_probs])
        from tpu_vp9_torch.bitstream.tokenize import full_probs_for

        self._coef_full = {}
        for ts in T.TxSize:
            for uv in (False, True):
                for inter in (False, True):
                    self._coef_full[(int(ts), uv, inter)] = \
                        np.ascontiguousarray(
                            full_probs_for(fc, ts, uv, inter), np.uint8)

    def mv_rate(self, mv, ref_mv) -> int:
        """write_mv price (1/256 bits), allow_hp = False."""
        dr = int(mv[0]) - int(ref_mv[0])
        dc = int(mv[1]) - int(ref_mv[1])
        joint = (1 if dc else 0) | (2 if dr else 0)
        cost = int(self.joint_cost[joint])
        if dr:
            cost += int(self.comp_cost[0][
                MV_COST_MAX + int(np.clip(dr, -MV_COST_MAX, MV_COST_MAX))])
        if dc:
            cost += int(self.comp_cost[1][
                MV_COST_MAX + int(np.clip(dc, -MV_COST_MAX, MV_COST_MAX))])
        return cost

    def coeff_rate(self, levels, tx_size, is_uv: bool, is_inter: bool,
                   ctx0) -> np.ndarray:
        """(B,) native token-walk price for a batch of level blocks."""
        from tpu_vp9_torch import native as nat

        lv = np.asarray(levels, np.int32)
        if lv.ndim == 2:
            lv = lv[None]
        b = lv.shape[0]
        c0 = np.full(b, ctx0, np.int32) if np.isscalar(ctx0) \
            else np.asarray(ctx0, np.int32)
        probs = self._coef_full[(int(tx_size), is_uv, is_inter)]
        lib = nat.get_lib()
        if lib is None:  # pure-python fallback: price via the oracle walk
            return np.array([_py_coeff_cost(lv[i], tx_size, probs,
                                            int(c0[i]))
                             for i in range(b)], np.int64)
        return nat.native_coeff_cost_batch(lv, int(tx_size),
                                           int(T.TxType.DCT_DCT), probs,
                                           c0).astype(np.int64)

    def rd(self, dist_sse, rate_256) -> float:
        return float(dist_sse) + self.lambda_bits * float(rate_256) / 256.0


def _py_coeff_cost(levels2d, tx_size, probs_full, ctx0: int) -> int:
    """Python oracle of native coeff_token_cost (tests + fallback)."""
    from tpu_vp9_torch.bitstream import tokenize as tok

    scan, _, nbrs = T.scan_order(T.TxSize(tx_size), T.TxType.DCT_DCT)
    band = T.coefband(T.TxSize(tx_size))
    energy = tok._energy()
    flat = np.asarray(levels2d).reshape(-1)[scan]
    nz = np.nonzero(flat)[0]
    eob = int(nz[-1]) + 1 if nz.size else 0
    cache = np.zeros(flat.size, np.int32)
    cat_probs = [T.tbl(f"cat{i}_prob") for i in range(1, 7)]
    cat_base = (5, 7, 11, 19, 35, 67)
    cat_bits = (1, 2, 3, 4, 5, 14)
    paths = _tree_paths("coef_con_tree")
    cost = 0
    skip_eob = False
    for c in range(min(eob + 1, flat.size)):
        if c == 0:
            pt = ctx0
        else:
            pt = (1 + cache[nbrs[c, 0]] + cache[nbrs[c, 1]]) >> 1
        p = probs_full[band[c], pt]
        is_eob = c == eob
        if not skip_eob:
            cost += bit_cost(0 if is_eob else 1, int(p[0]))
        if is_eob:
            break
        level = int(flat[c])
        mag = abs(level)
        tokv = _token_from_mag(mag)
        if mag == 0:
            cost += bit_cost(0, int(p[1]))
            cache[scan[c]] = 0
            skip_eob = True
            continue
        cost += bit_cost(1, int(p[1]))
        skip_eob = False
        cache[scan[c]] = int(energy[tokv])
        if mag == 1:
            cost += bit_cost(0, int(p[2]))
        else:
            cost += bit_cost(1, int(p[2]))
            for i, b in paths[tokv]:
                cost += bit_cost(b, int(p[3 + i]))
            if tokv >= 5:
                cat = tokv - 5
                extra = mag - cat_base[cat]
                nbits = cat_bits[cat]
                for k in range(nbits):
                    cost += bit_cost((extra >> (nbits - 1 - k)) & 1,
                                     int(cat_probs[cat][k]))
        cost += 256  # sign
    return cost


def _token_from_mag(mag: int) -> int:
    if mag <= 4:
        return mag
    if mag <= 6:
        return 5
    if mag <= 10:
        return 6
    if mag <= 18:
        return 7
    if mag <= 34:
        return 8
    if mag <= 66:
        return 9
    return 10
