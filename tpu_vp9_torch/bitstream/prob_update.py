"""Forward probability updates (subexp prob-delta coding + RD decision).

Per-frame coefficient/skip probability optimization: collect symbol
counts, pick new model probabilities where the bit savings exceed the
header cost of coding the delta.  Parity reference: vendored libvpx
``vp9_subexp.c`` (remap/term-subexp), ``vp9_bitstream.c``
``update_coef_probs_common`` in SVT-VP9 — re-derived with an exact
full-model cost (including the Pareto tail) instead of libvpx's
node-local heuristic.
"""

from __future__ import annotations

import numpy as np

from tpu_vp9_torch.bitstream import tables as T

DIFF_UPDATE_PROB = 252
MAX_PROB = 255


# ---------------------------------------------------------------------------
# subexp delta coding (encoder side)
# ---------------------------------------------------------------------------


def _recenter_nonneg(v: int, m: int) -> int:
    if v > 2 * m:
        return v
    if v >= m:
        return (v - m) * 2
    return (m - v) * 2 - 1


def remap_prob(v: int, m: int) -> int:
    """Encoder-side delta index for new prob v given old prob m."""
    table = T.tbl("subexp_map_table")
    v -= 1
    m -= 1
    if (m << 1) <= MAX_PROB:
        i = _recenter_nonneg(v, m) - 1
    else:
        i = _recenter_nonneg(MAX_PROB - 1 - v, MAX_PROB - 1 - m) - 1
    return int(table[i])


def subexp_bits(delta: int) -> int:
    """Bits used by the term-subexp code for a delta index."""
    if delta < 16:
        return 5  # 1 + 4
    if delta < 32:
        return 6  # 2 + 4
    if delta < 64:
        return 8  # 3 + 5
    v = delta - 64
    if v < 65:
        return 10  # 3 + 7
    return 11


def write_term_subexp(enc, delta: int) -> None:
    if delta < 16:
        enc.put_bit(0, 128)
        enc.put_literal(delta, 4)
    elif delta < 32:
        enc.put_bit(1, 128)
        enc.put_bit(0, 128)
        enc.put_literal(delta - 16, 4)
    elif delta < 64:
        enc.put_bit(1, 128)
        enc.put_bit(1, 128)
        enc.put_bit(0, 128)
        enc.put_literal(delta - 32, 5)
    else:
        enc.put_bit(1, 128)
        enc.put_bit(1, 128)
        enc.put_bit(1, 128)
        v = delta - 64
        # encode_uniform with l=8, m=65
        if v < 65:
            enc.put_literal(v, 7)
        else:
            enc.put_literal(65 + ((v - 65) >> 1), 7)
            enc.put_bit((v - 65) & 1, 128)


def write_prob_diff_update(enc, newp: int, oldp: int) -> None:
    delta = remap_prob(newp, oldp)
    write_term_subexp(enc, delta)


def update_cost_bits(newp: int, oldp: int) -> float:
    """Approximate header bits to signal an update (cond bit + subexp)."""
    cost = T.prob_cost()
    cond = cost[256 - DIFF_UPDATE_PROB] / 512.0  # '1' branch of the 252 bool
    return cond + subexp_bits(remap_prob(newp, oldp))


def no_update_cost_bits() -> float:
    return float(T.prob_cost()[DIFF_UPDATE_PROB]) / 512.0


# ---------------------------------------------------------------------------
# coefficient model optimization
# ---------------------------------------------------------------------------


def get_binary_prob(n0: int, n1: int) -> int:
    total = n0 + n1
    if total == 0:
        return 128
    p = (256 * n0 + (total >> 1)) // total
    return int(np.clip(p, 1, 255))


def _con_tree_costs(pareto_row, cost):
    """Cost (1/512 bits) of coding each token 2..10 through the con tree
    (nodes 3..10 probs = pareto_row) excluding nodes 0..2."""
    out = np.zeros(11)
    for tokv, path in T.tree_paths("coef_con_tree").items():
        c = 0.0
        for pi, bit in zip(path.prob_idx, path.bits):
            p = int(pareto_row[pi])
            c += cost[256 - p] if bit else cost[p]
        out[tokv] = c
    return out


_PARETO_COSTS = None


def _pareto_costs():
    """(255, 11) con-tree token costs per pivot value."""
    global _PARETO_COSTS
    if _PARETO_COSTS is None:
        cost = T.prob_cost().astype(np.float64)
        pareto = T.tbl("pareto8_full")
        _PARETO_COSTS = np.stack(
            [_con_tree_costs(pareto[p], cost) for p in range(255)])
    return _PARETO_COSTS


def model_cost(model, tk, eob_br):
    """Total coding cost (1/512 bits) for one (band, ctx) cell.

    model: (p0, p1, p2); tk: token counts (12,); eob_br: eob-branch count.
    """
    cost = T.prob_cost().astype(np.float64)
    p0, p1, p2 = int(model[0]), int(model[1]), int(model[2])
    neob = tk[11]
    n_zero = tk[0]
    n_one = tk[1]
    n_two_plus = tk[2:11].sum()
    n_nonzero = n_one + n_two_plus
    c = neob * cost[p0] + (eob_br - neob) * cost[256 - p0]
    c += n_zero * cost[p1] + n_nonzero * cost[256 - p1]
    c += n_one * cost[p2] + n_two_plus * cost[256 - p2]
    if n_two_plus:
        tc = _pareto_costs()[max(p2, 1) - 1]
        c += float((tk[2:11] * tc[2:11]).sum())
    return c / 512.0


def optimize_coef_probs(fc, counts, eob_counts):
    """Per-tx-size coef model updates with exact savings accounting.

    counts: {TxSize: (2, 2, 6, 6, 12) int64}, eob_counts: {...: (2,2,6,6)}.
    Returns (new_coef_probs dict, per-tx update flag dict).
    """
    new_probs = {}
    any_update = {}
    for ts, cnt in counts.items():
        old = fc.coef_probs[ts]
        new = old.copy()
        total_savings = 0.0
        for pt in range(2):
            for ref in range(2):
                for band in range(6):
                    for ctx in range(6 if band else 3):
                        tk = cnt[pt, ref, band, ctx]
                        ebr = int(eob_counts[ts][pt, ref, band, ctx])
                        if tk.sum() == 0 and ebr == 0:
                            continue
                        om = old[pt, ref, band, ctx]
                        base = model_cost(om, tk, ebr)
                        # candidate probs per node
                        neob = int(tk[11])
                        n_zero = int(tk[0])
                        n_one = int(tk[1])
                        n2p = int(tk[2:11].sum())
                        cands = [
                            get_binary_prob(neob, ebr - neob),
                            get_binary_prob(n_zero, n_one + n2p),
                            get_binary_prob(n_one, n2p),
                        ]
                        nm = om.copy()
                        for node in range(3):
                            best_p = int(om[node])
                            best_gain = 0.0
                            for cand in {cands[node],
                                         max(1, cands[node] - 1),
                                         min(255, cands[node] + 1)}:
                                if cand == int(om[node]):
                                    continue
                                trial = nm.copy()
                                trial[node] = cand
                                gain = (base - model_cost(trial, tk, ebr)
                                        - update_cost_bits(cand, int(om[node]))
                                        + no_update_cost_bits())
                                if gain > best_gain:
                                    best_gain = gain
                                    best_p = cand
                            if best_p != int(om[node]):
                                nm[node] = best_p
                                base = model_cost(nm, tk, ebr)
                                total_savings += best_gain
                        new[pt, ref, band, ctx] = nm
        # one flag bit per tx size: update only if net savings beat the
        # per-prob no-update flags we now must write
        if total_savings > 8.0 and not np.array_equal(new, old):
            new_probs[ts] = new
            any_update[ts] = True
        else:
            new_probs[ts] = old
            any_update[ts] = False
    return new_probs, any_update


def write_coef_updates(enc, old_probs, new_probs, do_update: bool) -> None:
    """Write one tx-size's update block (vp9_bitstream.c update_coef_probs)."""
    enc.put_bit(1 if do_update else 0, 128)
    if not do_update:
        return
    for pt in range(2):
        for ref in range(2):
            for band in range(6):
                for ctx in range(6 if band else 3):
                    for node in range(3):
                        o = int(old_probs[pt, ref, band, ctx, node])
                        n = int(new_probs[pt, ref, band, ctx, node])
                        if n != o:
                            enc.put_bit(1, DIFF_UPDATE_PROB)
                            write_prob_diff_update(enc, n, o)
                        else:
                            enc.put_bit(0, DIFF_UPDATE_PROB)


def optimize_binary_probs(old, counts0, counts1):
    """Optimize an array of standalone binary probs (e.g. skip_probs).

    counts0/1: arrays of 0/1 branch counts.  Returns new probs array.
    """
    cost = T.prob_cost().astype(np.float64)
    new = old.copy()
    for i in range(old.size):
        o = int(old[i])
        n0, n1 = int(counts0[i]), int(counts1[i])
        if n0 + n1 == 0:
            continue
        cand = get_binary_prob(n0, n1)
        base = (n0 * cost[o] + n1 * cost[256 - o]) / 512.0
        trial = (n0 * cost[cand] + n1 * cost[256 - cand]) / 512.0
        if base - trial > update_cost_bits(cand, o) - no_update_cost_bits():
            new[i] = cand
    return new


def write_binary_updates(enc, old, new) -> None:
    for i in range(old.size):
        o, n = int(old[i]), int(new[i])
        if n != o:
            enc.put_bit(1, DIFF_UPDATE_PROB)
            write_prob_diff_update(enc, n, o)
        else:
            enc.put_bit(0, DIFF_UPDATE_PROB)
