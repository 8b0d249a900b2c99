"""VP9 coefficient token coding (host serialization layer).

Implements the spec's coefficient syntax: EOB/zero/one tree with the
model-expanded node probabilities, category extra bits, sign, the
token_cache/neighbor context rule, and the per-plane above/left entropy
contexts.  Parity reference: SVT-VP9 vendored libvpx ``vp9_tokenize.c:397``
(token extraction) and ``vp9_bitstream.c`` ``pack_mb_tokens`` (writing);
re-written from the spec as a direct single pass (no intermediate token
buffer needed on the host path).

The TPU side computes quantized levels in batch; this layer walks scan
order and drives the boolean coder.  (A C++ fast path mirrors this.)
"""

from __future__ import annotations

import numpy as np

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream.tables import Token, TxSize, TxType

ENERGY_CLASS = None  # lazy: T.tbl("pt_energy_class")

# Full coefficient token tree probabilities are 11 nodes:
#   node0: EOB vs more; node1: ZERO vs nonzero; node2: ONE vs bigger;
#   nodes 3..10: the "constrained" tree over TWO..CAT6 (coef_con_tree).
CON_TREE_LEAF_TOKENS = (Token.TWO, Token.THREE, Token.FOUR, Token.CAT1,
                        Token.CAT2, Token.CAT3, Token.CAT4, Token.CAT5,
                        Token.CAT6)


def _energy():
    global ENERGY_CLASS
    if ENERGY_CLASS is None:
        ENERGY_CLASS = T.tbl("pt_energy_class").astype(np.int32)
    return ENERGY_CLASS


def _con_tree_paths():
    return T.tree_paths("coef_con_tree")


def write_coeffs(enc, levels2d, tx_size: TxSize, tx_type: TxType,
                 probs_full, ctx0: int, counts=None, eob_counts=None):
    """Encode one transform block's quantized levels.

    levels2d: (N, N) int array (natural order).
    probs_full: (6 bands, 6 ctx, 11) uint8 full node probs for this
        (tx_size, plane_type, ref_type).
    ctx0: entropy context (0..2) for scan position 0.
    counts: optional (6, 6, 12) int64 array accumulating token counts
        (token index 0..11); eob_counts: (6, 6) "EOB-coded" branch counts.
    Returns eob (number of coded coefficients).
    """
    scan, _, nbrs = T.scan_order(tx_size, tx_type)
    band = T.coefband(tx_size)
    energy = _energy()
    flat = np.asarray(levels2d).reshape(-1)
    lv = flat[scan]
    nz = np.nonzero(lv)[0]
    eob = int(nz[-1]) + 1 if nz.size else 0

    token_cache = np.zeros(flat.size, np.int32)
    con_paths = _con_tree_paths()

    skip_eob = False
    for c in range(eob + 1):
        if c == flat.size:
            break
        if c == 0:
            pt = ctx0
        else:
            pt = (1 + token_cache[nbrs[c, 0]] + token_cache[nbrs[c, 1]]) >> 1
        b = band[c]
        p = probs_full[b, pt]
        is_eob = c == eob
        if not skip_eob:
            if eob_counts is not None:
                eob_counts[b, pt] += 1
            enc.put_bit(0 if is_eob else 1, int(p[0]))
        if is_eob:
            if counts is not None and not skip_eob:
                counts[b, pt, int(Token.EOB)] += 1
            break
        level = int(lv[c])
        mag = abs(level)
        tok = T.token_from_level(mag)
        if counts is not None:
            counts[b, pt, int(tok)] += 1
        if mag == 0:
            enc.put_bit(0, int(p[1]))
            token_cache[scan[c]] = 0
            skip_eob = True
            continue
        enc.put_bit(1, int(p[1]))
        skip_eob = False
        token_cache[scan[c]] = int(energy[int(tok)])
        if mag == 1:
            enc.put_bit(0, int(p[2]))
        else:
            enc.put_bit(1, int(p[2]))
            path = con_paths[int(tok)]
            for pi, bit in zip(path.prob_idx, path.bits):
                enc.put_bit(bit, int(p[3 + pi]))
            if tok >= Token.CAT1:
                extra = mag - T.CAT_BASE[tok]
                cat_p = T.cat_probs(tok)
                nbits = T.CAT_NUM_EXTRA[tok]
                for i in range(nbits):
                    enc.put_bit((extra >> (nbits - 1 - i)) & 1, int(cat_p[i]))
        enc.put_bit(1 if level < 0 else 0, 128)
    return eob


def write_coeffs_any(enc, levels2d, tx_size, tx_type, probs_full,
                     ctx0: int, counts=None, eob_counts=None) -> int:
    """Dispatch to the native tokenizer when `enc` supports it."""
    if hasattr(enc, "write_coeffs"):
        return enc.write_coeffs(levels2d, tx_size, tx_type, probs_full, ctx0,
                                counts, eob_counts)
    return write_coeffs(enc, levels2d, tx_size, tx_type, probs_full, ctx0,
                        counts, eob_counts)


def read_coeffs(dec, tx_size: TxSize, tx_type: TxType, probs_full,
                ctx0: int, dc_q: int, ac_q: int,
                counts=None, eob_counts=None):
    """Decode one transform block; returns (dequantized (N,N) int32, eob).

    counts/eob_counts: optional accumulators mirroring write_coeffs —
    required for backward adaptation (decoder-side symbol counting,
    vp9 detokenize INCREMENT_COUNT / eob_branch semantics)."""
    scan, _, nbrs = T.scan_order(tx_size, tx_type)
    band = T.coefband(tx_size)
    energy = _energy()
    n2 = scan.size
    n = int(np.sqrt(n2))
    out = np.zeros(n2, np.int32)
    token_cache = np.zeros(n2, np.int32)
    con_tree = T.tbl("coef_con_tree")
    dq_shift = 1 if tx_size == TxSize.TX_32X32 else 0

    skip_eob = False
    c = 0
    while c < n2:
        pt = ctx0 if c == 0 else (
            (1 + token_cache[nbrs[c, 0]] + token_cache[nbrs[c, 1]]) >> 1)
        p = probs_full[band[c], pt]
        if not skip_eob:
            if eob_counts is not None:
                eob_counts[band[c], pt] += 1
            more = dec.read_bit(int(p[0]))
            if not more:
                if counts is not None:
                    counts[band[c], pt, int(Token.EOB)] += 1
                break
        if not dec.read_bit(int(p[1])):
            if counts is not None:
                counts[band[c], pt, int(Token.ZERO)] += 1
            token_cache[scan[c]] = 0
            skip_eob = True
            c += 1
            continue
        skip_eob = False
        if not dec.read_bit(int(p[2])):
            mag = 1
            tok = Token.ONE
        else:
            i = 0
            while True:
                bit = dec.read_bit(int(p[3 + (i >> 1)]))
                node = int(con_tree[i + bit])
                if node <= 0:
                    tok = Token(-node)
                    break
                i = node
            if tok < Token.CAT1:
                mag = int(tok)
            else:
                cat_p = T.cat_probs(tok)
                extra = 0
                for i in range(T.CAT_NUM_EXTRA[tok]):
                    extra = (extra << 1) | dec.read_bit(int(cat_p[i]))
                mag = T.CAT_BASE[tok] + extra
        if counts is not None:
            counts[band[c], pt, int(tok)] += 1
        token_cache[scan[c]] = int(energy[int(tok)])
        sign = dec.read_bit(128)
        q = dc_q if scan[c] == 0 else ac_q
        val = (mag * q) >> dq_shift
        out[scan[c]] = -val if sign else val
        c += 1
    return out.reshape(n, n), c


class PlaneContext:
    """Above/left entropy contexts for one plane (one entry per 4 px)."""

    def __init__(self, mi_cols: int, mi_rows: int, subsampling: int):
        self.above = np.zeros(((mi_cols * 2) >> subsampling) + 16, np.int8)
        self.left = np.zeros(((mi_rows * 2) >> subsampling) + 16, np.int8)

    def get_ctx(self, x4: int, y4: int, tx_size: TxSize) -> int:
        n4 = 1 << int(tx_size)
        a = int(self.above[x4 : x4 + n4].any())
        l = int(self.left[y4 : y4 + n4].any())
        return a + l

    def set_ctx(self, x4: int, y4: int, tx_size: TxSize, has_eob: bool,
                max_x4: int, max_y4: int) -> None:
        """Set contexts after coding; entries past the frame edge get 0."""
        n4 = 1 << int(tx_size)
        va = min(n4, max(0, max_x4 - x4)) if has_eob else 0
        vl = min(n4, max(0, max_y4 - y4)) if has_eob else 0
        self.above[x4 : x4 + va] = 1
        self.above[x4 + va : x4 + n4] = 0
        self.left[y4 : y4 + vl] = 1
        self.left[y4 + vl : y4 + n4] = 0


def full_probs_for(fc, tx_size: TxSize, plane_is_uv: bool, is_inter: bool):
    """(6, 6, 11) expanded node probs from a FrameContext."""
    model = fc.coef_probs[TxSize(tx_size)][1 if plane_is_uv else 0,
                                           1 if is_inter else 0]
    return T.model_to_full(model)
