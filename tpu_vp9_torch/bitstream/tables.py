"""VP9 normative constants: enums, probability tables, scans, trees.

Numeric tables are loaded from ``vp9_tables.npz`` (extracted by
``tools/extract_tables.py`` from the spec-mandated constants; see that tool's
docstring for provenance). Everything else here — structure, derived tables,
tree-path precomputation, probability model expansion — is written fresh.

Reference parity: vendored libvpx ``vp9_entropy.{c,h}``,
``vp9_entropymode.c``, ``vp9_entropymv.{c,h}``, ``vp9_scan.c``,
``vp9_quant_common.c``, ``vp9_filter.c`` in SVT-VP9.
"""

from __future__ import annotations

import enum
import functools
import os
from dataclasses import dataclass

import numpy as np

_NPZ = os.path.join(os.path.dirname(__file__), "vp9_tables.npz")


@functools.cache
def _load():
    return dict(np.load(_NPZ))


def tbl(name: str) -> np.ndarray:
    return _load()[name]


# ---------------------------------------------------------------------------
# Enums (VP9 spec values)
# ---------------------------------------------------------------------------


class IntraMode(enum.IntEnum):
    DC_PRED = 0
    V_PRED = 1
    H_PRED = 2
    D45_PRED = 3
    D135_PRED = 4
    D117_PRED = 5
    D153_PRED = 6
    D207_PRED = 7
    D63_PRED = 8
    TM_PRED = 9


class InterMode(enum.IntEnum):
    # absolute mode values (y_mode numbering continues after intra)
    NEARESTMV = 10
    NEARMV = 11
    ZEROMV = 12
    NEWMV = 13


INTER_MODE_OFFSET = {m: int(m) - 10 for m in InterMode}


class Partition(enum.IntEnum):
    NONE = 0
    HORZ = 1
    VERT = 2
    SPLIT = 3


class TxSize(enum.IntEnum):
    TX_4X4 = 0
    TX_8X8 = 1
    TX_16X16 = 2
    TX_32X32 = 3


class TxMode(enum.IntEnum):
    ONLY_4X4 = 0
    ALLOW_8X8 = 1
    ALLOW_16X16 = 2
    ALLOW_32X32 = 3
    TX_MODE_SELECT = 4


class TxType(enum.IntEnum):
    DCT_DCT = 0
    ADST_DCT = 1  # ADST in vertical (rows transform = DCT), per spec naming
    DCT_ADST = 2
    ADST_ADST = 3


class InterpFilter(enum.IntEnum):
    EIGHTTAP = 0
    EIGHTTAP_SMOOTH = 1
    EIGHTTAP_SHARP = 2
    BILINEAR = 3
    SWITCHABLE = 4


class RefFrame(enum.IntEnum):
    INTRA = 0
    LAST = 1
    GOLDEN = 2
    ALTREF = 3


class BlockSize(enum.IntEnum):
    BLOCK_4X4 = 0
    BLOCK_4X8 = 1
    BLOCK_8X4 = 2
    BLOCK_8X8 = 3
    BLOCK_8X16 = 4
    BLOCK_16X8 = 5
    BLOCK_16X16 = 6
    BLOCK_16X32 = 7
    BLOCK_32X16 = 8
    BLOCK_32X32 = 9
    BLOCK_32X64 = 10
    BLOCK_64X32 = 11
    BLOCK_64X64 = 12


# width/height in units of 4px (mi units are 8px)
BLOCK_WH = {
    BlockSize.BLOCK_4X4: (4, 4),
    BlockSize.BLOCK_4X8: (4, 8),
    BlockSize.BLOCK_8X4: (8, 4),
    BlockSize.BLOCK_8X8: (8, 8),
    BlockSize.BLOCK_8X16: (8, 16),
    BlockSize.BLOCK_16X8: (16, 8),
    BlockSize.BLOCK_16X16: (16, 16),
    BlockSize.BLOCK_16X32: (16, 32),
    BlockSize.BLOCK_32X16: (32, 16),
    BlockSize.BLOCK_32X32: (32, 32),
    BlockSize.BLOCK_32X64: (32, 64),
    BlockSize.BLOCK_64X32: (64, 32),
    BlockSize.BLOCK_64X64: (64, 64),
}

# Largest square tx size permitted for each block size (spec: max_txsize_lookup)
MAX_TX_SIZE = {
    BlockSize.BLOCK_4X4: TxSize.TX_4X4,
    BlockSize.BLOCK_4X8: TxSize.TX_4X4,
    BlockSize.BLOCK_8X4: TxSize.TX_4X4,
    BlockSize.BLOCK_8X8: TxSize.TX_8X8,
    BlockSize.BLOCK_8X16: TxSize.TX_8X8,
    BlockSize.BLOCK_16X8: TxSize.TX_8X8,
    BlockSize.BLOCK_16X16: TxSize.TX_16X16,
    BlockSize.BLOCK_16X32: TxSize.TX_16X16,
    BlockSize.BLOCK_32X16: TxSize.TX_16X16,
    BlockSize.BLOCK_32X32: TxSize.TX_32X32,
    BlockSize.BLOCK_32X64: TxSize.TX_32X32,
    BlockSize.BLOCK_64X32: TxSize.TX_32X32,
    BlockSize.BLOCK_64X64: TxSize.TX_32X32,
}

# ss_size_lookup[bsize] for 4:2:0 chroma (both subsampling = 1); spec table.
CHROMA_BSIZE_420 = {
    BlockSize.BLOCK_8X8: BlockSize.BLOCK_4X4,
    BlockSize.BLOCK_8X16: BlockSize.BLOCK_4X8,
    BlockSize.BLOCK_16X8: BlockSize.BLOCK_8X4,
    BlockSize.BLOCK_16X16: BlockSize.BLOCK_8X8,
    BlockSize.BLOCK_16X32: BlockSize.BLOCK_8X16,
    BlockSize.BLOCK_32X16: BlockSize.BLOCK_16X8,
    BlockSize.BLOCK_32X32: BlockSize.BLOCK_16X16,
    BlockSize.BLOCK_32X64: BlockSize.BLOCK_16X32,
    BlockSize.BLOCK_64X32: BlockSize.BLOCK_32X16,
    BlockSize.BLOCK_64X64: BlockSize.BLOCK_32X32,
}

# intra-mode "size group" per block size (spec: size_group_lookup), used for
# inter-frame y-mode context.
SIZE_GROUP = {
    BlockSize.BLOCK_4X4: 0,
    BlockSize.BLOCK_4X8: 0,
    BlockSize.BLOCK_8X4: 0,
    BlockSize.BLOCK_8X8: 1,
    BlockSize.BLOCK_8X16: 1,
    BlockSize.BLOCK_16X8: 1,
    BlockSize.BLOCK_16X16: 2,
    BlockSize.BLOCK_16X32: 2,
    BlockSize.BLOCK_32X16: 2,
    BlockSize.BLOCK_32X32: 3,
    BlockSize.BLOCK_32X64: 3,
    BlockSize.BLOCK_64X32: 3,
    BlockSize.BLOCK_64X64: 3,
}

SUBSIZE = {
    # partition_subsize[partition][bsize] for square bsizes 8..64
    (Partition.NONE, BlockSize.BLOCK_64X64): BlockSize.BLOCK_64X64,
    (Partition.HORZ, BlockSize.BLOCK_64X64): BlockSize.BLOCK_64X32,
    (Partition.VERT, BlockSize.BLOCK_64X64): BlockSize.BLOCK_32X64,
    (Partition.SPLIT, BlockSize.BLOCK_64X64): BlockSize.BLOCK_32X32,
    (Partition.NONE, BlockSize.BLOCK_32X32): BlockSize.BLOCK_32X32,
    (Partition.HORZ, BlockSize.BLOCK_32X32): BlockSize.BLOCK_32X16,
    (Partition.VERT, BlockSize.BLOCK_32X32): BlockSize.BLOCK_16X32,
    (Partition.SPLIT, BlockSize.BLOCK_32X32): BlockSize.BLOCK_16X16,
    (Partition.NONE, BlockSize.BLOCK_16X16): BlockSize.BLOCK_16X16,
    (Partition.HORZ, BlockSize.BLOCK_16X16): BlockSize.BLOCK_16X8,
    (Partition.VERT, BlockSize.BLOCK_16X16): BlockSize.BLOCK_8X16,
    (Partition.SPLIT, BlockSize.BLOCK_16X16): BlockSize.BLOCK_8X8,
    (Partition.NONE, BlockSize.BLOCK_8X8): BlockSize.BLOCK_8X8,
    (Partition.HORZ, BlockSize.BLOCK_8X8): BlockSize.BLOCK_8X4,
    (Partition.VERT, BlockSize.BLOCK_8X8): BlockSize.BLOCK_4X8,
    (Partition.SPLIT, BlockSize.BLOCK_8X8): BlockSize.BLOCK_4X4,
}


# ---------------------------------------------------------------------------
# Coefficient tokens
# ---------------------------------------------------------------------------


class Token(enum.IntEnum):
    ZERO = 0
    ONE = 1
    TWO = 2
    THREE = 3
    FOUR = 4
    CAT1 = 5  # 5..6
    CAT2 = 6  # 7..10
    CAT3 = 7  # 11..18
    CAT4 = 8  # 19..34
    CAT5 = 9  # 35..66
    CAT6 = 10  # 67..
    EOB = 11


CAT_BASE = {Token.CAT1: 5, Token.CAT2: 7, Token.CAT3: 11, Token.CAT4: 19,
            Token.CAT5: 35, Token.CAT6: 67}
CAT_NUM_EXTRA = {Token.CAT1: 1, Token.CAT2: 2, Token.CAT3: 3, Token.CAT4: 4,
                 Token.CAT5: 5, Token.CAT6: 14}


def cat_probs(token: Token) -> np.ndarray:
    return tbl(f"cat{int(token) - 4}_prob")


def token_from_level(level: int) -> Token:
    """Map |coefficient| to its token."""
    if level <= 4:
        return Token(level)
    if level <= 6:
        return Token.CAT1
    if level <= 10:
        return Token.CAT2
    if level <= 18:
        return Token.CAT3
    if level <= 34:
        return Token.CAT4
    if level <= 66:
        return Token.CAT5
    return Token.CAT6


# ---------------------------------------------------------------------------
# Trees and tree paths
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TreePath:
    """Encoding path for one leaf of a VP9 tree: parallel (prob_idx, bit)."""

    prob_idx: tuple
    bits: tuple


@functools.cache
def tree_paths(tree_name: str) -> dict:
    """token -> TreePath for a tree stored in the npz."""
    tree = tbl(tree_name)
    paths: dict[int, TreePath] = {}

    def walk(i: int, prob_idx, bits):
        for bit in (0, 1):
            node = int(tree[i + bit])
            pi = prob_idx + (i >> 1,)
            bs = bits + (bit,)
            if node <= 0:
                paths[-node] = TreePath(pi, bs)
            else:
                walk(node, pi, bs)

    walk(0, (), ())
    return paths


def write_token(enc, tree_name: str, probs, token: int) -> None:
    """Encode `token` through the named tree with node probabilities `probs`."""
    path = tree_paths(tree_name)[int(token)]
    for pi, bit in zip(path.prob_idx, path.bits):
        enc.put_bit(bit, int(probs[pi]))


def read_token(dec, tree_name: str, probs) -> int:
    tree = tbl(tree_name)
    i = 0
    while True:
        bit = dec.read_bit(int(probs[i >> 1]))
        node = int(tree[i + bit])
        if node <= 0:
            return -node
        i = node


# ---------------------------------------------------------------------------
# Coefficient probability model expansion (spec 8.5 / libvpx model_to_full)
# ---------------------------------------------------------------------------

# Full 11-node token tree probabilities are derived from 3 stored "model"
# probs: node0 = p(EOB branch), node1 = p(ZERO branch), node2 = pivot; nodes
# 3..10 come from the Pareto table row pareto8_full[pivot - 1].


@functools.cache
def _pareto() -> np.ndarray:
    return tbl("pareto8_full")


def model_to_full(model: np.ndarray) -> np.ndarray:
    """Expand (..., 3) model probs to (..., 11) full node probs."""
    model = np.asarray(model)
    full = np.zeros(model.shape[:-1] + (11,), dtype=np.uint8)
    full[..., :3] = model
    pivot = np.clip(model[..., 2].astype(np.int32), 1, 255)
    full[..., 3:] = _pareto()[pivot - 1]
    return full


# ---------------------------------------------------------------------------
# Scans
# ---------------------------------------------------------------------------

TX_SIZE_NAMES = {TxSize.TX_4X4: "4x4", TxSize.TX_8X8: "8x8",
                 TxSize.TX_16X16: "16x16", TxSize.TX_32X32: "32x32"}


@functools.cache
def scan_order(tx_size: TxSize, tx_type: TxType):
    """Return (scan, iscan, neighbors) arrays for a tx size/type.

    neighbors has shape (n+1, 2): the two already-coded spatial neighbor
    positions of each scan index, used for the coefficient context.
    """
    name = TX_SIZE_NAMES[TxSize(tx_size)]
    if tx_size == TxSize.TX_32X32:
        kind = "default"
    else:
        # spec: ADST in a direction flips which 1-D scan is used
        kind = {TxType.DCT_DCT: "default", TxType.ADST_DCT: "row",
                TxType.DCT_ADST: "col", TxType.ADST_ADST: "default"}[TxType(tx_type)]
    scan = tbl(f"{kind}_scan_{name}").astype(np.int32)
    nbrs = tbl(f"{kind}_scan_{name}_neighbors").astype(np.int32).reshape(-1, 2)
    iscan = np.zeros_like(scan)
    iscan[scan] = np.arange(scan.size, dtype=np.int32)
    return scan, iscan, nbrs


@functools.cache
def coefband(tx_size: TxSize) -> np.ndarray:
    """Band index per scan position."""
    if tx_size == TxSize.TX_4X4:
        return tbl("coefband_trans_4x4").astype(np.int32)
    n = {TxSize.TX_8X8: 64, TxSize.TX_16X16: 256, TxSize.TX_32X32: 1024}[TxSize(tx_size)]
    return tbl("coefband_trans_8x8plus").astype(np.int32)[:n]


# ---------------------------------------------------------------------------
# Quantizer
# ---------------------------------------------------------------------------


def dc_quant(qindex: int, delta: int = 0) -> int:
    return int(tbl("dc_qlookup")[int(np.clip(qindex + delta, 0, 255))])


def ac_quant(qindex: int, delta: int = 0) -> int:
    return int(tbl("ac_qlookup")[int(np.clip(qindex + delta, 0, 255))])


# ---------------------------------------------------------------------------
# MV context
# ---------------------------------------------------------------------------


@dataclass
class NmvComponent:
    sign: int
    classes: np.ndarray  # (10,)
    class0: np.ndarray  # (1,)
    bits: np.ndarray  # (10,)
    class0_fp: np.ndarray  # (2, 3)
    fp: np.ndarray  # (3,)
    class0_hp: int
    hp: int


@dataclass
class NmvContext:
    joints: np.ndarray  # (3,)
    comps: tuple  # (NmvComponent, NmvComponent) — (row, col)


def default_nmv_context() -> NmvContext:
    flat = tbl("default_nmv_flat")
    joints = flat[:3].copy()
    comps = []
    o = 3
    for _ in range(2):
        comps.append(
            NmvComponent(
                sign=int(flat[o]),
                classes=flat[o + 1 : o + 11].copy(),
                class0=flat[o + 11 : o + 12].copy(),
                bits=flat[o + 12 : o + 22].copy(),
                class0_fp=flat[o + 22 : o + 28].reshape(2, 3).copy(),
                fp=flat[o + 28 : o + 31].copy(),
                class0_hp=int(flat[o + 31]),
                hp=int(flat[o + 32]),
            )
        )
        o += 33
    assert o == flat.size
    return NmvContext(joints=joints, comps=tuple(comps))


# ---------------------------------------------------------------------------
# Default frame context (forward-adaptable probability state)
# ---------------------------------------------------------------------------


@dataclass
class FrameContext:
    """All forward probabilities for one frame (spec 'frame context')."""

    coef_probs: dict  # TxSize -> (2, 2, 6, 6, 3) uint8 model probs
    skip_probs: np.ndarray  # (3,)
    tx_probs_32x32: np.ndarray  # (2, 3)
    tx_probs_16x16: np.ndarray  # (2, 2)
    tx_probs_8x8: np.ndarray  # (2, 1)
    if_y_probs: np.ndarray  # (4, 9)
    if_uv_probs: np.ndarray  # (10, 9)
    partition_probs: np.ndarray  # (16, 3)
    inter_mode_probs: np.ndarray  # (7, 3)
    interp_probs: np.ndarray  # (4, 2)
    intra_inter_probs: np.ndarray  # (4,)
    comp_inter_probs: np.ndarray  # (5,)
    single_ref_probs: np.ndarray  # (5, 2)
    comp_ref_probs: np.ndarray  # (5,)
    nmv: NmvContext

    def copy(self) -> "FrameContext":
        import copy as _copy

        return _copy.deepcopy(self)


def default_frame_context() -> FrameContext:
    return FrameContext(
        coef_probs={
            ts: tbl(f"default_coef_probs_{TX_SIZE_NAMES[ts]}").astype(np.uint8)
            for ts in TxSize
        },
        skip_probs=tbl("default_skip_probs").astype(np.uint8),
        tx_probs_32x32=tbl("default_tx_probs_32x32").astype(np.uint8),
        tx_probs_16x16=tbl("default_tx_probs_16x16").astype(np.uint8),
        tx_probs_8x8=tbl("default_tx_probs_8x8").astype(np.uint8),
        if_y_probs=tbl("default_if_y_probs").astype(np.uint8),
        if_uv_probs=tbl("default_if_uv_probs").astype(np.uint8),
        partition_probs=tbl("default_partition_probs").astype(np.uint8),
        inter_mode_probs=tbl("default_inter_mode_probs").astype(np.uint8),
        interp_probs=tbl("default_switchable_interp_probs").astype(np.uint8),
        intra_inter_probs=tbl("default_intra_inter_prob").astype(np.uint8),
        comp_inter_probs=tbl("default_comp_inter_prob").astype(np.uint8),
        single_ref_probs=tbl("default_single_ref_prob").astype(np.uint8),
        comp_ref_probs=tbl("default_comp_ref_prob").astype(np.uint8),
        nmv=default_nmv_context(),
    )


# Keyframe-only static tables (never adapted)
def kf_y_mode_probs() -> np.ndarray:
    return tbl("kf_y_mode_probs").astype(np.uint8)  # (above, left, 9)


def kf_uv_mode_probs() -> np.ndarray:
    return tbl("kf_uv_mode_probs").astype(np.uint8)


def kf_partition_probs() -> np.ndarray:
    return tbl("kf_partition_probs").astype(np.uint8)


def prob_cost() -> np.ndarray:
    """Cost in 1/512-bit units of coding a zero-branch with prob p (and the
    one-branch via prob_cost[256 - p])."""
    return tbl("prob_cost").astype(np.int32)


def subpel_filters(which: InterpFilter) -> np.ndarray:
    name = {
        InterpFilter.EIGHTTAP: "sub_pel_filters_8",
        InterpFilter.EIGHTTAP_SMOOTH: "sub_pel_filters_8lp",
        InterpFilter.EIGHTTAP_SHARP: "sub_pel_filters_8s",
        InterpFilter.BILINEAR: "bilinear_filters",
    }[InterpFilter(which)]
    return tbl(name).astype(np.int32)
