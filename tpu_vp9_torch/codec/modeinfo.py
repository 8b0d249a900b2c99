"""Mode-info grid and VP9 syntax context rules.

Covers partition contexts (spec 9.3 / partition_context_lookup), skip
context, keyframe/interframe mode coding contexts, tx-type derivation, and
block-geometry helpers.  Parity reference: SVT-VP9 vendored libvpx
``vp9_pred_common.{c,h}``, ``vp9_common_data.c``, ``vp9_blockd.h``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream.tables import (
    BlockSize, IntraMode, Partition, TxSize, TxType,
)

MI_SIZE = 8  # pixels per mode-info unit

# width/height in mi units
BLOCK_MI_WH = {bs: (w // 8 if w >= 8 else 1, h // 8 if h >= 8 else 1)
               for bs, (w, h) in T.BLOCK_WH.items()}
# width/height log2 in mi units (mi_width_log2_lookup)
MI_WIDTH_LOG2 = {
    BlockSize.BLOCK_4X4: 0, BlockSize.BLOCK_4X8: 0, BlockSize.BLOCK_8X4: 0,
    BlockSize.BLOCK_8X8: 0, BlockSize.BLOCK_8X16: 0, BlockSize.BLOCK_16X8: 1,
    BlockSize.BLOCK_16X16: 1, BlockSize.BLOCK_16X32: 1,
    BlockSize.BLOCK_32X16: 2, BlockSize.BLOCK_32X32: 2,
    BlockSize.BLOCK_32X64: 2, BlockSize.BLOCK_64X32: 3,
    BlockSize.BLOCK_64X64: 3,
}

# partition_context_lookup[bsize] = (above, left) bitmasks
PARTITION_CTX_LOOKUP = {
    BlockSize.BLOCK_4X4: (15, 15), BlockSize.BLOCK_4X8: (15, 14),
    BlockSize.BLOCK_8X4: (14, 15), BlockSize.BLOCK_8X8: (14, 14),
    BlockSize.BLOCK_8X16: (14, 12), BlockSize.BLOCK_16X8: (12, 14),
    BlockSize.BLOCK_16X16: (12, 12), BlockSize.BLOCK_16X32: (12, 8),
    BlockSize.BLOCK_32X16: (8, 12), BlockSize.BLOCK_32X32: (8, 8),
    BlockSize.BLOCK_32X64: (8, 0), BlockSize.BLOCK_64X32: (0, 8),
    BlockSize.BLOCK_64X64: (0, 0),
}

SQUARE_BSIZE_OF_LOG2 = {0: BlockSize.BLOCK_8X8, 1: BlockSize.BLOCK_16X16,
                        2: BlockSize.BLOCK_32X32, 3: BlockSize.BLOCK_64X64}

INTRA_MODE_TO_TX_TYPE = {
    IntraMode.DC_PRED: TxType.DCT_DCT,
    IntraMode.V_PRED: TxType.ADST_DCT,
    IntraMode.H_PRED: TxType.DCT_ADST,
    IntraMode.D45_PRED: TxType.DCT_DCT,
    IntraMode.D135_PRED: TxType.ADST_ADST,
    IntraMode.D117_PRED: TxType.ADST_DCT,
    IntraMode.D153_PRED: TxType.DCT_ADST,
    IntraMode.D207_PRED: TxType.DCT_ADST,
    IntraMode.D63_PRED: TxType.ADST_DCT,
    IntraMode.TM_PRED: TxType.ADST_ADST,
}


def y_tx_type(mode: IntraMode, is_inter: bool, lossless: bool,
              tx_size: TxSize) -> TxType:
    if is_inter or lossless or tx_size == TxSize.TX_32X32:
        return TxType.DCT_DCT
    return INTRA_MODE_TO_TX_TYPE[IntraMode(mode)]


def uv_tx_size(bsize: BlockSize, y_tx: TxSize) -> TxSize:
    """4:2:0 chroma tx size (uv_txsize_lookup)."""
    uv_bsize = T.CHROMA_BSIZE_420[BlockSize(bsize)]
    return TxSize(min(int(y_tx), int(T.MAX_TX_SIZE[uv_bsize])))


@dataclass
class ModeInfo:
    """Per-8x8-mi-unit coding state (one leaf block may span many units)."""

    bsize: BlockSize = BlockSize.BLOCK_64X64
    y_mode: IntraMode = IntraMode.DC_PRED
    uv_mode: IntraMode = IntraMode.DC_PRED
    sub_modes: tuple = ()  # 4 entries for sub-8x8 blocks
    tx_size: TxSize = TxSize.TX_32X32
    skip: bool = False
    is_inter: bool = False
    ref_frame: tuple = (-1, -1)  # (ref0, ref1); intra = (-1,-1)... spec INTRA=0
    mv: tuple = ((0, 0), (0, 0))
    sub_mvs: tuple = ()  # for sub-8x8 inter
    inter_mode: int = 0
    interp_filter: int = 0
    seg_id: int = 0


class ModeInfoGrid:
    """mi_rows x mi_cols grid of shared ModeInfo references.

    tile_mi_start/end bound the *current* tile column while walking:
    left-neighbor availability (intra refs, contexts, mvrefs) stops at the
    tile boundary (spec: tiles are entropy/prediction independent).
    """

    def __init__(self, mi_rows: int, mi_cols: int):
        self.mi_rows = mi_rows
        self.mi_cols = mi_cols
        self.tile_mi_start = 0
        self.tile_mi_end = mi_cols
        self.grid = np.empty((mi_rows, mi_cols), dtype=object)
        # parallel per-mi field arrays for vectorized consumers (loop
        # filter decisions, future temporal-MV storage)
        shape = (mi_rows, mi_cols)
        self.f_bsize = np.zeros(shape, np.int8)
        self.f_tx = np.zeros(shape, np.int8)
        self.f_skip = np.zeros(shape, bool)
        self.f_inter = np.zeros(shape, bool)
        self.f_ref0 = np.zeros(shape, np.int8)
        self.f_ref1 = np.zeros(shape, np.int8)  # -1 = single reference
        self.f_mode = np.zeros(shape, np.int8)  # combined mode 0..13
        self.f_mv = np.zeros(shape + (2,), np.int32)  # mv[0] per mi (q3)
        self.f_mv1 = np.zeros(shape + (2,), np.int32)  # mv[1] (compound)

    def set_block(self, mi_row: int, mi_col: int, bsize: BlockSize,
                  mi: ModeInfo) -> None:
        bw, bh = BLOCK_MI_WH[BlockSize(bsize)]
        r1 = min(mi_row + bh, self.mi_rows)
        c1 = min(mi_col + bw, self.mi_cols)
        self.grid[mi_row:r1, mi_col:c1] = mi
        sl = (slice(mi_row, r1), slice(mi_col, c1))
        self.f_bsize[sl] = int(bsize)
        self.f_tx[sl] = int(mi.tx_size)
        self.f_skip[sl] = mi.skip
        self.f_inter[sl] = mi.is_inter
        self.f_ref0[sl] = mi.ref_frame[0] if mi.is_inter else 0
        self.f_ref1[sl] = mi.ref_frame[1] if mi.is_inter else -1
        self.f_mode[sl] = (10 + int(mi.inter_mode)) if mi.is_inter \
            else int(mi.y_mode)
        if mi.is_inter:
            self.f_mv[sl] = (int(mi.mv[0][0]), int(mi.mv[0][1]))
            self.f_mv1[sl] = (int(mi.mv[1][0]), int(mi.mv[1][1]))
        else:
            self.f_mv[sl] = (0, 0)
            self.f_mv1[sl] = (0, 0)

    def snapshot_mvs(self):
        """(ref0, ref1, mv0, mv1) grids — the spec's MV_REF motion field
        consumed by the next frame's temporal candidate scan."""
        return (self.f_ref0.copy(), self.f_ref1.copy(),
                self.f_mv.copy(), self.f_mv1.copy())

    def refresh_fields(self) -> None:
        """Re-derive field arrays from the object grid (after mutating
        ModeInfo objects in place, e.g. skip flags set post-hoc)."""
        for r in range(self.mi_rows):
            row = self.grid[r]
            for c in range(self.mi_cols):
                mi = row[c]
                if mi is None:
                    continue
                self.f_skip[r, c] = mi.skip

    def get(self, mi_row: int, mi_col: int):
        if 0 <= mi_row < self.mi_rows and 0 <= mi_col < self.mi_cols:
            return self.grid[mi_row, mi_col]
        return None

    def above(self, mi_row: int, mi_col: int):
        return self.get(mi_row - 1, mi_col)

    def left(self, mi_row: int, mi_col: int):
        if mi_col <= self.tile_mi_start:
            return None
        return self.get(mi_row, mi_col - 1)


class PartitionContext:
    """above/left partition context bitmask arrays."""

    def __init__(self, mi_rows: int, mi_cols: int):
        self.above = np.zeros(mi_cols + 8, np.int32)
        self.left = np.zeros(mi_rows + 8, np.int32)

    def ctx(self, mi_row: int, mi_col: int, bsize: BlockSize) -> int:
        bsl = MI_WIDTH_LOG2[BlockSize(bsize)]
        a = (int(self.above[mi_col]) >> bsl) & 1
        l = (int(self.left[mi_row]) >> bsl) & 1
        return (l * 2 + a) + bsl * 4

    def update(self, mi_row: int, mi_col: int, subsize: BlockSize,
               bsize: BlockSize) -> None:
        """After coding a leaf of `subsize` inside a partition of `bsize`:
        mark the *whole bsize extent* (spec: update_partition_context uses
        the parent bsize width)."""
        bw = 1 << MI_WIDTH_LOG2[BlockSize(bsize)]
        av, lv = PARTITION_CTX_LOOKUP[BlockSize(subsize)]
        self.above[mi_col : mi_col + bw] = av
        self.left[mi_row : mi_row + bw] = lv


def tx_size_ctx(mig: ModeInfoGrid, mi_row: int, mi_col: int,
                bsize: BlockSize) -> int:
    """get_tx_size_context (vp9_pred_common.h): above/left coded tx sizes
    (or this block's max) averaged against max."""
    max_tx = int(T.MAX_TX_SIZE[BlockSize(bsize)])
    a = mig.above(mi_row, mi_col)
    l = mig.left(mi_row, mi_col)
    above_ctx = int(a.tx_size) if (a is not None and not a.skip) else max_tx
    left_ctx = int(l.tx_size) if (l is not None and not l.skip) else max_tx
    if l is None:
        left_ctx = above_ctx
    if a is None:
        above_ctx = left_ctx
    return int(above_ctx + left_ctx > max_tx)


def tx_probs_row(fc, max_tx: TxSize, ctx: int):
    """The per-context node probs for coding a tx size below max_tx."""
    if max_tx == TxSize.TX_32X32:
        return fc.tx_probs_32x32[ctx]
    if max_tx == TxSize.TX_16X16:
        return fc.tx_probs_16x16[ctx]
    return fc.tx_probs_8x8[ctx]


def write_tx_size(enc, fc, mig: ModeInfoGrid, mi_row: int, mi_col: int,
                  bsize: BlockSize, tx_size: TxSize) -> None:
    """write_selected_tx_size: unary-ish code over tx_probs."""
    max_tx = T.MAX_TX_SIZE[BlockSize(bsize)]
    ctx = tx_size_ctx(mig, mi_row, mi_col, bsize)
    probs = tx_probs_row(fc, max_tx, ctx)
    t = int(tx_size)
    enc.put_bit(1 if t != 0 else 0, int(probs[0]))
    if t != 0 and int(max_tx) >= 2:
        enc.put_bit(1 if t != 1 else 0, int(probs[1]))
        if t != 1 and int(max_tx) >= 3:
            enc.put_bit(1 if t != 2 else 0, int(probs[2]))


def read_tx_size_coded(dec, fc, mig: ModeInfoGrid, mi_row: int, mi_col: int,
                       bsize: BlockSize) -> TxSize:
    max_tx = T.MAX_TX_SIZE[BlockSize(bsize)]
    ctx = tx_size_ctx(mig, mi_row, mi_col, bsize)
    probs = tx_probs_row(fc, max_tx, ctx)
    t = dec.read_bit(int(probs[0]))
    if t != 0 and int(max_tx) >= 2:
        t += dec.read_bit(int(probs[1]))
        if t != 1 and int(max_tx) >= 3:
            t += dec.read_bit(int(probs[2]))
    return TxSize(t)


def skip_ctx(mig: ModeInfoGrid, mi_row: int, mi_col: int) -> int:
    a = mig.above(mi_row, mi_col)
    l = mig.left(mi_row, mi_col)
    return (1 if (a is not None and a.skip) else 0) + (
        1 if (l is not None and l.skip) else 0)


def _neighbor_sub_mode(mi: ModeInfo, idx: int) -> IntraMode:
    if mi.bsize < BlockSize.BLOCK_8X8 and mi.sub_modes:
        return IntraMode(mi.sub_modes[idx])
    return IntraMode(mi.y_mode)


def kf_above_mode(mig: ModeInfoGrid, mi_row: int, mi_col: int) -> IntraMode:
    a = mig.above(mi_row, mi_col)
    return _neighbor_sub_mode(a, 2) if a is not None else IntraMode.DC_PRED


def kf_left_mode(mig: ModeInfoGrid, mi_row: int, mi_col: int) -> IntraMode:
    l = mig.left(mi_row, mi_col)
    return _neighbor_sub_mode(l, 1) if l is not None else IntraMode.DC_PRED


def partition_rule(bsize: BlockSize, mi_row: int, mi_col: int,
                   mi_rows: int, mi_cols: int):
    """(has_rows, has_cols) for reading/writing a partition at a node."""
    bw = 1 << MI_WIDTH_LOG2[BlockSize(bsize)]
    half = bw >> 1
    has_rows = (mi_row + half) < mi_rows
    has_cols = (mi_col + half) < mi_cols
    return has_rows, has_cols


def write_partition(enc, probs_row, partition: Partition,
                    has_rows: bool, has_cols: bool) -> None:
    if has_rows and has_cols:
        T.write_token(enc, "partition_tree", probs_row, int(partition))
    elif has_cols:  # !has_rows
        assert partition in (Partition.SPLIT, Partition.HORZ)
        enc.put_bit(1 if partition == Partition.SPLIT else 0, int(probs_row[1]))
    elif has_rows:  # !has_cols
        assert partition in (Partition.SPLIT, Partition.VERT)
        enc.put_bit(1 if partition == Partition.SPLIT else 0, int(probs_row[2]))
    else:
        assert partition == Partition.SPLIT


def read_partition(dec, probs_row, has_rows: bool, has_cols: bool) -> Partition:
    if has_rows and has_cols:
        return Partition(T.read_token(dec, "partition_tree", probs_row))
    if has_cols:
        return Partition.SPLIT if dec.read_bit(int(probs_row[1])) else Partition.HORZ
    if has_rows:
        return Partition.SPLIT if dec.read_bit(int(probs_row[2])) else Partition.VERT
    return Partition.SPLIT
