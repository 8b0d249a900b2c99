"""VP9 frame header serialization.

Layout follows the VP9 bitstream spec (uncompressed header, compressed
header, tile data); behavioral parity with the reference writer
``vp9_bitstream.c:1186`` (``write_uncompressed_header``), ``:1293``
(``write_compressed_header``) and ``:1369`` (``eb_vp9_pack_bitstream``) in
SVT-VP9's vendored libvpx — written fresh against the spec.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tpu_vp9_torch.bitstream import tables as T
from tpu_vp9_torch.bitstream.bool_coder import BoolEncoder

VP9_FRAME_MARKER = 2
SYNC_CODE = (0x49, 0x83, 0x42)
DIFF_UPDATE_PROB = 252
MV_UPDATE_PROB = 252
REF_FRAMES = 8


class BitWriter:
    """MSB-first raw bit writer (spec: uncompressed header f(n) syntax)."""

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._nbits = 0

    def bit(self, b: int) -> None:
        byte_idx = self._nbits >> 3
        if byte_idx >= len(self._bytes):
            self._bytes.append(0)
        if b:
            self._bytes[byte_idx] |= 0x80 >> (self._nbits & 7)
        self._nbits += 1

    def literal(self, value: int, bits: int) -> None:
        for i in range(bits - 1, -1, -1):
            self.bit((value >> i) & 1)

    def signed_literal(self, value: int, bits: int) -> None:
        self.literal(abs(value), bits)
        self.bit(1 if value < 0 else 0)

    def bytes_written(self) -> int:
        return (self._nbits + 7) >> 3

    def data(self) -> bytes:
        return bytes(self._bytes)

    def patch_literal(self, bit_offset: int, value: int, bits: int) -> None:
        """Overwrite `bits` bits starting at `bit_offset`."""
        for i in range(bits):
            pos = bit_offset + i
            b = (value >> (bits - 1 - i)) & 1
            byte_idx = pos >> 3
            mask = 0x80 >> (pos & 7)
            if b:
                self._bytes[byte_idx] |= mask
            else:
                self._bytes[byte_idx] &= ~mask

    @property
    def bit_pos(self) -> int:
        return self._nbits


class BitReader:
    """MSB-first raw bit reader (decoder oracle side)."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0

    def bit(self) -> int:
        byte = self._data[self._pos >> 3]
        b = (byte >> (7 - (self._pos & 7))) & 1
        self._pos += 1
        return b

    def literal(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            v = (v << 1) | self.bit()
        return v

    def signed_literal(self, bits: int) -> int:
        v = self.literal(bits)
        return -v if self.bit() else v

    def bytes_read(self) -> int:
        return (self._pos + 7) >> 3


@dataclass
class LoopFilterParams:
    filter_level: int = 0
    sharpness_level: int = 0
    mode_ref_delta_enabled: bool = True
    mode_ref_delta_update: bool = False
    ref_deltas: tuple = (1, 0, -1, -1)  # intra, last, golden, altref (spec defaults)
    mode_deltas: tuple = (0, 0)


@dataclass
class FrameHeader:
    """All uncompressed-header state for one frame."""

    width: int = 0
    height: int = 0
    is_keyframe: bool = True
    show_frame: bool = True
    error_resilient: bool = False
    intra_only: bool = False
    reset_frame_context: int = 0
    refresh_frame_mask: int = 0xFF
    ref_dpb_index: tuple = (0, 0, 0)  # LAST, GOLDEN, ALTREF dpb slots
    ref_sign_bias: tuple = (0, 0, 0)
    allow_high_precision_mv: bool = False
    interp_filter: T.InterpFilter = T.InterpFilter.EIGHTTAP
    refresh_frame_context: bool = True
    frame_parallel_decoding_mode: bool = True
    frame_context_idx: int = 0
    loop_filter: LoopFilterParams = field(default_factory=LoopFilterParams)
    base_qindex: int = 100
    y_dc_delta_q: int = 0
    uv_dc_delta_q: int = 0
    uv_ac_delta_q: int = 0
    log2_tile_cols: int = 0
    log2_tile_rows: int = 0
    color_space: int = 2  # CS_BT_601 (unknown=0, bt601=2)
    color_range: int = 0
    tx_mode: T.TxMode = T.TxMode.ALLOW_32X32
    show_existing_frame: bool = False
    show_existing_frame_index: int = 0
    # 0=SINGLE_REFERENCE, 1=COMPOUND_REFERENCE, 2=REFERENCE_MODE_SELECT;
    # only meaningful when compound is allowed (sign biases differ)
    reference_mode: int = 0

    def compound_allowed(self) -> bool:
        # setup_past_independence (spec 7.2 / vp9_entropymode.c) zeroes
        # ref_frame_sign_bias for every error-resilient frame AFTER the
        # biases are parsed, so compound prediction is normatively
        # impossible when error_resilient — the decoder reads no
        # reference_mode bits in that case.
        if self.error_resilient:
            return False
        return len(set(self.ref_sign_bias)) > 1

    @property
    def mi_cols(self) -> int:
        return (self.width + 7) >> 3

    @property
    def mi_rows(self) -> int:
        return (self.height + 7) >> 3

    @property
    def sb_cols(self) -> int:
        return (self.mi_cols + 7) >> 3

    @property
    def sb_rows(self) -> int:
        return (self.mi_rows + 7) >> 3

    def lossless(self) -> bool:
        return (
            self.base_qindex == 0
            and self.y_dc_delta_q == 0
            and self.uv_dc_delta_q == 0
            and self.uv_ac_delta_q == 0
        )


def tile_log2_limits(mi_cols: int) -> tuple:
    """min/max log2 tile columns (spec 6.2.14; ref eb_vp9_get_tile_n_bits)."""
    sb_cols = (mi_cols + 7) >> 3
    min_log2 = 0
    while (64 << min_log2) < sb_cols:  # MAX_TILE_WIDTH_B64 = 64
        min_log2 += 1
    max_log2 = 0
    while (sb_cols >> (max_log2 + 1)) >= 4:  # MIN_TILE_WIDTH_B64 = 4
        max_log2 += 1
    return min_log2, max_log2


def _write_delta_q(wb: BitWriter, delta: int) -> None:
    if delta:
        wb.bit(1)
        wb.literal(abs(delta), 4)
        wb.bit(1 if delta < 0 else 0)
    else:
        wb.bit(0)


def write_uncompressed_header(h: FrameHeader) -> BitWriter:
    wb = BitWriter()
    wb.literal(VP9_FRAME_MARKER, 2)
    # profile 0: two zero bits
    wb.bit(0)
    wb.bit(0)
    wb.bit(1 if h.show_existing_frame else 0)
    if h.show_existing_frame:
        wb.literal(h.show_existing_frame_index, 3)
        return wb
    wb.bit(0 if h.is_keyframe else 1)  # frame_type: 0 = KEY_FRAME
    wb.bit(1 if h.show_frame else 0)
    wb.bit(1 if h.error_resilient else 0)

    def sync_code():
        for b in SYNC_CODE:
            wb.literal(b, 8)

    def colorspace():
        wb.literal(h.color_space, 3)
        wb.bit(h.color_range)  # not SRGB for profile 0

    def frame_size():
        wb.literal(h.width - 1, 16)
        wb.literal(h.height - 1, 16)
        wb.bit(0)  # render size == frame size

    if h.is_keyframe:
        sync_code()
        colorspace()
        frame_size()
    else:
        if not h.show_frame:
            wb.bit(1 if h.intra_only else 0)
        if not h.error_resilient:
            wb.literal(h.reset_frame_context, 2)
        if h.intra_only:
            sync_code()
            wb.literal(h.refresh_frame_mask, REF_FRAMES)
            frame_size()
        else:
            wb.literal(h.refresh_frame_mask, REF_FRAMES)
            for i in range(3):
                wb.literal(h.ref_dpb_index[i], 3)
                wb.bit(h.ref_sign_bias[i])
            # frame_size_with_refs: size not inherited from any ref
            for _ in range(3):
                wb.bit(0)
            wb.literal(h.width - 1, 16)
            wb.literal(h.height - 1, 16)
            wb.bit(0)  # render size == frame size
            wb.bit(1 if h.allow_high_precision_mv else 0)
            # interp filter: spec literal order {EIGHTTAP_SMOOTH, EIGHTTAP,
            # EIGHTTAP_SHARP, BILINEAR} -> filter_to_literal
            filt = h.interp_filter
            wb.bit(1 if filt == T.InterpFilter.SWITCHABLE else 0)
            if filt != T.InterpFilter.SWITCHABLE:
                wb.literal({0: 1, 1: 0, 2: 2, 3: 3}[int(filt)], 2)

    if not h.error_resilient:
        wb.bit(1 if h.refresh_frame_context else 0)
        wb.bit(1 if h.frame_parallel_decoding_mode else 0)
    wb.literal(h.frame_context_idx, 2)

    # loop filter
    lf = h.loop_filter
    wb.literal(lf.filter_level, 6)
    wb.literal(lf.sharpness_level, 3)
    wb.bit(1 if lf.mode_ref_delta_enabled else 0)
    if lf.mode_ref_delta_enabled:
        wb.bit(1 if lf.mode_ref_delta_update else 0)
        if lf.mode_ref_delta_update:
            for d in lf.ref_deltas:
                wb.bit(1)
                wb.signed_literal(d, 6)
            for d in lf.mode_deltas:
                wb.bit(1)
                wb.signed_literal(d, 6)

    # quantization
    wb.literal(h.base_qindex, 8)
    _write_delta_q(wb, h.y_dc_delta_q)
    _write_delta_q(wb, h.uv_dc_delta_q)
    _write_delta_q(wb, h.uv_ac_delta_q)

    # segmentation: disabled
    wb.bit(0)

    # tile info
    min_log2, max_log2 = tile_log2_limits(h.mi_cols)
    assert min_log2 <= h.log2_tile_cols <= max_log2, (
        h.log2_tile_cols, min_log2, max_log2)
    for _ in range(h.log2_tile_cols - min_log2):
        wb.bit(1)
    if h.log2_tile_cols < max_log2:
        wb.bit(0)
    wb.bit(1 if h.log2_tile_rows else 0)
    if h.log2_tile_rows:
        wb.bit(1 if h.log2_tile_rows != 1 else 0)
    return wb


def _cond_no_update(enc: BoolEncoder, n: int, prob: int = DIFF_UPDATE_PROB) -> None:
    for _ in range(n):
        enc.put_bit(0, prob)


def write_compressed_header(h: FrameHeader, updates=None) -> bytes:
    """Compressed header, optionally carrying forward probability updates.

    updates: None (no updates) or a dict with keys
      "coef": {TxSize: (old_probs, new_probs, do_flag)}
      "skip": (old, new) arrays
    Layout per spec 6.3 / reference write_compressed_header.
    """
    from tpu_vp9_torch.bitstream.prob_update import (
        write_binary_updates, write_coef_updates,
    )

    enc = BoolEncoder()
    # --- tx mode (encode_txfm_probs, vp9_bitstream.c:806) ---
    if h.lossless():
        tx_mode = T.TxMode.ONLY_4X4
    else:
        tx_mode = h.tx_mode
        enc.put_literal(min(int(tx_mode), 3), 2)
        if int(tx_mode) >= int(T.TxMode.ALLOW_32X32):
            enc.put_bit(1 if tx_mode == T.TxMode.TX_MODE_SELECT else 0, 128)
        if tx_mode == T.TxMode.TX_MODE_SELECT:
            _cond_no_update(enc, 2 * 1)  # p8x8: 2 ctx x 1 node
            _cond_no_update(enc, 2 * 2)  # p16x16
            _cond_no_update(enc, 2 * 3)  # p32x32
    # --- coef prob updates per coded tx size ---
    max_tx = {
        T.TxMode.ONLY_4X4: 0,
        T.TxMode.ALLOW_8X8: 1,
        T.TxMode.ALLOW_16X16: 2,
        T.TxMode.ALLOW_32X32: 3,
        T.TxMode.TX_MODE_SELECT: 3,
    }[T.TxMode(tx_mode)]
    coef_updates = (updates or {}).get("coef")
    for ts in list(T.TxSize)[: max_tx + 1]:
        if coef_updates and ts in coef_updates:
            old, new, flag = coef_updates[ts]
            write_coef_updates(enc, old, new, flag)
        else:
            enc.put_bit(0, 128)
    # --- skip probs ---
    skip_upd = (updates or {}).get("skip")
    if skip_upd is not None:
        write_binary_updates(enc, skip_upd[0], skip_upd[1])
    else:
        _cond_no_update(enc, 3)

    if not (h.is_keyframe or h.intra_only):
        _cond_no_update(enc, 7 * 3)  # inter mode probs
        if h.interp_filter == T.InterpFilter.SWITCHABLE:
            _cond_no_update(enc, 4 * 2)
        _cond_no_update(enc, 4)  # intra_inter
        # frame reference mode (spec 6.3.12): only coded when compound is
        # possible (differing sign biases); otherwise SINGLE implied
        if h.compound_allowed():
            enc.put_bit(1 if h.reference_mode != 0 else 0, 128)
            if h.reference_mode != 0:
                enc.put_bit(1 if h.reference_mode == 2 else 0, 128)
        if h.reference_mode == 2:
            _cond_no_update(enc, 5)  # comp_inter probs
        if h.reference_mode != 1:
            _cond_no_update(enc, 5 * 2)  # single_ref probs
        if h.reference_mode != 0:
            _cond_no_update(enc, 5)  # comp_ref probs
        _cond_no_update(enc, 4 * 9)  # y mode probs
        _cond_no_update(enc, 16 * 3)  # partition probs
        # mv probs (write_nmv_probs): joints + per-component
        _cond_no_update(enc, 3, MV_UPDATE_PROB)
        for _ in range(2):
            _cond_no_update(enc, 1 + 10 + 1 + 10, MV_UPDATE_PROB)
        for _ in range(2):
            _cond_no_update(enc, 2 * 3 + 3, MV_UPDATE_PROB)
        if h.allow_high_precision_mv:
            for _ in range(2):
                _cond_no_update(enc, 2, MV_UPDATE_PROB)
    return enc.finalize()


def assemble_frame(h: FrameHeader, tile_data: bytes, updates=None) -> bytes:
    """Uncompressed header | first_part_size(16) | compressed hdr | tiles."""
    wb = write_uncompressed_header(h)
    if h.show_existing_frame:
        return wb.data()
    size_bit_pos = wb.bit_pos
    wb.literal(0, 16)  # placeholder for first partition size
    compressed = write_compressed_header(h, updates)
    assert len(compressed) <= 0xFFFF
    wb.patch_literal(size_bit_pos, len(compressed), 16)
    return wb.data() + compressed + tile_data


def split_superframe(payload: bytes) -> list:
    """Split a packet into frame payloads (spec annex B).

    Returns [payload] unchanged when no valid superframe index trails the
    packet. Inverse of build_superframe.
    """
    if not payload:
        return [payload]
    marker = payload[-1]
    if (marker & 0xE0) != 0xC0:
        return [payload]
    n_frames = (marker & 0x7) + 1
    bytes_per_size = ((marker >> 3) & 0x3) + 1
    index_len = 2 + n_frames * bytes_per_size
    if len(payload) < index_len or payload[-index_len] != marker:
        return [payload]
    idx = payload[-index_len + 1 : -1]
    sizes = []
    for f in range(n_frames):
        s = 0
        for i in range(bytes_per_size):
            s |= idx[f * bytes_per_size + i] << (8 * i)
        sizes.append(s)
    if sum(sizes) != len(payload) - index_len:
        return [payload]
    out, pos = [], 0
    for s in sizes:
        out.append(payload[pos : pos + s])
        pos += s
    return out


def build_superframe(frames: list) -> bytes:
    """Pack multiple frame payloads into a VP9 superframe (spec annex B)."""
    if len(frames) == 1:
        return frames[0]
    sizes = [len(f) for f in frames]
    bytes_per_size = max(1, (max(sizes).bit_length() + 7) // 8)
    marker = 0xC0 | ((bytes_per_size - 1) << 3) | (len(frames) - 1)
    index = bytearray([marker])
    for s in sizes:
        for i in range(bytes_per_size):
            index.append((s >> (8 * i)) & 0xFF)
    index.append(marker)
    return b"".join(frames) + bytes(index)
