"""VP9 boolean (arithmetic range) coder — pure-Python reference.

Semantics follow the VP9 specification (and the WebM libvpx realization the
reference vendors at ``Source/Lib/VPX/bitwriter.{c,h}``):

* probabilities are 8-bit, ``p`` = probability that the *zero* branch is
  taken, out of 256; ``split = 1 + (((range - 1) * p) >> 8)``;
* each bool partition starts with one *clear bit* (must encode/decode 0);
* the encoder flushes 32 zero bits at the end and appends a ``0x00`` byte
  if the final byte could collide with a superframe marker
  (``(last & 0xe0) == 0xc0``).

This module is the correctness oracle; the hot path used for real encodes
is the C++ implementation in ``native/`` (same byte-exact output, exercised
against this one in tests).
"""

from __future__ import annotations

import numpy as np

__all__ = ["BoolEncoder", "BoolDecoder", "encode_bools", "NORM"]


def _build_norm() -> np.ndarray:
    """norm[r] = number of left-shifts that bring r (1..255) to >= 128."""
    norm = np.zeros(256, dtype=np.uint8)
    for r in range(1, 256):
        s = 0
        v = r
        while v < 128:
            v <<= 1
            s += 1
        norm[r] = s
    return norm


NORM = _build_norm()


class BoolEncoder:
    """Boolean range encoder producing a VP9 bool partition."""

    def __init__(self) -> None:
        self._low = 0
        self._range = 255
        self._count = -24
        self._buf = bytearray()
        # Clear bit: guarantees the first byte of the partition is < 0x80.
        self.put_bit(0, 128)

    def put_bit(self, bit: int, prob: int) -> None:
        """Encode one boolean with P(bit == 0) = prob/256."""
        rng = self._range
        low = self._low
        count = self._count

        split = 1 + (((rng - 1) * prob) >> 8)
        if bit:
            low += split
            rng -= split
        else:
            rng = split

        shift = int(NORM[rng])
        rng <<= shift
        count += shift

        if count >= 0:
            offset = shift - count
            if (low << (offset - 1)) & 0x80000000:
                # Carry: propagate through any 0xff run.
                x = len(self._buf) - 1
                while x >= 0 and self._buf[x] == 0xFF:
                    self._buf[x] = 0
                    x -= 1
                if x >= 0:
                    self._buf[x] += 1
            self._buf.append((low >> (24 - offset)) & 0xFF)
            low = (low << offset) & 0xFFFFFF
            shift = count
            count -= 8

        self._low = (low << shift) & 0xFFFFFFFF
        self._range = rng
        self._count = count

    def put_literal(self, value: int, bits: int) -> None:
        """Encode a fixed-width unsigned literal, MSB first, p=1/2 each."""
        for b in range(bits - 1, -1, -1):
            self.put_bit((value >> b) & 1, 128)

    def put_tree(self, tree, probs, value_bits, num_bits: int) -> None:
        """Encode a token given its tree path (list of (bit, prob_index))."""
        for i in range(num_bits):
            self.put_bit(value_bits[i], probs[tree[i]])

    def finalize(self) -> bytes:
        """Flush and return the partition bytes."""
        for _ in range(32):
            self.put_bit(0, 128)
        # Superframe-marker collision guard.
        if self._buf and (self._buf[-1] & 0xE0) == 0xC0:
            self._buf.append(0)
        if not self._buf:
            self._buf.append(0)
        return bytes(self._buf)

    def __len__(self) -> int:
        return len(self._buf)


class BoolDecoder:
    """Boolean range decoder (byte-wise window formulation from the spec)."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 2
        b0 = data[0] if len(data) > 0 else 0
        b1 = data[1] if len(data) > 1 else 0
        self._value = (b0 << 8) | b1
        self._range = 255
        self._bit_count = 0
        # Clear bit must be zero per spec.
        marker = self.read_bit(128)
        if marker != 0:
            raise ValueError("bool partition clear bit is not zero")

    def read_bit(self, prob: int) -> int:
        split = 1 + (((self._range - 1) * prob) >> 8)
        big = split << 8
        if self._value >= big:
            bit = 1
            self._range -= split
            self._value -= big
        else:
            bit = 0
            self._range = split
        while self._range < 128:
            self._value = (self._value << 1) & 0xFFFFFFFF
            self._range <<= 1
            self._bit_count += 1
            if self._bit_count == 8:
                self._bit_count = 0
                nxt = self._data[self._pos] if self._pos < len(self._data) else 0
                self._pos += 1
                self._value |= nxt
        return bit

    def read_literal(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            v = (v << 1) | self.read_bit(128)
        return v

    def read_tree(self, tree, probs) -> int:
        """Decode a token from a VP9-style tree.

        ``tree`` is a flat int array: at index i, tree[i + bit] is either a
        negative value (-token, leaf) or the next index. Starts at 0.
        """
        i = 0
        while True:
            bit = self.read_bit(probs[i >> 1])
            node = tree[i + bit]
            if node <= 0:
                return -node
            i = node

    def exhausted(self) -> bool:
        return self._pos > len(self._data) + 2


def encode_bools(bits: np.ndarray, probs: np.ndarray) -> bytes:
    """Encode parallel arrays of bits and probabilities into one partition."""
    enc = BoolEncoder()
    for bit, p in zip(bits.tolist(), probs.tolist()):
        enc.put_bit(int(bit), int(p))
    return enc.finalize()
