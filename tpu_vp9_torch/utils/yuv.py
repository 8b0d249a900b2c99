"""Raw YUV / Y4M readers and writers (8-bit 4:2:0).

Capability parity with the reference app's input path
(``Source/App/EbAppProcessCmd.c:231`` ``read_input_frames`` — raw YUV and
Y4M incl. stdin pipes) — re-implemented for numpy frames.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import BinaryIO, Iterator, Optional

import numpy as np


@dataclass
class Frame420:
    """One 8-bit 4:2:0 picture as planar numpy arrays."""

    y: np.ndarray  # (H, W) uint8
    u: np.ndarray  # (H//2, W//2) uint8
    v: np.ndarray  # (H//2, W//2) uint8

    @property
    def width(self) -> int:
        return self.y.shape[1]

    @property
    def height(self) -> int:
        return self.y.shape[0]


def frame_size_420(width: int, height: int) -> int:
    return width * height + 2 * ((width + 1) // 2) * ((height + 1) // 2)


def read_yuv_frames(
    fh: BinaryIO, width: int, height: int, max_frames: Optional[int] = None
) -> Iterator[Frame420]:
    """Iterate frames from a raw planar I420 stream."""
    cw, ch = (width + 1) // 2, (height + 1) // 2
    ysize, csize = width * height, cw * ch
    n = 0
    while max_frames is None or n < max_frames:
        data = fh.read(ysize + 2 * csize)
        if len(data) < ysize + 2 * csize:
            return
        y = np.frombuffer(data, dtype=np.uint8, count=ysize).reshape(height, width)
        u = np.frombuffer(data, dtype=np.uint8, count=csize, offset=ysize).reshape(ch, cw)
        v = np.frombuffer(data, dtype=np.uint8, count=csize, offset=ysize + csize).reshape(ch, cw)
        yield Frame420(y=y.copy(), u=u.copy(), v=v.copy())
        n += 1


@dataclass
class Y4MHeader:
    width: int
    height: int
    fps_num: int
    fps_den: int


def parse_y4m_header(line: bytes) -> Y4MHeader:
    if not line.startswith(b"YUV4MPEG2"):
        raise ValueError("not a y4m stream")
    width = height = None
    fps_num, fps_den = 30, 1
    for tok in line.split()[1:]:
        tag, val = tok[:1], tok[1:].decode()
        if tag == b"W":
            width = int(val)
        elif tag == b"H":
            height = int(val)
        elif tag == b"F":
            m = re.match(r"(\d+):(\d+)", val)
            if m:
                fps_num, fps_den = int(m.group(1)), int(m.group(2))
        elif tag == b"C":
            if not val.startswith("420"):
                raise ValueError(f"unsupported y4m chroma format: {val}")
    if width is None or height is None:
        raise ValueError("y4m header missing dimensions")
    return Y4MHeader(width=width, height=height, fps_num=fps_num, fps_den=fps_den)


def read_y4m(fh: BinaryIO, max_frames: Optional[int] = None):
    """Return (header, frame iterator) for a Y4M stream."""
    line = bytearray()
    while True:
        c = fh.read(1)
        if not c or c == b"\n":
            break
        line.extend(c)
    header = parse_y4m_header(bytes(line))

    def frames() -> Iterator[Frame420]:
        n = 0
        while max_frames is None or n < max_frames:
            fline = bytearray()
            while True:
                c = fh.read(1)
                if not c:
                    return
                if c == b"\n":
                    break
                fline.extend(c)
            if not bytes(fline).startswith(b"FRAME"):
                raise ValueError(f"bad y4m frame marker: {bytes(fline)!r}")
            gen = read_yuv_frames(fh, header.width, header.height, max_frames=1)
            frame = next(gen, None)
            if frame is None:
                return
            yield frame
            n += 1

    return header, frames()


def write_y4m(fh: BinaryIO, frames, fps_num: int = 30, fps_den: int = 1) -> None:
    first = True
    for frame in frames:
        if first:
            fh.write(
                f"YUV4MPEG2 W{frame.width} H{frame.height} "
                f"F{fps_num}:{fps_den} Ip A1:1 C420jpeg\n".encode()
            )
            first = False
        fh.write(b"FRAME\n")
        fh.write(frame.y.tobytes())
        fh.write(frame.u.tobytes())
        fh.write(frame.v.tobytes())


def synthetic_frames(
    width: int, height: int, num_frames: int, seed: int = 0, motion: bool = True
) -> Iterator[Frame420]:
    """Deterministic synthetic test content: textured gradient + moving box.

    Used by the test-suite and bench in lieu of fetching clips (zero-egress
    environment); mirrors the role of akiyo_cif in the reference CI.
    """
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 40, size=(height, width), dtype=np.uint8)
    yy, xx = np.mgrid[0:height, 0:width]
    grad = ((xx * 255) // max(width - 1, 1)).astype(np.uint8)
    cw, ch = (width + 1) // 2, (height + 1) // 2
    cu = ((np.mgrid[0:ch, 0:cw][1] * 200) // max(cw - 1, 1) + 28).astype(np.uint8)
    cv = ((np.mgrid[0:ch, 0:cw][0] * 200) // max(ch - 1, 1) + 28).astype(np.uint8)
    bw, bh = max(width // 8, 8), max(height // 8, 8)
    for t in range(num_frames):
        y = (base.astype(np.int32) + grad) // 2
        if motion:
            bx = (7 * t) % max(width - bw, 1)
            by = (3 * t) % max(height - bh, 1)
            y[by : by + bh, bx : bx + bw] = 220
        yield Frame420(
            y=np.clip(y, 0, 255).astype(np.uint8), u=cu.copy(), v=cv.copy()
        )


def load_frames(path: str, width: int = 0, height: int = 0, max_frames=None):
    """Load frames from .y4m or raw .yuv. Returns (W, H, fps, list[Frame420])."""
    if path.endswith(".y4m"):
        with open(path, "rb") as fh:
            header, it = read_y4m(fh, max_frames=max_frames)
            frames = list(it)
        return header.width, header.height, (header.fps_num, header.fps_den), frames
    if width <= 0 or height <= 0:
        raise ValueError("raw YUV input requires width/height")
    with open(path, "rb") as fh:
        frames = list(read_yuv_frames(fh, width, height, max_frames=max_frames))
    return width, height, (30, 1), frames


# ---------------------------------------------------------------------------
# Test content with global motion (the port's addition)
#
# ``synthetic_frames`` moves one flat box over a static background, so most
# full-pel vectors are zero. A pan moves every block: the motion search has
# a nonzero answer everywhere.
# ---------------------------------------------------------------------------


def _box(a: np.ndarray, k: int) -> np.ndarray:
    """k x k box sums; the result is k pixels smaller on each axis."""
    c = np.cumsum(np.cumsum(a, axis=0), axis=1)
    return c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]


def _texture(h: int, w: int, rng, lo: int, hi: int) -> np.ndarray:
    """Smooth random texture in [lo, hi]: uniform noise through two
    15x15 box blurs (about a tent of 30 pixels)."""
    k = 15
    box = _box(_box(rng.random((h + 2 * k, w + 2 * k)), k), k)
    box = (box - box.min()) / max(box.max() - box.min(), 1e-9)
    return (lo + box[:h, :w] * (hi - lo)).astype(np.uint8)


def panning_frames(width: int, height: int, num_frames: int, seed: int = 0,
                   step=(2, 4)):
    """Frames cut from one textured canvas that pans by ``step`` = (dy, dx)
    luma pixels per frame (even, so chroma pans by whole pixels too)."""
    sy, sx = step
    if sy % 2 or sx % 2:
        raise ValueError(f"pan step {step} must be even")
    rng = np.random.default_rng(seed)
    span_y, span_x = abs(sy) * num_frames, abs(sx) * num_frames
    ch, cw = (height + 1) // 2, (width + 1) // 2
    y = _texture(height + span_y, width + span_x, rng, 16, 235)
    u = _texture(ch + span_y // 2, cw + span_x // 2, rng, 64, 192)
    v = _texture(ch + span_y // 2, cw + span_x // 2, rng, 64, 192)
    oy = span_y if sy > 0 else 0
    ox = span_x if sx > 0 else 0
    for t in range(num_frames):
        y0, x0 = oy - sy * t, ox - sx * t
        yield Frame420(
            y=y[y0:y0 + height, x0:x0 + width].copy(),
            u=u[y0 // 2:y0 // 2 + ch, x0 // 2:x0 // 2 + cw].copy(),
            v=v[y0 // 2:y0 // 2 + ch, x0 // 2:x0 // 2 + cw].copy())
