"""IVF container writer/reader for VP9 streams.

Mirrors the capability of the reference app's IVF output
(``Source/App/EbAppProcessCmd.c:515`` ``write_ivf_stream_header`` /
``:546`` frame header) — re-implemented, not ported.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import BinaryIO, Iterator

IVF_SIGNATURE = b"DKIF"
FOURCC_VP9 = b"VP90"


def write_ivf_header(
    fh: BinaryIO,
    width: int,
    height: int,
    fps_num: int,
    fps_den: int,
    num_frames: int = 0,
) -> None:
    fh.write(IVF_SIGNATURE)
    fh.write(struct.pack("<HH", 0, 32))  # version, header size
    fh.write(FOURCC_VP9)
    fh.write(struct.pack("<HH", width, height))
    fh.write(struct.pack("<II", fps_num, fps_den))
    fh.write(struct.pack("<I", num_frames))
    fh.write(struct.pack("<I", 0))  # unused


def write_ivf_frame(fh: BinaryIO, payload: bytes, pts: int) -> None:
    fh.write(struct.pack("<IQ", len(payload), pts))
    fh.write(payload)


def patch_ivf_frame_count(fh: BinaryIO, num_frames: int) -> None:
    pos = fh.tell()
    fh.seek(24)
    fh.write(struct.pack("<I", num_frames))
    fh.seek(pos)


@dataclass
class IvfFrame:
    pts: int
    payload: bytes


def read_ivf(fh: BinaryIO) -> Iterator[IvfFrame]:
    header = fh.read(32)
    if header[:4] != IVF_SIGNATURE:
        raise ValueError("not an IVF file")
    if header[8:12] != FOURCC_VP9:
        raise ValueError(f"not a VP9 IVF stream: fourcc={header[8:12]!r}")
    while True:
        fhdr = fh.read(12)
        if len(fhdr) < 12:
            return
        size, pts = struct.unpack("<IQ", fhdr)
        payload = fh.read(size)
        if len(payload) < size:
            raise ValueError("truncated IVF frame")
        yield IvfFrame(pts=pts, payload=payload)
