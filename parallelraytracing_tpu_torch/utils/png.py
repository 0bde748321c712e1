"""Dependency-free PNG writer (RGBA8 / RGB8).

The reference displays through OpenGL (src/opengl/*); headless TPU boxes
write PNGs instead. Pure stdlib (zlib + struct)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """image: (H,W,3) or (H,W,4) uint8."""
    data = encode_png(image)
    with open(path, "wb") as f:
        f.write(data)


def read_png(path: str) -> np.ndarray:
    """Minimal reader for files produced by write_png (8-bit, no filters
    other than what zlib reproduces; handles filter types 0-4)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of an (H, W, 3 or 4) uint8 image, rows unfiltered."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError("encode_png expects uint8")
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"bad image shape {img.shape}")
    h, w, c = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    header = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw, level))
            + _chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """The image of PNG bytes (8-bit; filter types 0-4), (H, W, C) uint8."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = c = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color_type = struct.unpack(">IIBB", payload[:10])
            assert depth == 8
            c = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + length
    raw = zlib.decompress(idat)
    stride = w * c
    out = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    p = 0
    for y in range(h):
        ft = raw[p]
        row = np.frombuffer(raw[p + 1:p + 1 + stride], dtype=np.uint8).astype(np.int32)
        p += 1 + stride
        if ft == 0:
            rec = row
        elif ft == 2:  # up
            rec = (row + prev) % 256
        else:
            rec = np.zeros(stride, dtype=np.int32)
            for i in range(stride):
                a = rec[i - c] if i >= c else 0
                b = int(prev[i])
                if ft == 1:
                    rec[i] = (row[i] + a) % 256
                elif ft == 3:
                    rec[i] = (row[i] + (a + b) // 2) % 256
                elif ft == 4:
                    cc = int(prev[i - c]) if i >= c else 0
                    pp = a + b - cc
                    pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - cc)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
                    rec[i] = (row[i] + pred) % 256
        out[y] = rec.astype(np.uint8)
        prev = out[y].astype(np.uint8)
    return out.reshape(h, w, c)
