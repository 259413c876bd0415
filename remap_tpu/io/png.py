"""PNG output of palette-mapped maps (pngu.hpp's role).

The reference writes RGB8 PNGs via libpng (pngu.hpp:18-105, write-only).
Here: Pillow when available, else a minimal self-contained zlib encoder
(RGB8, no interlace) so the framework has zero hard imaging deps.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from remap_tpu.core import palette


def write_png(path: str, rgb: np.ndarray) -> None:
    """[H, W, 3] uint8 -> PNG file."""
    try:
        from PIL import Image

        Image.fromarray(rgb, mode="RGB").save(path)
        return
    except ImportError:
        pass
    _write_png_zlib(path, rgb)


def _write_png_zlib(path: str, rgb: np.ndarray) -> None:
    h, w, _ = rgb.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = b"".join(
        b"\x00" + rgb[y].tobytes() for y in range(h)
    )  # filter 0 per scanline
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """PNG file -> [H, W, 3] uint8: Pillow when available, else the
    files ``_write_png_zlib`` writes (RGB8, filter 0 on every row)."""
    try:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    except ImportError:
        pass
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
            if (depth, ctype) != (8, 2):
                raise ValueError(f"{path}: not RGB8")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows need Pillow")
    return rows[:, 1:].reshape(h, w, 3).copy()


def write_map(path: str, image: np.ndarray) -> None:
    """Palette-map a native-code image and write it (main.cpp:255-259)."""
    write_png(path, palette.native_to_rgb(image))
