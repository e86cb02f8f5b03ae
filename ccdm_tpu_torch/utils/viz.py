"""Sample-grid PNGs (ccdm_tpu/utils/viz.py: make_grid, save_image_grid).

The grid layout is torchvision.utils.save_image's, in numpy: nrow images a
row, `padding` pixels of `pad_value` around each. The PNG is written with
zlib and struct from the standard library (one IDAT chunk, filter 0 on
every row), because the card's machine has no PIL; a PIL reader decodes it
to the same pixels as the JAX package's PIL-written file.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type (L, LA, RGB, RGBA)


def make_grid(images01: np.ndarray, nrow: int = 6, padding: int = 1,
              pad_value: float = 0.0) -> np.ndarray:
    """images01 [N, H, W, C] floats in [0, 1] -> [GH, GW, C] grid in [0, 1]."""
    n, h, w, c = images01.shape
    nrows = (n + nrow - 1) // nrow
    grid = np.full((nrows * (h + padding) + padding, nrow * (w + padding) + padding, c),
                   pad_value, dtype=np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y0, x0 = padding + r * (h + padding), padding + col * (w + padding)
        grid[y0:y0 + h, x0:x0 + w] = images01[i]
    return grid


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray) -> bytes:
    """uint8 [H, W] or [H, W, C] (C in 1-4) -> the bytes of an 8-bit PNG."""
    if pixels.dtype != np.uint8:
        raise TypeError(f"a PNG takes uint8 pixels, got {pixels.dtype}")
    arr = pixels[..., None] if pixels.ndim == 2 else pixels
    h, w, c = arr.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"a PNG takes 1 to 4 channels, got {c}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_image_grid(images01: np.ndarray, path: str, nrow: int = 6, padding: int = 1) -> None:
    """The grid of images01 [N, H, W, C] in [0, 1] as a PNG at `path`."""
    grid = make_grid(np.asarray(images01, dtype=np.float32), nrow, padding)
    with open(path, "wb") as f:
        f.write(encode_png((np.clip(grid, 0.0, 1.0) * 255.0).astype(np.uint8)))
