"""Sample-grid PNGs and trajectory GIFs (ccdm_tpu/utils/viz.py: make_grid,
save_image_grid, save_gif).

The grid layout is torchvision.utils.save_image's, in numpy: nrow images a
row, `padding` pixels of `pad_value` around each. Both files are written
with the standard library and numpy, because the card's machine has no
PIL. The PNG: zlib and struct, one IDAT chunk, filter 0 on every row; a PIL
reader decodes it to the same pixels as the JAX package's PIL-written file.
The GIF: GIF89a, one global palette, a NETSCAPE loop block (loop forever),
a delay of 1000 / fps ms a frame (in GIF's 10 ms units), each frame
LZW-coded. Grayscale frames take a palette of the 256 grays, so they are
lossless. PIL quantises RGB frames to an adaptive palette; here they take
the fixed palette of 6 levels a channel (0, 51, ..., 255), nearest level,
so each channel is off by at most 25 of 255 (`GIF_RGB_MAX_ERROR`).
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


GIF_RGB_LEVELS = 6
GIF_RGB_MAX_ERROR = 25  # of 255: half the step of 51 between levels, rounded down


def _lzw(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF's variable-length LZW code of palette indices, packed LSB first
    (codes from min_code_size + 1 to 12 bits; a clear code whenever the
    table nears 4096 entries)."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = n_bits = 0

    def emit(code: int, size: int) -> None:
        nonlocal acc, n_bits
        acc |= code << n_bits
        n_bits += size
        while n_bits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n_bits -= 8

    size, next_code, table = min_code_size + 1, eoi + 1, {}
    emit(clear, size)
    data = indices.reshape(-1).tolist()
    w = data[0]
    for c in data[1:]:
        key = (w << 8) | c
        code = table.get(key)
        if code is not None:
            w = code
            continue
        emit(w, size)
        table[key] = next_code
        next_code += 1
        if next_code > (1 << size) and size < 12:
            size += 1
        if next_code >= 4093:  # reset before the 12-bit table fills
            emit(clear, size)
            size, next_code, table = min_code_size + 1, eoi + 1, {}
        w = c
    emit(w, size)
    emit(eoi, size)
    if n_bits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def _palette_indices(frame: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(palette [256, 3] uint8, indices [H, W] uint8) of a uint8 frame
    [H, W] or [H, W, 1] (the grays, exact) or [H, W, 3] (6 levels a
    channel)."""
    arr = frame[..., 0] if frame.ndim == 3 and frame.shape[-1] == 1 else frame
    if arr.ndim == 2:
        return np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1), arr.astype(np.uint8)
    if arr.shape[-1] != 3:
        raise ValueError(f"a GIF frame takes 1 or 3 channels, got {arr.shape[-1]}")
    step = 255 // (GIF_RGB_LEVELS - 1)
    q = np.rint(arr.astype(np.float64) / step).astype(np.int64)  # per channel 0..5
    levels = np.arange(GIF_RGB_LEVELS) * step
    r, g, b = np.meshgrid(levels, levels, levels, indexing="ij")
    palette = np.zeros((256, 3), np.uint8)
    palette[:GIF_RGB_LEVELS ** 3] = np.stack([r, g, b], -1).reshape(-1, 3)
    idx = (q[..., 0] * GIF_RGB_LEVELS + q[..., 1]) * GIF_RGB_LEVELS + q[..., 2]
    return palette, idx.astype(np.uint8)


def encode_gif(frames: list, delay_ms: int) -> bytes:
    """uint8 frames of one shape, [H, W] / [H, W, 1] or [H, W, 3] -> the
    bytes of an animated GIF89a that loops forever."""
    h, w = frames[0].shape[:2]
    palette = _palette_indices(frames[0])[0]
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), palette.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00"]
    for frame in frames:
        _, idx = _palette_indices(frame)
        out += [b"\x21\xf9\x04\x04" + struct.pack("<H", int(round(delay_ms / 10))) + b"\x00\x00",
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0),
                b"\x08" + _sub_blocks(_lzw(idx))]
    return b"".join(out) + b"\x3b"


def save_gif(frames01: np.ndarray, path: str, nrow: int = 6, padding: int = 1,
             fps: int = 10, stride: int = 1) -> None:
    """An animated GIF of sampling trajectories: frames01 [S, B, H, W, C] in
    [0, 1], every `stride`-th step as one grid frame, 1000 / fps ms each."""
    frames = [(np.clip(make_grid(np.asarray(frames01[s], np.float32), nrow, padding), 0.0, 1.0)
               * 255.0).astype(np.uint8) for s in range(0, len(frames01), stride)]
    with open(path, "wb") as f:
        f.write(encode_gif(frames, int(1000 / fps)))
