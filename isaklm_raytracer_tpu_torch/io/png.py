"""PNG output of renders.

Port of ``save_png`` of ``isaklm_raytracer_tpu/io/png.py`` (the reference's
lodepng output, save_render.cuh:18-23, 41-66): a pure-Python encoder with
the same vertical flip as the reference. Texture decoding is not ported yet.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _to_u8(image: np.ndarray) -> np.ndarray:
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = (np.clip(image, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return image


def save_png(path: str, image, flip_vertical: bool = True) -> None:
    """Write an (H, W, 3) or (H, W, 4) image ([0,1] float or uint8) as PNG.

    flip_vertical mirrors save_render.cuh:44-61 (the reference framebuffer
    is y-up; PNG rows are top-down). Pure-python encoder (zlib), no external
    deps -- format parity with lodepng's RGBA8 output.
    """
    image = _to_u8(image)
    if image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4) image, got {image.shape}")
    if flip_vertical:
        image = image[::-1]
    h, w, c = image.shape
    color_type = 2 if c == 3 else 6

    raw = b"".join(b"\x00" + image[row].tobytes() for row in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    payload = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    with open(path, "wb") as f:
        f.write(payload)
