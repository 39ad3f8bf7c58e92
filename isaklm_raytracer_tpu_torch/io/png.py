"""Image I/O: PNG output of renders, texture decoding.

Port of ``isaklm_raytracer_tpu/io/png.py``. ``save_png`` replaces the
reference's lodepng output (save_render.cuh:18-23, 41-66): a pure-Python
encoder with the same vertical flip as the reference. ``load_image``
replaces its stb_image texture decode (scene.cuh:25-63): PIL when it
imports, else the built-in PNG decoder ``_decode_png``.
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


def load_image(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 4) uint8 RGBA.

    Equivalent of make_texture's stbi_load + RGBA repack (scene.cuh:25-63).
    Uses PIL when available, else the built-in PNG decoder.
    """
    try:
        from PIL import Image
    except ImportError:
        return _decode_png(path)
    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), np.uint8)


def _unfilter_sequential(filter_type: int, line: list, prev: list, channels: int) -> None:
    """Undo PNG filter 3 (average) or 4 (Paeth) in place, byte by byte:
    each byte depends on the byte ``channels`` to its left after its own
    decode."""
    for i in range(len(line)):
        a = line[i - channels] if i >= channels else 0
        b = prev[i]
        if filter_type == 3:
            pred = (a + b) >> 1
        else:
            c = prev[i - channels] if i >= channels else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def _decode_png(path: str) -> np.ndarray:
    """Minimal PNG decoder (8-bit RGB/RGBA/gray, non-interlaced).

    The JAX package's decoder, byte for byte. Filter 1 (sub) is a running
    sum mod 256 per channel, taken by ``np.cumsum`` in uint8; filters 3
    and 4 run their byte loop over Python ints."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = b""
    width = height = bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            width, height, bit_depth, color_type = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    if bit_depth != 8:
        raise ValueError(f"{path}: unsupported bit depth {bit_depth}")
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = width * channels
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for row in range(height):
        filter_type = raw[pos]
        line = np.frombuffer(raw[pos + 1 : pos + 1 + stride], np.uint8).copy()
        pos += 1 + stride
        if filter_type == 1:
            line = np.cumsum(line.reshape(width, channels), axis=0, dtype=np.uint8).reshape(-1)
        elif filter_type == 2:
            line = line + prev  # uint8: wraps mod 256
        elif filter_type in (3, 4):
            values = line.tolist()
            _unfilter_sequential(filter_type, values, prev.tolist(), channels)
            line = np.asarray(values, np.uint8)
        out[row] = line
        prev = line
    img = out.reshape(height, width, channels)
    if channels == 1:
        img = np.repeat(img, 3, axis=-1)
        channels = 3
    if channels == 2:
        rgb = np.repeat(img[..., :1], 3, axis=-1)
        img = np.concatenate([rgb, img[..., 1:]], axis=-1)
        channels = 4
    if channels == 3:
        img = np.concatenate(
            [img, np.full((height, width, 1), 255, np.uint8)], axis=-1
        )
    return img
