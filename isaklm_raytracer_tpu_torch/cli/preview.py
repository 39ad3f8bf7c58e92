"""Terminal progressive-preview backend.

Port of ``isaklm_raytracer_tpu/cli/preview.py``. The reference displays the
tonemapped running average in a GLFW window every frame and restarts
accumulation on keyboard input (main.cu:62-94, 114-155; camera_movement,
camera.cuh:28-100). Here the surface is the terminal: each frame of the
``viewer.InteractiveSession`` is drawn with 24-bit ANSI half-block cells
(one glyph = two vertically stacked pixels), and WASD/arrow keys drive the
same camera semantics, resetting accumulation exactly like the reference.

Pure host-side presentation: the image is already tonemapped on the device
by ``resolve_image``; this module only downsamples and escapes it.
"""

from __future__ import annotations

import os
import select
import shutil
import sys
from typing import Optional

import numpy as np

# Upper half block: foreground colors the TOP pixel, background the BOTTOM.
_HALF = "▀"
_RESET = "\x1b[0m"

# Terminal byte(s) -> reference key names (camera.cuh:38-98 bindings).
_KEYMAP = {
    b"w": "w", b"a": "a", b"s": "s", b"d": "d",
    b" ": "space", b"z": "shift",  # z = move down (GLFW_KEY_LEFT_SHIFT, camera.cuh:64-69)
    b"\x1b[A": "up", b"\x1b[B": "down", b"\x1b[C": "right", b"\x1b[D": "left",
}


def downsample(image: np.ndarray, cols: int, rows: int) -> np.ndarray:
    """Box-average an (H, W, 3) image to exactly (rows, cols, 3) by
    bucketing pixels into the character cell grid (no interpolation deps)."""
    h, w = image.shape[:2]
    rows = max(min(rows, h), 1)
    cols = max(min(cols, w), 1)
    ys = (np.arange(h) * rows) // h
    xs = (np.arange(w) * cols) // w
    out = np.zeros((rows, cols, 3), np.float64)
    cnt = np.zeros((rows, cols, 1), np.float64)
    np.add.at(out, (ys[:, None], xs[None, :]), image)
    np.add.at(cnt, (ys[:, None], xs[None, :]), 1.0)
    return (out / np.maximum(cnt, 1.0)).astype(np.float32)


def render_ansi(image: np.ndarray, max_cols: Optional[int] = None,
                max_rows: Optional[int] = None) -> str:
    """Encode an (H, W, 3) float [0,1] image as ANSI half-block art.

    One text row shows two image rows (fg = upper, bg = lower), so an
    (2R, C) image becomes R lines of C glyphs."""
    if max_cols is None or max_rows is None:
        size = shutil.get_terminal_size((80, 24))
        max_cols = max_cols or size.columns
        max_rows = max_rows or (size.lines - 2)
    img = downsample(np.asarray(image, np.float32), max_cols, 2 * max_rows)
    if img.shape[0] % 2:  # need an even number of pixel rows
        img = img[:-1] if img.shape[0] > 1 else np.repeat(img, 2, axis=0)
    u8 = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    top, bot = u8[0::2], u8[1::2]
    lines = []
    for tr, br in zip(top, bot):
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m{_HALF}"
            for t, b in zip(tr, br)
        ]
        lines.append("".join(cells) + _RESET)
    return "\n".join(lines)


def _read_keys(timeout: float) -> list[str]:
    """Non-blocking read of pending keystrokes, mapped to reference key
    names. Returns [] when stdin is not a tty."""
    if not sys.stdin.isatty():
        return []
    keys: list[str] = []
    while select.select([sys.stdin], [], [], timeout)[0]:
        timeout = 0.0
        data = os.read(sys.stdin.fileno(), 8)
        if not data:
            break
        if data in (b"\x1b", b"q", b"\x03"):  # esc / q / ctrl-c
            keys.append("quit")
            continue
        matched = _KEYMAP.get(data)
        if matched is None and data.startswith(b"\x1b["):
            matched = _KEYMAP.get(data[:3])
        if matched:
            keys.append(matched)
    return keys


def run_preview(session, max_samples: Optional[int] = None,
                out=None, interactive: Optional[bool] = None) -> np.ndarray:
    """Main preview loop (main.cu:114-155 parity): render one progressive
    sample per iteration, redraw the terminal, poll input, stop at
    max_samples / convergence / 'q'. Returns the final image."""
    out = out or sys.stdout
    limit = max_samples or session.config.max_samples
    if interactive is None:
        interactive = sys.stdin.isatty()

    raw = None
    if interactive:
        import termios
        import tty

        raw = termios.tcgetattr(sys.stdin)
        tty.setcbreak(sys.stdin.fileno())
    try:
        out.write("\x1b[2J")  # clear once; then repaint in place
        while session.sample_count < limit:
            keys = _read_keys(0.0) if interactive else []
            if "quit" in keys:
                break
            session.step(keys=[k for k in keys if k != "quit"])
            frame = render_ansi(session.image())
            out.write("\x1b[H" + frame +
                      f"\n{_RESET}sample {session.sample_count}/{limit}  "
                      "(wasd/space/z move, arrows rotate, q quits)\x1b[K\n")
            out.flush()
            if session.adaptive and session.converged():
                break
    finally:
        if raw is not None:
            import termios

            termios.tcsetattr(sys.stdin, termios.TCSADRAIN, raw)
        out.write(_RESET + "\n")
        out.flush()
    return session.image()
