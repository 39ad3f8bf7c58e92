"""Texture registry: packs images into one flat atlas.

Port of ``isaklm_raytracer_tpu/scene/texture.py`` (``add_array`` and
``build``). Loading image files waits for a later port.
"""

from __future__ import annotations

import numpy as np

from isaklm_raytracer_tpu_torch.scene.types import TextureAtlas

MAX_COLOR_CHANNEL = 255.0  # macros.h:9


class TextureRegistry:
    """Collects textures during scene assembly; ``build()`` emits the atlas."""

    def __init__(self) -> None:
        self._buffers: list[np.ndarray] = []
        self._dims: list[tuple[int, int]] = []

    def add_array(self, rgba: np.ndarray) -> int:
        """Register an (H, W, 3|4) uint8 or float image; returns its id."""
        rgba = np.asarray(rgba)
        if rgba.dtype == np.uint8:
            rgb = rgba[..., :3].astype(np.float32) / MAX_COLOR_CHANNEL
        else:
            rgb = rgba[..., :3].astype(np.float32)
        h, w = rgb.shape[:2]
        self._buffers.append(rgb.reshape(-1, 3))
        self._dims.append((w, h))
        return len(self._buffers) - 1

    def build(self) -> TextureAtlas:
        """The atlas, with host numpy leaves."""
        if not self._buffers:
            return TextureAtlas.empty()
        offsets = np.cumsum([0] + [b.shape[0] for b in self._buffers[:-1]])
        return TextureAtlas(
            buffer=np.concatenate(self._buffers, axis=0),
            offset=np.asarray(offsets, np.int32),
            width=np.asarray([d[0] for d in self._dims], np.int32),
            height=np.asarray([d[1] for d in self._dims], np.int32),
        )
