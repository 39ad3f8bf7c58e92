"""Texture registry: decodes images and packs them into one flat atlas.

Port of ``isaklm_raytracer_tpu/scene/texture.py`` (the reference's
make_texture, scene.cuh:25-63): every texture shares one flat (P, 3)
float32 buffer plus per-texture (offset, width, height) arrays, so a
texture fetch is one gather from one array.
"""

from __future__ import annotations

import numpy as np

from isaklm_raytracer_tpu_torch.io.png import load_image
from isaklm_raytracer_tpu_torch.scene.types import TextureAtlas

MAX_COLOR_CHANNEL = 255.0  # macros.h:9


class TextureRegistry:
    """Collects textures during scene assembly; ``build()`` emits the atlas."""

    def __init__(self) -> None:
        self._buffers: list[np.ndarray] = []
        self._dims: list[tuple[int, int]] = []
        self._by_path: dict[str, int] = {}

    def load(self, path: str) -> int:
        """Decode an image file; returns its texture id, deduplicated by
        path (the per-mesh material map's lazy loads,
        mesh_loading.cuh:290-298)."""
        if path in self._by_path:
            return self._by_path[path]
        return self.add_array(load_image(path), key=path)

    def add_array(self, rgba: np.ndarray, key: str | None = None) -> int:
        """Register an (H, W, 3|4) uint8 or float image; returns its id.
        ``key`` (a file path) makes ``load`` of that path return this id."""
        rgba = np.asarray(rgba)
        if rgba.dtype == np.uint8:
            rgb = rgba[..., :3].astype(np.float32) / MAX_COLOR_CHANNEL
        else:
            rgb = rgba[..., :3].astype(np.float32)
        h, w = rgb.shape[:2]
        tex_id = len(self._buffers)
        self._buffers.append(rgb.reshape(-1, 3))
        self._dims.append((w, h))
        if key is not None:
            self._by_path[key] = tex_id
        return tex_id

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
