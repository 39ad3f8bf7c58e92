"""Scene model as dataclasses of tensors.

Port of ``isaklm_raytracer_tpu/scene/types.py``: ``flax.struct`` pytrees
become plain dataclasses. Materials live in a compact ``MaterialTable`` and
triangles carry a material index; textures share one flat atlas buffer;
the KD tree is the flat ``KDTreeArrays``; the per-pixel accumulators are
the ``GBuffer``.

``build_scene`` assembles a scene from HOST numpy arrays; the leaves stay
numpy until ``accel.prepare_scene`` moves the finished scene to a device
once.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from isaklm_raytracer_tpu_torch.config import resolve_device


def _to(x, device):
    return torch.as_tensor(x).to(device) if x is not None else None


@dataclasses.dataclass
class MaterialTable:
    """Material parameters (reference Material, scene.cuh:65-74).

    albedo/emittance (M, 3); roughness/ior/extinction/transparent (M,);
    tex_id (M,) int32, -1 = no texture.
    """

    albedo: torch.Tensor
    emittance: torch.Tensor
    roughness: torch.Tensor
    ior: torch.Tensor
    extinction: torch.Tensor
    transparent: torch.Tensor
    tex_id: torch.Tensor

    @staticmethod
    def stack(mats: list[dict]) -> "MaterialTable":
        """Build from a list of material dicts; leaves are host numpy."""

        def col(key, default):
            rows = [m.get(key, default) for m in mats]
            return np.asarray(rows, np.float32 if key != "tex_id" else np.int32)

        return MaterialTable(
            albedo=col("albedo", (0.0, 0.0, 0.0)),
            emittance=col("emittance", (0.0, 0.0, 0.0)),
            roughness=col("roughness", 0.0),
            ior=col("ior", 0.0),
            extinction=col("extinction", 0.0),
            transparent=col("transparent", 0.0),
            tex_id=col("tex_id", -1),
        )

    def replace(self, **changes) -> "MaterialTable":
        """A copy with some leaves replaced, e.g. by tensors that require
        grad (the JAX package's ``MaterialTable.replace``)."""
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "MaterialTable":
        return MaterialTable(**{
            f.name: _to(getattr(self, f.name), device)
            for f in dataclasses.fields(self)
        })


@dataclasses.dataclass
class TextureAtlas:
    """All textures in one flat RGB buffer (reference Texture,
    scene.cuh:16-23). buffer (P, 3) float32; offset/width/height (T,) int32.
    A scene with no textures carries a 1-texel dummy."""

    buffer: torch.Tensor
    offset: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor

    @staticmethod
    def empty() -> "TextureAtlas":
        return TextureAtlas(
            buffer=np.ones((1, 3), np.float32),
            offset=np.zeros((1,), np.int32),
            width=np.ones((1,), np.int32),
            height=np.ones((1,), np.int32),
        )

    def to(self, device) -> "TextureAtlas":
        return TextureAtlas(**{
            f.name: _to(getattr(self, f.name), device)
            for f in dataclasses.fields(self)
        })


def pack_kd_nodes(child_a, child_b, axis, is_leaf, plane) -> torch.Tensor:
    """(K, 4) int32 rows [child_a, child_b, axis | leaf << 2, plane's bits]:
    one 16-byte load a node for the KD walk kernel (csrc/kd_intersect.cu)."""
    flags = axis.to(torch.int32) | (is_leaf.to(torch.int32) << 2)
    return torch.stack([child_a.to(torch.int32), child_b.to(torch.int32), flags,
                        plane.to(torch.float32).view(torch.int32)], dim=1).contiguous()


@dataclasses.dataclass
class KDTreeArrays:
    """Flattened KD tree (reference KD_Tree/KD_Tree_Node, scene.cuh:84-112).

    The unioned node struct becomes parallel arrays: for inner nodes
    (child_a, child_b) are child indices; for leaves they are
    (index_offset, triangle_count). DFS order, root = 0
    (create_kd_tree.cuh:267-328). ``accel.kdtree.build_kd_tree`` returns
    host numpy leaves; ``to`` moves them.
    """

    child_a: torch.Tensor  # (K,) int32: child_index1 | index_offset
    child_b: torch.Tensor  # (K,) int32: child_index2 | triangle_count
    axis: torch.Tensor  # (K,) int32 in {0,1,2}
    plane: torch.Tensor  # (K,) float32
    is_leaf: torch.Tensor  # (K,) bool
    tri_indices: torch.Tensor  # (I,) int32 into triangle arrays
    bbox_min: torch.Tensor  # (3,) float32 (root bbox, +/- 0.01 pad)
    bbox_max: torch.Tensor  # (3,) float32
    max_depth: int = 19

    def to(self, device) -> "KDTreeArrays":
        return dataclasses.replace(self, **{
            f.name: _to(getattr(self, f.name), device)
            for f in dataclasses.fields(self) if f.name != "max_depth"
        })

    @functools.cached_property
    def nodes(self) -> torch.Tensor:
        """The node rows of ``pack_kd_nodes``, packed once per tree."""
        return pack_kd_nodes(self.child_a, self.child_b, self.axis, self.is_leaf, self.plane)

    def tri_table(self, vertices: torch.Tensor) -> torch.Tensor:
        """(N, 20) float32 triangle records of ``vertices`` (N, 3, 3),
        indexed by triangle id (``kernels.intersect.tri_consts``): what the
        KD walk kernel reads over this tree's lists. Built at the first call
        with these vertices, then kept with the tree."""
        cached = self.__dict__.get("_tri_table")
        if cached is None or cached[0] is not vertices:
            from isaklm_raytracer_tpu_torch.kernels.intersect import tri_consts

            cached = (vertices, tri_consts(vertices.reshape(-1, 9)))
            self.__dict__["_tri_table"] = cached
        return cached[1]


@dataclasses.dataclass
class Scene:
    """Full scene (reference Scene, scene.cuh:114-121).

    vertices/normals (N, 3, 3) f32; uvs (N, 3, 2) f32; mat_id (N,) int32;
    light_indices (L,) int32. ``cbvh`` (accel.cluster.ClusterBVH),
    ``shade_table`` (T, 32), ``kd`` (KDTreeArrays) and ``wkd``
    (accel.wavefront.WavefrontKD, only when its ``build_kd`` asks) are set by
    accel.prepare_scene, which also
    renumbers the triangles so that cluster c holds ids [c*128, (c+1)*128).
    """

    vertices: torch.Tensor
    normals: torch.Tensor
    uvs: torch.Tensor
    mat_id: torch.Tensor
    light_indices: torch.Tensor
    materials: MaterialTable
    textures: TextureAtlas
    kd: Optional[KDTreeArrays] = None
    # accel.wavefront.WavefrontKD; typed object to avoid a scene<->accel
    # import cycle, as the JAX package does
    wkd: Optional[object] = None
    cbvh: Optional[object] = None
    shade_table: Optional[torch.Tensor] = None
    has_lights: bool = True

    @property
    def num_triangles(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_indices.shape[0]

    @property
    def device(self) -> torch.device:
        return torch.as_tensor(self.vertices).device

    def replace(self, **changes) -> "Scene":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class GBuffer:
    """Per-pixel progressive accumulators (reference G_Buffer,
    screen.cuh:15-46): frame (H*W, 3), sq_luminance (H*W,), count (H*W,)
    int32."""

    frame: torch.Tensor
    sq_luminance: torch.Tensor
    count: torch.Tensor

    @staticmethod
    def create(num_pixels: int, device="cuda") -> "GBuffer":
        """Zeroed accumulators on ``device``: the card unless the caller
        passes "cpu"; without a card the default raises
        (``config.resolve_device``)."""
        device = resolve_device(device)
        return GBuffer(
            frame=torch.zeros((num_pixels, 3), dtype=torch.float32, device=device),
            sq_luminance=torch.zeros((num_pixels,), dtype=torch.float32, device=device),
            count=torch.zeros((num_pixels,), dtype=torch.int32, device=device),
        )

    def reset(self) -> "GBuffer":
        """Zero all accumulators, on the buffer's own device (reference
        reset_frame, render.cuh:18-34)."""
        return GBuffer.create(self.frame.shape[0], self.frame.device)


def build_scene(
    vertices: np.ndarray,
    normals: np.ndarray,
    uvs: np.ndarray,
    mat_id: np.ndarray,
    materials: MaterialTable,
    textures: Optional[TextureAtlas] = None,
) -> Scene:
    """Assemble a Scene; scans emissive materials for light triangles
    (reference create_scene.cuh:40-66)."""
    mat_id = np.asarray(mat_id, np.int32)
    emittance = np.asarray(materials.emittance)
    is_light = (emittance[mat_id] > 0.0).any(axis=-1)
    light_indices = np.nonzero(is_light)[0].astype(np.int32)
    has_lights = light_indices.size > 0
    if not has_lights:
        # Non-empty for uniform shapes; NEE is skipped when has_lights is False.
        light_indices = np.zeros((1,), np.int32)
    return Scene(
        vertices=np.asarray(vertices, np.float32),
        normals=np.asarray(normals, np.float32),
        uvs=np.asarray(uvs, np.float32),
        mat_id=mat_id,
        light_indices=light_indices,
        materials=materials,
        textures=textures if textures is not None else TextureAtlas.empty(),
        has_lights=has_lights,
    )


def sample_texture(
    textures: TextureAtlas, tex_id: torch.Tensor, color: torch.Tensor, uv: torch.Tensor
) -> torch.Tensor:
    """Nearest-neighbour, wrap-mode texture lookup times material colour
    (trace_ray.cuh:31-46): uv wrapped by a FLOORED mod 1 (``jnp.mod``, so
    ``torch.remainder``), pixel = int(v*h)*w + int(u*w) with truncation
    toward zero; no texture -> colour."""
    valid = tex_id >= 0
    safe_id = torch.clamp_min(tex_id, 0).long()
    w = textures.width[safe_id]
    h = textures.height[safe_id]
    off = textures.offset[safe_id]
    u = torch.remainder(uv[..., 0], 1.0)
    v = torch.remainder(uv[..., 1], 1.0)
    px = (v * h.to(torch.float32)).to(torch.int32) * w + (
        u * w.to(torch.float32)
    ).to(torch.int32)
    texel = textures.buffer[(off + px).long()]
    return torch.where(valid[..., None], texel * color, color)
