"""Procedural scenes: the Cornell box and the textured material demo.

Port of the small-scene part of ``isaklm_raytracer_tpu/scene/procedural.py``
in numpy, so that the port builds its scenes without the JAX package.
The same arithmetic gives the same float32 geometry. ``hero_scene``,
``glass_box_scene`` and ``triangle_soup`` are not ported yet.
"""

from __future__ import annotations

import numpy as np

from isaklm_raytracer_tpu_torch.scene.texture import TextureRegistry
from isaklm_raytracer_tpu_torch.scene.types import MaterialTable, Scene, build_scene

# Reference default UV: ZERO_VEC2D is literally {1, 1} (math_library.cuh:13),
# so untextured corners carry uv = (1, 1).
DEFAULT_UV = (1.0, 1.0)


class SceneBuilder:
    """Accumulates triangles + materials, then assembles a Scene."""

    def __init__(self) -> None:
        self.vertices: list = []
        self.normals: list = []
        self.uvs: list = []
        self.mat_id: list = []
        self.materials: list[dict] = []

    def add_material(self, **kwargs) -> int:
        mat = {
            "albedo": (0.0, 0.0, 0.0),
            "emittance": (0.0, 0.0, 0.0),
            "roughness": 0.0,
            "ior": 0.0,
            "extinction": 0.0,
            "transparent": 0.0,
            "tex_id": -1,
        }
        mat.update(kwargs)
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_triangle(self, p1, p2, p3, mat: int, n1=None, n2=None, n3=None, uvs=None):
        p1, p2, p3 = (np.asarray(p, np.float32) for p in (p1, p2, p3))
        geo_n = np.cross(p2 - p1, p3 - p1)
        norm = np.linalg.norm(geo_n)
        geo_n = geo_n / (norm if norm > 0 else 1.0)
        self.vertices.append(np.stack([p1, p2, p3]))
        self.normals.append(
            np.stack(
                [
                    np.asarray(n1, np.float32) if n1 is not None else geo_n,
                    np.asarray(n2, np.float32) if n2 is not None else geo_n,
                    np.asarray(n3, np.float32) if n3 is not None else geo_n,
                ]
            )
        )
        self.uvs.append(
            np.asarray(uvs, np.float32)
            if uvs is not None
            else np.asarray([DEFAULT_UV] * 3, np.float32)
        )
        self.mat_id.append(mat)

    def add_quad(self, p00, p10, p11, p01, mat: int, uv=False):
        """Two triangles (p00, p10, p11) and (p00, p11, p01)."""
        uvs1 = [(0, 0), (1, 0), (1, 1)] if uv else None
        uvs2 = [(0, 0), (1, 1), (0, 1)] if uv else None
        self.add_triangle(p00, p10, p11, mat, uvs=uvs1)
        self.add_triangle(p00, p11, p01, mat, uvs=uvs2)

    def build(self, textures=None) -> Scene:
        return build_scene(
            np.stack(self.vertices),
            np.stack(self.normals),
            np.stack(self.uvs),
            np.asarray(self.mat_id, np.int32),
            MaterialTable.stack(self.materials),
            textures,
        )


def cornell_box(
    include_blockers: bool = True,
    light_emittance: float = 15.0,
    glossy: bool = False,
) -> Scene:
    """Cornell-style box interior, y-up, open toward -z; camera should sit
    near (0, 1, -3) looking +z.

    Materials mirror the reference's .mat conventions (materials/room.mat):
    diffuse-dominant dielectrics with n ~= 1.25 when `glossy`, or ior 1.0001
    (Fresnel ~= 0 => almost purely diffuse) for analytically simple tests.
    """
    b = SceneBuilder()
    ior = 1.25 if glossy else 1.0001
    rough = 0.2 if glossy else 0.4
    white = b.add_material(albedo=(0.73, 0.73, 0.73), roughness=rough, ior=ior)
    red = b.add_material(albedo=(0.65, 0.05, 0.05), roughness=rough, ior=ior)
    green = b.add_material(albedo=(0.12, 0.45, 0.15), roughness=rough, ior=ior)
    light = b.add_material(
        albedo=(0.78, 0.78, 0.78),
        emittance=(light_emittance,) * 3,
        roughness=rough,
        ior=ior,
    )

    lo, hi = -1.0, 1.0
    zlo, zhi = -1.0, 1.0
    # floor (y = lo), normal up
    b.add_quad((lo, lo, zlo), (hi, lo, zlo), (hi, lo, zhi), (lo, lo, zhi), white)
    # ceiling (y = hi), normal down
    b.add_quad((lo, hi, zhi), (hi, hi, zhi), (hi, hi, zlo), (lo, hi, zlo), white)
    # back wall (z = hi), normal -z
    b.add_quad((lo, lo, zhi), (hi, lo, zhi), (hi, hi, zhi), (lo, hi, zhi), white)
    # left wall (x = lo), normal +x
    b.add_quad((lo, lo, zlo), (lo, lo, zhi), (lo, hi, zhi), (lo, hi, zlo), red)
    # right wall (x = hi), normal -x
    b.add_quad((hi, lo, zhi), (hi, lo, zlo), (hi, hi, zlo), (hi, hi, zhi), green)
    # area light slightly below the ceiling
    s = 0.4
    y = hi - 1e-3
    b.add_quad((-s, y, s), (s, y, s), (s, y, -s), (-s, y, -s), light)

    if include_blockers:
        _add_box(b, center=(-0.35, -0.7, 0.3), size=(0.55, 0.6, 0.55), mat=white)
        _add_box(b, center=(0.4, -0.8, -0.2), size=(0.5, 0.4, 0.5), mat=white)
    return b.build()


def _add_box(b: SceneBuilder, center, size, mat: int):
    cx, cy, cz = center
    sx, sy, sz = (s * 0.5 for s in size)
    x0, x1 = cx - sx, cx + sx
    y0, y1 = cy - sy, cy + sy
    z0, z1 = cz - sz, cz + sz
    # six faces, outward normals
    b.add_quad((x0, y0, z0), (x0, y0, z1), (x1, y0, z1), (x1, y0, z0), mat)  # bottom
    b.add_quad((x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1), mat)  # top
    b.add_quad((x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0), mat)  # front
    b.add_quad((x1, y0, z1), (x0, y0, z1), (x0, y1, z1), (x1, y1, z1), mat)  # back
    b.add_quad((x0, y0, z1), (x0, y0, z0), (x0, y1, z0), (x0, y1, z1), mat)  # left
    b.add_quad((x1, y0, z0), (x1, y0, z1), (x1, y1, z1), (x1, y1, z0), mat)  # right


def checker_texture(
    tiles: int = 8,
    size: int = 64,
    c0=(40, 40, 40),
    c1=(230, 230, 230),
) -> np.ndarray:
    """(size, size, 3) uint8 checkerboard -- procedural stand-in for the
    reference's image textures (textures/*.png|jpg), fed through the same
    TextureRegistry/atlas path as decoded files."""
    ij = np.arange(size)
    cell = (ij * tiles // size)[:, None] + (ij * tiles // size)[None, :]
    mask = (cell % 2).astype(bool)
    img = np.where(mask[..., None], np.uint8(c1), np.uint8(c0))
    return img.astype(np.uint8)


def material_demo_scene(textured: bool = True) -> Scene:
    """Few-hundred-triangle scene exercising dielectric + metallic +
    transparent materials with NEE (BASELINE.json configs[1]).

    With `textured` (the default, and what bench.py measures) the floor
    carries a checkerboard through the full texture path -- .mat-style
    tex_id -> atlas gather -> albedo/emittance modulation
    (trace_ray.cuh:31-46 parity) -- so the "textured, adaptive + ACES"
    benchmark rung exercises texture sampling for real."""
    b = SceneBuilder()
    ior = 1.25
    registry = TextureRegistry()
    floor_tex = registry.add_array(checker_texture()) if textured else -1
    floor = b.add_material(
        albedo=(0.73, 0.73, 0.73), roughness=0.3, ior=ior, tex_id=floor_tex
    )
    white = b.add_material(albedo=(0.73, 0.73, 0.73), roughness=0.3, ior=ior)
    gold = b.add_material(
        albedo=(0.97, 0.74, 0.33), roughness=0.05, ior=0.27732, extinction=2.9278
    )
    glass = b.add_material(
        albedo=(0.995, 0.995, 0.995), roughness=0.001, ior=1.51, transparent=1.0
    )
    light = b.add_material(
        albedo=(0.78, 0.78, 0.78), emittance=(20.0, 18.0, 14.0), roughness=0.3, ior=ior
    )

    lo, hi = -2.0, 2.0
    b.add_quad((lo, 0, lo), (hi, 0, lo), (hi, 0, hi), (lo, 0, hi), floor, uv=True)
    b.add_quad((lo, 3, hi), (hi, 3, hi), (hi, 3, lo), (lo, 3, lo), white)  # ceiling
    b.add_quad((lo, 0, hi), (hi, 0, hi), (hi, 3, hi), (lo, 3, hi), white)  # back
    s = 0.6
    b.add_quad((-s, 2.999, s), (s, 2.999, s), (s, 2.999, -s), (-s, 2.999, -s), light)

    _add_icosphere(b, center=(-1.0, 0.6, 0.6), radius=0.6, mat=gold, subdiv=2)
    _add_icosphere(b, center=(0.9, 0.55, 0.0), radius=0.55, mat=glass, subdiv=2)
    _add_box(b, center=(0.0, 0.3, 1.2), size=(0.6, 0.6, 0.6), mat=white)
    return b.build(textures=registry.build() if textured else None)


def _add_icosphere(b: SceneBuilder, center, radius, mat: int, subdiv: int = 1):
    """Subdivided icosahedron with smooth (per-vertex) normals."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            (-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
            (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
            (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1),
        ],
        np.float32,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    tris = [tuple(verts[i] for i in f) for f in faces]
    for _ in range(subdiv):
        new = []
        for a, b_, c in tris:
            ab = (a + b_) / np.linalg.norm(a + b_)
            bc = (b_ + c) / np.linalg.norm(b_ + c)
            ca = (c + a) / np.linalg.norm(c + a)
            new += [(a, ab, ca), (b_, bc, ab), (c, ca, bc), (ab, bc, ca)]
        tris = new
    center = np.asarray(center, np.float32)
    for a, b_, c in tris:
        b.add_triangle(
            center + a * radius,
            center + b_ * radius,
            center + c * radius,
            mat,
            n1=a,
            n2=b_,
            n3=c,
        )
