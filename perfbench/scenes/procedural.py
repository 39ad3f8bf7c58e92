"""The benchmark's scenes, frozen: the textured material demo and the hero.

A numpy copy of the generators of the port's ``scene/procedural.py`` as
they stood when the benchmark was written, kept here so that no change to
the program changes the yardstick's scenes. A generator returns host
arrays (``SceneArrays``); the harness hands them to the port through its
public constructors and to the plain reference alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Reference default UV: ZERO_VEC2D is literally {1, 1} (math_library.cuh:13).
DEFAULT_UV = (1.0, 1.0)
MAX_COLOR_CHANNEL = 255.0  # macros.h:9
MATERIAL_KEYS = ("albedo", "emittance", "roughness", "ior", "extinction", "transparent",
                 "tex_id")


@dataclasses.dataclass
class SceneArrays:
    """A scene as host arrays: (N, 3, 3) vertices and normals, (N, 3, 2)
    uvs, (N,) int32 material ids, the material table as a dict of columns
    (``MATERIAL_KEYS``) and the texture atlas as a dict (buffer (P, 3),
    offset, width, height)."""

    vertices: np.ndarray
    normals: np.ndarray
    uvs: np.ndarray
    mat_id: np.ndarray
    materials: dict
    textures: dict

    @property
    def light_indices(self) -> np.ndarray:
        """The emissive triangles in id order (create_scene.cuh:40-66)."""
        is_light = (self.materials["emittance"][self.mat_id] > 0.0).any(axis=-1)
        return np.nonzero(is_light)[0].astype(np.int32)


def empty_atlas() -> dict:
    return {"buffer": np.ones((1, 3), np.float32), "offset": np.zeros((1,), np.int32),
            "width": np.ones((1,), np.int32), "height": np.ones((1,), np.int32)}


def stack_materials(mats: list) -> dict:
    def col(key, default):
        rows = [m.get(key, default) for m in mats]
        return np.asarray(rows, np.float32 if key != "tex_id" else np.int32)

    return {"albedo": col("albedo", (0.0, 0.0, 0.0)),
            "emittance": col("emittance", (0.0, 0.0, 0.0)),
            "roughness": col("roughness", 0.0), "ior": col("ior", 0.0),
            "extinction": col("extinction", 0.0), "transparent": col("transparent", 0.0),
            "tex_id": col("tex_id", -1)}


class _Builder:
    def __init__(self) -> None:
        self.vertices, self.normals, self.uvs, self.mat_id = [], [], [], []
        self.materials: list = []

    def add_material(self, **kwargs) -> int:
        mat = {"albedo": (0.0, 0.0, 0.0), "emittance": (0.0, 0.0, 0.0), "roughness": 0.0,
               "ior": 0.0, "extinction": 0.0, "transparent": 0.0, "tex_id": -1}
        mat.update(kwargs)
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_triangle(self, p1, p2, p3, mat: int, n1=None, n2=None, n3=None, uvs=None):
        p1, p2, p3 = (np.asarray(p, np.float32) for p in (p1, p2, p3))
        geo_n = np.cross(p2 - p1, p3 - p1)
        norm = np.linalg.norm(geo_n)
        geo_n = geo_n / (norm if norm > 0 else 1.0)
        self.vertices.append(np.stack([p1, p2, p3]))
        self.normals.append(np.stack([np.asarray(n, np.float32) if n is not None else geo_n
                                      for n in (n1, n2, n3)]))
        self.uvs.append(np.asarray(uvs, np.float32) if uvs is not None
                        else np.asarray([DEFAULT_UV] * 3, np.float32))
        self.mat_id.append(mat)

    def add_quad(self, p00, p10, p11, p01, mat: int, uv=False):
        uvs1 = [(0, 0), (1, 0), (1, 1)] if uv else None
        uvs2 = [(0, 0), (1, 1), (0, 1)] if uv else None
        self.add_triangle(p00, p10, p11, mat, uvs=uvs1)
        self.add_triangle(p00, p11, p01, mat, uvs=uvs2)

    def build(self, textures=None) -> SceneArrays:
        return SceneArrays(np.stack(self.vertices), np.stack(self.normals),
                           np.stack(self.uvs), np.asarray(self.mat_id, np.int32),
                           stack_materials(self.materials),
                           textures if textures is not None else empty_atlas())


def _add_box(b: _Builder, center, size, mat: int):
    cx, cy, cz = center
    sx, sy, sz = (s * 0.5 for s in size)
    x0, x1 = cx - sx, cx + sx
    y0, y1 = cy - sy, cy + sy
    z0, z1 = cz - sz, cz + sz
    b.add_quad((x0, y0, z0), (x0, y0, z1), (x1, y0, z1), (x1, y0, z0), mat)
    b.add_quad((x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1), mat)
    b.add_quad((x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0), mat)
    b.add_quad((x1, y0, z1), (x0, y0, z1), (x0, y1, z1), (x1, y1, z1), mat)
    b.add_quad((x0, y0, z1), (x0, y0, z0), (x0, y1, z0), (x0, y1, z1), mat)
    b.add_quad((x1, y0, z0), (x1, y0, z1), (x1, y1, z1), (x1, y1, z0), mat)


def _add_icosphere(b: _Builder, center, radius, mat: int, subdiv: int = 1):
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([(-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
                      (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
                      (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1)], np.float32)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
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
        b.add_triangle(center + a * radius, center + b_ * radius, center + c * radius, mat,
                       n1=a, n2=b_, n3=c)


def checker_texture(tiles: int = 8, size: int = 64, c0=(40, 40, 40), c1=(230, 230, 230)):
    ij = np.arange(size)
    cell = (ij * tiles // size)[:, None] + (ij * tiles // size)[None, :]
    mask = (cell % 2).astype(bool)
    return np.where(mask[..., None], np.uint8(c1), np.uint8(c0)).astype(np.uint8)


def _atlas(images: list) -> dict:
    """The flat atlas of uint8 RGB images (the port's TextureRegistry)."""
    buffers = [(img[..., :3].astype(np.float32) / MAX_COLOR_CHANNEL).reshape(-1, 3)
               for img in images]
    offsets = np.cumsum([0] + [b.shape[0] for b in buffers[:-1]])
    return {"buffer": np.concatenate(buffers, axis=0),
            "offset": np.asarray(offsets, np.int32),
            "width": np.asarray([img.shape[1] for img in images], np.int32),
            "height": np.asarray([img.shape[0] for img in images], np.int32)}


def material_demo_scene(textured: bool = True) -> SceneArrays:
    """660 triangles: dielectric, metal and glass, a checker-textured floor,
    one area light (BASELINE.json configs[2])."""
    b = _Builder()
    ior = 1.25
    floor = b.add_material(albedo=(0.73, 0.73, 0.73), roughness=0.3, ior=ior,
                           tex_id=0 if textured else -1)
    white = b.add_material(albedo=(0.73, 0.73, 0.73), roughness=0.3, ior=ior)
    gold = b.add_material(albedo=(0.97, 0.74, 0.33), roughness=0.05, ior=0.27732,
                          extinction=2.9278)
    glass = b.add_material(albedo=(0.995, 0.995, 0.995), roughness=0.001, ior=1.51,
                           transparent=1.0)
    light = b.add_material(albedo=(0.78, 0.78, 0.78), emittance=(20.0, 18.0, 14.0),
                           roughness=0.3, ior=ior)
    lo, hi = -2.0, 2.0
    b.add_quad((lo, 0, lo), (hi, 0, lo), (hi, 0, hi), (lo, 0, hi), floor, uv=True)
    b.add_quad((lo, 3, hi), (hi, 3, hi), (hi, 3, lo), (lo, 3, lo), white)
    b.add_quad((lo, 0, hi), (hi, 0, hi), (hi, 3, hi), (lo, 3, hi), white)
    s = 0.6
    b.add_quad((-s, 2.999, s), (s, 2.999, s), (s, 2.999, -s), (-s, 2.999, -s), light)
    _add_icosphere(b, center=(-1.0, 0.6, 0.6), radius=0.6, mat=gold, subdiv=2)
    _add_icosphere(b, center=(0.9, 0.55, 0.0), radius=0.55, mat=glass, subdiv=2)
    _add_box(b, center=(0.0, 0.3, 1.2), size=(0.6, 0.6, 0.6), mat=white)
    return b.build(_atlas([checker_texture()]) if textured else None)


def hero_scene(num_triangles: int = 2_000_000, seed: int = 7) -> SceneArrays:
    """A displaced height-field floor and a field of icospheres in a lit
    room: 1,997,838 triangles at the default count (README.md:12)."""
    rng = np.random.default_rng(seed)
    b = _Builder()
    ior = 1.25
    white = b.add_material(albedo=(0.73, 0.73, 0.73), roughness=0.3, ior=ior)
    gold = b.add_material(albedo=(0.97, 0.74, 0.33), roughness=0.05, ior=0.27732,
                          extinction=2.9278)
    glass = b.add_material(albedo=(0.995, 0.995, 0.995), roughness=0.001, ior=1.51,
                           transparent=1.0)
    b.add_material(albedo=(0.78, 0.78, 0.78), emittance=(40.0, 36.0, 28.0), roughness=0.3,
                   ior=ior)
    light = 3

    lo, hi, h = -8.0, 8.0, 8.0
    b.add_quad((lo, h, hi), (hi, h, hi), (hi, h, lo), (lo, h, lo), white)
    b.add_quad((lo, 0, hi), (hi, 0, hi), (hi, h, hi), (lo, h, hi), white)
    s = 2.0
    b.add_quad((-s, h - 1e-3, s), (s, h - 1e-3, s), (s, h - 1e-3, -s), (-s, h - 1e-3, -s),
               light)
    shell = b.build()

    sphere_budget = min(num_triangles // 5, 320 * 1280)
    n_spheres = max(sphere_budget // 1280, 1)
    grid_tris = num_triangles - n_spheres * 1280
    g = max(int(np.sqrt(grid_tris / 2.0)), 2)

    xs = np.linspace(lo, hi, g + 1, dtype=np.float32)
    zs = np.linspace(lo, hi, g + 1, dtype=np.float32)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    yy = (0.35 * np.sin(xx * 1.7) * np.cos(zz * 1.3)
          + 0.15 * np.sin(xx * 5.1 + 1.0) * np.sin(zz * 4.3)).astype(np.float32)
    pts = np.stack([xx, yy, zz], axis=-1)
    p00 = pts[:-1, :-1].reshape(-1, 3)
    p10 = pts[1:, :-1].reshape(-1, 3)
    p11 = pts[1:, 1:].reshape(-1, 3)
    p01 = pts[:-1, 1:].reshape(-1, 3)
    grid_vertices = np.concatenate([np.stack([p00, p10, p11], axis=1),
                                    np.stack([p00, p11, p01], axis=1)], axis=0)
    e1 = grid_vertices[:, 1] - grid_vertices[:, 0]
    e2 = grid_vertices[:, 2] - grid_vertices[:, 0]
    gn = np.cross(e1, e2)
    lens = np.linalg.norm(gn, axis=-1, keepdims=True)
    gn = gn / np.where(lens > 0, lens, 1.0)
    gn = np.where(gn[:, 1:2] < 0, -gn, gn)
    grid_normals = np.repeat(gn[:, None, :], 3, axis=1)

    tb = _Builder()
    _add_icosphere(tb, (0.0, 0.0, 0.0), 1.0, 0, subdiv=3)
    unit_v = np.stack(tb.vertices)
    unit_n = np.stack(tb.normals)
    mats = rng.choice([white, gold, glass], n_spheres, p=[0.5, 0.3, 0.2])
    cxz = np.empty((n_spheres, 2))
    radii = np.empty(n_spheres)
    cy = np.empty(n_spheres)
    for i in range(n_spheres):
        cxz[i] = rng.uniform(lo + 1, hi - 1, 2)
        radii[i] = rng.uniform(0.15, 0.45)
        cy[i] = 1.0 + rng.uniform(0, 2.5)
    centers = np.stack([cxz[:, 0], cy, cxz[:, 1]], axis=1).astype(np.float32)
    sphere_vertices = (unit_v[None] * radii[:, None, None, None].astype(np.float32)
                       + centers[:, None, None, :]).reshape(-1, 3, 3).astype(np.float32)
    sphere_normals = np.broadcast_to(unit_n[None], (n_spheres,) + unit_n.shape
                                     ).reshape(-1, 3, 3).astype(np.float32)
    sphere_mat = np.repeat(mats.astype(np.int32), unit_v.shape[0])

    vertices = np.concatenate([shell.vertices, grid_vertices, sphere_vertices])
    return SceneArrays(
        vertices=vertices.astype(np.float32),
        normals=np.concatenate([shell.normals, grid_normals, sphere_normals]).astype(np.float32),
        uvs=np.ones((len(vertices), 3, 2), np.float32),
        mat_id=np.concatenate([shell.mat_id, np.zeros(len(grid_vertices), np.int32),
                               sphere_mat]).astype(np.int32),
        materials=shell.materials,
        textures=empty_atlas(),
    )


GENERATORS = {"material_demo": material_demo_scene, "hero": hero_scene}
