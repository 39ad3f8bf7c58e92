"""Procedural scenes: the Cornell box and the textured material demo.

Port of the small-scene part of ``isaklm_raytracer_tpu/scene/procedural.py``
in numpy, so that the port builds its scenes without the JAX package.
The same arithmetic and the same RNG streams give the same float32
geometry: the Cornell box, the textured demo, the glass box, the random
triangle soup and the hero scene (terrain + icosphere field, 2M triangles
by default).
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


def glass_box_scene(subdiv: int = 2) -> Scene:
    """Cornell-style box dominated by a large transparent sphere -- the
    worst case for a bounded bounce loop: inside the glass the specular
    weight is forced to 1 (path_tracing.cuh:194) and throughput stays
    ~0.995 per bounce, so Russian roulette kills slowly and deep chains
    carry real energy. Used to QUANTIFY the max_bounces truncation bias
    (the reference loop is unbounded, path_tracing.cuh:279-319)."""
    b = SceneBuilder()
    ior = 1.25
    white = b.add_material(albedo=(0.73, 0.73, 0.73), roughness=0.3, ior=ior)
    glass = b.add_material(
        albedo=(0.995, 0.995, 0.995), roughness=0.001, ior=1.51, transparent=1.0
    )
    light = b.add_material(
        albedo=(0.78, 0.78, 0.78), emittance=(15.0, 15.0, 15.0),
        roughness=0.3, ior=ior,
    )
    lo, hi = -1.0, 1.0
    b.add_quad((lo, lo, lo), (hi, lo, lo), (hi, lo, hi), (lo, lo, hi), white)
    b.add_quad((lo, hi, hi), (hi, hi, hi), (hi, hi, lo), (lo, hi, lo), white)
    b.add_quad((lo, lo, hi), (hi, lo, hi), (hi, hi, hi), (lo, hi, hi), white)
    b.add_quad((lo, lo, lo), (lo, lo, hi), (lo, hi, hi), (lo, hi, lo), white)
    b.add_quad((hi, lo, hi), (hi, lo, lo), (hi, hi, lo), (hi, hi, hi), white)
    s = 0.4
    y = hi - 1e-3
    b.add_quad((-s, y, s), (s, y, s), (s, y, -s), (-s, y, -s), light)
    _add_icosphere(b, center=(0.0, -0.3, 0.2), radius=0.55, mat=glass,
                   subdiv=subdiv)
    return b.build()


def triangle_soup(
    num_triangles: int, seed: int = 0, extent: float = 10.0, tri_size: float = 0.35
) -> Scene:
    """Random diffuse triangles in a cube -- KD-tree stress fixture."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (num_triangles, 1, 3)).astype(np.float32)
    offsets = rng.normal(0.0, tri_size, (num_triangles, 3, 3)).astype(np.float32)
    vertices = centers + offsets

    b = SceneBuilder()
    white = b.add_material(albedo=(0.7, 0.7, 0.7), roughness=0.4, ior=1.0001)
    light = b.add_material(albedo=(1, 1, 1), emittance=(30.0, 30.0, 30.0))
    del white, light

    edge1 = vertices[:, 1] - vertices[:, 0]
    edge2 = vertices[:, 2] - vertices[:, 0]
    geo_n = np.cross(edge1, edge2)
    lens = np.linalg.norm(geo_n, axis=-1, keepdims=True)
    geo_n = geo_n / np.where(lens > 0, lens, 1.0)
    normals = np.repeat(geo_n[:, None, :], 3, axis=1)
    uvs = np.ones((num_triangles, 3, 2), np.float32)
    mat_id = np.zeros(num_triangles, np.int32)
    mat_id[: max(num_triangles // 100, 1)] = 1  # a few emitters

    return build_scene(
        vertices,
        normals,
        uvs,
        mat_id,
        MaterialTable.stack(b.materials),
    )


def hero_scene(num_triangles: int = 2_000_000, seed: int = 7) -> Scene:
    """~2M-triangle interior: displaced height-field terrain + icosphere
    field inside a lit box (stand-in for the stripped README hero scene,
    README.md:12)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    ior = 1.25
    white = b.add_material(albedo=(0.73, 0.73, 0.73), roughness=0.3, ior=ior)
    gold = b.add_material(
        albedo=(0.97, 0.74, 0.33), roughness=0.05, ior=0.27732, extinction=2.9278
    )
    glass = b.add_material(
        albedo=(0.995, 0.995, 0.995), roughness=0.001, ior=1.51, transparent=1.0
    )
    light = b.add_material(
        albedo=(0.78, 0.78, 0.78), emittance=(40.0, 36.0, 28.0), roughness=0.3, ior=ior
    )

    # Room shell.
    lo, hi, h = -8.0, 8.0, 8.0
    b.add_quad((lo, h, hi), (hi, h, hi), (hi, h, lo), (lo, h, lo), white)
    b.add_quad((lo, 0, hi), (hi, 0, hi), (hi, h, hi), (lo, h, hi), white)
    s = 2.0
    b.add_quad((-s, h - 1e-3, s), (s, h - 1e-3, s), (s, h - 1e-3, -s), (-s, h - 1e-3, -s), light)
    shell = b.build()  # small builder part; we fuse arrays below

    # Height-field floor: g x g grid -> 2 g^2 triangles; pick g to land near
    # the target count after adding the sphere field.
    sphere_budget = min(num_triangles // 5, 320 * 1280)
    n_spheres = max(sphere_budget // 1280, 1)  # 1280 tris per subdiv-3 sphere
    grid_tris = num_triangles - n_spheres * 1280
    g = max(int(np.sqrt(grid_tris / 2.0)), 2)

    xs = np.linspace(lo, hi, g + 1, dtype=np.float32)
    zs = np.linspace(lo, hi, g + 1, dtype=np.float32)
    xx, zz = np.meshgrid(xs, zs, indexing="ij")
    yy = (
        0.35 * np.sin(xx * 1.7) * np.cos(zz * 1.3)
        + 0.15 * np.sin(xx * 5.1 + 1.0) * np.sin(zz * 4.3)
    ).astype(np.float32)
    pts = np.stack([xx, yy, zz], axis=-1)  # (g+1, g+1, 3)

    p00 = pts[:-1, :-1].reshape(-1, 3)
    p10 = pts[1:, :-1].reshape(-1, 3)
    p11 = pts[1:, 1:].reshape(-1, 3)
    p01 = pts[:-1, 1:].reshape(-1, 3)
    tri1 = np.stack([p00, p10, p11], axis=1)
    tri2 = np.stack([p00, p11, p01], axis=1)
    grid_vertices = np.concatenate([tri1, tri2], axis=0)

    e1 = grid_vertices[:, 1] - grid_vertices[:, 0]
    e2 = grid_vertices[:, 2] - grid_vertices[:, 0]
    gn = np.cross(e1, e2)
    lens = np.linalg.norm(gn, axis=-1, keepdims=True)
    gn = gn / np.where(lens > 0, lens, 1.0)
    flip = gn[:, 1:2] < 0  # keep floor normals up
    gn = np.where(flip, -gn, gn)
    grid_normals = np.repeat(gn[:, None, :], 3, axis=1)

    # Sphere field: ONE subdiv-3 icosphere template (1280 tris), instanced
    # by broadcast -- building 320 spheres triangle-by-triangle through
    # SceneBuilder took minutes of host time at 2M-tri scale.
    tb = SceneBuilder()
    _add_icosphere(tb, (0.0, 0.0, 0.0), 1.0, 0, subdiv=3)
    unit_v = np.stack(tb.vertices)  # (1280, 3, 3)
    unit_n = np.stack(tb.normals)  # (1280, 3, 3) smooth normals

    mats = rng.choice([white, gold, glass], n_spheres, p=[0.5, 0.3, 0.2])
    # Draw per-sphere randoms in the same interleaved order as the round-3
    # per-sphere loop: same RNG stream, matching geometry up to f32
    # rounding (the old loop scaled in float64 and rounded once; the
    # broadcast below rounds radii to f32 first, so last-ulp vertex
    # differences are possible).
    cxz = np.empty((n_spheres, 2))
    radii = np.empty(n_spheres)
    cy = np.empty(n_spheres)
    for i in range(n_spheres):
        cxz[i] = rng.uniform(lo + 1, hi - 1, 2)
        radii[i] = rng.uniform(0.15, 0.45)
        cy[i] = 1.0 + rng.uniform(0, 2.5)
    centers = np.stack([cxz[:, 0], cy, cxz[:, 1]], axis=1).astype(np.float32)

    sphere_vertices = (
        unit_v[None] * radii[:, None, None, None].astype(np.float32)
        + centers[:, None, None, :]
    ).reshape(-1, 3, 3).astype(np.float32)
    sphere_normals = np.broadcast_to(
        unit_n[None], (n_spheres,) + unit_n.shape
    ).reshape(-1, 3, 3).astype(np.float32)
    sphere_mat = np.repeat(mats.astype(np.int32), unit_v.shape[0])

    vertices = np.concatenate(
        [np.asarray(shell.vertices), grid_vertices, sphere_vertices]
    )
    normals = np.concatenate(
        [np.asarray(shell.normals), grid_normals, sphere_normals]
    )
    uvs = np.ones((len(vertices), 3, 2), np.float32)
    mat_id = np.concatenate(
        [
            np.asarray(shell.mat_id),
            np.zeros(len(grid_vertices), np.int32),  # white floor
            sphere_mat,
        ]
    )
    return build_scene(vertices, normals, uvs, mat_id, MaterialTable.stack(b.materials))
