"""OBJ mesh loader with reference-parity semantics.

Port of ``isaklm_raytracer_tpu/scene/obj.py``, a re-derivation of
load_mesh (mesh_loading.cuh:221-440) that keeps every behavioural quirk,
so the same model files give the same triangle soup:

  - tokens split on spaces with empties dropped (mesh_loading.cuh:73-103),
    but face vertex specs split on '/' KEEPING empties ("1//2" has an empty
    uv slot, mesh_loading.cuh:301 `include_empty=true`);
  - negative (relative) OBJ indices (mesh_loading.cuh:105-150);
  - `vt` v coordinate stored flipped as 1 - v (mesh_loading.cuh:286);
  - all-zero `vn` lines are recorded as "false normals" and any face whose
    FIRST vertex references one is skipped entirely
    (mesh_loading.cuh:274-278, 303);
  - polygon faces are fan-triangulated from vertex 1
    (mesh_loading.cuh:305-314);
  - smoothed per-position normals = sum of (normalized) face normals,
    used unnormalized in assembly and only normalized after the transform
    (mesh_loading.cuh:328-342, 364-389, 436-438);
  - missing uv -> (1, 1), the reference's literal ZERO_VEC2D
    (math_library.cuh:13);
  - materials are loaded lazily per `usemtl` from the companion .mat file
    (mesh_loading.cuh:290-298); faces before any usemtl get the all-zero
    default material "" (std::map default-construction semantics), which
    is material 0 of every scene;
  - the mesh is re-centered on its bbox center, then p = M @ (p - c) +
    offset and n = normalize(M @ n) (mesh_loading.cuh:418-439).

Everything here is host numpy; ``create_scene_from_files`` hands the
assembled scene to ``accel.prepare_scene`` for the device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from isaklm_raytracer_tpu_torch.scene.mat import load_material
from isaklm_raytracer_tpu_torch.scene.texture import TextureRegistry
from isaklm_raytracer_tpu_torch.scene.types import MaterialTable, Scene, build_scene

DEFAULT_UV = np.array([1.0, 1.0], np.float32)  # ZERO_VEC2D quirk


@dataclasses.dataclass
class Transformation:
    """offset + 3x3 matrix (reference Transformation, mesh_loading.cuh:19-23)."""

    offset: np.ndarray
    matrix: np.ndarray

    @staticmethod
    def identity() -> "Transformation":
        return Transformation(np.zeros(3, np.float32), np.eye(3, dtype=np.float32))


@dataclasses.dataclass
class LoadedMesh:
    vertices: np.ndarray  # (N, 3, 3)
    normals: np.ndarray  # (N, 3, 3)
    uvs: np.ndarray  # (N, 3, 2)
    material_names: list  # length N


def _parse_index(token: str, count: int) -> int:
    idx = int(token)
    return idx - 1 if idx > 0 else count + idx


def _parse_vertex(spec: str, counts) -> tuple[int, int, int]:
    """'p/t/n' -> (pos, uv, normal) indices; -1 = absent
    (create_vertex, mesh_loading.cuh:105-150)."""
    fields = spec.split("/")
    pos = _parse_index(fields[0], counts[0]) if len(fields) > 0 and fields[0] else -1
    uv = _parse_index(fields[1], counts[1]) if len(fields) > 1 and fields[1] else -1
    nrm = _parse_index(fields[2], counts[2]) if len(fields) > 2 and fields[2] else -1
    return pos, uv, nrm


def _parse_python(model_file_path: str, material_file_path: str, materials: dict, loader):
    """The pure-Python parser: the same arrays as ``native.obj_parse_native``,
    with material names per face, loading each material at its first
    ``usemtl``."""
    positions: list[np.ndarray] = []
    normals: list[np.ndarray] = []
    uvs: list[np.ndarray] = []
    false_normals: set[int] = set()
    faces: list[tuple] = []  # (v1, v2, v3, material_name)
    material_name = ""

    with open(model_file_path, "r") as f:
        for raw in f:
            toks = [t for t in raw.strip().split(" ") if t != ""]
            if not toks:
                continue
            tag = toks[0]
            if tag == "v":
                positions.append(
                    np.array([float(toks[1]), float(toks[2]), float(toks[3])], np.float32)
                )
            elif tag == "vn":
                n = np.array([float(toks[1]), float(toks[2]), float(toks[3])], np.float32)
                if n[0] == 0 and n[1] == 0 and n[2] == 0:
                    false_normals.add(len(normals))
                normals.append(n)
            elif tag == "vt":
                uvs.append(np.array([float(toks[1]), 1.0 - float(toks[2])], np.float32))
            elif tag == "usemtl":
                material_name = toks[1]
                if material_name not in materials:
                    materials[material_name] = load_material(
                        material_file_path, material_name, loader
                    )
            elif tag == "f":
                counts = (len(positions), len(uvs), len(normals))
                v1 = _parse_vertex(toks[1], counts)
                if v1[2] in false_normals:
                    continue  # the reference skips the whole face on a false v1 normal
                for i in range(3, len(toks)):
                    v2 = _parse_vertex(toks[i - 1], counts)
                    v3 = _parse_vertex(toks[i], counts)
                    faces.append((v1, v2, v3, material_name))

    pos_arr = np.stack(positions) if positions else np.zeros((0, 3), np.float32)
    nrm_arr = np.stack(normals) if normals else np.zeros((0, 3), np.float32)
    uv_arr = np.stack(uvs) if uvs else np.zeros((0, 2), np.float32)
    corner = [np.array([[v[k] for v in face[:3]] for face in faces], np.int32).reshape(-1, 3)
              for k in range(3)]
    return pos_arr, nrm_arr, uv_arr, *corner, [face[3] for face in faces]


def load_mesh(
    model_file_path: str,
    material_file_path: str,
    transformation: Optional[Transformation] = None,
    smooth_normals: bool = False,
    materials: Optional[dict] = None,
    texture_registry: Optional[TextureRegistry] = None,
    use_native: bool = True,
) -> LoadedMesh:
    """Parse one OBJ file into transformed triangle arrays.

    ``materials`` (name -> material dict) accumulates lazily loaded
    materials across meshes; pass the same dict for every mesh of a scene.
    ``use_native`` (the default) parses with the C++ parser
    (``native.obj_parse_native``), which raises if it cannot be built;
    ``use_native=False`` runs the pure-Python parser, the oracle of the
    tests. Both give the same output.
    """
    if transformation is None:
        transformation = Transformation.identity()
    if materials is None:
        materials = {}
    loader = texture_registry.load if texture_registry is not None else None

    if not use_native:
        parsed = _parse_python(model_file_path, material_file_path, materials, loader)
        return _assemble(*parsed, transformation, smooth_normals)

    from isaklm_raytracer_tpu_torch.native import obj_parse_native

    parsed = obj_parse_native(model_file_path)
    # Lazy material loads in the order usemtl appeared
    # (mesh_loading.cuh:290-298); -1 face_mat = no usemtl yet.
    for name in parsed["mat_names"]:
        if name not in materials:
            materials[name] = load_material(material_file_path, name, loader)
    names_by_id = parsed["mat_names"]
    return _assemble(
        parsed["positions"], parsed["normals"], parsed["uvs"],
        parsed["face_pos"], parsed["face_uv"], parsed["face_nrm"],
        [names_by_id[m] if m >= 0 else "" for m in parsed["face_mat"]],
        transformation, smooth_normals,
    )


DEFAULT_MATERIAL = {
    "albedo": (0.0, 0.0, 0.0),
    "emittance": (0.0, 0.0, 0.0),
    "roughness": 0.0,
    "ior": 0.0,
    "extinction": 0.0,
    "transparent": 0.0,
    "tex_id": -1,
}


def create_scene_from_files(
    meshes: list[tuple],
    prepare: bool = True,
    device="cuda",
    kd_depth: int | None = None,
    kd_leaf: int | None = None,
) -> Scene:
    """Load a list of (obj_path, mat_path, Transformation, smooth_normals)
    into one Scene (reference create_scene, create_scene.cuh:18-73 +
    create_models.cuh:17-43).

    The scene is assembled with host numpy leaves by
    ``scene.types.build_scene``; with ``prepare`` (the default; the JAX
    package's ``build_kd``) it then goes through ``accel.prepare_scene``:
    the card unless the caller passes "cpu", raising without one. Given
    ``kd_depth`` or ``kd_leaf``, the prepared scene also carries a KD tree
    of that depth and leaf size (the other at its default, 19 or 7);
    without them it carries none, ``prepare_scene``'s default, since the
    port's renders take the cluster tables. Meshes are parsed by the
    native parser (``load_mesh``'s default)."""
    registry = TextureRegistry()
    materials: dict[str, dict] = {"": dict(DEFAULT_MATERIAL)}
    parts: list[LoadedMesh] = []
    for obj_path, mat_path, transformation, smooth in meshes:
        parts.append(
            load_mesh(obj_path, mat_path, transformation, smooth, materials, registry)
        )

    mat_names = list(materials.keys())
    mat_index = {n: i for i, n in enumerate(mat_names)}
    table = MaterialTable.stack([materials[n] for n in mat_names])

    vertices = np.concatenate([p.vertices for p in parts])
    normals = np.concatenate([p.normals for p in parts])
    uvs = np.concatenate([p.uvs for p in parts])
    mat_id = np.array([mat_index[n] for p in parts for n in p.material_names], np.int32)

    scene = build_scene(vertices, normals, uvs, mat_id, table, registry.build())
    if prepare:
        from isaklm_raytracer_tpu_torch.accel import prepare_scene

        kd = kd_depth is not None or kd_leaf is not None
        scene = prepare_scene(scene, device, build_kd=kd,
                              max_depth=19 if kd_depth is None else kd_depth,
                              leaf_size=7 if kd_leaf is None else kd_leaf)
    return scene


def _assemble(
    pos_arr: np.ndarray,
    nrm_arr: np.ndarray,
    uv_arr: np.ndarray,
    face_pos: np.ndarray,
    face_uv: np.ndarray,
    face_nrm: np.ndarray,
    names: list,
    transformation: Transformation,
    smooth_normals: bool,
) -> LoadedMesh:
    """Vectorized triangle assembly + transform (mesh_loading.cuh:328-439).

    face_*: (F, 3) per-corner indices into pos/uv/nrm arrays, -1 = absent.
    """
    num_faces = len(face_pos)
    face_pos = face_pos.reshape(-1, 3)
    tri_v = np.zeros((num_faces, 3, 3), np.float32)
    tri_n = np.zeros((num_faces, 3, 3), np.float32)
    tri_uv = np.tile(DEFAULT_UV, (num_faces, 3, 1))
    if not num_faces:
        return LoadedMesh(tri_v, tri_n, tri_uv, list(names))

    f_idx = face_pos.astype(np.int64)
    p1, p2, p3 = pos_arr[f_idx[:, 0]], pos_arr[f_idx[:, 1]], pos_arr[f_idx[:, 2]]
    face_n = np.cross(p2 - p1, p3 - p1)
    lens = np.linalg.norm(face_n, axis=-1, keepdims=True)
    face_n = face_n / np.where(lens > 0, lens, 1.0)

    # Smoothed normals: per-position sum of unit face normals
    # (mesh_loading.cuh:328-342). Left unnormalized here on purpose.
    computed = np.zeros_like(pos_arr)
    if smooth_normals:
        for c in range(3):
            np.add.at(computed, f_idx[:, c], face_n)

    tri_v[:, 0], tri_v[:, 1], tri_v[:, 2] = p1, p2, p3
    for c in range(3):
        nrm_idx = face_nrm[:, c].astype(np.int64)
        has_vn = nrm_idx >= 0
        if len(nrm_arr):
            corner = nrm_arr[np.clip(nrm_idx, 0, len(nrm_arr) - 1)]
        else:
            corner = np.zeros((num_faces, 3), np.float32)
        fallback = computed[f_idx[:, c]] if smooth_normals else face_n
        tri_n[:, c] = np.where(has_vn[:, None], corner, fallback)

        uv_idx = face_uv[:, c].astype(np.int64)
        has_uv = uv_idx >= 0
        if len(uv_arr):
            tri_uv[:, c] = np.where(
                has_uv[:, None], uv_arr[np.clip(uv_idx, 0, len(uv_arr) - 1)], DEFAULT_UV,
            )

    # Center on bbox center, then transform (mesh_loading.cuh:418-439).
    bmin = tri_v.reshape(-1, 3).min(axis=0)
    bmax = tri_v.reshape(-1, 3).max(axis=0)
    center = (bmin + bmax) * 0.5
    m = np.asarray(transformation.matrix, np.float32)
    off = np.asarray(transformation.offset, np.float32)
    tri_v = (tri_v - center) @ m.T + off
    tri_n = tri_n @ m.T
    lens = np.linalg.norm(tri_n, axis=-1, keepdims=True)
    tri_n = tri_n / np.where(lens > 0, lens, 1.0)
    return LoadedMesh(tri_v, tri_n, tri_uv, list(names))
