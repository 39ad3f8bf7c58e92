"""OBJ / .mat scene export.

Port of ``isaklm_raytracer_tpu/scene/export.py``. Writes triangle-soup
scene arrays as an indexed Wavefront OBJ (v/vn/vt + usemtl groups) plus a
companion ``.mat`` file in the reference's custom format
(mesh_loading.cuh:152-219), such that loading the pair back through
``scene.obj.create_scene_from_files`` reproduces the same triangle soup.
The reference has no exporter; this lets any scene, the procedural hero
included, travel through the real asset pipeline (OBJ text -> native C++
parser -> scene assembly).
"""

from __future__ import annotations

import os

import numpy as np

_F = "%.9g"  # round-trips float32 exactly through text


def material_rows(materials, texture_paths: dict | None = None) -> list[dict]:
    """The rows of a ``MaterialTable`` as the material dicts ``save_mat``
    writes; ``texture_paths`` maps a row's index to its texture file."""
    fields = ("albedo", "emittance", "roughness", "ior", "extinction", "transparent")
    cols = {k: np.asarray(getattr(materials, k)) for k in fields}
    rows = []
    for i in range(cols["ior"].shape[0]):
        row = {k: tuple(v[i]) if v.ndim == 2 else float(v[i]) for k, v in cols.items()}
        if texture_paths and i in texture_paths:
            row["texture_path"] = texture_paths[i]
        rows.append(row)
    return rows


def save_mat(path: str, names: list[str], materials: list[dict]) -> None:
    """Write named material dicts (``MaterialTable.stack`` rows) as a .mat
    file (format of mesh_loading.cuh:152-219; keys n/k = ior/extinction; a
    ``texture_path`` entry becomes a ``texture`` line)."""
    lines = []
    for name, m in zip(names, materials):
        lines.append(f"material {name}")
        a = m.get("albedo", (0.0, 0.0, 0.0))
        e = m.get("emittance", (0.0, 0.0, 0.0))
        lines.append("albedo " + " ".join(_F % v for v in a))
        lines.append("emittance " + " ".join(_F % v for v in e))
        lines.append("roughness " + _F % m.get("roughness", 0.0))
        lines.append("n " + _F % m.get("ior", 0.0))
        lines.append("k " + _F % m.get("extinction", 0.0))
        if m.get("transparent", 0.0):
            lines.append("transparent")
        tex = m.get("texture_path")
        if tex:
            lines.append(f"texture {tex}")
        lines.append("")  # blank line ends the section
    with open(path, "w") as f:
        f.write("\n".join(lines))


def save_obj(
    obj_path: str,
    vertices: np.ndarray,  # (T, 3, 3)
    normals: np.ndarray,  # (T, 3, 3)
    mat_id: np.ndarray,  # (T,)
    mat_names: list[str],  # material-table index -> name
    uvs: np.ndarray | None = None,  # (T, 3, 2); all-(1,1) is omitted
) -> None:
    """Write triangle arrays (host numpy) as an indexed OBJ.

    Positions/normals/uvs are deduplicated bitwise (np.unique); faces are
    emitted in triangle order grouped into usemtl runs, so a loader that
    appends triangles per face (mesh_loading.cuh:305-314) reproduces the
    original array order. The loader re-centers a mesh on its bbox center
    and then applies the manifest transform (mesh_loading.cuh:418-439):
    load with offset ``load_offset(vertices)`` to recover the original
    coordinates.
    """
    vertices = np.asarray(vertices, np.float32)
    normals = np.asarray(normals, np.float32)
    mat_id = np.asarray(mat_id)
    num_tris = vertices.shape[0]

    upos, pinv = np.unique(vertices.reshape(-1, 3), axis=0, return_inverse=True)
    unrm, ninv = np.unique(normals.reshape(-1, 3), axis=0, return_inverse=True)
    pinv = pinv.reshape(num_tris, 3) + 1  # OBJ is 1-based
    ninv = ninv.reshape(num_tris, 3) + 1

    write_vt = uvs is not None and not bool(np.all(np.asarray(uvs, np.float32) == np.float32(1.0)))
    if write_vt:
        # the loader stores vt.v as 1 - v (mesh_loading.cuh:286): pre-flip so
        # the loaded uvs equal the originals.
        flipped = np.asarray(uvs, np.float32).reshape(-1, 2).copy()
        flipped[:, 1] = 1.0 - flipped[:, 1]
        uuv, uvinv = np.unique(flipped, axis=0, return_inverse=True)
        uvinv = uvinv.reshape(num_tris, 3) + 1

    directory = os.path.dirname(obj_path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    with open(obj_path, "w") as f:
        np.savetxt(f, upos, fmt=f"v {_F} {_F} {_F}")
        np.savetxt(f, unrm, fmt=f"vn {_F} {_F} {_F}")
        if write_vt:
            np.savetxt(f, uuv, fmt=f"vt {_F} {_F}")
        # usemtl runs over consecutive equal mat ids
        bounds = np.concatenate([[0], np.flatnonzero(np.diff(mat_id)) + 1, [num_tris]])
        for s, e in zip(bounds[:-1], bounds[1:]):
            f.write(f"usemtl {mat_names[int(mat_id[s])]}\n")
            if write_vt:
                face = np.stack(
                    [pinv[s:e, 0], uvinv[s:e, 0], ninv[s:e, 0],
                     pinv[s:e, 1], uvinv[s:e, 1], ninv[s:e, 1],
                     pinv[s:e, 2], uvinv[s:e, 2], ninv[s:e, 2]], axis=1
                )
                np.savetxt(f, face, fmt="f %d/%d/%d %d/%d/%d %d/%d/%d")
            else:
                face = np.stack(
                    [pinv[s:e, 0], ninv[s:e, 0],
                     pinv[s:e, 1], ninv[s:e, 1],
                     pinv[s:e, 2], ninv[s:e, 2]], axis=1
                )
                np.savetxt(f, face, fmt="f %d//%d %d//%d %d//%d")


def load_offset(vertices: np.ndarray) -> np.ndarray:
    """The manifest offset that undoes the loader's bbox re-centering
    (mesh_loading.cuh:418-439): the exported mesh's bbox center."""
    flat = np.asarray(vertices, np.float32).reshape(-1, 3)
    return (flat.min(axis=0) + flat.max(axis=0)) * 0.5
