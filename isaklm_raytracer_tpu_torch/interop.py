"""Carry scene, camera and G-buffer state between the two packages.

Plain functions on numpy leaves; this module imports neither JAX nor the
JAX package. The ``*_to_numpy`` functions read the leaves of any object
with the fields of the JAX package's ``Scene``, ``Camera`` or ``GBuffer``
(its own, or the port's) with ``np.asarray``; the ``*_from_numpy``
functions build the port's dataclasses from them. ``MaterialTable`` is the
differentiable parameter set and the ``GBuffer`` the resumable state, so
with these a test gives both packages the same scene, camera and
accumulator.

Scene dict layout (keys as the Scene fields):
  vertices, normals, uvs, mat_id, light_indices, has_lights,
  materials: {albedo, emittance, roughness, ior, extinction, transparent, tex_id},
  textures: {buffer, offset, width, height},
  shade_table (may be None),
  cbvh (may be None): {tri_const, clu_bbox, num_triangles, clu_bbox_t,
    blk_const, blk_bbox_t, blk_branch, oct_bbox, oct_bbox_t, mxu_const,
    mxu_branch, mxu_tiles} (every table but the first two may be None),
  kd (may be None): {child_a, child_b, axis, plane, is_leaf, tri_indices,
    bbox_min, bbox_max, max_depth},
  wkd (may be None): {child_a, child_b, axis, plane, is_leaf, leaf_first,
    chunk_next, chunk_tri, chunk_data, bbox_min, bbox_max, max_depth,
    leaf_width}; the port's WavefrontKD also keeps the scene's vertices as
    its ``corners``.
"""

from __future__ import annotations

import numpy as np
import torch

from isaklm_raytracer_tpu_torch.accel.cluster import ClusterBVH
from isaklm_raytracer_tpu_torch.accel.wavefront import WavefrontKD
from isaklm_raytracer_tpu_torch.camera.camera import Camera
from isaklm_raytracer_tpu_torch.config import resolve_device
from isaklm_raytracer_tpu_torch.scene.types import (
    GBuffer,
    KDTreeArrays,
    MaterialTable,
    Scene,
    TextureAtlas,
)

_SCENE = ("vertices", "normals", "uvs", "mat_id", "light_indices")
_MATERIALS = ("albedo", "emittance", "roughness", "ior", "extinction", "transparent", "tex_id")
_TEXTURES = ("buffer", "offset", "width", "height")
_CAMERA = ("position", "yaw", "pitch", "fov", "aperture_radius")
_GBUFFER = ("frame", "sq_luminance", "count")
_CBVH = ("tri_const", "clu_bbox", "clu_bbox_t", "blk_const", "blk_bbox_t", "oct_bbox",
         "oct_bbox_t", "mxu_const", "mxu_tiles")
_CBVH_INTS = ("num_triangles", "blk_branch", "mxu_branch")
_KD = ("child_a", "child_b", "axis", "plane", "is_leaf", "tri_indices", "bbox_min", "bbox_max")
_WKD = ("child_a", "child_b", "axis", "plane", "is_leaf", "leaf_first", "chunk_next",
        "chunk_tri", "chunk_data", "bbox_min", "bbox_max")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _tensor(x, device) -> torch.Tensor:
    if x is None:
        return None
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _leaves(obj, names) -> dict:
    return {k: _np(getattr(obj, k)) for k in names}


def _tree(tree, names, ints) -> dict:
    if tree is None:
        return None
    return {**_leaves(tree, names), **{k: int(getattr(tree, k)) for k in ints}}


def scene_to_numpy(scene) -> dict:
    """The numpy leaves of a JAX-package or port Scene."""
    cbvh = scene.cbvh
    return {
        "kd": _tree(scene.kd, _KD, ("max_depth",)),
        "wkd": _tree(scene.wkd, _WKD, ("max_depth", "leaf_width")),
        **_leaves(scene, _SCENE),
        "has_lights": bool(scene.has_lights),
        "materials": _leaves(scene.materials, _MATERIALS),
        "textures": _leaves(scene.textures, _TEXTURES),
        "shade_table": None if scene.shade_table is None else _np(scene.shade_table),
        "cbvh": None if cbvh is None else {
            **{k: None if getattr(cbvh, k) is None else _np(getattr(cbvh, k))
               for k in _CBVH},
            **{k: int(getattr(cbvh, k)) for k in _CBVH_INTS},
        },
    }


def scene_from_numpy(leaves: dict, device="cuda") -> Scene:
    """A port Scene on ``device`` from a dict of numpy leaves: the card
    unless the caller passes "cpu"; without a card the default raises."""
    device = resolve_device(device)
    cbvh = leaves.get("cbvh")
    shade = leaves.get("shade_table")
    kd, wkd = leaves.get("kd"), leaves.get("wkd")
    return Scene(
        **{k: _tensor(leaves[k], device) for k in _SCENE},
        materials=MaterialTable(
            **{k: _tensor(leaves["materials"][k], device) for k in _MATERIALS}
        ),
        textures=TextureAtlas(
            **{k: _tensor(leaves["textures"][k], device) for k in _TEXTURES}
        ),
        cbvh=None if cbvh is None else ClusterBVH(
            **{k: _tensor(cbvh.get(k), device) for k in _CBVH},
            **{k: int(cbvh.get(k, 0)) for k in _CBVH_INTS},
        ),
        shade_table=None if shade is None else _tensor(shade, device),
        kd=None if kd is None else KDTreeArrays(
            **{k: _tensor(kd[k], device) for k in _KD}, max_depth=kd["max_depth"]),
        wkd=None if wkd is None else WavefrontKD(
            **{k: _tensor(wkd[k], device) for k in _WKD},
            corners=_tensor(np.asarray(leaves["vertices"], np.float32).reshape(-1, 9), device),
            max_depth=wkd["max_depth"], leaf_width=wkd["leaf_width"]),
        has_lights=bool(leaves["has_lights"]),
    )


def camera_to_numpy(camera) -> dict:
    """The numpy leaves of a JAX-package or port Camera."""
    return _leaves(camera, _CAMERA)


def camera_from_numpy(position, yaw, pitch, fov, aperture_radius, device="cuda") -> Camera:
    """A port Camera on ``device`` from a Camera's leaves (the card unless
    the caller passes "cpu")."""
    device = resolve_device(device)
    return Camera(*(
        _tensor(np.asarray(x, np.float32), device)
        for x in (position, yaw, pitch, fov, aperture_radius)
    ))


def gbuffer_to_numpy(gbuffer) -> dict:
    """The numpy leaves of a JAX-package or port GBuffer."""
    return _leaves(gbuffer, _GBUFFER)


def gbuffer_from_numpy(frame, sq_luminance, count, device="cuda") -> GBuffer:
    """A port GBuffer on ``device`` from a GBuffer's leaves (the card
    unless the caller passes "cpu")."""
    device = resolve_device(device)
    return GBuffer(
        frame=_tensor(np.asarray(frame, np.float32), device),
        sq_luminance=_tensor(np.asarray(sq_luminance, np.float32), device),
        count=_tensor(np.asarray(count, np.int32), device),
    )
