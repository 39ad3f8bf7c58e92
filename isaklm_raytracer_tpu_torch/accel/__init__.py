import os

import numpy as np
import torch

from isaklm_raytracer_tpu_torch.accel.cluster import (
    CLUSTER_WIDTH,
    ClusterBVH,
    build_cluster_bvh,
    cluster_order,
    morton_order,
    padded_clusters,
    with_blocks,
    with_mxu_blocks,
    with_mxu_tiles,
    with_oct_branch,
)
from isaklm_raytracer_tpu_torch.accel.kd_traverse import nearest_hit_kd
from isaklm_raytracer_tpu_torch.accel.kdtree import build_kd_tree
from isaklm_raytracer_tpu_torch.accel.traverse import (
    HitAttributes,
    hit_attributes,
    nearest_hit_brute,
)
from isaklm_raytracer_tpu_torch.accel.wavefront import (
    WavefrontKD,
    build_wavefront_kd,
    nearest_hit_wavefront,
)
from isaklm_raytracer_tpu_torch.config import resolve_device
from isaklm_raytracer_tpu_torch.kernels.intersect import VMEM_TABLE_LIMIT

KD_BUILD_LIMIT = 300_000  # build_kd=None builds the KD tree up to this size


def prepare_scene(scene, device="cuda", *, max_depth: int = 19, leaf_size: int = 7,
                  leaf_width: int = 8, build_kd: bool | None = False):
    """Build the acceleration tables of a Scene and move it to ``device``:
    the card unless the caller passes "cpu"; without a card the default
    raises (``config.resolve_device``).

    The KD arguments are keyword-only, after ``device``: the JAX package
    takes ``(scene, max_depth, leaf_size, leaf_width, build_kd)``
    positionally, and here the second positional argument is the device.

    Port of ``isaklm_raytracer_tpu.accel.prepare_scene``:

    1. renumbers the triangles with ``cluster_order`` so the intersector
       reconstructs triangle ids as c*128 + lane; every per-triangle array
       and the light list are permuted consistently;
    2. builds the cluster tables (``tri_const``, ``clu_bbox``,
       ``clu_bbox_t``, the oct tables) and, for a scene whose cluster table
       exceeds ``VMEM_TABLE_LIMIT`` (the blocked kernel's scenes), the
       blocked layout with ``ISAKLM_BLK_BRANCH`` clusters per block
       (default 128, as the JAX package), else the MXU tile pairs;
    3. packs the (T, 32) shading rows
       [p1 p2 p3 | n1 n2 n3 | uv1 uv2 uv3 | mat_id | pad];
    4. with ``build_kd``, builds the KD tree (``build_kd_tree(verts,
       max_depth, leaf_size)``, the native builder) and its chunk-row layout
       (``build_wavefront_kd`` with ``leaf_width``) on the host: the tables
       of the walks (``nearest_hit_wavefront``, ``nearest_hit_kd``), which
       ``integrator.render.make_trace_fn`` takes only for a scene without
       cluster tables. ``build_kd=None`` builds them for scenes of at most
       ``KD_BUILD_LIMIT`` triangles, the JAX package's default.

    The default here is ``build_kd=False``, unlike the JAX package: there
    the tree serves every backend but the TPU, while the port's renders
    take the cluster tables on every device, so a prepared scene's tree
    would cost host time and memory before the first sample and serve no
    render. A caller that walks the tree asks for it.
    """
    device = resolve_device(device)
    verts = np.asarray(scene.vertices)
    order = cluster_order(verts)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)

    lights = np.sort(inv[np.asarray(scene.light_indices)]).astype(np.int32)
    verts = verts[order]
    normals = np.asarray(scene.normals)[order]
    uvs = np.asarray(scene.uvs)[order]
    mat_id = np.asarray(scene.mat_id)[order]

    num = verts.shape[0]
    table = np.zeros((num, 32), np.float32)
    table[:, 0:9] = verts.reshape(num, 9)
    table[:, 9:18] = normals.reshape(num, 9)
    table[:, 18:24] = uvs.reshape(num, 6)
    table[:, 24] = mat_id

    blk_branch = _blk_branch(num)
    if build_kd is None:
        build_kd = num <= KD_BUILD_LIMIT
    kd = wkd = None
    if build_kd:
        kd = build_kd_tree(verts, max_depth, leaf_size)
        wkd = build_wavefront_kd(kd, verts, leaf_width)
    return move_scene(
        scene.replace(
            vertices=verts,
            normals=normals,
            uvs=uvs,
            mat_id=mat_id,
            light_indices=lights,
            shade_table=table,
            cbvh=build_cluster_bvh(verts, blk_branch=blk_branch,
                                   mxu_tiles=blk_branch is None),
            kd=kd,
            wkd=wkd,
        ),
        device,
    )


def _blk_branch(num_triangles: int):
    """Clusters per block for a scene too big for the queue kernel's table
    budget, else None (the JAX package's rule, accel/__init__.py:62-84)."""
    if padded_clusters(num_triangles) * 16 * CLUSTER_WIDTH * 4 <= VMEM_TABLE_LIMIT:
        return None
    return int(os.environ.get("ISAKLM_BLK_BRANCH", "128"))


def move_scene(scene, device):
    """The scene with every leaf as a tensor on ``device``."""

    def t(x):
        return None if x is None else torch.as_tensor(x).to(device)

    return scene.replace(
        vertices=t(scene.vertices),
        normals=t(scene.normals),
        uvs=t(scene.uvs),
        mat_id=t(scene.mat_id),
        light_indices=t(scene.light_indices),
        materials=scene.materials.to(device),
        textures=scene.textures.to(device),
        shade_table=t(scene.shade_table),
        cbvh=None if scene.cbvh is None else scene.cbvh.to(device),
        kd=None if scene.kd is None else scene.kd.to(device),
        wkd=None if scene.wkd is None else scene.wkd.to(device),
    )


__all__ = [
    "KD_BUILD_LIMIT",
    "ClusterBVH",
    "HitAttributes",
    "WavefrontKD",
    "build_cluster_bvh",
    "build_kd_tree",
    "build_wavefront_kd",
    "cluster_order",
    "hit_attributes",
    "morton_order",
    "move_scene",
    "nearest_hit_brute",
    "nearest_hit_kd",
    "nearest_hit_wavefront",
    "prepare_scene",
    "with_blocks",
    "with_mxu_blocks",
    "with_mxu_tiles",
    "with_oct_branch",
]
