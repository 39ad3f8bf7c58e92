import os

import numpy as np
import torch

from isaklm_raytracer_tpu_torch.accel.cluster import (
    CLUSTER_WIDTH,
    ClusterBVH,
    build_cluster_bvh,
    cluster_order,
    padded_clusters,
    with_blocks,
)
from isaklm_raytracer_tpu_torch.accel.traverse import (
    HitAttributes,
    hit_attributes,
    nearest_hit_brute,
)
from isaklm_raytracer_tpu_torch.config import resolve_device
from isaklm_raytracer_tpu_torch.kernels.intersect import VMEM_TABLE_LIMIT


def prepare_scene(scene, device="cuda"):
    """Build the acceleration tables of a Scene and move it to ``device``:
    the card unless the caller passes "cpu"; without a card the default
    raises (``config.resolve_device``).

    Port of ``isaklm_raytracer_tpu.accel.prepare_scene``:

    1. renumbers the triangles with ``cluster_order`` so the intersector
       reconstructs triangle ids as c*128 + lane; every per-triangle array
       and the light list are permuted consistently;
    2. builds the cluster tables (``tri_const``, ``clu_bbox``,
       ``clu_bbox_t``) and, for a scene whose cluster table exceeds
       ``VMEM_TABLE_LIMIT`` (the blocked kernel's scenes), the blocked
       layout with ``ISAKLM_BLK_BRANCH`` clusters per block (default 128,
       as the JAX package);
    3. packs the (T, 32) shading rows
       [p1 p2 p3 | n1 n2 n3 | uv1 uv2 uv3 | mat_id | pad].

    No KD tree is built: the port has no KD traversal. No MXU tiles are
    built: no ported kernel reads them.
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

    return move_scene(
        scene.replace(
            vertices=verts,
            normals=normals,
            uvs=uvs,
            mat_id=mat_id,
            light_indices=lights,
            shade_table=table,
            cbvh=build_cluster_bvh(verts, blk_branch=_blk_branch(num)),
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
    )


__all__ = [
    "ClusterBVH",
    "HitAttributes",
    "build_cluster_bvh",
    "cluster_order",
    "hit_attributes",
    "move_scene",
    "nearest_hit_brute",
    "prepare_scene",
    "with_blocks",
]
