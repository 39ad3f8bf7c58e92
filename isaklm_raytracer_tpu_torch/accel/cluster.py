"""Cluster tables for the flat intersector.

Port of the part of ``isaklm_raytracer_tpu/accel/cluster.py`` that the flat
kernel reads: ``cluster_order`` and the ``tri_const``/``clu_bbox`` tables of
``build_cluster_bvh``. Triangles are spatially renumbered and packed into
clusters of 128; cluster c holds triangle ids [c*128, (c+1)*128), and its
(16, 128) constant tile holds, per triangle slot (lane):

  rows 0-2   geometric normal n = cross(e1, e2)          (unnormalised)
  rows 3-5   edge e1 = p2 - p1
  rows 6-8   edge e2 = p3 - p1
  row  9     n . p1        (plane offset)
  row 10     p1 . e1
  row 11     p1 . e2
  row 12     d11 / den     (Cramer barycentric coefficients,
  row 13     d01 / den      den = d00*d11 - d01^2)
  row 14     d00 / den
  row 15     lanes 0-7 = the cluster's bbox row (minxyz, maxxyz, 0, 0)

Pad slots are all zeros; the intersection test rejects them because
``ddn == 0`` (or a NaN comparison is false). The oct, blocked and MXU
tables of the JAX package belong to kernels not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CLUSTER_WIDTH = 128  # triangles per cluster
CLUSTER_PAD = 64  # cluster-count padding granularity (as the JAX package)


@dataclasses.dataclass
class ClusterBVH:
    """Cluster tables over spatially renumbered triangles."""

    tri_const: torch.Tensor  # (C, 16, 128) f32
    clu_bbox: torch.Tensor  # (C, 8) f32; pad clusters carry inverted boxes
    num_triangles: int = 0

    @property
    def num_clusters(self) -> int:
        return self.tri_const.shape[0]

    @property
    def real_clusters(self) -> int:
        """Clusters that hold triangles (the rest is CLUSTER_PAD padding)."""
        return max(1, -(-self.num_triangles // CLUSTER_WIDTH))

    def to(self, device) -> "ClusterBVH":
        return ClusterBVH(
            tri_const=torch.as_tensor(self.tri_const).to(device),
            clu_bbox=torch.as_tensor(self.clu_bbox).to(device),
            num_triangles=self.num_triangles,
        )


def cluster_order(vertices: np.ndarray) -> np.ndarray:
    """Spatial median-split permutation (cluster.py:134-168).

    Recursive longest-axis median partition of the triangle centroids, the
    left split rounded up to a CLUSTER_WIDTH multiple, leaves emitted in DFS
    order. Returns ``order`` (T,) such that vertices[order] is
    cluster-packed.
    """
    verts = np.asarray(vertices, np.float32)
    cent = verts.mean(axis=1)
    total = cent.shape[0]
    out = np.empty(total, np.int64)
    pos = 0
    stack = [np.arange(total, dtype=np.int64)]
    while stack:
        idx = stack.pop()
        n = idx.size
        if n <= CLUSTER_WIDTH:
            out[pos:pos + n] = idx
            pos += n
            continue
        c = cent[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        left = -(-((n + 1) // 2) // CLUSTER_WIDTH) * CLUSTER_WIDTH
        part = np.argpartition(c[:, axis], left - 1)
        stack.append(idx[part[left:]])  # right pushed first ->
        stack.append(idx[part[:left]])  # left popped/emitted first (DFS)
    return out


def build_cluster_bvh(vertices: np.ndarray) -> ClusterBVH:
    """Host-side build over ALREADY renumbered triangles (cluster.py:324-389).

    vertices: (T, 3, 3) float32 in ``cluster_order`` order. Leaves are host
    numpy arrays; ``ClusterBVH.to`` moves them to a device.
    """
    vertices = np.asarray(vertices, np.float32)
    num_tris = vertices.shape[0]

    num_clusters = max(1, -(-num_tris // CLUSTER_WIDTH))
    num_clusters = -(-num_clusters // CLUSTER_PAD) * CLUSTER_PAD

    tri_ids = np.full(num_clusters * CLUSTER_WIDTH, -1, np.int64)
    tri_ids[:num_tris] = np.arange(num_tris)
    tri_ids = tri_ids.reshape(num_clusters, CLUSTER_WIDTH)

    safe = np.maximum(tri_ids, 0)
    tri = vertices[safe]  # (C, W, 3, 3)
    pad_mask = (tri_ids < 0)[..., None]
    p1 = np.where(pad_mask, 0.0, tri[:, :, 0])
    e1 = np.where(pad_mask, 0.0, tri[:, :, 1] - tri[:, :, 0])
    e2 = np.where(pad_mask, 0.0, tri[:, :, 2] - tri[:, :, 0])
    n = np.cross(e1, e2)

    d00 = np.sum(e1 * e1, axis=-1)
    d01 = np.sum(e1 * e2, axis=-1)
    d11 = np.sum(e2 * e2, axis=-1)
    den = d00 * d11 - d01 * d01
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_den = np.where(den != 0.0, 1.0 / den, 0.0)

    tri_const = np.zeros((num_clusters, 16, CLUSTER_WIDTH), np.float32)
    tri_const[:, 0:3] = np.moveaxis(n, -1, 1)
    tri_const[:, 3:6] = np.moveaxis(e1, -1, 1)
    tri_const[:, 6:9] = np.moveaxis(e2, -1, 1)
    tri_const[:, 9] = np.sum(n * p1, axis=-1)
    tri_const[:, 10] = np.sum(p1 * e1, axis=-1)
    tri_const[:, 11] = np.sum(p1 * e2, axis=-1)
    tri_const[:, 12] = d11 * inv_den
    tri_const[:, 13] = d01 * inv_den
    tri_const[:, 14] = d00 * inv_den

    # Empty/pad clusters get an inverted box.
    clu_bbox = np.zeros((num_clusters, 8), np.float32)
    clu_bbox[:, 0:3] = 3e38
    clu_bbox[:, 3:6] = -3e38
    valid_slot = tri_ids >= 0
    vmin = np.where(valid_slot[..., None, None], tri, 3e38).min(axis=(1, 2))
    vmax = np.where(valid_slot[..., None, None], tri, -3e38).max(axis=(1, 2))
    has_any = valid_slot.any(axis=1)
    clu_bbox[has_any, 0:3] = vmin[has_any]
    clu_bbox[has_any, 3:6] = vmax[has_any]
    tri_const[:, 15, 0:8] = clu_bbox

    return ClusterBVH(tri_const=tri_const, clu_bbox=clu_bbox, num_triangles=num_tris)
