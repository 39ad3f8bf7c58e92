"""Cluster tables for the flat, queue and blocked intersectors.

Port of the part of ``isaklm_raytracer_tpu/accel/cluster.py`` that those
kernels read: ``cluster_order``, the ``tri_const``/``clu_bbox`` tables of
``build_cluster_bvh``, the component-major box table ``clu_bbox_t`` and the
blocked layout (``with_blocks``, ``blk_branch=``). Triangles are spatially
renumbered and packed into clusters of 128; cluster c holds triangle ids
[c*128, (c+1)*128), and its (16, 128) constant tile holds, per triangle
slot (lane):

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
``ddn == 0`` (or a NaN comparison is false).

The blocked layout groups ``blk_branch`` consecutive clusters into a block
of ``blk_branch + 1`` tiles: a HEADER tile whose rows 0-5 hold the
block's cluster boxes component-major (lane k = cluster k of the block)
and row 6 their validity, then the block's cluster tiles. ``blk_bbox_t``
holds the block boxes the same way. The oct and MXU tables of the JAX
package belong to kernels not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
    # Component-major boxes: rows 0-5 = min xyz / max xyz along lanes
    # (padded to a 128 multiple), row 6 = validity (0.0 kills padding: an
    # inverted +-3e38 box does not fail the slab test once it saturates).
    clu_bbox_t: Optional[torch.Tensor] = None  # (8, 128-pad of C) f32
    blk_const: Optional[torch.Tensor] = None  # (NB, blk_branch + 1, 16, 128) f32
    blk_bbox_t: Optional[torch.Tensor] = None  # (8, 128-pad of NB) f32
    blk_branch: int = 0

    @property
    def num_clusters(self) -> int:
        return self.tri_const.shape[0]

    @property
    def vmem_bytes(self) -> int:
        """Bytes of the cluster table; the queue kernel's size rule reads it
        (the JAX package's name, for its VMEM budget)."""
        return self.num_clusters * 16 * CLUSTER_WIDTH * 4

    @property
    def real_clusters(self) -> int:
        """Clusters that hold triangles (the rest is CLUSTER_PAD padding)."""
        return max(1, -(-self.num_triangles // CLUSTER_WIDTH))

    def to(self, device) -> "ClusterBVH":
        def t(x):
            return None if x is None else torch.as_tensor(x).to(device)

        return ClusterBVH(
            tri_const=t(self.tri_const),
            clu_bbox=t(self.clu_bbox),
            num_triangles=self.num_triangles,
            clu_bbox_t=t(self.clu_bbox_t),
            blk_const=t(self.blk_const),
            blk_bbox_t=t(self.blk_bbox_t),
            blk_branch=self.blk_branch,
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


def padded_clusters(num_triangles: int) -> int:
    """Clusters of the table of ``num_triangles``, padded to CLUSTER_PAD."""
    num_clusters = max(1, -(-num_triangles // CLUSTER_WIDTH))
    return -(-num_clusters // CLUSTER_PAD) * CLUSTER_PAD


def _bbox_t(bbox: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Component-major 128-padded box table (see ClusterBVH.clu_bbox_t)."""
    n = bbox.shape[0]
    n_pad = -(-n // 128) * 128
    out = np.zeros((8, n_pad), np.float32)
    out[0:6, :n] = bbox[:, 0:6].T
    out[6, :n] = valid.astype(np.float32)
    return out


def _build_blocks_np(tri_const: np.ndarray, clu_bbox: np.ndarray, branch: int):
    """The blocked layout (see the module docstring): (blk_const, blk_bbox_t)."""
    if not 1 <= branch <= CLUSTER_WIDTH:
        raise ValueError(f"blk_branch must be in [1, {CLUSTER_WIDTH}] (header lanes), got {branch}")
    num_clusters = clu_bbox.shape[0]
    if num_clusters % branch:  # pad with inverted-box (always-culled) clusters
        pad = branch - num_clusters % branch
        tri_const = np.concatenate(
            [tri_const, np.zeros((pad,) + tri_const.shape[1:], np.float32)]
        )
        pad_box = np.zeros((pad, 8), np.float32)
        pad_box[:, 0:3] = 3e38
        pad_box[:, 3:6] = -3e38
        clu_bbox = np.concatenate([clu_bbox, pad_box])
        num_clusters += pad
    num_blk = num_clusters // branch
    has_any = clu_bbox[:, 0] <= clu_bbox[:, 3]

    blk = np.zeros((num_blk, branch + 1, 16, CLUSTER_WIDTH), np.float32)
    hdr_box = clu_bbox.reshape(num_blk, branch, 8)
    blk[:, 0, 0:6, :branch] = np.moveaxis(hdr_box[:, :, 0:6], 1, 2)
    blk[:, 0, 6, :branch] = has_any.reshape(num_blk, branch).astype(np.float32)
    blk[:, 1:] = tri_const.reshape(num_blk, branch, 16, CLUSTER_WIDTH)

    blk_bbox = np.zeros((num_blk, 8), np.float32)
    blk_bbox[:, 0:3] = np.where(
        has_any.reshape(num_blk, branch, 1), hdr_box[:, :, 0:3], 3e38
    ).min(axis=1)
    blk_bbox[:, 3:6] = np.where(
        has_any.reshape(num_blk, branch, 1), hdr_box[:, :, 3:6], -3e38
    ).max(axis=1)
    blk_valid = has_any.reshape(num_blk, branch).any(axis=1)
    return blk, _bbox_t(blk_bbox, blk_valid)


def with_blocks(cbvh: ClusterBVH, branch: int = 32) -> ClusterBVH:
    """``cbvh`` with the blocked layout of ``branch`` clusters per block
    (``branch`` <= 128, the header's lanes), built on the host from its
    tables and moved to the device they lie on."""
    device = torch.as_tensor(cbvh.tri_const).device
    blk, blk_bbox_t = _build_blocks_np(
        np.asarray(torch.as_tensor(cbvh.tri_const).cpu()),
        np.asarray(torch.as_tensor(cbvh.clu_bbox).cpu()),
        branch,
    )
    return dataclasses.replace(
        cbvh,
        blk_const=torch.from_numpy(blk).to(device),
        blk_bbox_t=torch.from_numpy(blk_bbox_t).to(device),
        blk_branch=branch,
    )


def build_cluster_bvh(vertices: np.ndarray, blk_branch: Optional[int] = None) -> ClusterBVH:
    """Host-side build over ALREADY renumbered triangles (cluster.py:324-430).

    vertices: (T, 3, 3) float32 in ``cluster_order`` order. ``blk_branch``
    also builds the blocked layout from the numpy intermediates. Leaves are
    host numpy arrays; ``ClusterBVH.to`` moves them to a device.
    """
    vertices = np.asarray(vertices, np.float32)
    num_tris = vertices.shape[0]
    num_clusters = padded_clusters(num_tris)

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

    blk = blk_bbox_t = None
    if blk_branch is not None:
        blk, blk_bbox_t = _build_blocks_np(tri_const, clu_bbox, blk_branch)
    return ClusterBVH(
        tri_const=tri_const,
        clu_bbox=clu_bbox,
        num_triangles=num_tris,
        clu_bbox_t=_bbox_t(clu_bbox, has_any),
        blk_const=blk,
        blk_bbox_t=blk_bbox_t,
        blk_branch=0 if blk_branch is None else blk_branch,
    )
