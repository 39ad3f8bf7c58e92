"""Cluster tables for the intersectors.

Port of ``isaklm_raytracer_tpu/accel/cluster.py``: ``cluster_order``, the
``tri_const``/``clu_bbox`` tables of ``build_cluster_bvh``, the
component-major box tables, the oct tables, the blocked layout and the MXU
layouts. Triangles are spatially renumbered and packed into clusters of
128; cluster c holds triangle ids [c*128, (c+1)*128), and its (16, 128)
constant tile holds, per triangle slot (lane):

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

An OCT is ``oct_branch`` consecutive clusters (``OCT_BRANCH``, or another
divisor of the cluster count by ``with_oct_branch``); ``oct_bbox`` holds
their merged boxes and ``oct_bbox_t`` the same component-major.

The blocked layout groups ``blk_branch`` consecutive clusters into a block
of ``blk_branch + 1`` tiles: a HEADER tile whose rows 0-5 hold the
block's cluster boxes component-major (lane k = cluster k of the block)
and row 6 their validity, then the block's cluster tiles. ``blk_bbox_t``
holds the block boxes the same way.

The MXU layouts store each cluster as a PAIR of tiles, W1 = [n (rows 0-2);
e1 (rows 8-10)] and W2 = [e2 (rows 0-2); np1 p1e1 p1e2 ca cb cc (rows
8-13)], the other rows zero: ``mxu_tiles`` (C, 2, 16, 128) per cluster,
and ``mxu_const``, blocks of ``mxu_branch`` clusters with the header tile
of the blocked layout followed by the pairs. Both layouts share
``blk_bbox_t``, so a table carries blocks of one branch: the JAX package
lets ``blk_branch`` and ``mxu_branch`` differ and then walks one of them
with the other's block boxes; here that raises ValueError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

CLUSTER_WIDTH = 128  # triangles per cluster
CLUSTER_PAD = 64  # cluster-count padding granularity (as the JAX package)
OCT_BRANCH = 8  # clusters per oct of build_cluster_bvh (as the JAX package)


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
    oct_bbox: Optional[torch.Tensor] = None  # (C / oct_branch, 8) f32
    oct_bbox_t: Optional[torch.Tensor] = None  # (8, 128-pad of C / oct_branch) f32
    mxu_const: Optional[torch.Tensor] = None  # (NB, 2 * mxu_branch + 1, 16, 128) f32
    mxu_branch: int = 0
    mxu_tiles: Optional[torch.Tensor] = None  # (C, 2, 16, 128) f32

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

    @property
    def oct_branch(self) -> int:
        """Clusters per oct of the oct tables."""
        return self.num_clusters // self.oct_bbox.shape[0]

    def to(self, device) -> "ClusterBVH":
        """The tables as tensors on ``device``."""
        return dataclasses.replace(self, **{
            f.name: torch.as_tensor(v).to(device)
            for f in dataclasses.fields(self)
            if isinstance(v := getattr(self, f.name), (np.ndarray, torch.Tensor))
        })


def _morton3(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Interleave 10-bit integer coordinates into a 30-bit Morton code."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(x) | (spread(y) << 1) | (spread(z) << 2)


def morton_order(vertices: np.ndarray) -> np.ndarray:
    """Morton-sort permutation of the triangles by quantised centroid
    (cluster.py:119-131): ``order`` (T,) int64 such that vertices[order] is
    Morton-ordered, 10 bits an axis over the centroids' box, ties stable.
    ``prepare_scene`` orders by ``cluster_order``; this order is valid for
    the cluster tables too."""
    vertices = np.asarray(vertices, np.float32)
    centroids = vertices.mean(axis=1)
    lo = centroids.min(axis=0)
    span = np.maximum(centroids.max(axis=0) - lo, 1e-12)
    q = np.clip(((centroids - lo) / span) * 1023.0, 0, 1023).astype(np.uint32)
    return np.argsort(_morton3(q[:, 0], q[:, 1], q[:, 2]), kind="stable")


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


def _oct_tables_np(clu_bbox: np.ndarray, branch: int):
    """(oct_bbox, oct_bbox_t) of octs of ``branch`` clusters."""
    num_clusters = clu_bbox.shape[0]
    if branch < 1 or num_clusters % branch:
        raise ValueError(f"oct_branch {branch} must divide the {num_clusters} clusters")
    has_any = clu_bbox[:, 0] <= clu_bbox[:, 3]  # non-inverted box
    num_oct = num_clusters // branch
    og = clu_bbox.reshape(num_oct, branch, 8)
    oct_bbox = np.zeros((num_oct, 8), np.float32)
    oct_bbox[:, 0:3] = og[:, :, 0:3].min(axis=1)
    oct_bbox[:, 3:6] = og[:, :, 3:6].max(axis=1)
    oct_valid = has_any.reshape(num_oct, branch).any(axis=1)
    return oct_bbox, _bbox_t(oct_bbox, oct_valid)


def _mxu_pairs_np(tri_const: np.ndarray) -> np.ndarray:
    """(..., 2, 16, 128) MXU tile pairs W1, W2 of (..., 16, 128) tiles."""
    pairs = np.zeros(tri_const.shape[:-2] + (2, 16, CLUSTER_WIDTH), np.float32)
    pairs[..., 0, 0:3, :] = tri_const[..., 0:3, :]    # W1: n
    pairs[..., 0, 8:11, :] = tri_const[..., 3:6, :]   # W1: e1
    pairs[..., 1, 0:3, :] = tri_const[..., 6:9, :]    # W2: e2
    pairs[..., 1, 8:14, :] = tri_const[..., 9:15, :]  # W2: np1 p1e1 p1e2 ca cb cc
    return pairs


def _build_blocks_np(tri_const: np.ndarray, clu_bbox: np.ndarray, branch: int,
                     mxu: bool = False):
    """The blocked layout (see the module docstring): (blk_const, blk_bbox_t),
    or with ``mxu`` (mxu_const, blk_bbox_t)."""
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

    tiles = 2 * branch + 1 if mxu else branch + 1
    blk = np.zeros((num_blk, tiles, 16, CLUSTER_WIDTH), np.float32)
    hdr_box = clu_bbox.reshape(num_blk, branch, 8)
    blk[:, 0, 0:6, :branch] = np.moveaxis(hdr_box[:, :, 0:6], 1, 2)
    blk[:, 0, 6, :branch] = has_any.reshape(num_blk, branch).astype(np.float32)
    tc = tri_const.reshape(num_blk, branch, 16, CLUSTER_WIDTH)
    if mxu:
        blk[:, 1:] = _mxu_pairs_np(tc).reshape(num_blk, 2 * branch, 16, CLUSTER_WIDTH)
    else:
        blk[:, 1:] = tc

    blk_bbox = np.zeros((num_blk, 8), np.float32)
    blk_bbox[:, 0:3] = np.where(
        has_any.reshape(num_blk, branch, 1), hdr_box[:, :, 0:3], 3e38
    ).min(axis=1)
    blk_bbox[:, 3:6] = np.where(
        has_any.reshape(num_blk, branch, 1), hdr_box[:, :, 3:6], -3e38
    ).max(axis=1)
    blk_valid = has_any.reshape(num_blk, branch).any(axis=1)
    return blk, _bbox_t(blk_bbox, blk_valid)


def _check_branches(blk_branch, mxu_branch) -> None:
    """Both block layouts read one blk_bbox_t, so they must agree."""
    if blk_branch and mxu_branch and blk_branch != mxu_branch:
        raise ValueError(
            f"blk_branch {blk_branch} and mxu_branch {mxu_branch} differ, but both "
            "block layouts share one blk_bbox_t table"
        )


def _host(x) -> np.ndarray:
    return np.asarray(torch.as_tensor(x).cpu())


def _device_of(cbvh: ClusterBVH):
    return torch.as_tensor(cbvh.tri_const).device


def with_oct_branch(cbvh: ClusterBVH, branch: int) -> ClusterBVH:
    """``cbvh`` with oct tables of ``branch`` clusters per oct, which must
    divide the cluster count (every power of two up to CLUSTER_PAD does)."""
    oct_bbox, oct_bbox_t = _oct_tables_np(_host(cbvh.clu_bbox), branch)
    device = _device_of(cbvh)
    return dataclasses.replace(
        cbvh,
        oct_bbox=torch.from_numpy(oct_bbox).to(device),
        oct_bbox_t=torch.from_numpy(oct_bbox_t).to(device),
    )


def with_mxu_tiles(cbvh: ClusterBVH) -> ClusterBVH:
    """``cbvh`` with the per-cluster MXU tile pairs (``mxu_tiles``)."""
    tiles = _mxu_pairs_np(_host(cbvh.tri_const))
    return dataclasses.replace(cbvh, mxu_tiles=torch.from_numpy(tiles).to(_device_of(cbvh)))


def with_blocks(cbvh: ClusterBVH, branch: int = 32) -> ClusterBVH:
    """``cbvh`` with the blocked layout of ``branch`` clusters per block
    (``branch`` <= 128, the header's lanes), built on the host from its
    tables and moved to the device they lie on."""
    _check_branches(branch, cbvh.mxu_branch if cbvh.mxu_const is not None else 0)
    blk, blk_bbox_t = _build_blocks_np(_host(cbvh.tri_const), _host(cbvh.clu_bbox), branch)
    device = _device_of(cbvh)
    return dataclasses.replace(
        cbvh,
        blk_const=torch.from_numpy(blk).to(device),
        blk_bbox_t=torch.from_numpy(blk_bbox_t).to(device),
        blk_branch=branch,
    )


def with_mxu_blocks(cbvh: ClusterBVH, branch: int = 32) -> ClusterBVH:
    """``cbvh`` with the MXU block layout of ``branch`` clusters per block
    (``mxu_const``) and its block boxes (``blk_bbox_t``, shared with the
    blocked layout, whose branch must then be the same)."""
    _check_branches(cbvh.blk_branch if cbvh.blk_const is not None else 0, branch)
    mxu, blk_bbox_t = _build_blocks_np(
        _host(cbvh.tri_const), _host(cbvh.clu_bbox), branch, mxu=True
    )
    device = _device_of(cbvh)
    return dataclasses.replace(
        cbvh,
        mxu_const=torch.from_numpy(mxu).to(device),
        blk_bbox_t=torch.from_numpy(blk_bbox_t).to(device),
        mxu_branch=branch,
    )


def build_cluster_bvh(vertices: np.ndarray, blk_branch: Optional[int] = None,
                      mxu_branch: Optional[int] = None, mxu_tiles: bool = False) -> ClusterBVH:
    """Host-side build over ALREADY renumbered triangles (cluster.py:324-430).

    vertices: (T, 3, 3) float32 in ``cluster_order`` order. The oct tables
    (``OCT_BRANCH`` clusters per oct) are always built; ``blk_branch``,
    ``mxu_branch`` and ``mxu_tiles`` also build the blocked, MXU block and
    MXU tile layouts from the numpy intermediates. Leaves are host numpy
    arrays; ``ClusterBVH.to`` moves them to a device.
    """
    _check_branches(blk_branch, mxu_branch)
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

    oct_bbox, oct_bbox_t = _oct_tables_np(clu_bbox, OCT_BRANCH)
    blk = mxu = blk_bbox_t = None
    if blk_branch is not None:
        blk, blk_bbox_t = _build_blocks_np(tri_const, clu_bbox, blk_branch)
    if mxu_branch is not None:
        mxu, blk_bbox_t = _build_blocks_np(tri_const, clu_bbox, mxu_branch, mxu=True)
    return ClusterBVH(
        tri_const=tri_const,
        clu_bbox=clu_bbox,
        num_triangles=num_tris,
        clu_bbox_t=_bbox_t(clu_bbox, has_any),
        blk_const=blk,
        blk_bbox_t=blk_bbox_t,
        blk_branch=0 if blk_branch is None else blk_branch,
        oct_bbox=oct_bbox,
        oct_bbox_t=oct_bbox_t,
        mxu_const=mxu,
        mxu_branch=0 if mxu_branch is None else mxu_branch,
        mxu_tiles=_mxu_pairs_np(tri_const) if mxu_tiles else None,
    )
