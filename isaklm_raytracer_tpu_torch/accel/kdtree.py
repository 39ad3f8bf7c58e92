"""Host-side KD-tree construction.

Port of ``isaklm_raytracer_tpu/accel/kdtree.py``, the reference's
create_kd_tree (create_kd_tree.cuh:162-328):

  - split axis round-robins depth % 3 (create_kd_tree.cuh:164);
  - split plane = median of per-triangle centroid extents ((min+max)/2)
    along the axis: values sorted, element [n/2] (create_kd_tree.cuh:125-160);
  - triangles overlapping the plane are DUPLICATED into both children
    (behind: min <= plane, afore: max >= plane, create_kd_tree.cuh:59-123);
  - a child becomes a leaf when count <= leaf_size (min_triangle_count = 7,
    create_kd_tree.cuh:222) or depth >= max_depth (KD_TREE_DEPTH = 19,
    macros.h:11); the root is always an inner node;
  - nodes are appended in DFS order (child recorded before recursion), root
    index 0; leaves store (index_offset, count) into one flat index array
    (create_kd_tree.cuh:225-264);
  - the root bounding box is padded by eps = 0.01 (create_kd_tree.cuh:18-57).

The tree is built on the host and returned with numpy leaves, equal bit
for bit to the JAX package's; ``accel.prepare_scene(..., build_kd=True)``
builds it and moves it to the device. The C++ builder (``native.kd_build_native``, the repo's
``native/kd_builder.cpp``) is the default; the numpy version below builds
the same tree level by level instead of recursively (a 1.9M-node tree in
seconds where the recursion takes tens).
"""

from __future__ import annotations

import numpy as np

from isaklm_raytracer_tpu_torch.scene.types import KDTreeArrays

BBOX_EPSILON = 0.01  # create_kd_tree.cuh:20


def build_kd_tree(
    vertices: np.ndarray,
    max_depth: int = 19,
    leaf_size: int = 7,
    use_native: bool = True,
) -> KDTreeArrays:
    """vertices: (N, 3, 3) float32 triangle corners.

    ``use_native`` builds with the C++ builder (same output; a failed
    build raises ``native.NativeBuildError``), else with numpy."""
    vertices = np.asarray(vertices, np.float32)

    if use_native:
        from isaklm_raytracer_tpu_torch.native import kd_build_native

        return KDTreeArrays(**kd_build_native(vertices, max_depth, leaf_size),
                            max_depth=max_depth)
    return KDTreeArrays(**_build_numpy(vertices, max_depth, leaf_size), max_depth=max_depth)


def _build_numpy(vertices: np.ndarray, max_depth: int, leaf_size: int) -> dict:
    """The reference's recursive build (the module docstring), level by
    level: every inner node of a depth is split at once (its axis is
    depth % 3), then the nodes are numbered in the recursion's depth-first
    order and the leaves' lists laid out in that order. A child keeps its
    parent's ids in their order, so each list is the recursion's."""
    tmin = vertices.min(axis=1)  # (N, 3)
    tmax = vertices.max(axis=1)
    mid = (tmin + tmax) * 0.5

    # nodes in breadth-first order (the root is 0), and each level's inner
    # nodes with their axis and plane
    parent, which, leaf = [np.array([-1])], [np.array([0])], [np.array([False])]
    levels = []  # (inner nodes, axis, planes) per depth
    leaf_nodes, leaf_counts, leaf_ids = [], [], []
    ids = np.arange(len(vertices), dtype=np.int32)  # the level's ids, by node
    seg = np.zeros(len(vertices), np.int64)  # each id's node among the level's
    nodes, counts = np.array([0]), np.array([len(vertices)])
    total, depth = 1, 0
    while nodes.size:
        axis = depth % 3
        vals = mid[ids, axis]
        # the median of each node's sorted values, element [n/2]
        ranked = np.lexsort((vals, seg))
        planes = vals[ranked[np.cumsum(counts) - counts + counts // 2]]
        levels.append((nodes, axis, planes))
        behind = tmin[ids, axis] <= planes[seg]
        afore = tmax[ids, axis] >= planes[seg]
        # children 2k (behind) and 2k + 1 (afore) of the level's node k
        child = np.concatenate([2 * seg[behind], 2 * seg[afore] + 1])
        child_ids = np.concatenate([ids[behind], ids[afore]])
        order = np.argsort(child, kind="stable")
        child, child_ids = child[order], child_ids[order]
        child_counts = np.bincount(child, minlength=2 * nodes.size)
        child_nodes = total + np.arange(2 * nodes.size)
        total += 2 * nodes.size
        parent.append(np.repeat(nodes, 2))
        which.append(np.tile([0, 1], nodes.size))
        inner = (child_counts > leaf_size) & (depth < max_depth)
        leaf.append(~inner)
        leaf_nodes.append(child_nodes[~inner])
        leaf_counts.append(child_counts[~inner])
        leaf_ids.append(child_ids[~inner[child]])
        keep = inner[child]
        ids, seg = child_ids[keep], (np.cumsum(inner) - 1)[child[keep]]
        nodes, counts = child_nodes[inner], child_counts[inner]
        depth += 1

    parent, which, leaf = (np.concatenate(x) for x in (parent, which, leaf))
    children = np.zeros((total, 2), np.int64)
    children[parent[1:], which[1:]] = np.arange(1, total)
    size = np.ones(total, np.int64)  # subtree sizes, deepest level first
    for nodes, _, _ in reversed(levels):
        size[nodes] = 1 + size[children[nodes, 0]] + size[children[nodes, 1]]
    pre = np.zeros(total, np.int64)  # depth-first (creation) order
    for nodes, _, _ in levels:
        pre[children[nodes, 0]] = pre[nodes] + 1
        pre[children[nodes, 1]] = pre[nodes] + 1 + size[children[nodes, 0]]

    child_a = np.zeros(total, np.int32)
    child_b = np.zeros(total, np.int32)
    axes = np.zeros(total, np.int32)
    planes = np.zeros(total, np.float32)
    for nodes, axis, plane in levels:
        axes[pre[nodes]] = axis
        planes[pre[nodes]] = plane
        child_a[pre[nodes]] = pre[children[nodes, 0]]
        child_b[pre[nodes]] = pre[children[nodes, 1]]
    # leaves: (offset, count) into one list laid out in depth-first order
    leaf_nodes, leaf_counts, leaf_ids = (np.concatenate(x) for x in
                                         (leaf_nodes, leaf_counts, leaf_ids))
    order = np.argsort(pre[leaf_nodes])
    counts = leaf_counts[order]
    offsets = np.cumsum(counts) - counts
    child_a[pre[leaf_nodes[order]]] = offsets
    child_b[pre[leaf_nodes[order]]] = counts
    starts = (np.cumsum(leaf_counts) - leaf_counts)[order]
    tri_indices = leaf_ids[np.repeat(starts - offsets, counts) + np.arange(counts.sum())]
    return {
        "child_a": child_a,
        "child_b": child_b,
        "axis": axes,
        "plane": planes,
        "is_leaf": leaf[np.argsort(pre)],
        "tri_indices": tri_indices.astype(np.int32),
        "bbox_min": np.asarray(tmin.min(axis=0) - BBOX_EPSILON, np.float32),
        "bbox_max": np.asarray(tmax.max(axis=0) + BBOX_EPSILON, np.float32),
    }
