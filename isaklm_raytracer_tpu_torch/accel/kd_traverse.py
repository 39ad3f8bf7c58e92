"""The scalar KD walk over the tree's own triangle lists.

Port of ``isaklm_raytracer_tpu/accel/kd_traverse.py``, the JAX package's
re-derivation of the reference's iterative short-stack walk
(trace_ray.cuh:244-318) as one state machine that interleaves inner-node
descent, leaf tests and stack pops. There ``vmap`` runs it over rays; here
``kd_plain`` runs it as a batch: each live ray takes one step per
iteration, and a leaf step tests all of the leaf's triangles at once
(``_leaf_scan`` of the JAX package, as (ray, slot) pairs).

Semantics, as ``accel.wavefront``: the root slab test with IEEE
infinities, near/far child by ray origin vs plane, near-only checked
first, leaf hits clamped to the cell's exit distance (strictly nearer,
the first slot on ties), the walk returning at the first leaf with a hit.
The stack has max_depth + 2 slots and NO clamp on the push
(``kd_traverse.py:144-157``): a tree built to ``max_depth`` pushes at most
max_depth + 1 cells. A push beyond the last slot is dropped and a pop
beyond it reads the last slot, as JAX's scatter and gather do.

On CUDA tensors ``nearest_hit_kd`` launches the KD walk kernel over the
tree layout (``kernels.intersect.kd_intersect`` with ``vertices``).
"""

from __future__ import annotations

import numpy as np
import torch

from isaklm_raytracer_tpu_torch.accel.wavefront import descend, root_slab, tri_hits
from isaklm_raytracer_tpu_torch.kernels.intersect import COUNTS, kd_intersect
from isaklm_raytracer_tpu_torch.scene.types import KDTreeArrays

_INF = float("inf")


def _leaf_scan(kd: KDTreeArrays, vertices, o, d, node, max_t, t_eps):
    """The nearest hit of each ray in its leaf ``node`` strictly before
    ``max_t``, the first slot on ties (trace_leaf_node,
    trace_ray.cuh:115-141): (t, idx, tests), idx = -1 where none."""
    offset, count = kd.child_a[node].long(), kd.child_b[node].long()
    pair = torch.repeat_interleave(torch.arange(node.shape[0], device=node.device), count)
    slot = torch.arange(pair.shape[0], device=node.device) - (torch.cumsum(count, 0) - count)[pair]
    tri = kd.tri_indices[offset[pair] + slot].long()
    p = vertices[tri]
    p1 = p[:, 0]
    s = tri_hits(o[pair], d[pair], p1, p[:, 1] - p1, p[:, 2] - p1, t_eps)
    s = torch.where(s < max_t[pair], s, _INF)
    best = torch.full_like(max_t, _INF).scatter_reduce(0, pair, s, "amin")
    big = torch.iinfo(torch.long).max
    first = torch.full_like(count, big).scatter_reduce(
        0, pair, torch.where((s == best[pair]) & torch.isfinite(s), slot, big), "amin")
    hit = first != big
    idx = kd.tri_indices[torch.where(hit, offset + first, 0)]
    return best, torch.where(hit, idx, -1), count


def kd_plain(kd: KDTreeArrays, vertices, o, d, t_eps: float = 1e-5, active=None,
             stats: bool = False):
    """Plain PyTorch version of the KD walk over the tree layout (any
    device): the JAX package's ``nearest_hit_kd`` step for step, on the rays
    still walking. Returns (t (R,), idx (R,) int32); with ``stats`` also
    (R, 3) int32 per ray: inner-node steps, leaves visited and triangle
    tests."""
    if o.is_cuda:
        COUNTS.kd_plain_cuda += 1
    t_eps = float(np.float32(t_eps))
    dev, num = o.device, o.shape[0]
    depth = kd.max_depth + 2
    t_near, t_far = root_slab(kd.bbox_min, kd.bbox_max, o, d)
    walking = t_near <= t_far
    if active is not None:
        walking = walking & active
    node = torch.zeros(num, dtype=torch.long, device=dev)
    entry, exit_ = t_near.clone(), t_far.clone()
    sp = torch.zeros(num, dtype=torch.long, device=dev)
    st_node = torch.zeros((num, depth), dtype=torch.long, device=dev)
    st_entry = torch.zeros((num, depth), dtype=torch.float32, device=dev)
    st_exit = torch.zeros((num, depth), dtype=torch.float32, device=dev)
    best_t = torch.full((num,), _INF, dtype=torch.float32, device=dev)
    best_i = torch.full((num,), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((num, 3), dtype=torch.int32, device=dev)
    child_a, child_b = kd.child_a.long(), kd.child_b.long()
    while True:
        r = torch.nonzero(walking).flatten()
        if r.numel() == 0:
            break
        n = node[r]
        leaf = kd.is_leaf[n]

        # descend one inner node
        rd, nd = r[~leaf], n[~leaf]
        near, far, t_plane, far_only, push = descend(
            o[rd], d[rd], kd.axis[nd].long(), kd.plane[nd], child_a[nd], child_b[nd],
            entry[rd], exit_[rd])
        pr, psp = rd[push], sp[rd][push]
        keep = psp < depth  # JAX drops a scatter out of bounds
        st_node[pr[keep], psp[keep]] = far[push][keep]
        st_entry[pr[keep], psp[keep]] = t_plane[push][keep]
        st_exit[pr[keep], psp[keep]] = exit_[pr[keep]]
        sp[rd] = torch.where(push, sp[rd] + 1, sp[rd])
        node[rd] = torch.where(far_only, far, near)
        exit_[rd] = torch.where(push, t_plane, exit_[rd])

        # scan a leaf: return its hit, or pop (an empty stack ends the walk)
        rl = r[leaf]
        leaf_t, leaf_i, tests = _leaf_scan(kd, vertices, o[rl], d[rl], n[leaf], exit_[rl],
                                           t_eps)
        hit = leaf_i >= 0
        best_t[rl[hit]] = leaf_t[hit]
        best_i[rl[hit]] = leaf_i[hit].to(torch.int32)
        if stats:
            counts[rd, 0] += 1
            counts[rl, 1] += 1
            counts[rl, 2] += tests.to(torch.int32)
        pop = rl[~hit]
        empty = sp[pop] == 0
        walking[rl[hit]] = False
        walking[pop[empty]] = False
        pop = pop[~empty]
        k = torch.clamp_max(sp[pop] - 1, depth - 1)  # JAX clamps a gather
        node[pop], entry[pop], exit_[pop] = st_node[pop, k], st_entry[pop, k], st_exit[pop, k]
        sp[pop] = sp[pop] - 1
    t = torch.where(best_i >= 0, best_t, _INF)
    return (t, best_i, counts) if stats else (t, best_i)


@torch.no_grad()
def nearest_hit_kd(kd: KDTreeArrays, vertices, o, d, t_eps: float = 1e-5, active=None,
                   t_max=None):
    """Batched nearest hit via the KD walk. o, d: (R, 3); vertices (N, 3, 3).
    Returns detached (t (R,), idx (R,) int32, hit (R,) bool); ``active``
    masks lanes to an immediate miss. The KD walk kernel on CUDA tensors,
    ``kd_plain`` on CPU tensors. ``t_max`` is accepted for interface
    parity and ignored, as in the JAX package."""
    del t_max
    t, idx = kd_intersect(kd, o.detach(), d.detach(), t_eps, active, vertices=vertices)
    return t, idx, idx >= 0
