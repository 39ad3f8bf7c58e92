"""The KD tree re-laid out in chunk rows, and its nearest-hit walk.

Port of ``isaklm_raytracer_tpu/accel/wavefront.py``:

  - ``build_wavefront_kd`` (host, numpy) re-lays each leaf's triangle list
    out as FIXED-SIZE chunk rows, chunk_data (C, L, 9) with p1|e1|e2 per
    slot and -1-padded ids; an oversized depth-capped leaf becomes a chain
    of rows (chunk_next). Equal bit for bit to the JAX package's layout.
  - ``nearest_hit_wavefront`` walks it: on CUDA tensors through the KD walk
    kernel (``kernels.intersect.kd_intersect``, csrc/kd_intersect.cu, one
    thread a ray, reading ``WavefrontKD.tri_table``: each triangle's
    constants, ``tri_consts_plain``'s records, built once on the card by
    ``kernels.intersect.tri_consts``), on CPU tensors through
    ``wavefront_plain``, the JAX package's batched lockstep written out in
    PyTorch: every live ray takes one step of one state machine (descend
    one inner node, arm a leaf's scan, or scan one chunk row) per
    iteration.

Semantics match trace_ray.cuh:244-318 as the JAX package re-derives them:
near/far child by ray origin vs plane (origin on the plane disambiguated
by direction), the near-only case checked first, leaf hits clamped to the
cell's exit distance, the walk returning at the first leaf with a hit,
duplicated straddlers handled by that clamp. The push clamps the stack
pointer at depth - 1 (``wavefront.py:246``); the scalar walk of
``accel.kd_traverse`` does not.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from isaklm_raytracer_tpu_torch.kernels.intersect import COUNTS, kd_intersect, tri_consts
from isaklm_raytracer_tpu_torch.math import transforms
from isaklm_raytracer_tpu_torch.scene.types import KDTreeArrays, _to, pack_kd_nodes

_INF = float("inf")


@dataclasses.dataclass
class WavefrontKD:
    """KD tree re-laid out for the batched walk."""

    # node arrays (K,)
    child_a: torch.Tensor
    child_b: torch.Tensor
    axis: torch.Tensor
    plane: torch.Tensor
    is_leaf: torch.Tensor
    leaf_first: torch.Tensor  # (K,) first chunk row, -1 = empty leaf / inner
    # chunk arrays
    chunk_next: torch.Tensor  # (C,) next row in chain, -1 = end
    chunk_tri: torch.Tensor  # (C, L) triangle ids, -1 pad
    chunk_data: torch.Tensor  # (C, L, 9) p1 | e1 | e2
    corners: torch.Tensor  # (N, 9) p1 | p2 | p3 of each triangle, the source of tri_table
    bbox_min: torch.Tensor
    bbox_max: torch.Tensor
    max_depth: int = 19
    leaf_width: int = 8

    def to(self, device) -> "WavefrontKD":
        return dataclasses.replace(self, **{
            f.name: _to(getattr(self, f.name), device)
            for f in dataclasses.fields(self) if f.name not in ("max_depth", "leaf_width")
        })

    @functools.cached_property
    def nodes(self) -> torch.Tensor:
        """The node rows of ``scene.types.pack_kd_nodes``, packed once."""
        return pack_kd_nodes(self.child_a, self.child_b, self.axis, self.is_leaf, self.plane)

    @functools.cached_property
    def tri_table(self) -> torch.Tensor:
        """(N, 20) float32 triangle records indexed by id (``tri_consts`` of
        ``corners``), built once at first use: what the KD walk kernel
        reads through chunk_tri. Its first use is eager, as a graph step's
        first call is: the table kernel refuses to run inside a CUDA graph
        capture."""
        return tri_consts(torch.as_tensor(self.corners))


def build_wavefront_kd(kd: KDTreeArrays, vertices: np.ndarray,
                       leaf_width: int = 8) -> WavefrontKD:
    """Host-side re-layout of a built tree (numpy in, numpy leaves out).

    The leaves with triangles get consecutive rows in node order, each
    leaf's ids in its own order, padded with -1 to whole rows; a row's
    next is the leaf's following row, -1 after its last."""
    child_a = np.asarray(kd.child_a)
    child_b = np.asarray(kd.child_b)
    tri_indices = np.asarray(kd.tri_indices)
    vertices = np.asarray(vertices, np.float32)

    leaf_first = np.full(len(child_a), -1, np.int32)
    leaves = np.nonzero(np.asarray(kd.is_leaf) & (child_b > 0))[0]
    counts = child_b[leaves].astype(np.int64)
    rows = -(-counts // leaf_width)
    first = np.cumsum(rows) - rows
    leaf_first[leaves] = first
    num_rows = int(rows.sum())
    if num_rows:
        # slot j of leaf k lands at row first[k] + j // L, lane j % L
        j = np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
        flat = np.full(num_rows * leaf_width, -1, np.int32)
        flat[np.repeat(first * leaf_width, counts) + j] = tri_indices[
            np.repeat(child_a[leaves].astype(np.int64), counts) + j]
        chunk_tri = flat.reshape(num_rows, leaf_width)
        row = np.arange(num_rows)
        chunk_next = np.where(row + 1 < np.repeat(first + rows, rows), row + 1, -1)
    else:
        chunk_tri = np.full((1, leaf_width), -1, np.int32)
        chunk_next = np.full(1, -1)

    tri = vertices[np.maximum(chunk_tri, 0)]  # (C, L, 3, 3)
    p1 = tri[:, :, 0]
    chunk_data = np.concatenate([p1, tri[:, :, 1] - p1, tri[:, :, 2] - p1], axis=-1)
    return WavefrontKD(
        child_a=child_a,
        child_b=child_b,
        axis=np.asarray(kd.axis),
        plane=np.asarray(kd.plane),
        is_leaf=np.asarray(kd.is_leaf),
        leaf_first=leaf_first,
        chunk_next=chunk_next.astype(np.int32),
        chunk_tri=chunk_tri,
        chunk_data=chunk_data,
        corners=vertices.reshape(-1, 9),
        bbox_min=np.asarray(kd.bbox_min),
        bbox_max=np.asarray(kd.bbox_max),
        max_depth=kd.max_depth,
        leaf_width=leaf_width,
    )


def tri_hits(o, d, p1, e1, e2, t_eps: float) -> torch.Tensor:
    """The ray/triangle test of the KD walks and the brute-force oracle
    (trace_ray.cuh:73-113), broadcasting rays (..., 3) against triangles
    (..., 3): the plane distance s where the ray hits the triangle at
    s >= t_eps, +inf where it does not. Every product and sum is the one
    ``accel.traverse.nearest_hit_brute`` forms, in its order, and the one
    ``tri_t`` of csrc/tri_test.cuh forms; the normal is scaled by
    1 / sqrt, where the JAX package's KD walks take XLA's rsqrt."""
    n = transforms.normalize(transforms.cross(e1, e2))
    ddn = transforms.dot(d, n)
    s = (transforms.dot(n, p1) - transforms.dot(o, n)) / ddn
    v2 = o + s[..., None] * d - p1
    d00 = transforms.dot(e1, e1)
    d01 = transforms.dot(e1, e2)
    d11 = transforms.dot(e2, e2)
    d20 = transforms.dot(v2, e1)
    d21 = transforms.dot(v2, e2)
    inv_den = 1.0 / (d00 * d11 - d01 * d01)
    b = (d11 * d20 - d01 * d21) * inv_den
    c = (d00 * d21 - d01 * d20) * inv_den
    a = 1.0 - b - c
    inside = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0) & (c >= 0.0) & (c <= 1.0)
    return torch.where((ddn != 0.0) & (s >= t_eps) & inside, s, _INF)


def tri_consts_plain(src) -> torch.Tensor:
    """Plain PyTorch version of the triangle-constant table (any device):
    (num, 20) float32 records of csrc/tri_test.cuh, one a row of the
    corners src (num, 9), p1 | p2 | p3:

        [nx ny nz n.p1] [p1 id] [e1 d00] [e2 d11] [d01 inv_den 0 0]

    each term formed as ``tri_hits`` forms it, in its order (the edges
    e1 = p2 - p1 and e2 = p3 - p1 as ``build_wavefront_kd`` forms the chunk
    rows', the unit normal by 1 / sqrt, d00 = e1.e1, d01 = e1.e2, d11 =
    e2.e2, inv_den = 1 / (d00 d11 - d01 d01)), so a test that reads them
    equals ``tri_hits`` bit for bit. The id word holds the row's index as
    int32 bits."""
    if src.is_cuda:
        COUNTS.tri_consts_plain_cuda += 1
    p1 = src[:, 0:3]
    e1, e2 = src[:, 3:6] - p1, src[:, 6:9] - p1
    n = transforms.normalize(transforms.cross(e1, e2))
    d00 = transforms.dot(e1, e1)
    d01 = transforms.dot(e1, e2)
    d11 = transforms.dot(e2, e2)
    inv_den = 1.0 / (d00 * d11 - d01 * d01)
    ids = torch.arange(src.shape[0], dtype=torch.int32, device=src.device)
    zero = torch.zeros_like(d00)
    return torch.stack([n[:, 0], n[:, 1], n[:, 2], transforms.dot(n, p1),
                        p1[:, 0], p1[:, 1], p1[:, 2], ids.view(torch.float32),
                        e1[:, 0], e1[:, 1], e1[:, 2], d00, e2[:, 0], e2[:, 1], e2[:, 2], d11,
                        d01, inv_den, zero, zero], dim=1)


def root_slab(bbox_min, bbox_max, o, d):
    """Entry and exit of each ray into the root box (trace_ray.cuh:212-242),
    with IEEE infinities for zero direction components; NaN propagates
    through the min and max, as jnp.minimum/jnp.max do, so such a ray
    whose origin lies on a face misses."""
    t_lo = (bbox_min - o) / d
    t_hi = (bbox_max - o) / d
    t_near = torch.minimum(t_lo, t_hi).amax(dim=-1)
    t_far = torch.maximum(t_lo, t_hi).amin(dim=-1)
    return t_near, t_far


def descend(o, d, axis, plane, c1, c2, entry, exit_):
    """One inner-node step (trace_ray.cuh:273-306) for a batch of rays:
    (near, far, t_plane, far_only, push). A NaN t_plane (a ray lying in the
    splitting plane) goes to the near child only; near-only is decided
    before far-only; a ray that straddles the plane pushes the far cell."""
    o_ax = o.gather(1, axis[:, None])[:, 0]
    d_ax = d.gather(1, axis[:, None])[:, 0]
    behind = (o_ax > plane) | ((o_ax == plane) & (d_ax < 0.0))
    near = torch.where(behind, c2, c1)
    far = torch.where(behind, c1, c2)
    t_plane = (plane - o_ax) / d_ax
    near_only = (t_plane >= exit_) | (t_plane < 0.0) | torch.isnan(t_plane)
    far_only = ~near_only & (t_plane <= entry)
    return near, far, t_plane, far_only, ~near_only & ~far_only


def wavefront_plain(wkd: WavefrontKD, o, d, t_eps: float = 1e-5, active=None,
                    stats: bool = False):
    """Plain PyTorch version of the KD walk over chunk rows (any device):
    the JAX package's ``nearest_hit_wavefront`` step for step, on the rays
    still walking. Returns (t (R,), idx (R,) int32); with ``stats`` also
    (R, 3) int32 per ray: inner-node steps, chunk rows scanned and
    triangle tests (the real slots of those rows)."""
    if o.is_cuda:
        COUNTS.kd_plain_cuda += 1
    t_eps = float(np.float32(t_eps))
    dev, num = o.device, o.shape[0]
    depth = wkd.max_depth + 2
    t_near, t_far = root_slab(wkd.bbox_min, wkd.bbox_max, o, d)
    walking = t_near <= t_far
    if active is not None:
        walking = walking & active
    node = torch.zeros(num, dtype=torch.long, device=dev)
    entry, exit_ = t_near.clone(), t_far.clone()
    sp = torch.zeros(num, dtype=torch.long, device=dev)
    st_node = torch.zeros((num, depth), dtype=torch.long, device=dev)
    st_entry = torch.zeros((num, depth), dtype=torch.float32, device=dev)
    st_exit = torch.zeros((num, depth), dtype=torch.float32, device=dev)
    chunk = torch.full((num,), -1, dtype=torch.long, device=dev)
    best_t = torch.full((num,), _INF, dtype=torch.float32, device=dev)
    best_i = torch.full((num,), -1, dtype=torch.int32, device=dev)
    counts = torch.zeros((num, 3), dtype=torch.int32, device=dev)
    child_a, child_b = wkd.child_a.long(), wkd.child_b.long()
    leaf_first, chunk_next = wkd.leaf_first.long(), wkd.chunk_next.long()
    while True:
        r = torch.nonzero(walking).flatten()
        if r.numel() == 0:
            break
        n, ch, sp_r = node[r], chunk[r], sp[r]
        scanning = ch >= 0
        leaf = wkd.is_leaf[n]

        # descend one inner node
        desc = ~scanning & ~leaf
        rd = r[desc]
        near, far, t_plane, far_only, push = descend(
            o[rd], d[rd], wkd.axis[n[desc]].long(), wkd.plane[n[desc]],
            child_a[n[desc]], child_b[n[desc]], entry[rd], exit_[rd])
        pr, psp = rd[push], sp[rd][push]
        st_node[pr, psp] = far[push]
        st_entry[pr, psp] = t_plane[push]
        st_exit[pr, psp] = exit_[pr]
        sp[rd] = torch.where(push, torch.clamp_max(sp[rd] + 1, depth - 1), sp[rd])
        node[rd] = torch.where(far_only, far, near)
        exit_[rd] = torch.where(push, t_plane, exit_[rd])

        # arm the scan of a leaf with rows; an empty leaf finishes at once
        enter = ~scanning & leaf
        first = leaf_first[n[enter]]
        chunk[r[enter][first >= 0]] = first[first >= 0]
        finish_r = [r[enter][first < 0]]

        # scan one chunk row
        rs, rows = r[scanning], ch[scanning]
        tri = wkd.chunk_tri[rows]
        data = wkd.chunk_data[rows]
        s = tri_hits(o[rs, None], d[rs, None], data[..., 0:3], data[..., 3:6],
                     data[..., 6:9], t_eps)
        limit = torch.minimum(exit_[rs], best_t[rs])
        s = torch.where((tri >= 0) & (s < limit[:, None]), s, _INF)
        row_t, slot = s.min(dim=1)  # the first slot on ties, as jnp.argmin
        found = torch.isfinite(row_t)
        best_t[rs] = torch.where(found, row_t, best_t[rs])
        best_i[rs] = torch.where(found, tri.gather(1, slot[:, None])[:, 0], best_i[rs])
        nxt = chunk_next[rows]
        chunk[rs] = torch.where(nxt >= 0, nxt, -1)
        finish_r.append(rs[nxt < 0])
        if stats:
            counts[rd, 0] += 1
            counts[rs, 1] += 1
            counts[rs, 2] += (tri >= 0).sum(dim=1, dtype=torch.int32)

        # a finished leaf returns its hit, or pops the stack (an empty
        # stack ends the walk)
        fr = torch.cat(finish_r)
        hit = best_i[fr] >= 0
        pop = fr[~hit]
        empty = sp[pop] == 0
        walking[fr[hit]] = False
        walking[pop[empty]] = False
        pop = pop[~empty]
        k = sp[pop] - 1
        node[pop], entry[pop], exit_[pop] = st_node[pop, k], st_entry[pop, k], st_exit[pop, k]
        sp[pop] = k
    t = torch.where(best_i >= 0, best_t, _INF)
    return (t, best_i, counts) if stats else (t, best_i)


@torch.no_grad()
def nearest_hit_wavefront(wkd: WavefrontKD, o, d, t_eps: float = 1e-5, active=None,
                          t_max=None):
    """Batched nearest hit. o, d: (R, 3) -> detached (t (R,), idx (R,)
    int32, hit (R,) bool); a miss and an inactive ray give (+inf, -1,
    False). The KD walk kernel on CUDA tensors, ``wavefront_plain`` on CPU
    tensors (``kernels.intersect.kd_intersect``).

    ``t_max`` is accepted for interface parity with the cluster
    intersectors and ignored, as in the JAX package: visibility results
    are identical either way."""
    del t_max
    t, idx = kd_intersect(wkd, o.detach(), d.detach(), t_eps, active)
    return t, idx, idx >= 0
