"""Nearest-hit intersectors: CUDA kernel wrappers and their plain versions.

Ports of the Pallas kernels of ``isaklm_raytracer_tpu/kernels/intersect.py``
that ``integrator.render.intersector_name`` picks by scene size:

- ``flat_intersect`` (``csrc/flat_intersect.cu``) <- ``_flat_kernel`` of
  ``nearest_hit_cluster_flat``: every ray against every triangle of the
  real clusters, for at most ``FLAT_CLUSTER_LIMIT`` clusters;
- ``queue_intersect`` (``csrc/queue_intersect.cu``) <- ``_vmem_kernel`` of
  ``nearest_hit_cluster``: a front-to-back walk over the pierced clusters,
  for a cluster table of at most ``VMEM_TABLE_LIMIT`` bytes;
- ``blk_intersect`` (``csrc/blk_intersect.cu``) <- ``_blk_kernel`` of
  ``nearest_hit_cluster_blk``: the same walk over blocks of clusters, each
  with a header of its cluster boxes, for anything larger.

Contract, shared by every kernel and its plain version: rays (R, 8)
float32 with columns [ox oy oz dx dy dz active t_max] give, per ray, the
best t (t_max when nothing beat it) and the winning id c*128 + lane
(2**31 - 1 when nothing won). A candidate wins only strictly inside the
window (t < t_max); ties go to the lowest id. ``nearest_hit_*`` wrap that
into the intersector interface (t, idx, hit): a hit is an id that WON, not
a finite t.

On a CPU tensor each wrapper runs its plain version. On a CUDA tensor it
launches its kernel or raises; a failed build raises too. ``COUNTS``
records kernel launches and plain calls on CUDA tensors, so a run can show
which one it went through.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from isaklm_raytracer_tpu_torch.kernels import build

FLAT_CLUSTER_LIMIT = 64  # as the JAX package: at most this many real clusters
# The JAX package's budget for its VMEM-resident queue kernel: scenes over
# FLAT_CLUSTER_LIMIT clusters take the queue kernel up to this table size
# and the blocked kernel above it (integrator.render.intersector_name).
VMEM_TABLE_LIMIT = 6 * 1024 * 1024
SOURCES = ("flat_intersect.cu", "queue_intersect.cu", "blk_intersect.cu")
_INF = 3.4e38  # unbounded t_max seed and the value of a rejected candidate
_BIG_ID = 2**31 - 1
# The queue and blocked kernels stage 7 floats per box in shared memory;
# a block may use at most 232,448 bytes of it on the H100.
_MAX_SHARED_BOXES = 232_448 // (7 * 4)
# Plain versions: ray x box masks of at most this many elements at once,
# and at most this many (ray, cluster) pairs tested at once.
_MASK_ELEMS = 1 << 22
_PAIR_CHUNK = 4096


class LaunchCounts:
    """Kernel launches and plain-version calls on CUDA tensors."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        for kernel in ("flat", "queue", "blk"):
            setattr(self, f"{kernel}_kernel", 0)
            setattr(self, f"{kernel}_plain_cuda", 0)

    def plain_cuda(self) -> int:
        """Plain-version calls on CUDA tensors, all kernels together."""
        return self.flat_plain_cuda + self.queue_plain_cuda + self.blk_plain_cuda


COUNTS = LaunchCounts()

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of each C entry point; every one starts with the device index and
# ends with the stream
_ENTRY_ARGS = {
    # tri, num_clusters, rays, num_rays, t_eps, out_t, out_id
    "flat_intersect": [_P, _I, _P, _I, _F, _P, _P],
    # box_t, stride, num_clusters, tri, rays, num_rays, t_eps, out_t, out_id
    "queue_intersect": [_P, _I, _I, _P, _P, _I, _F, _P, _P],
    # bbox_t, stride, num_blocks, blk, branch, rays, num_rays, t_eps, out_t,
    # out_id, stats (or null)
    "blk_intersect": [_P, _I, _I, _P, _I, _P, _I, _F, _P, _P, _P],
}


@functools.cache
def _kernel_fn(name: str):
    """The C entry point ``name`` of its built library (built at first use)."""
    fn = getattr(build.load(f"{name}.cu"), name)
    fn.argtypes = [_I, *_ENTRY_ARGS[name], _P]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, rays: torch.Tensor, *args) -> None:
    """Launch kernel ``name`` on the current stream of ``rays``' card."""
    device = rays.device.index if rays.device.index is not None else torch.cuda.current_device()
    err = _kernel_fn(name)(
        device, *args, torch.cuda.current_stream(rays.device).cuda_stream
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    counter = name.replace("_intersect", "_kernel")
    setattr(COUNTS, counter, getattr(COUNTS, counter) + 1)


def _outputs(rays: torch.Tensor):
    num_rays = rays.shape[0]
    return (
        torch.empty((num_rays,), dtype=torch.float32, device=rays.device),
        torch.empty((num_rays,), dtype=torch.int32, device=rays.device),
    )


def _check_rays(rays: torch.Tensor, *tables: torch.Tensor) -> None:
    if rays.dtype != torch.float32 or any(t.dtype != torch.float32 for t in tables):
        raise TypeError(
            f"float32 expected, got rays {rays.dtype}, tables {[t.dtype for t in tables]}"
        )
    if rays.dim() != 2 or rays.shape[1] != 8:
        raise ValueError(f"rays must be (R, 8), got {tuple(rays.shape)}")
    if any(t.device != rays.device for t in tables):
        raise ValueError(
            f"rays on {rays.device}, tables on {[str(t.device) for t in tables]}"
        )


def _check_contiguous(name: str, *tensors: torch.Tensor) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: every table and the rays must be contiguous")


def _check_tiles(tri: torch.Tensor) -> None:
    if tri.dim() != 3 or tri.shape[1:] != (16, 128) or tri.shape[0] < 1:
        raise ValueError(f"tri must be (C>=1, 16, 128), got {tuple(tri.shape)}")


def _check_boxes(box_t: torch.Tensor, num: int, what: str) -> None:
    if box_t.dim() != 2 or box_t.shape[0] != 8 or box_t.shape[1] < num:
        raise ValueError(
            f"{what} box table must be (8, >= {num}), got {tuple(box_t.shape)}"
        )


def _check_shared(num: int, what: str) -> None:
    if num > _MAX_SHARED_BOXES:
        raise ValueError(
            f"{num} {what} boxes exceed the {_MAX_SHARED_BOXES} the kernel stages "
            "in shared memory"
        )


def _tri_hits(tile: torch.Tensor, rays: torch.Tensor, t_eps: float) -> torch.Tensor:
    """Candidate t of each ray against each triangle slot, _INF where the
    test rejects it (``_make_intersect``, in the kernels' order of
    operations). tile (..., 16, 128) broadcasts against the (n, 1) ray
    columns: one (16, 128) tile for every ray, or one tile per ray."""
    ox, oy, oz = rays[:, 0:1], rays[:, 1:2], rays[:, 2:3]
    dx, dy, dz = rays[:, 3:4], rays[:, 4:5], rays[:, 5:6]
    act = rays[:, 6:7] > 0.0
    nx, ny, nz = tile[..., 0, :], tile[..., 1, :], tile[..., 2, :]
    e1x, e1y, e1z = tile[..., 3, :], tile[..., 4, :], tile[..., 5, :]
    e2x, e2y, e2z = tile[..., 6, :], tile[..., 7, :], tile[..., 8, :]
    np1, p1e1, p1e2 = tile[..., 9, :], tile[..., 10, :], tile[..., 11, :]
    ca, cb, cc = tile[..., 12, :], tile[..., 13, :], tile[..., 14, :]

    ddn = dx * nx + dy * ny + dz * nz  # (n, 128)
    odn = ox * nx + oy * ny + oz * nz
    s = (np1 - odn) / ddn
    de1 = dx * e1x + dy * e1y + dz * e1z
    oe1 = ox * e1x + oy * e1y + oz * e1z
    d20 = oe1 + s * de1 - p1e1
    de2 = dx * e2x + dy * e2y + dz * e2z
    oe2 = ox * e2x + oy * e2y + oz * e2z
    d21 = oe2 + s * de2 - p1e2
    b = d20 * ca - d21 * cb
    c3 = d21 * cc - d20 * cb
    a = 1.0 - b - c3
    inside = (
        (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
        & (c3 >= 0.0) & (c3 <= 1.0)
    )
    valid = (ddn != 0.0) & (s >= t_eps) & inside & act
    return torch.where(valid, s, _INF)


def _pierce(box_t: torch.Tensor, rays: torch.Tensor, t_eps: float) -> torch.Tensor:
    """(n, N) mask of the active rays that pierce each valid box of a
    component-major (8, N) table: the kernels' slab test (``_dense_near``),
    conservative under NaN -- torch.minimum/maximum propagate NaN as
    jnp.minimum/maximum do, and every comparison with NaN is false."""
    ix, iy, iz = 1.0 / rays[:, 3:4], 1.0 / rays[:, 4:5], 1.0 / rays[:, 5:6]
    ox, oy, oz = rays[:, 0:1], rays[:, 1:2], rays[:, 2:3]
    t1x, t2x = (box_t[0:1] - ox) * ix, (box_t[3:4] - ox) * ix
    t1y, t2y = (box_t[1:2] - oy) * iy, (box_t[4:5] - oy) * iy
    t1z, t2z = (box_t[2:3] - oz) * iz, (box_t[5:6] - oz) * iz
    near = torch.maximum(
        torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
        torch.minimum(t1z, t2z),
    )
    far = torch.minimum(
        torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
        torch.maximum(t1z, t2z),
    )
    miss = (near > far) | (far < t_eps)
    return ~miss & (box_t[6:7] > 0.0) & (rays[:, 6:7] > 0.0)


def _nearest_of_pairs(rays, num_boxes, pierce_fn, tile_fn, t_eps):
    """The contract's result over the (ray, cluster) pairs that ``pierce_fn``
    selects, with no pruning by the running best.

    pierce_fn(rays_slice) -> (n, num_boxes) mask of the pairs to test;
    tile_fn(cluster ids (P,)) -> (P, 16, 128) tiles. Each pair runs the
    128-lane test; then per pair and per ray, the least t strictly inside
    the window and, among equal t, the lowest id (two ``amin`` scatters).
    """
    num_rays = rays.shape[0]
    t_max = rays[:, 7]
    lane = torch.arange(128, dtype=torch.int32, device=rays.device)
    step = max(1, _MASK_ELEMS // max(num_boxes, 1))
    pair_r, pair_t, pair_id = [], [], []
    for start in range(0, num_rays, step):
        r_loc, c = torch.nonzero(pierce_fn(rays[start:start + step]), as_tuple=True)
        r = r_loc + start
        for p in range(0, r.shape[0], _PAIR_CHUNK):
            rp, cp = r[p:p + _PAIR_CHUNK], c[p:p + _PAIR_CHUNK]
            tval = _tri_hits(tile_fn(cp), rays[rp], t_eps)  # (P, 128)
            tval = torch.where(tval < t_max[rp, None], tval, float("inf"))
            t_min = tval.min(dim=1).values
            ids = cp[:, None].to(torch.int32) * 128 + lane
            ids = torch.where((tval == t_min[:, None]) & (tval < float("inf")), ids, _BIG_ID)
            pair_r.append(rp)
            pair_t.append(t_min)
            pair_id.append(ids.min(dim=1).values)
    best_t = torch.full((num_rays,), float("inf"), dtype=torch.float32, device=rays.device)
    best_id = torch.full((num_rays,), _BIG_ID, dtype=torch.int32, device=rays.device)
    if pair_r:
        r, pt, pid = torch.cat(pair_r), torch.cat(pair_t), torch.cat(pair_id)
        best_t = best_t.scatter_reduce(0, r, pt, "amin")
        best_id = best_id.scatter_reduce(
            0, r, torch.where(pt == best_t[r], pid, _BIG_ID), "amin"
        )
    return torch.where(best_id != _BIG_ID, best_t, t_max), best_id


# --- flat -----------------------------------------------------------------


def flat_intersect_plain(tri: torch.Tensor, rays: torch.Tensor, t_eps: float):
    """Plain PyTorch version of the flat kernel's contract (any device).

    Mirrors ``_flat_kernel``: a per-lane running (t, id) over the clusters
    in order, then one argmin per ray with ties to the lowest id -- the same
    result as the kernel's walk over ids in order. The products and sums are
    written out in the kernel's order.
    """
    _check_rays(rays, tri)
    _check_tiles(tri)
    if rays.is_cuda:
        COUNTS.flat_plain_cuda += 1
    t_eps = float(np.float32(t_eps))
    num_rays = rays.shape[0]
    best_t = rays[:, 7:8].expand(num_rays, 128).clone()
    best_id = torch.full((num_rays, 128), _BIG_ID, dtype=torch.int32, device=rays.device)
    lane = torch.arange(128, dtype=torch.int32, device=rays.device)
    for c in range(tri.shape[0]):
        tval = _tri_hits(tri[c], rays, t_eps)  # (R, 128)
        better = tval < best_t
        best_id = torch.where(better, c * 128 + lane, best_id)
        best_t = torch.where(better, tval, best_t)
    tmin = best_t.min(dim=1, keepdim=True).values
    idmin = torch.where(best_t <= tmin, best_id, _BIG_ID).min(dim=1).values
    return tmin[:, 0], idmin


def flat_intersect(tri: torch.Tensor, rays: torch.Tensor, t_eps: float):
    """The flat kernel on CUDA tensors, its plain version on CPU tensors.

    tri: (C, 16, 128) float32 real cluster tiles; rays: (R, 8) float32.
    Returns (best_t (R,) float32, best_id (R,) int32) as in the contract.
    """
    _check_rays(rays, tri)
    _check_tiles(tri)
    if not rays.is_cuda:
        return flat_intersect_plain(tri, rays, t_eps)
    _check_contiguous("flat_intersect", tri, rays)
    out_t, out_id = _outputs(rays)
    _launch(
        "flat_intersect", rays,
        tri.data_ptr(), tri.shape[0], rays.data_ptr(), rays.shape[0], float(t_eps),
        out_t.data_ptr(), out_id.data_ptr(),
    )
    return out_t, out_id


# --- queue ----------------------------------------------------------------


def _check_queue(box_t, tri, rays):
    _check_rays(rays, box_t, tri)
    _check_tiles(tri)
    _check_boxes(box_t, tri.shape[0], "cluster")


def queue_intersect_plain(box_t: torch.Tensor, tri: torch.Tensor, rays: torch.Tensor,
                          t_eps: float):
    """Plain PyTorch version of the queue kernel's contract (any device):
    the slab cull of every ray against every cluster box, then the 128-lane
    test of every pierced (ray, cluster) pair, with no pruning by the
    running best."""
    _check_queue(box_t, tri, rays)
    if rays.is_cuda:
        COUNTS.queue_plain_cuda += 1
    t_eps = float(np.float32(t_eps))
    num_clusters = tri.shape[0]
    boxes = box_t[:, :num_clusters]
    return _nearest_of_pairs(
        rays, num_clusters, lambda r: _pierce(boxes, r, t_eps), lambda c: tri[c], t_eps
    )


def queue_intersect(box_t: torch.Tensor, tri: torch.Tensor, rays: torch.Tensor,
                    t_eps: float):
    """The queue kernel on CUDA tensors, its plain version on CPU tensors.

    box_t: (8, >= C) float32 component-major cluster boxes (``clu_bbox_t``);
    tri: (C, 16, 128) float32 cluster tiles; rays: (R, 8) float32.
    Returns (best_t (R,) float32, best_id (R,) int32) as in the contract.
    """
    _check_queue(box_t, tri, rays)
    if not rays.is_cuda:
        return queue_intersect_plain(box_t, tri, rays, t_eps)
    _check_contiguous("queue_intersect", box_t, tri, rays)
    _check_shared(tri.shape[0], "cluster")
    out_t, out_id = _outputs(rays)
    _launch(
        "queue_intersect", rays,
        box_t.data_ptr(), box_t.shape[1], tri.shape[0], tri.data_ptr(),
        rays.data_ptr(), rays.shape[0], float(t_eps), out_t.data_ptr(), out_id.data_ptr(),
    )
    return out_t, out_id


# --- blocked --------------------------------------------------------------


def _check_blk(bbox_t, blk, rays):
    _check_rays(rays, bbox_t, blk)
    if blk.dim() != 4 or blk.shape[2:] != (16, 128) or not 2 <= blk.shape[1] <= 129:
        raise ValueError(
            f"blk must be (NB, branch + 1, 16, 128) with branch <= 128, got "
            f"{tuple(blk.shape)}"
        )
    _check_boxes(bbox_t, blk.shape[0], "block")


def blk_intersect_plain(bbox_t: torch.Tensor, blk: torch.Tensor, rays: torch.Tensor,
                        t_eps: float):
    """Plain PyTorch version of the blocked kernel's contract (any device):
    the slab cull of every ray against every cluster box of the headers,
    ANDed with the cull of the cluster's block, then the 128-lane test of
    every pierced (ray, cluster) pair, with no pruning by the running
    best."""
    _check_blk(bbox_t, blk, rays)
    if rays.is_cuda:
        COUNTS.blk_plain_cuda += 1
    t_eps = float(np.float32(t_eps))
    num_blocks, branch = blk.shape[0], blk.shape[1] - 1
    blk_boxes = bbox_t[:, :num_blocks]
    # header rows 0-6, lanes [0, branch): cluster b*branch + k at column
    # b*branch + k of a component-major (8, NB*branch) table
    clu_boxes = torch.cat([
        blk[:, 0, 0:7, :branch].permute(1, 0, 2).reshape(7, num_blocks * branch),
        torch.zeros((1, num_blocks * branch), dtype=torch.float32, device=blk.device),
    ])

    def pierce(r):
        in_blk = _pierce(blk_boxes, r, t_eps).repeat_interleave(branch, dim=1)
        return in_blk & _pierce(clu_boxes, r, t_eps)

    return _nearest_of_pairs(
        rays, num_blocks * branch, pierce,
        lambda c: blk[c // branch, 1 + c % branch], t_eps,
    )


def blk_intersect(bbox_t: torch.Tensor, blk: torch.Tensor, rays: torch.Tensor,
                  t_eps: float, stats: bool = False):
    """The blocked kernel on CUDA tensors, its plain version on CPU tensors.

    bbox_t: (8, >= NB) float32 component-major block boxes (``blk_bbox_t``);
    blk: (NB, branch + 1, 16, 128) float32 blocked table (``blk_const``);
    rays: (R, 8) float32. Returns (best_t (R,) float32, best_id (R,) int32)
    as in the contract, and with ``stats`` also (R, 2) int32 per ray: blocks
    visited, clusters intersected. The counts describe the kernel's walk, so
    the plain version has none and ``stats`` needs a CUDA tensor.
    """
    _check_blk(bbox_t, blk, rays)
    if not rays.is_cuda:
        if stats:
            raise ValueError("blk_intersect: stats count the kernel's walk; "
                             "the plain version on the CPU has none")
        return blk_intersect_plain(bbox_t, blk, rays, t_eps)
    _check_contiguous("blk_intersect", bbox_t, blk, rays)
    _check_shared(blk.shape[0], "block")
    out_t, out_id = _outputs(rays)
    out_stats = (
        torch.empty((rays.shape[0], 2), dtype=torch.int32, device=rays.device)
        if stats else None
    )
    _launch(
        "blk_intersect", rays,
        bbox_t.data_ptr(), bbox_t.shape[1], blk.shape[0], blk.data_ptr(), blk.shape[1] - 1,
        rays.data_ptr(), rays.shape[0], float(t_eps), out_t.data_ptr(), out_id.data_ptr(),
        None if out_stats is None else out_stats.data_ptr(),
    )
    return (out_t, out_id, out_stats) if stats else (out_t, out_id)


# --- the intersector interface --------------------------------------------


def prep_rays(o, d, active=None, t_max=None) -> torch.Tensor:
    """(R, 8) float32 rays [o | d | active | t_max], detached; unbounded
    rays get t_max = 3.4e38."""
    num_rays = o.shape[0]
    o = o.detach().to(torch.float32)
    d = d.detach().to(torch.float32)
    if active is None:
        act = torch.ones((num_rays,), dtype=torch.float32, device=o.device)
    else:
        act = active.detach().to(torch.float32)
    if t_max is None:
        tm = torch.full((num_rays,), _INF, dtype=torch.float32, device=o.device)
    else:
        tm = t_max.detach().to(torch.float32)
    return torch.cat([o, d, act[:, None], tm[:, None]], dim=1).contiguous()


def unpack(best_t: torch.Tensor, best_id: torch.Tensor):
    """(t, idx, hit) from the raw contract: a hit is a WON id; misses get
    idx = -1 and t = inf."""
    hit = best_id != _BIG_ID
    idx = torch.where(hit, best_id, -1)
    t = torch.where(hit, best_t, float("inf"))
    return t, idx, hit


@torch.no_grad()
def nearest_hit_flat(cbvh, o, d, t_eps: float = 1e-5, active=None, t_max=None):
    """Batched nearest hit against every real cluster of ``cbvh``.

    o, d: (R, 3) -> detached (t (R,), idx (R,) int32, hit (R,) bool).
    ``t_max`` (R,) optionally seeds each ray's search window (NEE shadow
    rays); a ray with no hit strictly inside its window reports a miss.
    """
    tri = cbvh.tri_const[: cbvh.real_clusters]
    best_t, best_id = flat_intersect(tri, prep_rays(o, d, active, t_max), t_eps)
    return unpack(best_t, best_id)


@torch.no_grad()
def nearest_hit_queue(cbvh, o, d, t_eps: float = 1e-5, active=None, t_max=None):
    """Batched nearest hit through the queue intersector, the counterpart of
    the JAX package's ``nearest_hit_cluster``; arguments and results as
    ``nearest_hit_flat``."""
    if cbvh.clu_bbox_t is None:
        raise ValueError("nearest_hit_queue needs cbvh.clu_bbox_t (build_cluster_bvh)")
    best_t, best_id = queue_intersect(
        cbvh.clu_bbox_t, cbvh.tri_const, prep_rays(o, d, active, t_max), t_eps
    )
    return unpack(best_t, best_id)


@torch.no_grad()
def nearest_hit_blk(cbvh, o, d, t_eps: float = 1e-5, active=None, t_max=None,
                    stats: bool = False):
    """Batched nearest hit through the blocked intersector, the counterpart
    of the JAX package's ``nearest_hit_cluster_blk`` (either ``per_ray``
    mode: they differ only in the TPU schedule). Arguments and results as
    ``nearest_hit_flat``; ``stats`` (CUDA only) also returns (R, 2) int32
    block visits and clusters intersected per ray."""
    if cbvh.blk_const is None:
        raise ValueError(
            "nearest_hit_blk needs cbvh.blk_const: prepare_scene builds it for big "
            "scenes, accel.with_blocks for any"
        )
    out = blk_intersect(
        cbvh.blk_bbox_t, cbvh.blk_const, prep_rays(o, d, active, t_max), t_eps, stats
    )
    return unpack(out[0], out[1]) + tuple(out[2:])
