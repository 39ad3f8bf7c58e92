"""Nearest-hit intersectors: CUDA kernel wrappers and their plain versions.

Ports of the Pallas kernels of ``isaklm_raytracer_tpu/kernels/intersect.py``
that ``integrator.render.intersector_name`` picks by scene size or by
``ISAKLM_INTERSECTOR``:

- ``flat_intersect`` (``csrc/flat_intersect.cu``) <- ``_flat_kernel`` of
  ``nearest_hit_cluster_flat``: every ray against every triangle of the
  real clusters, for at most ``FLAT_CLUSTER_LIMIT`` clusters, each pair
  stopped at the first of three stages (plane, window, edges) that rules
  it out;
- ``flat_mxu_intersect`` (``csrc/flat_mxu_intersect.cu``) <-
  ``_flat_mxu_kernel`` of ``nearest_hit_cluster_flat_mxu``: the same staged
  walk (``csrc/flat_walk.cuh``) over the MXU tile pairs (``mxu_tiles``);
- ``queue_intersect`` (``csrc/queue_intersect.cu``) <- ``_vmem_kernel`` of
  ``nearest_hit_cluster``: a front-to-back walk over the pierced clusters,
  for a cluster table of at most ``VMEM_TABLE_LIMIT`` bytes;
- ``blk_intersect`` (``csrc/blk_intersect.cu``) <- ``_blk_kernel`` of
  ``nearest_hit_cluster_blk``: the same walk over blocks of clusters, each
  with a header of its cluster boxes, for anything larger;
- ``blk_mxu_intersect`` (``csrc/blk_mxu_intersect.cu``) <- ``_blk_kernel``
  with ``mxu=True``: the blocked walk over the MXU blocks (``mxu_const``);
- ``hbm_intersect`` (``csrc/hbm_intersect.cu``) <- ``_hbm_kernel`` of
  ``nearest_hit_cluster_hbm``: the walk over octs of ``oct_branch``
  clusters, each cluster's box read from row 15 of its own tile.

queue, blk, blk_mxu and hbm share one walk (``csrc/group_walk.cuh``): one
warp per ray, the queue's groups being single clusters.
``queue_walk_plain``, ``blk_walk_plain``, ``blk_mxu_walk_plain`` and
``hbm_walk_plain`` run that walk in plain PyTorch, with its per-ray
counts, and ``flat_staged_plain`` runs the flat kernels' staged walk
(``csrc/flat_walk.cuh``) with its counts of pairs per stage; the walks
count their cluster tests' pairs by the same stages on request. They
serve the tests and ``chip_smoke.py``, not the render.

``null_intersect`` (``csrc/null_intersect.cu``) ports the two probe
kernels of ``scripts/fixed_cost_probe.py``: zeros in the walks' launch
shape, the fixed cost of a launch.

Two kernels have no Pallas counterpart; each computes a jnp function of
the JAX package with that function's contract, (t, idx) with +inf and -1
for a miss, t_max ignored:

- ``kd_intersect`` (``csrc/kd_intersect.cu``): the KD walk, one thread a
  ray, over the chunk rows of a ``WavefrontKD`` (``nearest_hit_wavefront``)
  or the tree's own triangle lists (``nearest_hit_kd``); the plain
  versions are ``accel.wavefront.wavefront_plain`` and
  ``accel.kd_traverse.kd_plain``. It reads each triangle's constants from
  a table of 80-byte records that ``tri_consts`` (``csrc/tri_consts.cu``,
  plain version ``accel.wavefront.tri_consts_plain``) builds once a tree:
  ``WavefrontKD.tri_table`` and ``KDTreeArrays.tri_table``;
- ``brute_intersect`` (``csrc/brute_intersect.cu``): every ray against
  every triangle (``nearest_hit_brute``, which stays the plain version and
  the oracle).

Contract, shared by every intersector and its plain version: rays (R, 8)
float32 with columns [ox oy oz dx dy dz active t_max] give, per ray, the
best t (t_max when nothing beat it) and the winning id c*128 + lane
(2**31 - 1 when nothing won). A candidate wins only strictly inside the
window (t < t_max); ties go to the lowest id. Every intersector returns the
same hits for the same scene. ``nearest_hit_*`` wrap that into the
intersector interface (t, idx, hit): a hit is an id that WON, not a finite
t.

Ray ordering, as the JAX package's ``_prep_rays``/``_unpack``: before a
call each ``nearest_hit_*`` wrapper may sort its rays (``sort_rays``) and
scatters the results back to the caller's order. ``True`` (the default
but for flat_mxu, which keeps the caller's order as the JAX package does)
is the Morton key of ``coherence_perm``; ``"block"`` (blk only) sorts by
``first_block_keys`` (``csrc/first_block_keys.cu`` <- ``_first_blocks_kernel``
of ``first_block_keys``): the first and second block a ray enters and its
direction octant. Every ray's result is computed on its own, so the order
changes no result, only the kernels' coherence.

On a CPU tensor each wrapper runs its plain version. On a CUDA tensor it
launches its kernel or raises; a failed build raises too. ``COUNTS``
records kernel launches and plain calls on CUDA tensors, so a run can show
which one it went through.

``SOURCES`` also lists the sampler's kernel (``csrc/threefry_uniforms.cu``,
wrapped by ``kernels/sampler.py`` for ``math.rng.uniforms``), the two
shading kernels of a bounce (``csrc/shade_bounce.cu``) and their backward
(``csrc/shade_backward.cu``: its binning and its reverse), all wrapped by
``kernels/shade.py``, which share this module's build, launch route and
``COUNTS`` (``sampler``; ``shade``, ``shade_finish``, ``shade_bin`` and
``shade_backward``).
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
SOURCES = ("flat_intersect.cu", "queue_intersect.cu", "blk_intersect.cu",
           "first_block_keys.cu", "hbm_intersect.cu", "flat_mxu_intersect.cu",
           "blk_mxu_intersect.cu", "null_intersect.cu", "kd_intersect.cu",
           "brute_intersect.cu", "threefry_uniforms.cu", "tri_consts.cu", "shade_bounce.cu",
           "shade_backward.cu")
# The JAX package's packet sizes: the ordering sorts a call's rays only when
# there are more of them than one packet (DEFAULT_PACKET for every
# intersector but blk, which the render path calls with BLK_PACKET).
DEFAULT_PACKET = 256
BLK_PACKET = 128
_INF = 3.4e38  # unbounded t_max seed and the value of a rejected candidate
_BIG_ID = 2**31 - 1
_CUT = 1e38  # block entry keys at or above this mean "not pierced"
# A block may use at most 232,448 bytes of shared memory on the H100. The
# first-block kernel (csrc/first_block_keys.cu, kBoxBytes) takes 28 of them
# a box of the padded table: its six coordinates and its index.
_MAX_SHARED_BYTES = 232_448
_KEY_BOX_BYTES = 28
_MAX_SHARED_BOXES = _MAX_SHARED_BYTES // _KEY_BOX_BYTES
# The walks (csrc/group_walk.cuh: kWalkWarps, walk_shared_bytes) run
# blocks of _WALK_WARPS warps, one ray each, and give each warp a list of
# one 8-byte key per group in shared memory.
_WALK_WARPS = 2
# Plain versions: ray x box masks of at most this many elements at once,
# and at most this many (ray, cluster) pairs tested at once.
_MASK_ELEMS = 1 << 22
_PAIR_CHUNK = 4096
# Stack slots a thread of the KD walk kernel has (csrc/kd_intersect.cu
# kKdStack): a tree's max_depth + 2 must fit.
KD_STACK = 64
# The words of a triangle's record (csrc/tri_test.cuh): five float4.
TRI_RECORD = 20


class LaunchCounts:
    """Kernel launches and plain-version calls on CUDA tensors."""

    KERNELS = ("flat", "queue", "blk", "first_blocks", "hbm", "flat_mxu", "blk_mxu", "null",
               "kd", "brute", "sampler", "tri_consts", "shade", "shade_finish", "shade_bin",
               "shade_backward")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        for kernel in self.KERNELS:
            setattr(self, f"{kernel}_kernel", 0)
            setattr(self, f"{kernel}_plain_cuda", 0)
        # renders on CUDA that shaded plainly because a geometry tensor
        # requires grad (integrator.path_trace.shade_route)
        self.shade_geometry_grad = 0

    def plain_cuda(self) -> int:
        """Plain-version calls on CUDA tensors, all kernels together."""
        return sum(getattr(self, f"{kernel}_plain_cuda") for kernel in self.KERNELS)

    def snapshot(self) -> dict:
        """Every count by its attribute name."""
        return dict(vars(self))


COUNTS = LaunchCounts()

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# argtypes of each C entry point; every one starts with the device index and
# ends with the stream
_ENTRY_ARGS = {
    # tri, num_clusters, rays, num_rays, t_eps, out_t, out_id
    "flat_intersect": [_P, _I, _P, _I, _F, _P, _P],
    # box_t, stride, num_clusters, tri, rays, num_rays, t_eps, out_t, out_id,
    # stats (or null)
    "queue_intersect": [_P, _I, _I, _P, _P, _I, _F, _P, _P, _P],
    # bbox_t, stride, num_blocks, blk, branch, rays, num_rays, t_eps, out_t,
    # out_id, stats (or null)
    "blk_intersect": [_P, _I, _I, _P, _I, _P, _I, _F, _P, _P, _P],
    # bbox_t, stride (= the padded block count n), rays, num_rays, t_eps, out_key
    "first_block_keys": [_P, _I, _P, _I, _F, _P],
    # oct_t, stride, num_octs, tri, oct_branch, rays, num_rays, t_eps, out_t,
    # out_id, stats (or null)
    "hbm_intersect": [_P, _I, _I, _P, _I, _P, _I, _F, _P, _P, _P],
    # tiles, num_clusters, rays, num_rays, t_eps, out_t, out_id
    "flat_mxu_intersect": [_P, _I, _P, _I, _F, _P, _P],
    # bbox_t, stride, num_blocks, mxu, branch, rays, num_rays, t_eps, out_t,
    # out_id, stats (or null)
    "blk_mxu_intersect": [_P, _I, _I, _P, _I, _P, _I, _F, _P, _P, _P],
    # num_rays, shared_groups, out_t, out_id
    "null_intersect": [_I, _I, _P, _P],
    # nodes, bbox_min, bbox_max, chunks, leaf_first, chunk_next, chunk_tri,
    # tri_indices, table, width, depth, rays, num_rays, t_eps, out_t, out_id,
    # stats (or null), next_ray
    "kd_intersect": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _I, _F, _P, _P, _P, _P],
    # vertices, num_tris, rays, num_rays, t_eps, out_t, out_id
    "brute_intersect": [_P, _I, _P, _I, _F, _P, _P],
    # ids, id_bytes, num_rays, key (or null), k0, k1, w1_base, n, out
    # (kernels/sampler.py)
    "threefry_uniforms": [_P, _I, _I, _P, _U, _U, _U, _I, _P],
    # corners, num, out
    "tri_consts": [_P, _I, _P],
    # the ShadeScene and ShadeArgs / FinishArgs structs (kernels/shade.py)
    "shade_bounce": [_P, _P],
    "finish_bounce": [_P, _P],
    # the ShadeScene and BackwardArgs structs (kernels/shade.py)
    "bounce_bin": [_P, _P],
    "bounce_backward": [_P, _P],
}
# entry points whose source is not <name>.cu
_SOURCE = {"finish_bounce": "shade_bounce.cu", "bounce_bin": "shade_backward.cu",
           "bounce_backward": "shade_backward.cu"}
# the COUNTS attribute prefix of each entry point
_COUNTER = {
    "flat_intersect": "flat",
    "queue_intersect": "queue",
    "blk_intersect": "blk",
    "first_block_keys": "first_blocks",
    "hbm_intersect": "hbm",
    "flat_mxu_intersect": "flat_mxu",
    "blk_mxu_intersect": "blk_mxu",
    "null_intersect": "null",
    "kd_intersect": "kd",
    "brute_intersect": "brute",
    "threefry_uniforms": "sampler",
    "tri_consts": "tri_consts",
    "shade_bounce": "shade",
    "finish_bounce": "shade_finish",
    "bounce_bin": "shade_bin",
    "bounce_backward": "shade_backward",
}


@functools.cache
def _kernel_fn(name: str):
    """The C entry point ``name`` of its built library (built at first use)."""
    fn = getattr(build.load(_SOURCE.get(name, f"{name}.cu")), name)
    fn.argtypes = [_I, *_ENTRY_ARGS[name], _P]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, rays: torch.Tensor, *args) -> None:
    """Launch kernel ``name`` on the current stream of ``rays``' card (any
    tensor of the launch: the sampler passes its ids)."""
    device = rays.device.index if rays.device.index is not None else torch.cuda.current_device()
    err = _kernel_fn(name)(
        device, *args, torch.cuda.current_stream(rays.device).cuda_stream
    )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    counter = f"{_COUNTER[name]}_kernel"
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
            f"{num} {what} boxes exceed the {_MAX_SHARED_BOXES} the first-block kernel stages "
            f"in the {_MAX_SHARED_BYTES} bytes of shared memory a block ({_KEY_BOX_BYTES} a box)"
        )


def walk_shared_bytes(num_groups: int) -> int:
    """Dynamic shared memory of a group-walk launch over ``num_groups``
    groups: each of the block's warps keeps one 8-byte key per group."""
    return _WALK_WARPS * 8 * num_groups


def _check_walk(name: str, num_groups: int, what: str, *tables: torch.Tensor) -> None:
    """Raise before a walk launch that the card would refuse: lists over
    the shared memory of a block, or tables that its float4 loads cannot
    read (not 16-byte aligned)."""
    if walk_shared_bytes(num_groups) > _MAX_SHARED_BYTES:
        raise ValueError(
            f"{num_groups} {what}s need {walk_shared_bytes(num_groups)} bytes of shared "
            f"memory a block, over the {_MAX_SHARED_BYTES} of the card"
        )
    if any(t.data_ptr() % 16 for t in tables):
        raise ValueError(f"{name}: the tables must start on a 16-byte boundary")


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


def _slab(box_t: torch.Tensor, rays: torch.Tensor, t_eps: float):
    """The kernels' slab test (``slab``, ``_dense_near``) of the active rays
    against the valid boxes of a component-major table: box_t (8, N), one
    row of boxes for every ray, or (8, n, N), a row per ray. Returns the
    (n, N) pierced mask and the entries (clamped at 0; 0 where a slab is
    NaN). Conservative under NaN -- torch.minimum/maximum propagate NaN as
    jnp.minimum/maximum do, and every comparison with NaN is false."""
    ix, iy, iz = 1.0 / rays[:, 3:4], 1.0 / rays[:, 4:5], 1.0 / rays[:, 5:6]
    ox, oy, oz = rays[:, 0:1], rays[:, 1:2], rays[:, 2:3]
    t1x, t2x = (box_t[0] - ox) * ix, (box_t[3] - ox) * ix
    t1y, t2y = (box_t[1] - oy) * iy, (box_t[4] - oy) * iy
    t1z, t2z = (box_t[2] - oz) * iz, (box_t[5] - oz) * iz
    near = torch.maximum(
        torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
        torch.minimum(t1z, t2z),
    )
    far = torch.minimum(
        torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
        torch.maximum(t1z, t2z),
    )
    miss = (near > far) | (far < t_eps)
    pierced = ~miss & (box_t[6] > 0.0) & (rays[:, 6:7] > 0.0)
    return pierced, torch.where(near != near, 0.0, torch.clamp_min(near, 0.0))


def _pierce(box_t: torch.Tensor, rays: torch.Tensor, t_eps: float) -> torch.Tensor:
    """(n, N) mask of the active rays that pierce each valid box of a
    component-major (8, N) table (``_slab``)."""
    return _slab(box_t, rays, t_eps)[0]


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
    return _flat(tri, rays, t_eps)


def _flat(tri: torch.Tensor, rays: torch.Tensor, t_eps: float):
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


def _stages_apply(best_t: torch.Tensor, t_eps: float) -> torch.Tensor:
    """Where the flat kernel's stages apply: t_eps > 0 and a best of at
    most _INF (not above it, not NaN)."""
    return (best_t <= _INF) & (t_eps > 0.0)


def _flat_stages(tile: torch.Tensor, rays: torch.Tensor, t_eps: float,
                 best_t: torch.Tensor, fast: torch.Tensor, keep_ties: bool = False):
    """The plane and window stages of the flat kernels (``csrc/flat_walk.cuh``)
    for each active ray against each slot of ``tile`` (..., 16, k), as
    ``_tri_hits`` broadcasts, with the ray's best ``best_t`` (n, 1) or
    (n, k). Returns (plane, window): the pairs the plane stage passes on to
    the division, and those the window stage passes on to the edge test.
    Where ``fast`` (broadcast as best_t) is false, the stages do not apply
    and every pair of an active ray passes both. The window stage rejects
    s >= best_t, or with ``keep_ties`` only s > best_t (a walk's accept can
    take a tie at the best with a lower id)."""
    ox, oy, oz = rays[:, 0:1], rays[:, 1:2], rays[:, 2:3]
    dx, dy, dz = rays[:, 3:4], rays[:, 4:5], rays[:, 5:6]
    nx, ny, nz, np1 = tile[..., 0, :], tile[..., 1, :], tile[..., 2, :], tile[..., 9, :]
    ddn = dx * nx + dy * ny + dz * nz
    odn = ox * nx + oy * ny + oz * nz
    num = np1 - odn
    ordered = (num == num) & (ddn == ddn)
    behind = ordered & ((ddn == 0.0) | (num == 0.0) | ((num > 0.0) != (ddn > 0.0)))
    act = rays[:, 6:7] > 0.0
    plane = act & ~(fast & behind)
    s = num / ddn
    beyond = (s > best_t) if keep_ties else ~(s < best_t)
    window = plane & ~(fast & (~(s >= t_eps) | beyond))
    return plane, window


def _tile_stage_counts(tiles: torch.Tensor, rays: torch.Tensor, t_eps: float,
                       best_t: torch.Tensor) -> torch.Tensor:
    """The flat stages' count for one tile test of a walk: ray i against
    its tile ``tiles[i]`` (n, 16, 128) with its best at the test's start
    ``best_t`` (n,). Returns (n, 3) int64: the slots up to the tile's last
    real one (all 128 where the stages do not apply), the pairs reaching the
    division, and those reaching the edge test, a tie at the best included."""
    lanes = torch.arange(1, 129, device=rays.device)
    used = ((tiles[:, :15] != 0.0).any(dim=1) * lanes).amax(dim=1, keepdim=True)
    fast = _stages_apply(best_t, t_eps)[:, None]
    visit = (rays[:, 6:7] > 0.0) & ~(fast & (lanes > used))
    plane, window = _flat_stages(tiles, rays, t_eps, best_t[:, None], fast, keep_ties=True)
    return torch.stack([visit.sum(dim=1), (visit & plane).sum(dim=1),
                        (visit & window).sum(dim=1)], dim=1)


def flat_staged_plain(tri: torch.Tensor, rays: torch.Tensor, t_eps: float):
    """The flat kernel's staged walk in plain PyTorch (any device): slot by
    slot in id order with each ray's running best, skipping the pairs that
    ``_flat_stages`` rules out and a tile's trailing all-zero (pad) slots,
    where the stages apply at the tile's start (a ray outside them then
    takes the full test through the whole tile, as the kernel decides it
    once a tile). Returns (best_t, best_id, (R, 3) int64 per ray: slots
    that entered the plane stage, pairs that reached the division, pairs
    that reached the edge test); (best_t, best_id) equal the flat plain
    version's. For tests and ``chip_smoke.py``."""
    _check_rays(rays, tri)
    _check_tiles(tri)
    if rays.is_cuda:
        COUNTS.flat_plain_cuda += 1
    t_eps = float(np.float32(t_eps))
    best_t = rays[:, 7].clone()
    best_id = torch.full((rays.shape[0],), _BIG_ID, dtype=torch.int32, device=rays.device)
    counts = torch.zeros((rays.shape[0], 3), dtype=torch.int64, device=rays.device)
    act = rays[:, 6] > 0.0
    for c in range(tri.shape[0]):
        nonzero = (tri[c, :15] != 0.0).any(dim=0).nonzero()
        used = int(nonzero[-1]) + 1 if nonzero.numel() else 0
        fast = _stages_apply(best_t, t_eps)[:, None]
        for lane in range(128):
            slot = tri[c, :, lane:lane + 1]
            visit = act & ~(fast[:, 0] & (lane >= used))
            plane, window = _flat_stages(slot, rays, t_eps, best_t[:, None], fast)
            tval = _tri_hits(slot, rays, t_eps)[:, 0]
            better = visit & window[:, 0] & (tval < best_t)
            best_t = torch.where(better, tval, best_t)
            best_id = torch.where(better, c * 128 + lane, best_id)
            counts += torch.stack([visit, visit & plane[:, 0], visit & window[:, 0]], dim=1)
    return best_t, best_id, counts


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


# --- flat over MXU tile pairs ---------------------------------------------


def _check_pairs(tiles: torch.Tensor) -> None:
    if tiles.dim() != 4 or tiles.shape[1:] != (2, 16, 128) or tiles.shape[0] < 1:
        raise ValueError(f"tiles must be (C>=1, 2, 16, 128), got {tuple(tiles.shape)}")


def _mxu_unpack(pairs: torch.Tensor) -> torch.Tensor:
    """(..., 16, 128) cluster tiles of (..., 2, 16, 128) MXU pairs: rows 0-14
    as in the VPU layout (``accel.cluster._mxu_pairs_np`` backwards), row
    15 zero."""
    w1, w2 = pairs[..., 0, :, :], pairs[..., 1, :, :]
    return torch.cat([w1[..., 0:3, :], w1[..., 8:11, :], w2[..., 0:3, :],
                      w2[..., 8:14, :], torch.zeros_like(w1[..., 0:1, :])], dim=-2)


def flat_mxu_intersect_plain(tiles: torch.Tensor, rays: torch.Tensor, t_eps: float):
    """Plain PyTorch version of the flat MXU kernel's contract (any device):
    the pairs unpacked to the VPU layout, then the flat plain version's
    walk, so the two agree bit for bit."""
    _check_rays(rays, tiles)
    _check_pairs(tiles)
    if rays.is_cuda:
        COUNTS.flat_mxu_plain_cuda += 1
    return _flat(_mxu_unpack(tiles), rays, t_eps)


def flat_mxu_intersect(tiles: torch.Tensor, rays: torch.Tensor, t_eps: float):
    """The flat MXU kernel on CUDA tensors, its plain version on CPU tensors.

    tiles: (C, 2, 16, 128) float32 MXU pairs of the real clusters
    (``mxu_tiles``); rays: (R, 8) float32. Returns (best_t (R,) float32,
    best_id (R,) int32) as in the contract.
    """
    _check_rays(rays, tiles)
    _check_pairs(tiles)
    if not rays.is_cuda:
        return flat_mxu_intersect_plain(tiles, rays, t_eps)
    _check_contiguous("flat_mxu_intersect", tiles, rays)
    out_t, out_id = _outputs(rays)
    _launch(
        "flat_mxu_intersect", rays,
        tiles.data_ptr(), tiles.shape[0], rays.data_ptr(), rays.shape[0], float(t_eps),
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


def queue_walk_plain(box_t: torch.Tensor, tri: torch.Tensor, rays: torch.Tensor,
                     t_eps: float, stages: bool = False):
    """The queue kernel's own walk in plain PyTorch (any device): the group
    walk over groups of one cluster, whose boxes are the cluster boxes.
    Returns (best_t, best_id, (R, 2) int32 clusters visited and clusters
    intersected, which are equal), which the kernel's ``stats=True`` call
    must equal, and with ``stages`` the stages' count of
    ``_group_walk_pruned``. For tests and ``chip_smoke.py``."""
    _check_queue(box_t, tri, rays)
    if rays.is_cuda:
        COUNTS.queue_plain_cuda += 1
    boxes = box_t[:, : tri.shape[0]]
    return _group_walk_pruned(boxes, boxes, 1, lambda c: tri[c], rays, t_eps, stages)


def queue_intersect(box_t: torch.Tensor, tri: torch.Tensor, rays: torch.Tensor,
                    t_eps: float, stats: bool = False):
    """The queue kernel on CUDA tensors, its plain version on CPU tensors.

    box_t: (8, >= C) float32 component-major cluster boxes (``clu_bbox_t``);
    tri: (C, 16, 128) float32 cluster tiles; rays: (R, 8) float32.
    Returns (best_t (R,) float32, best_id (R,) int32) as in the contract,
    and with ``stats`` also (R, 2) int32 per ray (CUDA only): clusters
    visited, clusters intersected.
    """
    _check_queue(box_t, tri, rays)
    if not rays.is_cuda:
        _no_stats_on_cpu("queue_intersect", stats)
        return queue_intersect_plain(box_t, tri, rays, t_eps)
    _check_contiguous("queue_intersect", box_t, tri, rays)
    _check_walk("queue_intersect", tri.shape[0], "cluster", tri)
    return _walk("queue_intersect", rays, t_eps, stats, box_t.data_ptr(), box_t.shape[1],
                 tri.shape[0], tri.data_ptr())


# --- group walks: blocked, blocked over MXU pairs, octs --------------------


def _group_walk_plain(group_t, clu_t, branch, tile_fn, rays, t_eps):
    """The plain counterpart of the walk kernels (``csrc/group_walk.cuh``):
    the slab cull of every ray against every cluster box of the
    component-major (8, G * branch) table ``clu_t``, ANDed with the cull of
    the cluster's group in ``group_t``, then the 128-lane test of every
    pierced (ray, cluster) pair, with no pruning by the running best.
    tile_fn(cluster ids (P,)) -> (P, 16, 128) tiles."""
    t_eps = float(np.float32(t_eps))
    num = clu_t.shape[1]
    groups = group_t[:, : num // branch]

    def pierce(r):
        in_group = _pierce(groups, r, t_eps).repeat_interleave(branch, dim=1)
        return in_group & _pierce(clu_t, r, t_eps)

    return _nearest_of_pairs(rays, num, pierce, tile_fn, t_eps)


def _first_least(entry: torch.Tensor, cand: torch.Tensor):
    """Per row, the least entry among the candidates and the lowest column
    that holds it (rows with at least one candidate)."""
    least = torch.where(cand, entry, float("inf")).min(dim=1).values
    col = (cand & (entry == least[:, None])).to(torch.uint8).argmax(dim=1)
    return least, col


def _group_walk_pruned(group_t, clu_t, size, tile_fn, rays, t_eps, stages=False):
    """The walk of the walk kernels (``csrc/group_walk.cuh``) in plain
    PyTorch, vectorised over rays, with its per-ray counts.

    Each step takes, for every ray still walking, the pierced valid group
    with the least (entry, index) after the ray's cursor whose entry is at
    most the ray's best t; culls the group's ``size`` clusters (the boxes of
    the component-major (8, G * size) table ``clu_t``) against that best;
    then, front to back, intersects the pierced cluster with the least
    (entry, index) whose entry is still at most the best, dropping those
    now behind it. A cluster test applies ``accept`` to the least (t, id)
    of its 128 slots. tile_fn(cluster ids (P,)) -> (P, 16, 128) tiles.
    Returns (best_t, best_id, (R, 2) int32 groups visited and clusters
    intersected) and, with ``stages``, (R, 3) int64 the flat stages' count
    of the cluster tests (``_tile_stage_counts``, each against the best at
    its start): the least work of those tests, for ``chip_smoke.py``'s
    bounds."""
    t_eps = float(np.float32(t_eps))
    num_rays, device = rays.shape[0], rays.device
    num_groups = clu_t.shape[1] // size
    best_t = rays[:, 7].clone()
    best_id = torch.full((num_rays,), _BIG_ID, dtype=torch.int32, device=device)
    stats = torch.zeros((num_rays, 2), dtype=torch.int32, device=device)
    counts = torch.zeros((num_rays, 3), dtype=torch.int64, device=device)
    g_pierced, g_entry = _slab(group_t[:, :num_groups], rays, t_eps)
    cur_e = torch.full((num_rays,), -1.0, dtype=torch.float32, device=device)
    cur_g = torch.full((num_rays,), -1, dtype=torch.int64, device=device)
    g_index = torch.arange(num_groups, device=device)
    k_index = torch.arange(size, device=device)
    lane = torch.arange(128, dtype=torch.int32, device=device)
    while True:
        after = (g_entry > cur_e[:, None]) | (
            (g_entry == cur_e[:, None]) & (g_index > cur_g[:, None]))
        cand = g_pierced & ~(g_entry > best_t[:, None]) & after
        rows = torch.nonzero(cand.any(dim=1)).flatten()
        if rows.numel() == 0:
            break
        cur_e[rows], cur_g[rows] = _first_least(g_entry[rows], cand[rows])
        stats[rows, 0] += 1
        clusters = cur_g[rows, None] * size + k_index  # (m, size)
        c_pierced, c_entry = _slab(clu_t[:, clusters], rays[rows], t_eps)
        left = c_pierced & (c_entry <= best_t[rows, None])
        while True:
            left &= ~(c_entry > best_t[rows, None])
            sub = torch.nonzero(left.any(dim=1)).flatten()
            if sub.numel() == 0:
                break
            _, k = _first_least(c_entry[sub], left[sub])
            left[sub, k] = False
            r = rows[sub]
            stats[r, 1] += 1
            c = clusters[sub, k]
            tiles, bt, bid = tile_fn(c), best_t[r], best_id[r]
            tval = _tri_hits(tiles, rays[r], t_eps)  # (P, 128)
            if stages:
                counts[r] += _tile_stage_counts(tiles, rays[r], t_eps, bt)
            t, slot = _first_least(tval, torch.ones_like(tval, dtype=torch.bool))
            cid = c.to(torch.int32) * 128 + lane[slot]
            win = (t < bt) | ((t == bt) & (bid != _BIG_ID) & (cid < bid))
            best_t[r] = torch.where(win, t, bt)
            best_id[r] = torch.where(win, cid, bid)
    return (best_t, best_id, stats, counts) if stages else (best_t, best_id, stats)


def _walk(name: str, rays: torch.Tensor, t_eps: float, stats: bool, *tables) -> tuple:
    """Launch walk kernel ``name`` on its table arguments ``tables`` (those
    before the rays): (best_t, best_id) and, with ``stats``, the (R, 2)
    int32 groups visited and clusters intersected per ray."""
    out_t, out_id = _outputs(rays)
    out_stats = (
        torch.empty((rays.shape[0], 2), dtype=torch.int32, device=rays.device)
        if stats else None
    )
    _launch(
        name, rays, *tables, rays.data_ptr(), rays.shape[0], float(t_eps),
        out_t.data_ptr(), out_id.data_ptr(),
        None if out_stats is None else out_stats.data_ptr(),
    )
    return (out_t, out_id, out_stats) if stats else (out_t, out_id)


def _no_stats_on_cpu(name: str, stats: bool) -> None:
    if stats:
        raise ValueError(f"{name}: stats count the kernel's walk; the plain version "
                         "on the CPU has none")


def _check_blk(bbox_t, blk, rays, tiles_per_cluster: int = 1) -> int:
    """Checks a blocked table of ``tiles_per_cluster`` tiles a cluster after
    the header; returns its branch."""
    _check_rays(rays, bbox_t, blk)
    branch, rest = divmod(blk.shape[1] - 1, tiles_per_cluster) if blk.dim() == 4 else (0, 0)
    if blk.shape[2:] != (16, 128) or rest or not 1 <= branch <= 128:
        k = "" if tiles_per_cluster == 1 else f"{tiles_per_cluster} * "
        raise ValueError(
            f"table must be (NB, {k}branch + 1, 16, 128) with branch <= 128, got "
            f"{tuple(blk.shape)}"
        )
    _check_boxes(bbox_t, blk.shape[0], "block")
    return branch


def _header_boxes(blk: torch.Tensor, branch: int) -> torch.Tensor:
    """Header rows 0-6, lanes [0, branch): cluster b*branch + k at column
    b*branch + k of a component-major (8, NB*branch) table."""
    num_blocks = blk.shape[0]
    return torch.cat([
        blk[:, 0, 0:7, :branch].permute(1, 0, 2).reshape(7, num_blocks * branch),
        torch.zeros((1, num_blocks * branch), dtype=torch.float32, device=blk.device),
    ])


def _blk_groups(bbox_t, blk, rays):
    """The blocked table as the plain walks take it: (group boxes, cluster
    boxes, clusters a group, tile_fn)."""
    branch = _check_blk(bbox_t, blk, rays)
    return bbox_t, _header_boxes(blk, branch), branch, lambda c: blk[c // branch, 1 + c % branch]


def blk_intersect_plain(bbox_t: torch.Tensor, blk: torch.Tensor, rays: torch.Tensor,
                        t_eps: float):
    """Plain PyTorch version of the blocked kernel's contract (any device):
    the group-walk plain version over the header tiles' cluster boxes."""
    groups = _blk_groups(bbox_t, blk, rays)
    if rays.is_cuda:
        COUNTS.blk_plain_cuda += 1
    return _group_walk_plain(*groups, rays, t_eps)


def blk_walk_plain(bbox_t: torch.Tensor, blk: torch.Tensor, rays: torch.Tensor,
                   t_eps: float, stages: bool = False):
    """The blocked kernel's own walk in plain PyTorch (any device): (best_t,
    best_id, (R, 2) int32 blocks visited and clusters intersected), which
    the kernel's ``stats=True`` call must equal, and with ``stages`` the
    stages' count of ``_group_walk_pruned``. For tests and
    ``chip_smoke.py``."""
    groups = _blk_groups(bbox_t, blk, rays)
    if rays.is_cuda:
        COUNTS.blk_plain_cuda += 1
    return _group_walk_pruned(*groups, rays, t_eps, stages)


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
    branch = _check_blk(bbox_t, blk, rays)
    if not rays.is_cuda:
        _no_stats_on_cpu("blk_intersect", stats)
        return blk_intersect_plain(bbox_t, blk, rays, t_eps)
    _check_contiguous("blk_intersect", bbox_t, blk, rays)
    _check_walk("blk_intersect", blk.shape[0], "block", blk)
    return _walk("blk_intersect", rays, t_eps, stats, bbox_t.data_ptr(), bbox_t.shape[1],
                 blk.shape[0], blk.data_ptr(), branch)


def _blk_mxu_groups(bbox_t, mxu, rays):
    """The MXU blocked table as the plain walks take it, each cluster's pair
    unpacked to the VPU layout."""
    branch = _check_blk(bbox_t, mxu, rays, 2)

    def tiles(c):
        first = 1 + 2 * (c % branch)
        block = c // branch
        return _mxu_unpack(torch.stack([mxu[block, first], mxu[block, first + 1]], dim=1))

    return bbox_t, _header_boxes(mxu, branch), branch, tiles


def blk_mxu_intersect_plain(bbox_t: torch.Tensor, mxu: torch.Tensor, rays: torch.Tensor,
                            t_eps: float):
    """Plain PyTorch version of the MXU blocked kernel's contract (any
    device): the blocked plain version with each cluster's pair unpacked to
    the VPU layout, so the two agree bit for bit on the same clusters."""
    groups = _blk_mxu_groups(bbox_t, mxu, rays)
    if rays.is_cuda:
        COUNTS.blk_mxu_plain_cuda += 1
    return _group_walk_plain(*groups, rays, t_eps)


def blk_mxu_walk_plain(bbox_t: torch.Tensor, mxu: torch.Tensor, rays: torch.Tensor,
                       t_eps: float, stages: bool = False):
    """The MXU blocked kernel's own walk in plain PyTorch, as
    ``blk_walk_plain``."""
    groups = _blk_mxu_groups(bbox_t, mxu, rays)
    if rays.is_cuda:
        COUNTS.blk_mxu_plain_cuda += 1
    return _group_walk_pruned(*groups, rays, t_eps, stages)


def blk_mxu_intersect(bbox_t: torch.Tensor, mxu: torch.Tensor, rays: torch.Tensor,
                      t_eps: float, stats: bool = False):
    """The MXU blocked kernel on CUDA tensors, its plain version on CPU
    tensors.

    bbox_t: (8, >= NB) float32 block boxes (``blk_bbox_t``); mxu: (NB,
    2 * branch + 1, 16, 128) float32 MXU blocked table (``mxu_const``);
    rays: (R, 8) float32. Results and ``stats`` as ``blk_intersect``.
    """
    branch = _check_blk(bbox_t, mxu, rays, 2)
    if not rays.is_cuda:
        _no_stats_on_cpu("blk_mxu_intersect", stats)
        return blk_mxu_intersect_plain(bbox_t, mxu, rays, t_eps)
    _check_contiguous("blk_mxu_intersect", bbox_t, mxu, rays)
    _check_walk("blk_mxu_intersect", mxu.shape[0], "block", mxu)
    return _walk("blk_mxu_intersect", rays, t_eps, stats, bbox_t.data_ptr(),
                 bbox_t.shape[1], mxu.shape[0], mxu.data_ptr(), branch)


def _check_hbm(oct_t, tri, rays, oct_branch: int) -> int:
    """Checks the oct walk's tables; returns the oct count."""
    _check_rays(rays, oct_t, tri)
    _check_tiles(tri)
    if not 1 <= oct_branch <= 128 or tri.shape[0] % oct_branch:
        raise ValueError(
            f"oct_branch {oct_branch} must be in [1, 128] and divide the "
            f"{tri.shape[0]} clusters"
        )
    num_octs = tri.shape[0] // oct_branch
    _check_boxes(oct_t, num_octs, "oct")
    return num_octs


def _oct_groups(oct_t, tri, rays, oct_branch):
    """The oct tables as the plain walks take them: the row-15 cluster
    boxes of the tiles, valid where min x <= max x (the kernel's skip of a
    pad cluster's inverted box)."""
    _check_hbm(oct_t, tri, rays, oct_branch)
    box = tri[:, 15, 0:6].T
    clu_t = torch.cat([box, (box[0:1] <= box[3:4]).float(), torch.zeros_like(box[0:1])])
    return oct_t, clu_t, oct_branch, lambda c: tri[c]


def hbm_intersect_plain(oct_t: torch.Tensor, tri: torch.Tensor, rays: torch.Tensor,
                        t_eps: float, oct_branch: int):
    """Plain PyTorch version of the oct kernel's contract (any device): the
    group-walk plain version over the octs and the row-15 cluster boxes."""
    groups = _oct_groups(oct_t, tri, rays, oct_branch)
    if rays.is_cuda:
        COUNTS.hbm_plain_cuda += 1
    return _group_walk_plain(*groups, rays, t_eps)


def hbm_walk_plain(oct_t: torch.Tensor, tri: torch.Tensor, rays: torch.Tensor,
                   t_eps: float, oct_branch: int, stages: bool = False):
    """The oct kernel's own walk in plain PyTorch, as ``blk_walk_plain``
    (octs visited, clusters intersected)."""
    groups = _oct_groups(oct_t, tri, rays, oct_branch)
    if rays.is_cuda:
        COUNTS.hbm_plain_cuda += 1
    return _group_walk_pruned(*groups, rays, t_eps, stages)


def hbm_intersect(oct_t: torch.Tensor, tri: torch.Tensor, rays: torch.Tensor,
                  t_eps: float, oct_branch: int, stats: bool = False):
    """The oct kernel on CUDA tensors, its plain version on CPU tensors.

    oct_t: (8, >= C / oct_branch) float32 component-major oct boxes
    (``oct_bbox_t``); tri: (C, 16, 128) float32 cluster tiles; rays: (R, 8)
    float32; oct_branch: clusters per oct of ``oct_t``. Returns (best_t
    (R,) float32, best_id (R,) int32) as in the contract, and with
    ``stats`` also (R, 2) int32 per ray (CUDA only): octs visited, clusters
    intersected.
    """
    num_octs = _check_hbm(oct_t, tri, rays, oct_branch)
    if not rays.is_cuda:
        _no_stats_on_cpu("hbm_intersect", stats)
        return hbm_intersect_plain(oct_t, tri, rays, t_eps, oct_branch)
    _check_contiguous("hbm_intersect", oct_t, tri, rays)
    _check_walk("hbm_intersect", num_octs, "oct", tri)
    return _walk("hbm_intersect", rays, t_eps, stats, oct_t.data_ptr(), oct_t.shape[1],
                 num_octs, tri.data_ptr(), oct_branch)


# --- the probe of a launch's fixed cost -----------------------------------


def null_intersect_plain(rays: torch.Tensor, shared_groups: int = 0):
    """Plain PyTorch version of the null kernel (any device): zero (R,)
    float32 and int32 outputs; ``shared_groups`` only sizes the kernel's
    launch."""
    _check_rays(rays)
    if rays.is_cuda:
        COUNTS.null_plain_cuda += 1
    return (torch.zeros((rays.shape[0],), dtype=torch.float32, device=rays.device),
            torch.zeros((rays.shape[0],), dtype=torch.int32, device=rays.device))


def null_intersect(rays: torch.Tensor, shared_groups: int = 0):
    """The null kernel on CUDA tensors, its plain version on CPU tensors:
    the outputs of an intersector call over ``rays``, all zero, from a
    launch in the group walks' shape with their shared memory for
    ``shared_groups`` groups (``walk_shared_bytes``; the blocked kernel's
    block count, or 0 for none). It reads no ray: it measures the fixed
    cost of a launch."""
    _check_rays(rays)
    if not rays.is_cuda:
        return null_intersect_plain(rays, shared_groups)
    _check_walk("null_intersect", shared_groups, "group")
    out_t, out_id = _outputs(rays)
    _launch("null_intersect", rays, rays.shape[0], int(shared_groups), out_t.data_ptr(),
            out_id.data_ptr())
    return out_t, out_id


# --- the KD walk and the brute force (no Pallas counterpart) ---------------


def _check_kd(tree, o, d, vertices) -> None:
    depth = tree.max_depth + 2
    if depth > KD_STACK:
        raise ValueError(
            f"max_depth {tree.max_depth}: the KD walk kernel's stack holds {KD_STACK} cells "
            f"a ray, the walk needs max_depth + 2 = {depth}"
        )
    floats = [o, d, tree.bbox_min, tree.bbox_max]
    floats += [tree.chunk_data] if vertices is None else [vertices]
    ints = ([tree.leaf_first, tree.chunk_next, tree.chunk_tri] if vertices is None
            else [tree.tri_indices])
    if any(t.dtype != torch.float32 for t in floats) or any(t.dtype != torch.int32 for t in ints):
        raise TypeError("KD walk: float32 rays, boxes and triangles, int32 indices expected")
    if any(t.device != o.device for t in floats + ints):
        raise ValueError("KD walk: the rays and the tree must lie on one device")


@torch.no_grad()
def kd_intersect(tree, o, d, t_eps: float = 1e-5, active=None, vertices=None,
                 stats: bool = False):
    """The KD walk kernel on CUDA tensors, its plain version on CPU tensors.

    ``tree``: a ``WavefrontKD`` (the chunk rows; plain version
    ``accel.wavefront.wavefront_plain``), or with ``vertices`` (N, 3, 3) a
    ``KDTreeArrays`` (the tree's own lists; ``accel.kd_traverse.kd_plain``).
    o, d: (R, 3) float32; ``active`` (R,) bool or None. Returns (t (R,)
    float32, idx (R,) int32): +inf and -1 for a miss and an inactive ray;
    with ``stats`` also (R, 3) int32 inner-node steps, leaf rows and
    triangle tests per ray (csrc/kd_intersect.cu).

    The kernel reads the tree's triangle table (``tri_table``), which the
    first call on the card builds (``tri_consts``): outside a CUDA graph
    capture, as a graph step's first, eager call is.
    """
    vertices = None if vertices is None else torch.as_tensor(vertices)
    _check_kd(tree, o, d, vertices)
    if not o.is_cuda:
        if vertices is None:
            from isaklm_raytracer_tpu_torch.accel.wavefront import wavefront_plain

            return wavefront_plain(tree, o, d, t_eps, active, stats)
        from isaklm_raytracer_tpu_torch.accel.kd_traverse import kd_plain

        return kd_plain(tree, vertices, o, d, t_eps, active, stats)
    rays = prep_rays(o, d, active)
    nodes = tree.nodes
    if vertices is None:
        table = tree.tri_table
        tables = (1, tree.leaf_first, tree.chunk_next, tree.chunk_tri, None, table,
                  tree.leaf_width)
    else:
        table = tree.tri_table(vertices)
        tables = (0, None, None, None, tree.tri_indices, table, 0)
    _check_contiguous("kd_intersect", nodes, rays, tree.bbox_min, tree.bbox_max,
                      *(t for t in tables if isinstance(t, torch.Tensor)))
    if table.data_ptr() % 16:
        raise ValueError("kd_intersect: the triangle table must start on a 16-byte boundary")

    def ptr(t):
        return t.data_ptr() if isinstance(t, torch.Tensor) else t

    out_t, out_id = _outputs(rays)
    out_stats = (torch.zeros((rays.shape[0], 3), dtype=torch.int32, device=rays.device)
                 if stats else None)
    next_ray = torch.empty((1,), dtype=torch.int32, device=rays.device)
    _launch("kd_intersect", rays, nodes.data_ptr(), tree.bbox_min.data_ptr(),
            tree.bbox_max.data_ptr(), *(ptr(t) for t in tables), tree.max_depth + 2,
            rays.data_ptr(), rays.shape[0], float(t_eps), out_t.data_ptr(), out_id.data_ptr(),
            None if out_stats is None else out_stats.data_ptr(), next_ray.data_ptr())
    return (out_t, out_id, out_stats) if stats else (out_t, out_id)


@torch.no_grad()
def tri_consts(src: torch.Tensor) -> torch.Tensor:
    """The triangle-constant table kernel on CUDA tensors, ``accel.wavefront.
    tri_consts_plain`` on CPU tensors: (num, 20) float32 records of the KD
    walk kernel (csrc/tri_test.cuh), one a row of ``src``.

    src (num, 9) float32: each triangle's corners p1 | p2 | p3; word 7
    holds the row's index. The table is built once a tree, so on the card
    it refuses to run inside a CUDA graph capture: a graph would own the
    table's memory.
    """
    if src.dim() != 2 or src.shape[1] != 9 or src.dtype != torch.float32:
        raise ValueError(f"tri_consts: src must be (num, 9) float32, got {tuple(src.shape)} "
                         f"{src.dtype}")
    if not src.is_cuda:
        from isaklm_raytracer_tpu_torch.accel.wavefront import tri_consts_plain

        return tri_consts_plain(src)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("tri_consts: the KD walk's triangle table is built once, outside "
                           "a CUDA graph capture (a graph step's first call runs eagerly)")
    _check_contiguous("tri_consts", src)
    out = torch.empty((src.shape[0], TRI_RECORD), dtype=torch.float32, device=src.device)
    _launch("tri_consts", src, src.data_ptr(), src.shape[0], out.data_ptr())
    return out


@torch.no_grad()
def brute_intersect(vertices, o, d, t_eps: float = 1e-5, active=None, t_max=None):
    """The brute-force kernel on CUDA tensors, ``accel.traverse.
    nearest_hit_brute`` on CPU tensors: every ray against every triangle
    of vertices (N, 3, 3). o, d: (R, 3). Returns detached (t (R,), idx (R,)
    int32, hit (R,) bool) with ``nearest_hit_brute``'s contract: the
    lowest id on ties, (+inf, -1, False) for a miss and an inactive ray;
    ``t_max`` is accepted for interface parity and ignored."""
    if not o.is_cuda:
        from isaklm_raytracer_tpu_torch.accel.traverse import nearest_hit_brute

        return nearest_hit_brute(o, d, vertices, t_eps, active=active, t_max=t_max)
    rays = prep_rays(o, d, active)
    _check_rays(rays, vertices)
    if vertices.dim() != 3 or vertices.shape[1:] != (3, 3):
        raise ValueError(f"vertices must be (N, 3, 3), got {tuple(vertices.shape)}")
    _check_contiguous("brute_intersect", vertices, rays)
    out_t, out_id = _outputs(rays)
    _launch("brute_intersect", rays, vertices.data_ptr(), vertices.shape[0], rays.data_ptr(),
            rays.shape[0], float(t_eps), out_t.data_ptr(), out_id.data_ptr())
    return out_t, out_id, torch.isfinite(out_t)


# --- first-block keys -----------------------------------------------------


def check_key_capacity(n: int) -> None:
    """Raise unless every key of an ``n``-wide block table fits below the
    "pierces nothing" key _BIG_ID - 1. The largest key of a ray that pierces
    a block is 8n^2 + 8n - 1 (first block n - 1, second "none" n, octant 7);
    the JAX package's assert (n + 1) * n * 8 < 2**31 admits the same n."""
    if 8 * n * n + 8 * n - 1 >= _BIG_ID - 1:
        raise ValueError(f"{n} blocks overflow the int32 first-block key")


def _check_keys(bbox_t, rays):
    _check_rays(rays, bbox_t)
    if bbox_t.dim() != 2 or bbox_t.shape[0] != 8 or bbox_t.shape[1] < 1:
        raise ValueError(f"block box table must be (8, n >= 1), got {tuple(bbox_t.shape)}")
    check_key_capacity(bbox_t.shape[1])


def _first_keys(bbox_t: torch.Tensor, rays: torch.Tensor, t_eps: float) -> torch.Tensor:
    """``_first_blocks_kernel`` on a slice of rays, operation for operation."""
    n = bbox_t.shape[1]
    ox, oy, oz = rays[:, 0:1], rays[:, 1:2], rays[:, 2:3]
    dx, dy, dz = rays[:, 3:4], rays[:, 4:5], rays[:, 5:6]
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    t1x, t2x = (bbox_t[0:1] - ox) * ix, (bbox_t[3:4] - ox) * ix
    t1y, t2y = (bbox_t[1:2] - oy) * iy, (bbox_t[4:5] - oy) * iy
    t1z, t2z = (bbox_t[2:3] - oz) * iz, (bbox_t[5:6] - oz) * iz
    # torch.minimum/maximum propagate NaN as jnp.minimum/maximum do
    near = torch.maximum(
        torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
        torch.minimum(t1z, t2z),
    )
    far = torch.minimum(
        torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
        torch.maximum(t1z, t2z),
    )
    miss = (near > far) | (far < t_eps)  # false on NaN: a conservative hit
    key = torch.where(miss, _INF, torch.maximum(near, torch.zeros_like(near)))
    key = torch.where(key != key, 0.0, key)  # NaN: visit first
    key = torch.where(bbox_t[6:7] > 0.0, key, _INF)

    iota = torch.arange(n, dtype=torch.int32, device=rays.device)
    first = key.min(dim=1, keepdim=True).values
    fidx = torch.where(key <= first, iota, _BIG_ID).min(dim=1, keepdim=True).values
    key2 = torch.where(iota == fidx, _INF, key)
    second = key2.min(dim=1, keepdim=True).values
    sidx = torch.where(key2 <= second, iota, _BIG_ID).min(dim=1, keepdim=True).values
    sidx = torch.where(second >= _CUT, n, sidx)
    octant = (dx > 0.0).int() + 2 * (dy > 0.0).int() + 4 * (dz > 0.0).int()
    comp = (fidx * (n + 1) + sidx) * 8 + octant
    comp = torch.where(first >= _CUT, _BIG_ID - 1, comp)
    return torch.where(rays[:, 6:7] > 0.0, comp, _BIG_ID)[:, 0]


def first_block_keys_plain(bbox_t: torch.Tensor, rays: torch.Tensor, t_eps: float):
    """Plain PyTorch version of the first-block key (any device): the dense
    (ray, block) slab pass of ``_first_blocks_kernel``, reduced per ray to
    its least and second-least (entry, index) pairs."""
    _check_keys(bbox_t, rays)
    if rays.is_cuda:
        COUNTS.first_blocks_plain_cuda += 1
    t_eps = float(np.float32(t_eps))
    step = max(1, _MASK_ELEMS // bbox_t.shape[1])
    keys = torch.empty((rays.shape[0],), dtype=torch.int32, device=rays.device)
    for start in range(0, rays.shape[0], step):
        keys[start:start + step] = _first_keys(bbox_t, rays[start:start + step], t_eps)
    return keys


def first_block_keys(bbox_t: torch.Tensor, rays: torch.Tensor, t_eps: float):
    """The first-block key kernel on CUDA tensors, its plain version on CPU
    tensors.

    bbox_t: (8, n) float32 component-major block boxes (``blk_bbox_t``; n is
    its padded width); rays: (R, 8) float32, column 7 ignored. Returns (R,)
    int32 keys ((first * (n + 1) + second) * 8 + octant), where first and
    second are the blocks the ray enters first and second (second = n when
    it enters one), _BIG_ID - 1 for a ray that pierces no block and _BIG_ID
    for an inactive one.
    """
    _check_keys(bbox_t, rays)
    if not rays.is_cuda:
        return first_block_keys_plain(bbox_t, rays, t_eps)
    _check_contiguous("first_block_keys", bbox_t, rays)
    _check_shared(bbox_t.shape[1], "block")
    keys = torch.empty((rays.shape[0],), dtype=torch.int32, device=rays.device)
    _launch(
        "first_block_keys", rays,
        bbox_t.data_ptr(), bbox_t.shape[1], rays.data_ptr(), rays.shape[0], float(t_eps),
        keys.data_ptr(),
    )
    return keys


# --- ray ordering ---------------------------------------------------------

_SPREAD3 = ((16, 0x030000FF), (8, 0x0300F00F), (4, 0x030C30C3), (2, 0x09249249))


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each int64 to every third bit
    (``_spread3_u32``; the values stay below 2**30, so no mask is lost)."""
    for shift, mask in _SPREAD3:
        v = (v | (v << shift)) & mask
    return v


def coherence_perm(o: torch.Tensor, d: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_coherence_perm``: a stable argsort of
    Morton(origin, 5 bits an axis over the batch's box) << 15 |
    Morton(direction, 5 bits an axis over [-1, 1]), inactive rays last."""
    lo = o.min(dim=0).values
    span = torch.clamp_min(o.max(dim=0).values - lo, 1e-12)
    qo = torch.clamp((o - lo) / span * 31.0, 0.0, 31.0)
    qd = torch.clamp((d * 0.5 + 0.5) * 31.0, 0.0, 31.0)
    s = _spread3(torch.cat([qo, qd], dim=1).to(torch.int64))
    mo = s[:, 0] | (s[:, 1] << 1) | (s[:, 2] << 2)
    md = s[:, 3] | (s[:, 4] << 1) | (s[:, 5] << 2)
    key = torch.where(act > 0.0, (mo << 15) | md, _BIG_ID)
    return torch.argsort(key, stable=True)


def ray_order(rays: torch.Tensor, sort_rays, packet: int, bbox_t=None, t_eps: float = 1e-5):
    """The permutation ``_prep_rays`` sorts the rays of one call by, or None:
    caller order for ``sort_rays`` False or at most ``packet`` rays, else
    Morton (True) or the stable argsort of ``first_block_keys`` ("block",
    which needs the block boxes ``bbox_t``)."""
    if sort_rays not in (False, True, "block"):
        raise ValueError(f"sort_rays={sort_rays!r}: expected False, True or 'block'")
    if sort_rays == "block" and bbox_t is None:
        raise ValueError("sort_rays='block' needs the block boxes (blk only)")
    if not sort_rays or rays.shape[0] <= packet:
        return None
    if sort_rays == "block":
        return torch.argsort(first_block_keys(bbox_t, rays, t_eps), stable=True)
    return coherence_perm(rays[:, 0:3], rays[:, 3:6], rays[:, 6])


def _ordered(kernel, rays: torch.Tensor, perm):
    """kernel(rays) with the rays in ``perm`` order, every output scattered
    back to the caller's order (``_unpack``)."""
    if perm is None:
        return kernel(rays)
    out = []
    for x in kernel(rays[perm]):
        back = torch.empty_like(x)
        back[perm] = x
        out.append(back)
    return tuple(out)


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
def nearest_hit_flat(cbvh, o, d, t_eps: float = 1e-5, active=None, t_max=None,
                     sort_rays=True):
    """Batched nearest hit against every real cluster of ``cbvh``.

    o, d: (R, 3) -> detached (t (R,), idx (R,) int32, hit (R,) bool).
    ``t_max`` (R,) optionally seeds each ray's search window (NEE shadow
    rays); a ray with no hit strictly inside its window reports a miss.
    ``sort_rays`` (True: Morton, as the JAX package; False: caller order)
    orders the rays of a call of more than DEFAULT_PACKET rays.
    """
    tri = cbvh.tri_const[: cbvh.real_clusters]
    rays = prep_rays(o, d, active, t_max)
    out = _ordered(lambda r: flat_intersect(tri, r, t_eps), rays,
                   ray_order(rays, sort_rays, DEFAULT_PACKET))
    return unpack(*out)


@torch.no_grad()
def nearest_hit_queue(cbvh, o, d, t_eps: float = 1e-5, active=None, t_max=None,
                      sort_rays=True):
    """Batched nearest hit through the queue intersector, the counterpart of
    the JAX package's ``nearest_hit_cluster``; arguments and results as
    ``nearest_hit_flat``."""
    if cbvh.clu_bbox_t is None:
        raise ValueError("nearest_hit_queue needs cbvh.clu_bbox_t (build_cluster_bvh)")
    rays = prep_rays(o, d, active, t_max)
    out = _ordered(lambda r: queue_intersect(cbvh.clu_bbox_t, cbvh.tri_const, r, t_eps),
                   rays, ray_order(rays, sort_rays, DEFAULT_PACKET))
    return unpack(*out)


@torch.no_grad()
def nearest_hit_blk(cbvh, o, d, t_eps: float = 1e-5, active=None, t_max=None,
                    stats: bool = False, sort_rays=True):
    """Batched nearest hit through the blocked intersector, the counterpart
    of the JAX package's ``nearest_hit_cluster_blk`` (either ``per_ray``
    mode: they differ only in the TPU schedule). Arguments and results as
    ``nearest_hit_flat``, but sorted above BLK_PACKET rays, and
    ``sort_rays="block"`` orders by ``first_block_keys``. ``stats`` (CUDA only) also returns (R, 2) int32
    block visits and clusters intersected per ray."""
    if cbvh.blk_const is None:
        raise ValueError(
            "nearest_hit_blk needs cbvh.blk_const: prepare_scene builds it for big "
            "scenes, accel.with_blocks for any"
        )
    rays = prep_rays(o, d, active, t_max)
    out = _ordered(
        lambda r: blk_intersect(cbvh.blk_bbox_t, cbvh.blk_const, r, t_eps, stats), rays,
        ray_order(rays, sort_rays, BLK_PACKET, cbvh.blk_bbox_t, t_eps),
    )
    return unpack(out[0], out[1]) + tuple(out[2:])


@torch.no_grad()
def nearest_hit_flat_mxu(cbvh, o, d, t_eps: float = 1e-5, active=None, t_max=None,
                         sort_rays=False):
    """Batched nearest hit through the flat MXU intersector, the counterpart
    of the JAX package's ``nearest_hit_cluster_flat_mxu``: needs
    ``cbvh.mxu_tiles``; rays in the caller's order unless ``sort_rays``.
    Arguments and results as ``nearest_hit_flat``."""
    if cbvh.mxu_tiles is None:
        raise ValueError("nearest_hit_flat_mxu needs cbvh.mxu_tiles (accel.with_mxu_tiles)")
    tiles = cbvh.mxu_tiles[: cbvh.real_clusters]
    rays = prep_rays(o, d, active, t_max)
    out = _ordered(lambda r: flat_mxu_intersect(tiles, r, t_eps), rays,
                   ray_order(rays, sort_rays, DEFAULT_PACKET))
    return unpack(*out)


@torch.no_grad()
def nearest_hit_hbm(cbvh, o, d, t_eps: float = 1e-5, active=None, t_max=None,
                    stats: bool = False, sort_rays=True):
    """Batched nearest hit through the oct intersector, the counterpart of
    the JAX package's ``nearest_hit_cluster_hbm``, over the oct tables of
    ``cbvh`` (``build_cluster_bvh`` builds them; ``accel.with_oct_branch``
    rebuilds them for another branch). Arguments and results as
    ``nearest_hit_blk`` (no block order); ``stats`` counts octs."""
    if cbvh.oct_bbox_t is None:
        raise ValueError("nearest_hit_hbm needs cbvh.oct_bbox_t (build_cluster_bvh)")
    rays = prep_rays(o, d, active, t_max)
    out = _ordered(
        lambda r: hbm_intersect(cbvh.oct_bbox_t, cbvh.tri_const, r, t_eps, cbvh.oct_branch,
                                stats),
        rays, ray_order(rays, sort_rays, DEFAULT_PACKET),
    )
    return unpack(out[0], out[1]) + tuple(out[2:])


@torch.no_grad()
def nearest_hit_blk_mxu(cbvh, o, d, t_eps: float = 1e-5, active=None, t_max=None,
                        stats: bool = False, sort_rays=True):
    """Batched nearest hit through the MXU blocked intersector, the
    counterpart of the JAX package's ``nearest_hit_cluster_blk(mxu=True)``:
    needs ``cbvh.mxu_const`` (``accel.with_mxu_blocks``); sorted by Morton
    above DEFAULT_PACKET rays, as the JAX package calls it. Arguments and
    results as ``nearest_hit_blk`` (no block order)."""
    if cbvh.mxu_const is None:
        raise ValueError("nearest_hit_blk_mxu needs cbvh.mxu_const (accel.with_mxu_blocks)")
    rays = prep_rays(o, d, active, t_max)
    out = _ordered(
        lambda r: blk_mxu_intersect(cbvh.blk_bbox_t, cbvh.mxu_const, r, t_eps, stats),
        rays, ray_order(rays, sort_rays, DEFAULT_PACKET),
    )
    return unpack(out[0], out[1]) + tuple(out[2:])
