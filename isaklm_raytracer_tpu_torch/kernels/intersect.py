"""Flat nearest-hit intersector: CUDA kernel wrapper and its plain version.

Port of ``nearest_hit_cluster_flat`` / ``_flat_kernel`` of
``isaklm_raytracer_tpu/kernels/intersect.py``. Every ray is tested against
every triangle of the scene's real clusters (scenes of at most
``FLAT_CLUSTER_LIMIT`` clusters of 128 triangles).

Contract, shared by the kernel (``csrc/flat_intersect.cu``) and the plain
version ``flat_intersect_plain``: rays (R, 8) float32 with columns
[ox oy oz dx dy dz active t_max] and the real cluster tiles (C, 16, 128)
give, per ray, the best t (t_max when nothing beat it) and the winning id
c*128 + lane (2**31 - 1 when nothing won). Ties go to the lowest id.
``nearest_hit_flat`` wraps that into the intersector interface
(t, idx, hit): a hit is an id that WON, not a finite t.

On a CPU tensor ``flat_intersect`` runs the plain version. On a CUDA tensor
it launches the kernel or raises; a failed build raises too. ``COUNTS``
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
_INF = 3.4e38  # unbounded t_max seed and the value of a rejected candidate
_BIG_ID = 2**31 - 1
_SOURCE = "flat_intersect.cu"


class LaunchCounts:
    """Kernel launches and plain-version calls on CUDA tensors."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.flat_kernel = 0
        self.flat_plain_cuda = 0


COUNTS = LaunchCounts()


@functools.cache
def _kernel_fn():
    """The C entry point of the built library (built at first use)."""
    fn = build.load(_SOURCE).flat_intersect
    fn.argtypes = [
        ctypes.c_int,  # device
        ctypes.c_void_p, ctypes.c_int,  # tri, num_clusters
        ctypes.c_void_p, ctypes.c_int,  # rays, num_rays
        ctypes.c_float,  # t_eps
        ctypes.c_void_p, ctypes.c_void_p,  # out_t, out_id
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return fn


def _check(tri: torch.Tensor, rays: torch.Tensor) -> None:
    if tri.dtype != torch.float32 or rays.dtype != torch.float32:
        raise TypeError(f"float32 expected, got tri {tri.dtype}, rays {rays.dtype}")
    if tri.dim() != 3 or tri.shape[1:] != (16, 128) or tri.shape[0] < 1:
        raise ValueError(f"tri must be (C>=1, 16, 128), got {tuple(tri.shape)}")
    if rays.dim() != 2 or rays.shape[1] != 8:
        raise ValueError(f"rays must be (R, 8), got {tuple(rays.shape)}")
    if tri.device != rays.device:
        raise ValueError(f"tri on {tri.device}, rays on {rays.device}")


def flat_intersect_plain(tri: torch.Tensor, rays: torch.Tensor, t_eps: float):
    """Plain PyTorch version of the kernel's contract (any device).

    Mirrors ``_flat_kernel``: a per-lane running (t, id) over the clusters
    in order, then one argmin per ray with ties to the lowest id -- the same
    result as the kernel's walk over ids in order. The products and sums are
    written out in the kernel's order.
    """
    _check(tri, rays)
    if rays.is_cuda:
        COUNTS.flat_plain_cuda += 1
    t_eps = float(np.float32(t_eps))
    num_rays = rays.shape[0]
    ox, oy, oz = rays[:, 0:1], rays[:, 1:2], rays[:, 2:3]
    dx, dy, dz = rays[:, 3:4], rays[:, 4:5], rays[:, 5:6]
    act = rays[:, 6:7] > 0.0
    best_t = rays[:, 7:8].expand(num_rays, 128).clone()
    best_id = torch.full((num_rays, 128), _BIG_ID, dtype=torch.int32, device=rays.device)
    lane = torch.arange(128, dtype=torch.int32, device=rays.device)
    for c in range(tri.shape[0]):
        blk = tri[c]
        nx, ny, nz = blk[0:1], blk[1:2], blk[2:3]
        e1x, e1y, e1z = blk[3:4], blk[4:5], blk[5:6]
        e2x, e2y, e2z = blk[6:7], blk[7:8], blk[8:9]
        np1, p1e1, p1e2 = blk[9:10], blk[10:11], blk[11:12]
        ca, cb, cc = blk[12:13], blk[13:14], blk[14:15]

        ddn = dx * nx + dy * ny + dz * nz  # (R, 128)
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
        tval = torch.where(valid, s, _INF)
        better = tval < best_t
        best_id = torch.where(better, c * 128 + lane, best_id)
        best_t = torch.where(better, tval, best_t)
    tmin = best_t.min(dim=1, keepdim=True).values
    idmin = torch.where(best_t <= tmin, best_id, _BIG_ID).min(dim=1).values
    return tmin[:, 0], idmin


def flat_intersect(tri: torch.Tensor, rays: torch.Tensor, t_eps: float):
    """The kernel on CUDA tensors, the plain version on CPU tensors.

    tri: (C, 16, 128) float32 real cluster tiles; rays: (R, 8) float32.
    Returns (best_t (R,) float32, best_id (R,) int32) as in the contract.
    """
    _check(tri, rays)
    if not rays.is_cuda:
        return flat_intersect_plain(tri, rays, t_eps)
    if not (tri.is_contiguous() and rays.is_contiguous()):
        raise ValueError("flat_intersect: tri and rays must be contiguous")
    num_rays = rays.shape[0]
    out_t = torch.empty((num_rays,), dtype=torch.float32, device=rays.device)
    out_id = torch.empty((num_rays,), dtype=torch.int32, device=rays.device)
    fn = _kernel_fn()
    err = fn(
        rays.device.index if rays.device.index is not None else torch.cuda.current_device(),
        tri.data_ptr(), tri.shape[0],
        rays.data_ptr(), num_rays,
        float(t_eps),
        out_t.data_ptr(), out_id.data_ptr(),
        torch.cuda.current_stream(rays.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flat_intersect kernel launch failed: CUDA error {err}")
    COUNTS.flat_kernel += 1
    return out_t, out_id


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
