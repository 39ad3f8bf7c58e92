"""Nearest hits for the plain reference, from the scene's own vertices.

``brute`` is the exhaustive oracle, a frozen copy of the port's plain
``nearest_hit_brute``: every (ray, triangle) pair tested with the
reference's plane and barycentric arithmetic, ties to the lowest id.
``Culled`` gives the same answers on large scenes: it groups the
triangles by the Morton code of their centroids into boxes of its own,
tests a ray's boxes in the order it enters them and stops once the next
box starts beyond the nearest hit found. Both build everything from the
vertices they are given; neither reads a table of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference.plain import barycentric, cross, dot, normalize

_INF = float("inf")
T_EPS = 1e-5


def _tests(o, d, p1, p2, p3, t_eps):
    """t of each (ray, triangle) pair, inf where the pair misses;
    broadcasting the brute force's arithmetic over leading axes."""
    geo_n = normalize(cross(p2 - p1, p3 - p1))
    ddn = dot(d, geo_n)
    s = (dot(geo_n, p1) - dot(o, geo_n)) / ddn
    point = o + s[..., None] * d
    bary = barycentric(point, p1, p2, p3)
    inside = ((bary >= 0.0) & (bary <= 1.0)).all(dim=-1)
    valid = (ddn != 0.0) & (s >= t_eps) & inside
    return torch.where(valid, s, torch.full_like(s, _INF))


def _better(t, i, best_t, best_i):
    """Nearest first, then the lowest id."""
    return (t < best_t) | ((t == best_t) & (i < best_i))


@torch.no_grad()
def brute(vertices, o, d, active=None, t_max=None, t_eps=T_EPS, chunk=2048):
    """(idx (R,) int32, hit (R,) bool) of the nearest triangle of every
    ray; ``t_max`` is ignored, as the port's oracle ignores it."""
    del t_max
    n = o.shape[0]
    best_t = torch.full((n,), _INF, dtype=o.dtype, device=o.device)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    oc, dc = o[:, None, :], d[:, None, :]
    for base in range(0, vertices.shape[0], chunk):
        tri = vertices[base:base + chunk]
        t = _tests(oc, dc, tri[:, 0], tri[:, 1], tri[:, 2], t_eps)
        local_t, local_i = torch.min(t, dim=-1)
        better = local_t < best_t
        best_i = torch.where(better, base + local_i.to(torch.int32), best_i)
        best_t = torch.where(better, local_t, best_t)
    hit = torch.isfinite(best_t)
    if active is not None:
        hit = hit & active
        best_i = torch.where(active, best_i, torch.full_like(best_i, -1))
    return best_i, hit


def _morton3(q: np.ndarray) -> np.ndarray:
    def spread(v):
        v = v.astype(np.uint64) & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


class Culled:
    """The brute force's answers with box culling. Triangles whose box
    spans more than ``big`` are tested for every ray; the others go, in
    Morton order of their centroids, into boxes of ``width`` triangles.
    A ray tests its boxes in the order it enters them, 8 in its first
    round and twice as many in each round after, until the next box
    starts beyond its nearest hit (or its ``t_max``)."""

    def __init__(self, vertices: torch.Tensor, width: int = 128, big: float = 0.5,
                 rays_per_pass: int = 4096, boxes_per_round: int = 8,
                 pairs_per_test: int = 1 << 23) -> None:
        v = vertices.detach().float().cpu().numpy()
        lo, hi = v.min(axis=1), v.max(axis=1)
        is_big = (hi - lo).max(axis=1) > big
        small = np.nonzero(~is_big)[0]
        cent = v[small].mean(axis=1)
        c_lo = cent.min(axis=0)
        span = np.maximum(cent.max(axis=0) - c_lo, 1e-12)
        q = np.clip((cent - c_lo) / span * 1023.0, 0, 1023).astype(np.uint32)
        small = small[np.argsort(_morton3(q), kind="stable")]
        num_boxes = -(-small.size // width)
        ids = np.full(num_boxes * width, -1, np.int64)
        ids[:small.size] = small
        ids = ids.reshape(num_boxes, width)
        members = np.where(ids >= 0, ids, ids[:, :1])
        b_lo, b_hi = lo[members].min(axis=1), hi[members].max(axis=1)
        pad = 1e-4 * np.maximum(np.abs(b_lo), np.abs(b_hi)) + 1e-5
        device = vertices.device
        self.vertices = vertices
        self.big = torch.as_tensor(np.nonzero(is_big)[0], device=device)
        self.ids = torch.as_tensor(ids, device=device)
        self.box_lo = torch.as_tensor(b_lo - pad, device=device).to(vertices.dtype)
        self.box_hi = torch.as_tensor(b_hi + pad, device=device).to(vertices.dtype)
        self.rays_per_pass = rays_per_pass
        self.boxes_per_round = boxes_per_round
        self.pairs_per_test = pairs_per_test

    def _entries(self, o, d):
        """(R, B) t at which each ray enters each box (0 from inside),
        inf for a box it misses; a NaN slab counts as entered."""
        inv = 1.0 / d
        t1 = (self.box_lo[None] - o[:, None]) * inv[:, None]
        t2 = (self.box_hi[None] - o[:, None]) * inv[:, None]
        near = torch.fmin(t1, t2).nan_to_num(nan=-_INF).amax(dim=-1)
        far = torch.fmax(t1, t2).nan_to_num(nan=_INF).amin(dim=-1)
        enter = torch.clamp_min(near, 0.0)
        return torch.where((near <= far) & (far >= 0.0), enter, torch.full_like(enter, _INF))

    def _test_ids(self, o, d, ids, best_t, best_i):
        """Tests rays (R,) against their (R, M) triangle ids (-1: none)."""
        tri = self.vertices[torch.clamp_min(ids, 0)]
        t = _tests(o[:, None], d[:, None], tri[..., 0, :], tri[..., 1, :], tri[..., 2, :], T_EPS)
        t = torch.where(ids >= 0, t, torch.full_like(t, _INF))
        # nearest, then lowest id: the min of t, then the min id among ties
        local_t = t.min(dim=-1).values
        tied = torch.where(t == local_t[:, None], ids, torch.full_like(ids, 1 << 62))
        local_i = tied.min(dim=-1).values
        better = torch.isfinite(local_t) & _better(local_t, local_i, best_t, best_i)
        return torch.where(better, local_t, best_t), torch.where(better, local_i, best_i)

    @torch.no_grad()
    def __call__(self, o, d, active=None, t_max=None):
        n = o.shape[0]
        device = o.device
        out_i = torch.full((n,), -1, dtype=torch.int64, device=device)
        out_t = torch.full((n,), _INF, dtype=o.dtype, device=device)
        rows = torch.arange(n, device=device)
        if active is not None:
            rows = rows[active]
        for start in range(0, rows.shape[0], self.rays_per_pass):
            r = rows[start:start + self.rays_per_pass]
            ro, rd = o[r], d[r]
            best_t = torch.full((r.shape[0],), _INF, dtype=o.dtype, device=device)
            best_i = torch.full((r.shape[0],), 1 << 62, dtype=torch.int64, device=device)
            if self.big.numel():
                best_t, best_i = self._test_ids(ro, rd, self.big[None].expand(r.shape[0], -1),
                                                best_t, best_i)
            enter = self._entries(ro, rd)
            limit = best_t if t_max is None else torch.minimum(best_t, t_max[r])
            enter, order = torch.sort(enter, dim=1)
            col, k = 0, self.boxes_per_round
            while col < enter.shape[1]:
                # a box entered beyond the nearest hit so far holds no nearer one
                slack = limit * (1.0 + 1e-4) + 1e-4
                open_ = enter[:, col] <= slack
                if not bool(open_.any()):
                    break
                sel = torch.nonzero(open_).squeeze(1)
                k = min(k, enter.shape[1] - col)
                step = max(1, self.pairs_per_test // (k * self.ids.shape[1]))
                for lo in range(0, sel.shape[0], step):
                    s_ = sel[lo:lo + step]
                    ok = enter[s_, col:col + k] <= slack[s_, None]
                    ids = torch.where(ok[..., None], self.ids[order[s_, col:col + k]], -1)
                    t_s, i_s = self._test_ids(ro[s_], rd[s_], ids.reshape(s_.shape[0], -1),
                                              best_t[s_], best_i[s_])
                    best_t = best_t.index_copy(0, s_, t_s)
                    best_i = best_i.index_copy(0, s_, i_s)
                limit = best_t if t_max is None else torch.minimum(best_t, t_max[r])
                # rays still open after k boxes take twice as many next
                col, k = col + k, 2 * k
            out_t[r], out_i[r] = best_t, torch.where(torch.isfinite(best_t), best_i, -1)
        hit = torch.isfinite(out_t)
        return out_i.to(torch.int32), hit
