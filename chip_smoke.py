#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port once on one NVIDIA card and check it.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 chip_smoke.py

Phases, each printing its own lines, its wall seconds as it ends, and
raising on failure:

1. card: name and power limit as nvidia-smi reports them;
2. build: compiles the four kernels of ``csrc/`` (three intersectors and
   the first-block keys) with nvcc, one process per source, all started
   together, and prints each one's ptxas register and spill lines;
3. kernel flat: the flat intersector against its plain PyTorch version
   (exact) and against the brute-force oracle (the bench.py gate: hit masks
   equal, relative t error <= 1e-3, ids differ only at ties), on random
   rays in the demo scene and in a random triangle soup, with partial
   active masks, NEE-style t_max windows and an all-inactive batch, at 2048
   and 777 rays and (demo) at every ray count the 512x512 main path gives
   the kernel; then both timed at 262,144 rays, in turns;
4. kernel queue: the queue intersector on the 20k hero scene and on a
   triangle soup of about 700 clusters (near the 6 MB table bound), against
   its plain version (exact) and the oracle at 2048 and 777 rays in the
   same four activity cases; then both timed at 262,144 rays, in turns;
5. kernel blk: the blocked intersector on the full 2M-triangle hero scene
   with camera rays of the bench camera, bounce rays that start on the
   surfaces those hit, and NEE rays toward the lights with t_max windows.
   Against its plain version: exact at 2048 and 777 rays; at 65,536 rays of
   each kind, rays that differ (near-ties: a cluster's entry rounded past a
   hit inside it) may be at most 0.001% of the rays, each within
   1e-5 * max(t, 1) of the plain t and inside the oracle gate. Against the
   oracle at 256 rays of each kind (bench.py's count at this scale), with
   the surface origins lifted 1e-3 (see LIFT). Kernel
   and plain timed in turns at the largest ray count at which the plain
   version takes at most PLAIN_BUDGET_S; the kernel alone, with its per-ray
   visit counts, at the 230,400 rays of one 640x360 wavefront;
6. kernel first_blocks: the first-block key kernel on the same hero camera,
   bounce and NEE rays against its plain version (key for key) at 2048,
   777 and the whole wavefront, in the four activity cases; the key's
   leading factor against a numpy slab oracle at 256 rays; kernel and
   plain timed in turns at 230,400 camera rays, the argsort of the keys
   on its own;
7. ordering: the blocked path on each hero wavefront in caller order,
   Morton order and block order, each bit-equal to caller order; the
   kernel alone on the sorted rays, the key + argsort, and the whole call,
   in turns; s/sample of the demo (flat) and hero (blk) in one pass under
   each order; the blocked kernel alone on the rays of every intersector
   call of one hero sample, in caller and Morton order;
8. goldens: cornell_64 and demo_textured_64 (flat) and hero_small_32
   (queue) on the card, against tests/golden/*.npz (the tolerance of
   tests/test_torch_render.py: every value within 1e-4 but at most 8 of
   the image, which stay within 3e-4 -- the goldens carry XLA's fused FMA
   and approximate-rsqrt rounding, and the JAX package's own ops run one
   by one miss them by as much) and against the port on the CPU. The
   hero_small_32 render is the queue kernel's main-path run;
9. main path: the CLI renders the demo at 512x512 with 8 bounces and the
   default Cornell box at 512x512 (the flat kernel's path), then the hero
   scene at 640x360 with 6 bounces (the blocked kernel's path). For each
   path the launch counts are zeroed just before and read just after: its
   kernel must have launched and no plain version may have run on CUDA;
10. perf: seconds per sample and rays/s (pixels x bounces x 2) of full
   steps, demo 512x512x8 and hero 640x360x6, at the CLI's ray_chunk (16384)
   and in one pass (0), in turns, and one torch.profiler sample at each:
   CUDA kernels per sample, summed device kernel time and the
   intersector's share;
11. grad: bench.py's fwd and fwd+bwd (loss = mean(render_sample), leaf =
   the material albedo) through the entry points: demo 512x512x8 and hero
   640x360x6 at ray_chunk 0 and 16384, the hero again in one pass under
   ISAKLM_BLK_SORT=block (the first-block key kernel's main-path run);
   s/sample, rays/s, peak memory, launches per kernel (no plain version
   on CUDA; first_blocks and blk both launch under block ordering), grads
   finite and nonzero; one torch.profiler sample of the hero's forward
   and backward; grad-vs-FD on the card through the flat kernel (Cornell
   albedo, the silhouette-free camera view) with tests/test_estimator.py's
   tolerances, and the card's gradient against the port's on the CPU.

The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}. Exits non-zero, printing no result,
when there is no CUDA card or the port is missing.
"""

from __future__ import annotations

import functools
import json
import os
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "renders")
# Golden tolerance, as tests/test_torch_render.py (see the module docstring)
GOLDEN_ATOL, GOLDEN_OUTLIERS, GOLDEN_MAX = 1e-4, 8, 3e-4
# The bench.py oracle gate holds in full at its own ray counts. Among
# hundreds of thousands of random rays some start within 5e-3 of a surface
# and graze it (|cos| ~ 0.05): there the flat contract's plane equation,
# shared with the TPU kernel, rounds t by a few 1e-6 (the brute oracle's
# normalized form lands nearer the float64 value), which the relative gate
# with its 1e-3 floor on t reads as up to 2e-3. Such a hit must still be on
# the oracle's triangle and within this absolute distance.
BENCH_RAYS = (2048, 777)
NEAR_SURFACE_ATOL = 1e-5
# Bounce and NEE rays of the main path start exactly on a surface. Whether
# such a ray hits its own triangle at t ~ t_eps depends on the last bits of
# the plane equation, which the cluster contract (the TPU kernel's and the
# port's) and the brute oracle's normalized form round differently. The
# oracle gate therefore runs on the same rays with their origins lifted
# LIFT along the surface normal, as the repo's own oracle tests start
# bounce rays 1e-3 off a vertex; the disagreements at exact surface origins
# are counted and printed.
LIFT = 1e-3
# Kernel vs plain where pruning may differ (near-ties): at most this share
# of the rays checked, each within NEAR_TIE_TOL * max(t, 1).
NEAR_TIE_SHARE, NEAR_TIE_TOL = 1e-5, 1e-5
HERO_W, HERO_H, HERO_BOUNCES = 640, 360, 6
PLAIN_BUDGET_S = 3.0  # "a few seconds" for one plain call of the blk timing
_BIG_ID = 2**31 - 1
# Card vs CPU gradients of one render: the CUDA backward of the material
# gathers adds with atomics in an order of its own, and sin/cos/exp round
# their last bit differently from the CPU's, so the two agree to float32
# accumulation error, not bit for bit.
CARD_VS_CPU_RTOL, CARD_VS_CPU_ATOL = 1e-4, 1e-6
# The least time the card could take (bound_ms): published H100 SXM peaks,
# float32 outside the tensor cores and HBM3. Operation counts per unit of
# work, read off the kernels' code: tri_hit of intersect_common.cuh (30
# products and sums of six dot products, a subtraction and a division, 14
# more for the barycentrics, 8 comparisons, the select and accept's
# compare), the slab test (6 subtractions, 6 products, 10 min/max, 2
# comparisons, the clamp at 0) and the first-block key's slab test plus its
# 2 comparisons against the running pair.
F32_OPS_PER_S, HBM_BYTES_PER_S = 67e12, 3.35e12
TRI_HIT_OPS, SLAB_OPS, KEY_OPS = 56, 25, 27
TILE_BYTES = 16 * 128 * 4


CARD = ""  # nvidia-smi's "name, power.limit" of the card, once read


def log(msg: str, name_card: bool = True) -> None:
    """Print a line; once the card is known, every line names it (the
    JSON result lines pass name_card=False)."""
    if name_card and CARD and CARD not in msg:
        msg = f"{msg} [{CARD}]"
    print(msg, flush=True)


class Phase:
    """Prints the wall seconds of a phase as it ends."""

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"phase {self.name}: {time.perf_counter() - self.t0:.1f} s wall")
        return False


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 2):
    """Mean milliseconds of fn() on the card, after ``warmup`` calls, and the
    result of the last call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def bound(ops: float, nbytes: float) -> dict:
    """bound_ms = max(ops / peak fp32 rate, bytes / HBM rate), and which."""
    t_ops, t_bytes = ops / F32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def main_path_shapes(num_pixels: int, floor: int, ray_chunks) -> list:
    """Every ray count the render hands the intersector: each bucket of the
    ceil-halving ladder {num_pixels, ..., floor}, cut into ``ray_chunk``
    passes (0 = one pass), remainders included."""
    from isaklm_raytracer_tpu_torch.integrator.render import compact_bucket

    buckets, n = set(), num_pixels
    while True:
        buckets.add(compact_bucket(n, num_pixels, floor))
        if n <= 1:
            break
        n = -(-n // 2)
    shapes = set()
    for bucket in buckets:
        for chunk in ray_chunks:
            step = chunk or bucket
            shapes.update(min(step, bucket - s) for s in range(0, bucket, step))
    return sorted(shapes)


def random_rays(rng, n, lo, hi, device):
    o = (rng.random((n, 3)) * (hi - lo) + lo).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.tensor(o, device=device), torch.tensor(d, device=device)


def brute(o, d, vertices, rays_per_call: int = 256):
    """nearest_hit_brute in slices of rays, so a 2M-triangle scene keeps
    its (rays, triangles) temporaries small."""
    from isaklm_raytracer_tpu_torch.accel import nearest_hit_brute

    parts = [nearest_hit_brute(o[s:s + rays_per_call], d[s:s + rays_per_call], vertices)
             for s in range(0, o.shape[0], rays_per_call)]
    return tuple(torch.cat(p) for p in zip(*parts))


def oracle_gate(label, t_k, i_k, h_k, oracle, act, t_max, bench_gate) -> int:
    """The bench.py gate against the brute oracle (hit masks equal,
    relative t error <= 1e-3 with a 1e-3 floor on t, ids differ only at
    ties). Beyond the bench's ray counts a hit over the relative gate passes
    only on the oracle's own triangle within NEAR_SURFACE_ATOL. Returns the
    hits."""
    t_b, i_b, h_b = oracle
    want = h_b.clone()
    if act is not None:
        want &= act
    if t_max is not None:
        want &= t_b < t_max
    hit_mism = int((h_k != want).sum())
    both = h_k & want
    dt = torch.where(both, (t_k - t_b).abs(), 0.0)
    rel_all = dt / t_b.clamp_min(1e-3)
    id_mism = int((i_k != i_b)[both].sum())
    over = rel_all > 1e-3
    excused = over & (i_k == i_b) & (dt <= NEAR_SURFACE_ATOL)
    log(f"{label}: hits={int(h_k.sum())} hit mismatches={hit_mism} "
        f"max rel dt={float(rel_all.max()):.2e} id mismatches={id_mism}"
        + (f" near-surface hits over the rel gate={int(over.sum())} "
           f"(max dt {float(dt[over].max()):.2e})" if over.any() else ""))
    bad = (h_k != want) | (over if bench_gate else over & ~excused)
    if bad.any():
        for r in torch.nonzero(bad).flatten()[:8].tolist():
            log(f"  ray {r}: kernel t={float(t_k[r]):.9g} id={int(i_k[r])} hit={bool(h_k[r])}; "
                f"oracle t={float(t_b[r]):.9g} id={int(i_b[r])} hit={bool(want[r])}")
        raise RuntimeError(f"{label}: fails the oracle gate")
    return int(h_k.sum())


def origin_disagreements(t_k, i_k, h_k, oracle, t_max) -> list:
    """Rays on which the kernel and the oracle disagree (hit mask or id),
    as (kernel t, oracle t) pairs: counted, not gated, for rays whose
    origin lies exactly on a surface (see LIFT)."""
    t_b, i_b, h_b = oracle
    want = h_b if t_max is None else h_b & (t_b < t_max)
    differ = (h_k != want) | ((i_k != i_b) & h_k & want)
    return [(float(t_k[r]), float(t_b[r])) for r in torch.nonzero(differ).flatten().tolist()]


def exact(label, kernel_out, plain_out) -> float:
    """Kernel == plain version bit for bit, every output ((t, id) of an
    intersector, (keys,) of first_block_keys); returns max |first output's
    difference|."""
    kernel_out, plain_out = kernel_out[:2], plain_out[:2]
    if not all(torch.equal(k, p) for k, p in zip(kernel_out, plain_out)):
        raise RuntimeError(f"{label}: kernel != plain version")
    k, p = kernel_out[0], plain_out[0]
    return float((k.double() - p.double()).abs().max()) if k.numel() else 0.0


ACTIVITY_CASES = ("all active", "partial active", "partial + t_max", "none active")


def activity(rng, n, device):
    partial = torch.tensor(rng.random(n) > 0.3, device=device)
    window = torch.tensor(rng.random(n).astype(np.float32) * 4.0, device=device)
    none = torch.zeros(n, dtype=torch.bool, device=device)
    return dict(zip(ACTIVITY_CASES, (
        (None, None), (partial, None), (partial, window), (none, None),
    )))


def check_kernel(name, kernel, plain, tables, scene, rng, device, sizes,
                 strict=BENCH_RAYS) -> float:
    """Kernel vs plain (exact) and vs brute (bench.py gate) on one scene, at
    each ray count of ``sizes``, in the four activity cases; the gate is
    strict at the counts of ``strict``. Returns the largest
    |t_kernel - t_plain|."""
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki

    verts = scene.vertices.reshape(-1, 3).cpu().numpy()
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    worst = 0.0
    for n in sizes:
        o, d = random_rays(rng, n, lo, hi, device)
        oracle = brute(o, d, scene.vertices, rays_per_call=n)
        for case, (act, t_max) in activity(rng, n, device).items():
            rays = ki.prep_rays(o, d, act, t_max)
            kout = kernel(*tables, rays, 1e-5)
            pout = plain(*tables, rays, 1e-5)
            torch.cuda.synchronize()
            worst = max(worst, exact(f"{name} {n} {case}", kout, pout))
            t_k, i_k, h_k = ki.unpack(*kout)
            oracle_gate(f"kernel {name} rays={n} {case}", t_k, i_k, h_k, oracle, act,
                        t_max, n in strict)
            if case == "none active" and (h_k.any() or (i_k != -1).any()):
                raise RuntimeError("all-inactive batch reported hits")
    return worst


def time_in_turns(label, kernel_fn, plain_fn, plain_reps=5, plain_warmup=2):
    """plain, kernel, kernel, plain within one call; outputs must be equal.
    Returns (mean kernel ms, mean plain ms, kernel output)."""
    p1, plain_out = cuda_ms(plain_fn, reps=plain_reps, warmup=plain_warmup)
    k1, kernel_out = cuda_ms(kernel_fn)
    k2, _ = cuda_ms(kernel_fn)
    p2, _ = cuda_ms(plain_fn, reps=plain_reps, warmup=plain_warmup)
    exact(f"timed {label}", kernel_out, plain_out)
    log(f"time {label}: kernel {k1:.4f}/{k2:.4f} ms, plain {p1:.3f}/{p2:.3f} ms, "
        f"outputs equal")
    return (k1 + k2) / 2, (p1 + p2) / 2, kernel_out


def hero_ray_sets(scene, rng, device):
    """Rays of the hero's main path: camera rays of the bench camera at
    640x360, bounce rays from the surfaces they hit (origin on the surface,
    as path_trace makes them) into the normal's hemisphere, and NEE rays
    from there toward a random point of a random light triangle with the
    window nee.sample_direct_light gives them. Returns those, and the same
    rays with the surface origins lifted LIFT along the normal."""
    from isaklm_raytracer_tpu_torch.accel import hit_attributes
    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.camera.camera import generate_rays
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki

    n = HERO_W * HERO_H
    camera = Camera.create((0.0, 1.2, -1.8), pitch=0.15, fov=np.pi / 2, device=device)
    ids = torch.arange(n, device=device)
    cam_u = torch.tensor(rng.random((n, 4)), dtype=torch.float32, device=device)
    o_cam, d_cam = generate_rays(camera, HERO_W, HERO_H, ids % HERO_W, ids // HERO_W, cam_u)

    t, idx, hit = ki.nearest_hit_blk(scene.cbvh, o_cam, d_cam)
    attrs = hit_attributes(scene, o_cam, d_cam, idx, hit)
    pos, nrm = attrs.position[hit], attrs.normal[hit]
    m = pos.shape[0]
    rand = torch.tensor(rng.standard_normal((m, 3)), dtype=torch.float32, device=device)
    rand = rand / rand.norm(dim=1, keepdim=True)
    d_bounce = torch.where((rand * nrm).sum(dim=1, keepdim=True) < 0, -rand, rand)

    lights = scene.light_indices[torch.tensor(
        rng.integers(0, scene.num_lights, m), device=device)].long()
    tri = scene.vertices[lights]
    u = torch.tensor(rng.random((m, 2)), dtype=torch.float32, device=device)
    su = torch.sqrt(u[:, 0:1])
    point = (1.0 - su) * tri[:, 0] + u[:, 1:2] * su * tri[:, 1] + (
        1.0 - (1.0 - su) - u[:, 1:2] * su) * tri[:, 2]
    def nee(origin):
        to_light = point - origin
        dist = to_light.norm(dim=1)
        return origin, to_light / dist[:, None], dist * 1.001 + 1e-3

    lifted = pos + LIFT * nrm
    on_surface = {
        "camera": (o_cam, d_cam, None),
        "bounce": (pos, d_bounce, None),
        "nee": nee(pos),
    }
    return on_surface, {
        "camera": on_surface["camera"],
        "bounce": (lifted, d_bounce, None),
        "nee": nee(lifted),
    }


def check_blk_hero(scene, rng, device):
    """Phase 5. Returns (worst |dt|, ms, plain_ms, ray count timed,
    {kind: kernel ms at the wavefront}, the bound of the timed call, the
    hero ray sets)."""
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki

    cbvh = scene.cbvh
    tables = (cbvh.blk_bbox_t, cbvh.blk_const)
    sets, lifted = hero_ray_sets(scene, rng, device)
    worst, checked, near_ties = 0.0, 0, []
    for kind, (o, d, t_max) in sets.items():
        for n in BENCH_RAYS:
            rays = ki.prep_rays(o[:n], d[:n], None, None if t_max is None else t_max[:n])
            worst = max(worst, exact(f"blk hero {kind} {n}",
                                     ki.blk_intersect(*tables, rays, 1e-5),
                                     ki.blk_intersect_plain(*tables, rays, 1e-5)))
        n = min(65536, o.shape[0])
        rays = ki.prep_rays(o[:n], d[:n], None, None if t_max is None else t_max[:n])
        kt, kid = ki.blk_intersect(*tables, rays, 1e-5)
        pt, pid = ki.blk_intersect_plain(*tables, rays, 1e-5)
        torch.cuda.synchronize()
        differ = torch.nonzero((kt != pt) | (kid != pid)).flatten()
        checked += n
        if differ.numel():
            dt = (kt[differ] - pt[differ]).abs()
            if (dt > NEAR_TIE_TOL * torch.clamp_min(pt[differ], 1.0)).any():
                raise RuntimeError(f"blk hero {kind}: a near-tie beyond {NEAR_TIE_TOL}")
            worst = max(worst, float(dt.max()))
            sub = (o[:n][differ], d[:n][differ], None if t_max is None else t_max[:n][differ])
            t_k, i_k, h_k = ki.unpack(kt[differ], kid[differ])
            oracle_gate(f"blk hero {kind} near-ties", t_k, i_k, h_k,
                        brute(sub[0], sub[1], scene.vertices), None, sub[2], False)
            near_ties.append((kind, int(differ.numel()), float(dt.max())))
        log(f"kernel blk hero {kind}: {n} rays vs plain, {int((kid != _BIG_ID).sum())} hits, "
            f"{int(differ.numel())} near-ties")
        # the oracle at bench.py's hero count: the gate on lifted origins,
        # the disagreements at exact surface origins counted
        m = 256
        variants = [("", sets[kind])] + ([(" lifted", lifted[kind])] if kind != "camera" else [])
        for label, (o_s, d_s, tm) in variants:
            o_s, d_s = o_s[:m], d_s[:m]
            tm = None if tm is None else tm[:m]
            t_k, i_k, h_k = ki.nearest_hit_blk(cbvh, o_s, d_s, t_max=tm)
            oracle = brute(o_s, d_s, scene.vertices)
            if label or kind == "camera":
                oracle_gate(f"kernel blk hero {kind}{label} rays={m}", t_k, i_k, h_k,
                            oracle, None, tm, True)
            else:
                pairs = origin_disagreements(t_k, i_k, h_k, oracle, tm)
                log(f"kernel blk hero {kind} rays={m}, origins exactly on a surface: "
                    f"{len(pairs)} disagree with the oracle (kernel t, oracle t): {pairs}")
    allowed = int(NEAR_TIE_SHARE * checked)
    total = sum(c for _, c, _ in near_ties)
    log(f"kernel blk hero: {checked} rays vs plain, near-ties {total} "
        f"(allowed {allowed}: {NEAR_TIE_SHARE:.3%}) {near_ties}")
    if total > allowed:
        raise RuntimeError("blk hero: more near-ties than allowed")

    # timing: kernel and plain in turns at the largest camera-ray count at
    # which one plain call takes at most PLAIN_BUDGET_S
    o, d, _ = sets["camera"]
    count = 4096
    ki.blk_intersect_plain(*tables, ki.prep_rays(o[:count], d[:count]), 1e-5)
    for n in (4096, 16384, 65536, HERO_W * HERO_H):
        rays = ki.prep_rays(o[:n], d[:n])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ki.blk_intersect_plain(*tables, rays, 1e-5)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        log(f"blk plain, {n} camera rays: {seconds:.2f} s")
        if seconds > PLAIN_BUDGET_S:
            break
        count = n
    rays = ki.prep_rays(o[:count], d[:count])
    ms, plain_ms, kout = time_in_turns(
        f"blk_intersect hero {count} camera rays x {cbvh.blk_const.shape[0]} blocks",
        lambda: ki.blk_intersect(*tables, rays, 1e-5),
        lambda: ki.blk_intersect_plain(*tables, rays, 1e-5),
        plain_reps=2, plain_warmup=1,
    )
    # the bound of that call: the clusters the kernel intersected and the
    # cluster boxes of the blocks it visited (its per-ray counts), one slab
    # test per ray and valid block; the rays, results, block boxes and the
    # tiles and block headers of the winning triangles
    stats = ki.blk_intersect(*tables, rays, 1e-5, stats=True)[2].long()
    branch = cbvh.blk_const.shape[1] - 1
    valid = int((cbvh.blk_bbox_t[6] > 0).sum())
    won = kout[1][kout[1] != _BIG_ID].long() // 128
    blk_bound = bound(
        int(stats[:, 1].sum()) * 128 * TRI_HIT_OPS + int(stats[:, 0].sum()) * branch * SLAB_OPS
        + count * valid * SLAB_OPS,
        count * 40 + cbvh.blk_bbox_t.numel() * 4
        + (torch.unique(won).numel() + torch.unique(won // branch).numel()) * TILE_BYTES,
    )
    wavefront = {}
    for kind, (o, d, t_max) in sets.items():
        rays = ki.prep_rays(o, d, None, t_max)
        k_ms, (_, _, stats) = cuda_ms(lambda: ki.blk_intersect(*tables, rays, 1e-5, stats=True))
        wavefront[kind] = k_ms
        log(f"time blk_intersect hero {kind} rays, kernel alone, {rays.shape[0]} rays: "
            f"{k_ms:.3f} ms; per ray: mean block visits {float(stats[:, 0].float().mean()):.3f}, "
            f"mean clusters intersected {float(stats[:, 1].float().mean()):.3f}")
    return worst, ms, plain_ms, count, wavefront, blk_bound, sets


def slab_oracle_first(bbox_t, o, d):
    """The block a numpy slab test says each ray enters first, and whether
    it pierces any (tests/test_cluster_kernel.py's oracle)."""
    bb, o, d = bbox_t.cpu().numpy(), o.cpu().numpy(), d.cpu().numpy()
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        inv = 1.0 / d
        t1 = (bb[0:3].T[None] - o[:, None]) * inv[:, None]
        t2 = (bb[3:6].T[None] - o[:, None]) * inv[:, None]
    near = np.minimum(t1, t2).max(axis=2)
    far = np.maximum(t1, t2).min(axis=2)
    pierce = (near <= far) & (far >= 1e-5) & (bb[6] > 0)[None]
    return np.where(pierce, np.maximum(near, 0.0), np.inf).argmin(axis=1), pierce.any(axis=1)


def check_first_blocks(scene, sets, rng, device):
    """Phase kernel first_blocks. Returns (worst, ms, plain_ms, argsort_ms,
    bound of the timed call)."""
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki

    bbox_t = scene.cbvh.blk_bbox_t
    n = bbox_t.shape[1]

    def keys(fn, rays):
        return (fn(bbox_t, rays, 1e-5),)

    for kind, (o, d, _) in sets.items():
        for count in sorted({min(c, o.shape[0]) for c in (*BENCH_RAYS, o.shape[0])}):
            for case, (act, t_max) in activity(rng, count, device).items():
                rays = ki.prep_rays(o[:count], d[:count], act, t_max)
                exact(f"first_blocks hero {kind} {count} {case}",
                      keys(ki.first_block_keys, rays), keys(ki.first_block_keys_plain, rays))
        log(f"kernel first_blocks hero {kind}: keys == plain at {BENCH_RAYS} and "
            f"{o.shape[0]} rays in the cases {ACTIVITY_CASES}")
        m = 256
        lead = ki.first_block_keys(bbox_t, ki.prep_rays(o[:m], d[:m]), 1e-5).cpu().numpy()
        first, pierced = slab_oracle_first(bbox_t, o[:m], d[:m])
        bad = int((lead[pierced] // (8 * (n + 1)) != first[pierced]).sum()
                  + (lead[~pierced] != _BIG_ID - 1).sum())
        log(f"kernel first_blocks hero {kind} rays={m}: {int(pierced.sum())} pierce a block; "
            f"leading factor vs the numpy slab oracle: {bad} disagree")
        if bad:
            raise RuntimeError(f"first_blocks hero {kind}: the key does not lead with the "
                               "block entered first")

    o, d, _ = sets["camera"]
    rays = ki.prep_rays(o, d)
    ms, plain_ms, (k,) = time_in_turns(
        f"first_block_keys hero {rays.shape[0]} camera rays x {n} block columns",
        lambda: keys(ki.first_block_keys, rays), lambda: keys(ki.first_block_keys_plain, rays),
    )
    argsort_ms, _ = cuda_ms(lambda: torch.argsort(k, stable=True))
    log(f"time argsort(stable) of {k.numel()} first-block keys: {argsort_ms:.4f} ms")
    valid = int((bbox_t[6] > 0).sum())
    b = bound(rays.shape[0] * valid * KEY_OPS, rays.shape[0] * (32 + 4) + bbox_t.numel() * 4)
    return 0.0, ms, plain_ms, argsort_ms, b


ORDERINGS = (False, True, "block")


def order_name(mode) -> str:
    return {False: "caller", True: "morton", "block": "block"}[mode]


def check_ordering(scene, sets, card):
    """Phase ordering: the blk path on each hero wavefront in caller order,
    Morton and block order; results equal to caller order bit for bit; the
    kernel alone on the sorted rays and the whole call, in turns. Returns
    {(kind, order): [(kernel ms, key+argsort ms, whole call ms), ...]}."""
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki

    cbvh = scene.cbvh
    tables = (cbvh.blk_bbox_t, cbvh.blk_const)
    times = {}
    for kind, (o, d, t_max) in sets.items():
        want = ki.nearest_hit_blk(cbvh, o, d, t_max=t_max, sort_rays=False)
        for mode in ORDERINGS[1:]:
            got = ki.nearest_hit_blk(cbvh, o, d, t_max=t_max, sort_rays=mode)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"ordering {order_name(mode)} changed the {kind} hits")
        rays = ki.prep_rays(o, d, None, t_max)
        for mode in ORDERINGS + ORDERINGS[::-1]:
            perm = ki.ray_order(rays, mode, ki.BLK_PACKET, cbvh.blk_bbox_t)
            in_order = rays if perm is None else rays[perm].contiguous()
            k_ms, _ = cuda_ms(lambda: ki.blk_intersect(*tables, in_order, 1e-5), reps=5, warmup=1)
            o_ms, _ = cuda_ms(lambda: ki.ray_order(rays, mode, ki.BLK_PACKET, cbvh.blk_bbox_t),
                              reps=5, warmup=1)
            w_ms, _ = cuda_ms(lambda: ki.nearest_hit_blk(cbvh, o, d, t_max=t_max, sort_rays=mode),
                              reps=5, warmup=1)
            times.setdefault((kind, mode), []).append((k_ms, o_ms, w_ms))
        for mode in ORDERINGS:
            runs = times[(kind, mode)]
            log(f"ordering hero {kind} {rays.shape[0]} rays, {order_name(mode)}: blk kernel "
                f"{runs[0][0]:.3f}/{runs[1][0]:.3f} ms; key + argsort {runs[0][1]:.3f}/"
                f"{runs[1][1]:.3f} ms; whole call {runs[0][2]:.3f}/{runs[1][2]:.3f} ms, of which "
                f"outside the kernel {runs[0][2] - runs[0][0]:.3f}/{runs[1][2] - runs[1][0]:.3f} ms; "
                f"(t, idx, hit) == caller order; on {card}")
    return times


def render_calls_by_order(scene, camera, config, card):
    """The blocked kernel alone on the rays of each intersector call of one
    hero sample (extension and NEE rays of every bounce, as the render
    makes them), in caller and Morton order, in turns."""
    from isaklm_raytracer_tpu_torch.integrator.render import render_sample
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki
    from isaklm_raytracer_tpu_torch.math import rng as prng

    cbvh = scene.cbvh
    calls = []

    def trace(o, d, active=None, t_max=None):
        calls.append(ki.prep_rays(o, d, active, t_max))
        return ki.nearest_hit_blk(cbvh, o, d, config.t_epsilon, active, t_max, sort_rays=False)

    with torch.no_grad():
        render_sample(scene, camera, prng.sample_key_words(0, 0), config, trace_fn=trace)
    totals = {}
    for i, rays in enumerate(calls):
        kind = f"bounce {i // 2} {'NEE' if i % 2 else 'extension'}"
        times = {}
        for mode in (False, True, True, False):
            perm = ki.ray_order(rays, mode, ki.BLK_PACKET)
            in_order = rays if perm is None else rays[perm].contiguous()
            ms, _ = cuda_ms(lambda: ki.blk_intersect(cbvh.blk_bbox_t, cbvh.blk_const, in_order,
                                                     config.t_epsilon), reps=5, warmup=1)
            times.setdefault(mode, []).append(ms)
            totals[mode] = totals.get(mode, 0.0) + ms / 2
        log(f"ordering hero render call {i} ({kind}, {int((rays[:, 6] > 0).sum())} of "
            f"{rays.shape[0]} rays active): blk kernel caller {times[False][0]:.3f}/"
            f"{times[False][1]:.3f} ms, morton {times[True][0]:.3f}/{times[True][1]:.3f} ms")
    log(f"ordering hero render, blk kernel summed over the {len(calls)} calls of a sample: "
        f"caller {totals[False]:.2f} ms, morton {totals[True]:.2f} ms on {card}")


def ordered_step_seconds(scene, camera, config, trace, samples: int = 2) -> float:
    """Seconds of one render_sample (a full step's radiance) with ``trace``,
    after one warm-up sample."""
    from isaklm_raytracer_tpu_torch.integrator.render import render_sample
    from isaklm_raytracer_tpu_torch.math import rng as prng

    with torch.no_grad():
        render_sample(scene, camera, prng.sample_key_words(0, 0), config, trace_fn=trace)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(samples):
            out = render_sample(scene, camera, prng.sample_key_words(0, 1 + i), config,
                                trace_fn=trace)
        torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError("non-finite radiance in the timed render")
    return (time.perf_counter() - t0) / samples


def fwd_and_fwd_bwd(label, scene, camera, config, counts, card):
    """bench.py's fwd and fwd+bwd (loss = mean(render_sample), leaf = the
    material albedo): s/sample of each, two timed samples after a warm-up,
    rays/s by the bench's count, the peak device memory of fwd+bwd, and the
    launches of each kernel in the fwd+bwd samples. Returns those."""
    from isaklm_raytracer_tpu_torch.integrator.render import render_sample
    from isaklm_raytracer_tpu_torch.math import rng as prng

    albedo = scene.materials.albedo

    def fwd(i):
        with torch.no_grad():
            return render_sample(scene, camera, prng.sample_key_words(0, i), config).mean()

    def fwd_bwd(i):
        leaf = albedo.detach().clone().requires_grad_(True)
        s = scene.replace(materials=scene.materials.replace(albedo=leaf))
        loss = render_sample(s, camera, prng.sample_key_words(0, i), config).mean()
        return torch.autograd.grad(loss, leaf)[0]

    fwd_bwd(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in (1, 2):
        fwd(i)
    torch.cuda.synchronize()
    fwd_s = (time.perf_counter() - t0) / 2
    counts.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    grads = [fwd_bwd(i) for i in (1, 2)]
    torch.cuda.synchronize()
    bwd_s = (time.perf_counter() - t0) / 2
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {k: getattr(counts, f"{k}_kernel") for k in counts.KERNELS}
    plain = counts.plain_cuda()
    rays = config.num_pixels * config.max_bounces * 2
    log(f"grad {label} {config.width}x{config.height}x{config.max_bounces} ray_chunk "
        f"{config.ray_chunk}: fwd {fwd_s:.4f} s/sample ({rays / fwd_s / 1e6:.3f} M rays/s), "
        f"fwd+bwd {bwd_s:.4f} s/sample ({rays / bwd_s / 1e6:.3f} M rays/s), ratio "
        f"{bwd_s / fwd_s:.2f}; peak memory {peak:.2f} GiB; launches in 2 fwd+bwd samples "
        f"{launches}, plain calls on CUDA {plain}; on {card}")
    for g in grads:
        if not torch.isfinite(g).all() or not g.abs().max() > 0:
            raise RuntimeError(f"grad {label}: the albedo gradient is not finite and nonzero")
    if plain:
        raise RuntimeError(f"grad {label}: a plain version ran on CUDA")
    return {"fwd_s": fwd_s, "fwd_bwd_s": bwd_s, "peak_gib": peak, "launches": launches}


def profile_fwd_bwd(scene, camera, config, card):
    """torch.profiler over the forward (with autograd recording) and, apart,
    the backward of one hero sample: device time of each, the blocked
    kernel's share of the forward, the backward's top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from isaklm_raytracer_tpu_torch.integrator.render import render_sample
    from isaklm_raytracer_tpu_torch.math import rng as prng

    def device_us(prof):
        per = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
        if not per:
            raise RuntimeError("the profiler recorded no CUDA kernel")
        return per

    leaf = scene.materials.albedo.detach().clone().requires_grad_(True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as pf:
        s = scene.replace(materials=scene.materials.replace(albedo=leaf))
        loss = render_sample(s, camera, prng.sample_key_words(0, 9), config).mean()
        torch.cuda.synchronize()
    with profile(activities=acts) as pb:
        torch.autograd.grad(loss, leaf)
        torch.cuda.synchronize()
    f, b = device_us(pf), device_us(pb)
    f_us, b_us = sum(f.values()), sum(b.values())
    blk_us = sum(v for k, v in f.items() if "blk_intersect" in k)
    keys_us = sum(v for k, v in f.items() if "first_block_keys" in k)
    top = sorted(b.items(), key=lambda kv: -kv[1])[:6]
    log(f"profile hero fwd+bwd ray_chunk {config.ray_chunk}: fwd device time {f_us / 1e3:.2f} ms "
        f"(blk_intersect {blk_us / 1e3:.2f} ms = {blk_us / f_us:.1%}, first_block_keys "
        f"{keys_us / 1e3:.2f} ms), bwd device time {b_us / 1e3:.2f} ms; blk_intersect "
        f"{blk_us / (f_us + b_us):.1%} of fwd+bwd device time; on {card}")
    for name, us in top:
        log(f"  bwd top kernel {us / 1e3:.3f} ms ({us / b_us:.1%}): {name[:110]}")


def floor_view():
    """TestGradVsFDCamera's scene (tests/test_estimator.py): one large
    diffuse floor lit by a panel outside every camera ray's frustum."""
    from isaklm_raytracer_tpu_torch.scene.procedural import SceneBuilder

    b = SceneBuilder()
    light = b.add_material(albedo=(0.0, 0.0, 0.0), emittance=(6.0, 6.0, 6.0), ior=1.0)
    floor = b.add_material(albedo=(0.6, 0.5, 0.4), roughness=0.7, ior=1.0)
    s = 60.0
    b.add_quad((-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s), floor)
    b.add_quad((-2, 6, -9), (2, 6, -9), (2, 6, -5), (-2, 6, -5), light)
    return b.build()


def grad_checks_on_card(device, counts):
    """Grad-vs-FD on the card through the kernels (TestGradVsFD's Cornell
    albedo, TestGradVsFDCamera's pose, with their tolerances), then the
    card's autodiff gradient against the port's on the CPU."""
    from isaklm_raytracer_tpu_torch.accel import prepare_scene
    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.diff import check_grad_vs_fd
    from isaklm_raytracer_tpu_torch.integrator.render import render_sample
    from isaklm_raytracer_tpu_torch.scene import procedural

    kw = (0, 11)  # the JAX package's PRNGKey(11)
    no_rr = RenderConfig(width=16, height=16, max_bounces=4, rr_start_bounce=4)

    def cornell_loss(scene, camera):
        def loss(albedo):
            s = scene.replace(materials=scene.materials.replace(albedo=albedo))
            return render_sample(s, camera, kw, no_rr).mean()
        return loss

    cornell = procedural.cornell_box(include_blockers=False)
    scene = prepare_scene(cornell, device)
    camera = Camera.create((0.0, 0.0, -0.9), fov=np.pi / 2, device=device)
    counts.reset()
    auto, fd = check_grad_vs_fd(cornell_loss(scene, camera), scene.materials.albedo,
                                h=2e-3, rtol=0.05, atol=2e-4)
    log(f"grad vs FD on the card, Cornell albedo {auto.shape}: max |auto - fd| "
        f"{np.abs(auto - fd).max():.3e} (rtol 0.05, atol 2e-4); flat launches "
        f"{counts.flat_kernel}, plain calls on CUDA {counts.plain_cuda()}")
    if counts.flat_kernel == 0 or counts.plain_cuda():
        raise RuntimeError("grad vs FD did not go through the flat kernel alone")

    floor = prepare_scene(floor_view(), device)
    config = RenderConfig(width=12, height=12, max_bounces=1, rr_start_bounce=1,
                          lobe_ratio_grad=False)
    cam = Camera.create((0.0, 3.0, 0.0), yaw=0.0, pitch=0.9, fov=0.9, device=device)
    fkw = (0, 23)
    for label, leaf, make in (
        ("position", cam.position, lambda x: cam.replace(position=x)),
        ("yaw/pitch", torch.stack([cam.yaw, cam.pitch]),
         lambda x: cam.replace(yaw=x[0], pitch=x[1])),
    ):
        auto, fd = check_grad_vs_fd(
            lambda x: render_sample(floor, make(x), fkw, config).mean(), leaf,
            h=1e-3, rtol=0.05, atol=5e-4)
        log(f"grad vs FD on the card, floor camera {label}: auto {np.round(auto, 5).tolist()} "
            f"fd {np.round(fd, 5).tolist()} (rtol 0.05, atol 5e-4)")
        if not np.abs(auto).max() > 0:
            raise RuntimeError(f"camera {label} gradient is zero")

    cpu_scene = prepare_scene(cornell, "cpu")
    grads = []
    for s, c in ((scene, camera), (cpu_scene, camera.to("cpu"))):
        leaf = s.materials.albedo.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(cornell_loss(s, c)(leaf), leaf)[0].cpu())
    diff = (grads[0] - grads[1]).abs()
    log(f"grad card vs CPU, Cornell albedo: max |diff| {float(diff.max()):.3e}, max rel "
        f"{float((diff / grads[1].abs().clamp_min(1e-12)).max()):.3e} (rtol "
        f"{CARD_VS_CPU_RTOL:g}, atol {CARD_VS_CPU_ATOL:g})")
    torch.testing.assert_close(grads[0], grads[1], rtol=CARD_VS_CPU_RTOL, atol=CARD_VS_CPU_ATOL)


def sample_seconds(render, scene, camera, config, counts, samples: int = 2):
    """Wall seconds per full step after one warm-up step, and the
    intersector kernels' launches per step."""
    gb = render(scene, camera, config, num_samples=1, seed=0)
    torch.cuda.synchronize()
    before = counts.flat_kernel + counts.queue_kernel + counts.blk_kernel
    t0 = time.perf_counter()
    gb = render(scene, camera, config, num_samples=samples, seed=0, gbuffer=gb,
                sample_offset=1)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / samples
    if not torch.isfinite(gb.frame).all():
        raise RuntimeError("non-finite radiance in the timed render")
    after = counts.flat_kernel + counts.queue_kernel + counts.blk_kernel
    return seconds, (after - before) / samples


def profile_sample(render, scene, camera, config, kernel_name):
    """torch.profiler over one full step: (CUDA kernels, their summed device
    seconds, launches of ``kernel_name``, its device seconds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render(scene, camera, config, num_samples=1, seed=0)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no CUDA kernel")
    mine = [e for e in kernels if kernel_name in e.name]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    mine_us = sum(e.time_range.elapsed_us() for e in mine)
    return len(kernels), busy_us / 1e6, len(mine), mine_us / 1e6


def perf(name, render, scene, camera, width, height, bounces, counts, kernel_name, card):
    """Seconds per full step at ray_chunk 16384 and 0, in turns, then one
    profiled step at each."""
    from isaklm_raytracer_tpu_torch.config import RenderConfig

    chunk_default = RenderConfig().ray_chunk
    per_chunk = {}
    for chunk in (chunk_default, 0, 0, chunk_default):
        config = RenderConfig(width=width, height=height, max_bounces=bounces, ray_chunk=chunk)
        s, launches = sample_seconds(render, scene, camera, config, counts)
        per_chunk.setdefault(chunk, []).append(s)
        rays = config.num_pixels * config.max_bounces * 2
        log(f"{name} {width}x{height}x{bounces} ray_chunk {chunk}: {s:.4f} s/sample, "
            f"{rays / s / 1e6:.3f} M rays/s (pixels x bounces x 2), "
            f"{launches:g} intersector launches/sample on {card}")
    for chunk in (chunk_default, 0):
        config = RenderConfig(width=width, height=height, max_bounces=bounces, ray_chunk=chunk)
        n, busy_s, mine_n, mine_s = profile_sample(render, scene, camera, config, kernel_name)
        s = min(per_chunk[chunk])
        log(f"profile {name} ray_chunk {chunk}: {n} CUDA kernels/sample, device kernel time "
            f"{busy_s:.4f} s = {busy_s / s:.1%} of the unprofiled {s:.4f} s/sample; "
            f"{kernel_name} {mine_n} launches, {mine_s * 1e3:.2f} ms = "
            f"{mine_s / busy_s:.1%} of device kernel time, on {card}")
    return per_chunk


def read_png(path):
    """Decode the filter-0 RGB PNGs that io/png.save_png writes."""
    with open(path, "rb") as f:
        data = f.read()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise RuntimeError(f"{path}: unexpected PNG row filter")
    return rows[:, 1:].reshape(h, w, 3)


def cli_path(name, counts, runs, kernel_attr, cli):
    """One main path through the CLI: counts zeroed just before, read just
    after; its kernel must launch and no plain version may run on CUDA."""
    counts.reset()
    for label, argv in runs:
        out = os.path.join(OUT_DIR, f"chip_smoke_{label}.png")
        shape = (int(argv[argv.index("--height") + 1]), int(argv[argv.index("--width") + 1]), 3)
        t0 = time.perf_counter()
        if cli.main([*argv, "--out", out]) != 0:
            raise RuntimeError(f"CLI {label} failed")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        img = read_png(out)
        log(f"cli {label}: {wall:.2f} s wall, png {img.shape}, mean {img.mean():.2f}")
        if img.shape != shape or img.mean() < 1.0:
            raise RuntimeError(f"CLI {label}: bad image {img.shape} mean {img.mean()}")
    launches = getattr(counts, kernel_attr)
    log(f"main path {name}: {kernel_attr} launches {launches}, plain intersector calls "
        f"on CUDA {counts.plain_cuda()}")
    if launches == 0 or counts.plain_cuda():
        raise RuntimeError(f"the {name} path did not go through its kernel alone")
    return launches


def main() -> int:
    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)

    from isaklm_raytracer_tpu_torch.accel import prepare_scene
    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.cli import render as cli
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.integrator.render import (
        intersector_name,
        render,
        resolve_image,
    )
    from isaklm_raytracer_tpu_torch.kernels import build
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki
    from isaklm_raytracer_tpu_torch.scene import procedural
    from isaklm_raytracer_tpu_torch.scene.types import build_scene, MaterialTable

    start = time.perf_counter()
    with Phase("card"):
        card = CARD = card_line()
        log(f"card: {card}")

    with Phase("build"):
        for source, (path, seconds, build_log) in build.build_all(ki.SOURCES, rebuild=True).items():
            ptxas = [ln.strip() for ln in build_log.splitlines()
                     if "registers" in ln or "spill" in ln]
            log(f"build: {source} -> {os.path.relpath(path, REPO)} in {seconds:.2f} s; "
                + "; ".join(ptxas))

    results = {}
    rng = np.random.default_rng(42)
    defaults = RenderConfig()
    with Phase("kernel flat"):
        demo = prepare_scene(procedural.material_demo_scene(), device)
        soup_n = 6000  # 47 clusters, under the 64-cluster limit
        centers = rng.uniform(-4.0, 4.0, (soup_n, 1, 3)).astype(np.float32)
        soup_v = (centers + rng.uniform(-0.4, 0.4, (soup_n, 3, 3))).astype(np.float32)
        soup_b = procedural.SceneBuilder()
        soup_b.add_material(albedo=(0.7, 0.7, 0.7), roughness=0.4, ior=1.0001)
        soup = prepare_scene(build_scene(
            soup_v, np.repeat(np.cross(soup_v[:, 1] - soup_v[:, 0],
                                       soup_v[:, 2] - soup_v[:, 0])[:, None], 3, axis=1),
            np.ones((soup_n, 3, 2), np.float32), np.zeros(soup_n, np.int32),
            MaterialTable.stack(soup_b.materials)), device)
        # the bench's 2048 rays, an odd count, and every ray count the
        # 512x512 main path gives the kernel, at the CLI's ray_chunk and in
        # one pass
        shapes = main_path_shapes(512 * 512, defaults.min_wavefront, (defaults.ray_chunk, 0))
        log(f"kernel flat: main path ray counts {shapes}")

        def flat_tables(scene):
            return (scene.cbvh.tri_const[: scene.cbvh.real_clusters],)

        max_err = max(
            check_kernel("flat demo", ki.flat_intersect, ki.flat_intersect_plain,
                         flat_tables(demo), demo, rng, device, sorted({2048, 777, *shapes})),
            check_kernel(f"flat soup{soup.cbvh.real_clusters}", ki.flat_intersect,
                         ki.flat_intersect_plain, flat_tables(soup), soup, rng, device,
                         BENCH_RAYS),
        )
        tri = flat_tables(demo)[0]
        verts = demo.vertices.reshape(-1, 3).cpu().numpy()
        o, d = random_rays(rng, 512 * 512, verts.min(axis=0), verts.max(axis=0), device)
        window = torch.tensor(rng.random(512 * 512).astype(np.float32) * 4.0, device=device)
        timing = {}
        for label, t_max in (("no t_max", None), ("t_max windows", window)):
            rays = ki.prep_rays(o, d, None, t_max)
            k_ms, p_ms, kout = time_in_turns(
                f"flat_intersect 262144 rays x {demo.cbvh.real_clusters} clusters, {label}",
                lambda: ki.flat_intersect(tri, rays, 1e-5),
                lambda: ki.flat_intersect_plain(tri, rays, 1e-5),
            )
            timing[label] = (k_ms, p_ms)
        # every ray tests every slot of the real clusters
        slots = demo.cbvh.real_clusters * 128
        results["flat"] = {"max_abs_err": max_err, "ms": timing["no t_max"][0],
                           "plain_ms": timing["no t_max"][1],
                           **bound(512 * 512 * slots * TRI_HIT_OPS,
                                   512 * 512 * 40 + tri.numel() * 4),
                           "shape": f"262144 rays x {demo.cbvh.real_clusters} clusters (demo)"}

    with Phase("kernel queue"):
        hero20k = prepare_scene(procedural.hero_scene(20_000), device)
        soup700 = prepare_scene(procedural.triangle_soup(89_000, seed=3), device)
        for scene in (hero20k, soup700):
            if intersector_name(scene.cbvh) != "queue":
                raise RuntimeError(f"{scene.cbvh.num_clusters} clusters: not a queue scene")
        worst = 0.0
        # The soup's 89k triangles fill a 20-unit cube densely, so some random
        # rays start within 1e-3 of a triangle: the strict gate holds on the
        # bench's scene, the soup gets the near-surface rule.
        for label, scene, strict in (
            ("hero20k", hero20k, BENCH_RAYS),
            (f"soup{soup700.cbvh.real_clusters}", soup700, ()),
        ):
            log(f"kernel queue {label}: {scene.num_triangles} triangles, "
                f"{scene.cbvh.real_clusters} real clusters, table "
                f"{scene.cbvh.vmem_bytes / 2**20:.2f} MiB")
            worst = max(worst, check_kernel(
                f"queue {label}", ki.queue_intersect, ki.queue_intersect_plain,
                (scene.cbvh.clu_bbox_t, scene.cbvh.tri_const), scene, rng, device,
                BENCH_RAYS, strict))
        verts = soup700.vertices.reshape(-1, 3).cpu().numpy()
        o, d = random_rays(rng, 512 * 512, verts.min(axis=0), verts.max(axis=0), device)
        rays = ki.prep_rays(o, d)
        tables = (soup700.cbvh.clu_bbox_t, soup700.cbvh.tri_const)
        q_ms, q_plain_ms, qout = time_in_turns(
            f"queue_intersect 262144 rays x {soup700.cbvh.num_clusters} clusters",
            lambda: ki.queue_intersect(*tables, rays, 1e-5),
            lambda: ki.queue_intersect_plain(*tables, rays, 1e-5),
            plain_reps=2, plain_warmup=1,
        )
        # the bound, an upper count: every pierced (ray, cluster) pair the
        # plain version tests (the kernel prunes some) and one slab test per
        # ray and cluster; the rays, results, boxes and the winners' tiles
        num_c = soup700.cbvh.num_clusters
        won = qout[1][qout[1] != _BIG_ID]
        pairs = sum(int(ki._pierce(tables[0][:, :num_c], rays[i:i + 4096], 1e-5).sum())
                    for i in range(0, rays.shape[0], 4096))
        results["queue"] = {"max_abs_err": worst, "ms": q_ms, "plain_ms": q_plain_ms,
                            **bound(pairs * 128 * TRI_HIT_OPS + rays.shape[0] * num_c * SLAB_OPS,
                                    rays.shape[0] * 40 + 7 * num_c * 4
                                    + torch.unique(won // 128).numel() * TILE_BYTES),
                            "shape": f"262144 rays x {num_c} clusters (soup near 6 MB), "
                                     f"{pairs / rays.shape[0]:.2f} pierced clusters a ray"}
        del soup700, tables, rays

    with Phase("kernel blk"):
        t0 = time.perf_counter()
        hero = prepare_scene(procedural.hero_scene(), device)
        torch.cuda.synchronize()
        cbvh = hero.cbvh
        log(f"hero: {hero.num_triangles} triangles, {cbvh.real_clusters} real clusters, "
            f"blk_const {tuple(cbvh.blk_const.shape)} = {cbvh.blk_const.numel() * 4 / 2**20:.1f} "
            f"MiB, blk_bbox_t {tuple(cbvh.blk_bbox_t.shape)}, intersector "
            f"{intersector_name(cbvh)}, built and moved in {time.perf_counter() - t0:.1f} s")
        if intersector_name(cbvh) != "blk":
            raise RuntimeError("the hero scene does not pick the blk intersector")
        worst, b_ms, b_plain_ms, b_count, wavefront, b_bound, sets = check_blk_hero(
            hero, rng, device)
        results["blk"] = {"max_abs_err": worst, "ms": b_ms, "plain_ms": b_plain_ms, **b_bound,
                          "shape": f"{b_count} camera rays x {cbvh.blk_const.shape[0]} blocks "
                                   "(hero 2M)"}

    with Phase("kernel first_blocks"):
        k_err, k_ms, k_plain_ms, argsort_ms, k_bound = check_first_blocks(hero, sets, rng, device)
        results["first_blocks"] = {
            "max_abs_err": k_err, "ms": k_ms, "plain_ms": k_plain_ms, **k_bound,
            "shape": f"{HERO_W * HERO_H} camera rays x {cbvh.blk_bbox_t.shape[1]} block columns "
                     f"(hero; the stable argsort of the keys {argsort_ms:.4f} ms)"}

    with Phase("ordering"):
        check_ordering(hero, sets, card)
        camera = Camera.create((0.0, 1.2, -1.8), pitch=0.15, fov=np.pi / 2, device=device)
        for label, scene, fn, modes, (w, h, b) in (
            ("demo", demo, ki.nearest_hit_flat, ORDERINGS[:2], (512, 512, 8)),
            ("hero", hero, ki.nearest_hit_blk, ORDERINGS, (HERO_W, HERO_H, HERO_BOUNCES)),
        ):
            config = RenderConfig(width=w, height=h, max_bounces=b, ray_chunk=0)
            per = {}
            for mode in modes + modes[::-1]:
                trace = functools.partial(fn, scene.cbvh, t_eps=config.t_epsilon, sort_rays=mode)
                per.setdefault(mode, []).append(ordered_step_seconds(scene, camera, config, trace))
            log(f"ordering {label} {w}x{h}x{b} ray_chunk 0, s/sample: " + "; ".join(
                f"{order_name(m)} {per[m][0]:.4f}/{per[m][1]:.4f}" for m in modes)
                + f" on {card}")
        render_calls_by_order(hero, camera, RenderConfig(
            width=HERO_W, height=HERO_H, max_bounces=HERO_BOUNCES, ray_chunk=0), card)

    with Phase("goldens"):
        counts = ki.COUNTS
        for name, scene_fn, cam, spp, res, bounces in (
            ("cornell_64", lambda: procedural.cornell_box(glossy=True),
             Camera.create((0.0, 0.0, -0.9), fov=np.pi / 2, device=device), 4, 64, 4),
            ("demo_textured_64", lambda: procedural.material_demo_scene(textured=True),
             Camera.create((0.0, 1.2, -1.8), pitch=0.15, fov=np.pi / 2, device=device), 2, 64, 4),
            ("hero_small_32", lambda: procedural.hero_scene(20_000),
             Camera.create((0.0, 2.0, -6.0), fov=np.pi / 2, device=device), 2, 32, 3),
        ):
            config = RenderConfig(width=res, height=res, max_bounces=bounces, ray_chunk=0,
                                  min_samples=1)
            images = []  # the card's, then the port's on the CPU
            for dev in (device, torch.device("cpu")):
                scene = prepare_scene(scene_fn(), dev)
                counts.reset()
                gb = render(scene, cam.to(dev), config, num_samples=spp, seed=11)
                images.append(resolve_image(gb, config).cpu().numpy())
                if dev is device and name == "hero_small_32":
                    # the queue kernel's main-path run, through render()
                    queue_launches = counts.queue_kernel
                    log(f"main path queue (render of hero_small_32): queue_kernel launches "
                        f"{queue_launches}, plain intersector calls on CUDA "
                        f"{counts.plain_cuda()}")
                    if queue_launches == 0 or counts.plain_cuda():
                        raise RuntimeError("the queue path did not go through its kernel alone")
            got = images[0]
            with np.load(os.path.join(REPO, "tests", "golden", f"{name}.npz")) as f:
                want = f["image"]
            err = np.abs(got - want)
            over = int((err > GOLDEN_ATOL).sum())
            vs_cpu = np.abs(got - images[1])
            log(f"golden {name}: max abs err {err.max():.3e}, values over {GOLDEN_ATOL:g}: "
                f"{over} of {err.size}, mean abs err {err.mean():.3e}; card vs the port on "
                f"the CPU: max {vs_cpu.max():.3e}, values over {GOLDEN_ATOL:g}: "
                f"{int((vs_cpu > GOLDEN_ATOL).sum())}")
            if not np.isfinite(got).all() or over > GOLDEN_OUTLIERS or err.max() > GOLDEN_MAX:
                raise RuntimeError(f"golden {name} drifted beyond its tolerance")

    with Phase("main path"):
        os.makedirs(OUT_DIR, exist_ok=True)
        flat_launches = cli_path("flat", counts, (
            ("demo", ["--scene", "demo", "--width", "512", "--height", "512",
                      "--max-bounces", "8", "--min-samples", "4", "--max-samples", "8",
                      "--camera", "0", "1.2", "-1.8", "0", "0.15"]),
            ("cornell", ["--scene", "cornell", "--width", "512", "--height", "512",
                         "--min-samples", "1", "--max-samples", "2"]),
        ), "flat_kernel", cli)
        blk_launches = cli_path("blk", counts, (
            ("hero", ["--scene", "hero", "--width", str(HERO_W), "--height", str(HERO_H),
                      "--max-bounces", str(HERO_BOUNCES), "--min-samples", "2",
                      "--max-samples", "4", "--camera", "0", "1.2", "-1.8", "0", "0.15"]),
        ), "blk_kernel", cli)

    with Phase("perf"):
        camera = Camera.create((0.0, 1.2, -1.8), pitch=0.15, fov=np.pi / 2, device=device)
        perf("demo", render, demo, camera, 512, 512, 8, counts, "flat_intersect", card)
        hero_s = perf("hero", render, hero, camera, HERO_W, HERO_H, HERO_BOUNCES, counts,
                      "blk_intersect", card)
        log(f"hero s/sample: ray_chunk 0 {hero_s[0]}, ray_chunk {defaults.ray_chunk} "
            f"{hero_s[defaults.ray_chunk]} on {card}")

    with Phase("grad"):
        # bench.py's fwd+bwd (loss = mean(render_sample), leaf = albedo)
        # through the entry points, counts zeroed just before each run
        for label, scene, (w, h, b), chunks, sort in (
            ("demo", demo, (512, 512, 8), (0, defaults.ray_chunk), "morton"),
            ("hero", hero, (HERO_W, HERO_H, HERO_BOUNCES), (0, defaults.ray_chunk), "morton"),
            ("hero ISAKLM_BLK_SORT=block", hero, (HERO_W, HERO_H, HERO_BOUNCES), (0,), "block"),
        ):
            os.environ["ISAKLM_BLK_SORT"] = sort
            for chunk in chunks:
                config = RenderConfig(width=w, height=h, max_bounces=b, ray_chunk=chunk)
                out = fwd_and_fwd_bwd(label, scene, camera, config, counts, card)
                kernel = "flat" if label == "demo" else "blk"
                if out["launches"][kernel] == 0:
                    raise RuntimeError(f"grad {label}: the {kernel} kernel did not launch")
                if sort == "block":
                    first_blocks_launches = out["launches"]["first_blocks"]
                    if first_blocks_launches == 0:
                        raise RuntimeError("block ordering did not launch first_block_keys")
        os.environ["ISAKLM_BLK_SORT"] = "morton"
        profile_fwd_bwd(hero, camera, RenderConfig(width=HERO_W, height=HERO_H,
                                                   max_bounces=HERO_BOUNCES, ray_chunk=0), card)
        grad_checks_on_card(device, counts)

    log(f"chip_smoke: {time.perf_counter() - start:.1f} s wall in all")
    launches = {"flat": flat_launches, "queue": queue_launches, "blk": blk_launches,
                "first_blocks": first_blocks_launches}
    names = {"flat": "flat_intersect", "queue": "queue_intersect", "blk": "blk_intersect",
             "first_blocks": "first_block_keys"}
    for k, r in results.items():
        log(f"kernels line, {names[k]}: ms and plain_ms at {r['shape']}; launches from "
            f"its main-path run; max_abs_err over every kernel-vs-plain comparison; bound "
            f"{r['ops']:.4g} operations, {r['bytes']:.4g} bytes")
    log(json.dumps({"kernels": [{
        "name": names[k],
        "route": "cuda",
        "source": f"isaklm_raytracer_tpu_torch/csrc/{names[k]}.cu",
        "replaces": "isaklm_raytracer_tpu/kernels/intersect.py:" + line,
        "launches": launches[k],
        "max_abs_err": results[k]["max_abs_err"],
        "ms": results[k]["ms"],
        "plain_ms": results[k]["plain_ms"],
        "bound_ms": results[k]["bound_ms"],
        "bound_by": results[k]["bound_by"],
        "library_ms": None,  # no PyTorch call computes a nearest hit or a block key
    } for k, line in (("flat", "521"), ("queue", "349"), ("blk", "592"),
                      ("first_blocks", "949"))]}), name_card=False)
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), name_card=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
