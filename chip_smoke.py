#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port once on one NVIDIA card and check it.

Usage (from the root of a checkout, on a machine with a CUDA card):

    python3 chip_smoke.py

Phases, each printing its own lines, its wall seconds as it ends, and
raising on failure:

1. card: name and power limit as nvidia-smi reports them;
2. build: compiles the three intersector kernels of ``csrc/`` with nvcc,
   one process per source, all started together, and prints each one's
   ptxas register and spill lines;
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
6. goldens: cornell_64 and demo_textured_64 (flat) and hero_small_32
   (queue) on the card, against tests/golden/*.npz (the tolerance of
   tests/test_torch_render.py: every value within 1e-4 but at most 8 of
   the image, which stay within 3e-4 -- the goldens carry XLA's fused FMA
   and approximate-rsqrt rounding, and the JAX package's own ops run one
   by one miss them by as much) and against the port on the CPU. The
   hero_small_32 render is the queue kernel's main-path run;
7. main path: the CLI renders the demo at 512x512 with 8 bounces and the
   default Cornell box at 512x512 (the flat kernel's path), then the hero
   scene at 640x360 with 6 bounces (the blocked kernel's path). For each
   path the launch counts are zeroed just before and read just after: its
   kernel must have launched and no plain version may have run on CUDA;
8. perf: seconds per sample and rays/s (pixels x bounces x 2) of full
   steps, demo 512x512x8 and hero 640x360x6, at the CLI's ray_chunk (16384)
   and in one pass (0), in turns, and one torch.profiler sample at each:
   CUDA kernels per sample, summed device kernel time and the
   intersector's share.

The line before the last is a JSON object of per-kernel results; the last
line is {"ok": true, "device": {...}}. Exits non-zero, printing no result,
when there is no CUDA card or the port is missing.
"""

from __future__ import annotations

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


def log(msg: str) -> None:
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
    """Kernel == plain version bit for bit; returns max |t_k - t_p|."""
    (kt, kid), (pt, pid) = kernel_out[:2], plain_out[:2]
    if not (torch.equal(kt, pt) and torch.equal(kid, pid)):
        raise RuntimeError(f"{label}: kernel != plain version")
    return float((kt - pt).abs().max()) if kt.numel() else 0.0


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
    {kind: kernel ms at the wavefront})."""
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
    ms, plain_ms, _ = time_in_turns(
        f"blk_intersect hero {count} camera rays x {cbvh.blk_const.shape[0]} blocks",
        lambda: ki.blk_intersect(*tables, rays, 1e-5),
        lambda: ki.blk_intersect_plain(*tables, rays, 1e-5),
        plain_reps=2, plain_warmup=1,
    )
    wavefront = {}
    for kind, (o, d, t_max) in sets.items():
        rays = ki.prep_rays(o, d, None, t_max)
        k_ms, (_, _, stats) = cuda_ms(lambda: ki.blk_intersect(*tables, rays, 1e-5, stats=True))
        wavefront[kind] = k_ms
        log(f"time blk_intersect hero {kind} rays, kernel alone, {rays.shape[0]} rays: "
            f"{k_ms:.3f} ms; per ray: mean block visits {float(stats[:, 0].float().mean()):.3f}, "
            f"mean clusters intersected {float(stats[:, 1].float().mean()):.3f}")
    return worst, ms, plain_ms, count, wavefront


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
        card = card_line()
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
        results["flat"] = {"max_abs_err": max_err, "ms": timing["no t_max"][0],
                           "plain_ms": timing["no t_max"][1],
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
        q_ms, q_plain_ms, _ = time_in_turns(
            f"queue_intersect 262144 rays x {soup700.cbvh.num_clusters} clusters",
            lambda: ki.queue_intersect(*tables, rays, 1e-5),
            lambda: ki.queue_intersect_plain(*tables, rays, 1e-5),
            plain_reps=2, plain_warmup=1,
        )
        results["queue"] = {"max_abs_err": worst, "ms": q_ms, "plain_ms": q_plain_ms,
                            "shape": f"262144 rays x {soup700.cbvh.num_clusters} clusters "
                                     "(soup near 6 MB)"}
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
        worst, b_ms, b_plain_ms, b_count, wavefront = check_blk_hero(hero, rng, device)
        results["blk"] = {"max_abs_err": worst, "ms": b_ms, "plain_ms": b_plain_ms,
                          "shape": f"{b_count} camera rays x {cbvh.blk_const.shape[0]} blocks "
                                   "(hero 2M)"}

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

    log(f"chip_smoke: {time.perf_counter() - start:.1f} s wall in all")
    launches = {"flat": flat_launches, "queue": queue_launches, "blk": blk_launches}
    for k, r in results.items():
        log(f"kernels line, {k}_intersect: ms and plain_ms at {r['shape']}; launches from "
            f"its main-path run; max_abs_err over every kernel-vs-plain comparison")
    log(json.dumps({"kernels": [{
        "name": f"{k}_intersect",
        "route": "cuda",
        "source": f"isaklm_raytracer_tpu_torch/csrc/{k}_intersect.cu",
        "replaces": "isaklm_raytracer_tpu/kernels/intersect.py:" + line,
        "launches": launches[k],
        "max_abs_err": results[k]["max_abs_err"],
        "ms": results[k]["ms"],
        "plain_ms": results[k]["plain_ms"],
    } for k, line in (("flat", "521"), ("queue", "349"), ("blk", "592"))]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
