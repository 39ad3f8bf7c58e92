#!/usr/bin/env python3
"""The intersector kernels and one-pass renders of checkouts of this
repository, side by side on one CUDA card.

Usage (from anywhere, on a machine with a CUDA card):

    python3 isaklm_raytracer_tpu_torch/tools/compare_walks.py OTHER_DIR [OTHER_DIR ...]

runs a child process for each checkout in turns: the others in order, this
checkout twice, the others in reverse order. Each child imports the
``isaklm_raytracer_tpu_torch`` of its own checkout, so it builds the
kernels from that checkout's sources and calls them through that
checkout's wrappers; the checkouts need not share a C interface. Each
child builds its scenes, makes their rays with ``chip_smoke.py``'s
helpers (this checkout's ``main_path_rays``, ``random_rays``, ``morton``)
from fixed seeds, and

- runs blk, hbm and blk_mxu with per-ray stats on the 2M-triangle hero's
  camera, bounce and NEE wavefronts (640x360);
- runs queue on the 20k hero's camera, bounce and NEE wavefronts (512x512,
  Morton-ordered as the render calls it) and on 262,144 random rays of a
  704-cluster soup, with per-ray stats where the checkout's queue has
  them;
- runs flat on 262,144 random rays of the demo and on the demo's camera,
  bounce and NEE wavefronts (512x512, Morton-ordered), and flat_mxu on the
  same random rays and on those wavefronts in the caller's order (the
  render's order for flat_mxu);
- runs first_block_keys on the hero's camera, bounce and NEE wavefronts;
- times each of those kernels alone by CUDA events;
- times one pass (ray_chunk 0) of the hero at 640x360x6 under the auto
  rule (blk), under ISAKLM_BLK_SORT=block and under
  ISAKLM_INTERSECTOR=hbm, of the 20k hero at 512x512x8 (queue) and of the
  demo at 512x512x8 (flat, and under ISAKLM_INTERSECTOR=flat_mxu), as
  chip_smoke's perf phase.

Then, for each other checkout, one line per kernel and ray set: the sums
of group visits and clusters intersected (where both checkouts count
them), whether the rays and the per-ray results (t, id, and the stats
where both have them; the keys of first_block_keys) have the same SHA-256
in both checkouts, and each checkout's two times; the s/sample of each
render; and, for each source of ``csrc/`` both checkouts built, whether
the two libraries hold the same instructions (``cuobjdump -sass``, with
addresses, encodings and kernel names left out). Exits non-zero if a child
fails or a digest differs.
"""

from __future__ import annotations

import hashlib
import importlib.util
import inspect
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
WALKS = ("blk", "hbm", "blk_mxu")
# timed calls a kernel; hbm few, as an older checkout's oct walk took 0.3 s a call
REPS = {"blk": 10, "hbm": 3, "blk_mxu": 10, "queue": 5, "flat": 20, "first_blocks": 50}
SEED = 42


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def child() -> dict:
    """The measurements of the checkout whose package is on sys.path."""
    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import isaklm_raytracer_tpu_torch as port
    from isaklm_raytracer_tpu_torch.accel import prepare_scene, with_mxu_blocks
    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.integrator.render import render
    from isaklm_raytracer_tpu_torch.kernels import intersect as ki
    from isaklm_raytracer_tpu_torch.scene import procedural

    device = torch.device("cuda", 0)
    out = {"package": os.path.dirname(port.__file__), "walks": {}, "s_per_sample": {}}
    # a second of work first: the card idled while the process started, and
    # the first timing would run below its clock
    square = torch.ones((4096, 4096), device=device)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        square @ square
        torch.cuda.synchronize()

    def record(key, fn, rays, reps):
        ms, res = smoke.cuda_ms(lambda: fn(rays), reps=reps)
        stats = res[2] if len(res) > 2 else None
        out["walks"][key] = {
            "rays": rays.shape[0], "rays_sha256": _digest(rays), "ms": ms,
            "sums": None if stats is None else stats.long().sum(dim=0).tolist(),
            "sha256": _digest(*res[:2]), "stats_sha256": None if stats is None else _digest(stats)}

    def one_pass(label, scene, camera, config, kernel, blk_sort="morton"):
        ki.COUNTS.reset()
        os.environ["ISAKLM_BLK_SORT"] = blk_sort
        with smoke.intersector_env(None if kernel in ("blk", "queue", "flat") else kernel):
            seconds, _ = smoke.sample_seconds(render, scene, camera, config, ki.COUNTS)
        os.environ["ISAKLM_BLK_SORT"] = "morton"
        if getattr(ki.COUNTS, f"{kernel}_kernel") == 0:
            raise RuntimeError(f"the {label} pass did not launch {kernel}")
        if blk_sort == "block" and ki.COUNTS.first_blocks_kernel == 0:
            raise RuntimeError(f"the {label} pass did not launch first_block_keys")
        out["s_per_sample"][label] = seconds

    # the small scenes: flat on the demo, queue on the 20k hero and the soup
    demo = prepare_scene(procedural.material_demo_scene(), device)
    tri = demo.cbvh.tri_const[: demo.cbvh.real_clusters]
    verts = demo.vertices.reshape(-1, 3).cpu().numpy()
    o, d = smoke.random_rays(np.random.default_rng(SEED), 512 * 512, verts.min(axis=0),
                             verts.max(axis=0), device)
    flat = functools.partial(ki.flat_intersect, tri, t_eps=1e-5)
    flat_mxu = functools.partial(ki.flat_mxu_intersect,
                                 demo.cbvh.mxu_tiles[: demo.cbvh.real_clusters], t_eps=1e-5)
    random = ki.prep_rays(o, d)
    record("flat demo random", flat, random, REPS["flat"])
    record("flat_mxu demo random", flat_mxu, random, REPS["flat"])
    sets, _ = smoke.main_path_rays(demo, np.random.default_rng(SEED), device,
                                   ki.nearest_hit_flat, 512, 512)
    for kind, (o, d, t_max) in sets.items():
        rays = ki.prep_rays(o, d, None, t_max)
        record(f"flat demo {kind}", flat, smoke.morton(rays), REPS["flat"])
        record(f"flat_mxu demo {kind} (caller order)", flat_mxu, rays, REPS["flat"])
    hero20k = prepare_scene(procedural.hero_scene(20_000), device)
    soup = prepare_scene(procedural.triangle_soup(89_000, seed=3), device)
    with_stats = "stats" in inspect.signature(ki.queue_intersect).parameters
    for label, scene in (("hero20k", hero20k), ("soup", soup)):
        tables = (scene.cbvh.clu_bbox_t, scene.cbvh.tri_const)
        queue = functools.partial(ki.queue_intersect, *tables, t_eps=1e-5,
                                  **({"stats": True} if with_stats else {}))
        if label == "soup":
            verts = scene.vertices.reshape(-1, 3).cpu().numpy()
            o, d = smoke.random_rays(np.random.default_rng(SEED), 512 * 512,
                                     verts.min(axis=0), verts.max(axis=0), device)
            record("queue soup random", queue, ki.prep_rays(o, d), REPS["queue"])
            continue
        sets, _ = smoke.main_path_rays(scene, np.random.default_rng(SEED), device,
                                       ki.nearest_hit_queue, 512, 512, eye=smoke.GOLDEN_EYE,
                                       pitch=0.0)
        for kind, (o, d, t_max) in sets.items():
            record(f"queue hero20k {kind}", queue,
                   smoke.morton(ki.prep_rays(o, d, None, t_max)), REPS["queue"])
    config = RenderConfig(width=512, height=512, max_bounces=8, ray_chunk=0)
    demo_camera = Camera.create(smoke.BENCH_EYE, pitch=smoke.BENCH_PITCH, fov=np.pi / 2,
                                device=device)
    one_pass("demo 512x512x8 (flat)", demo, demo_camera, config, "flat")
    one_pass("demo 512x512x8 (flat_mxu)", demo, demo_camera, config, "flat_mxu")
    one_pass("hero20k 512x512x8 (queue)", hero20k,
             Camera.create(smoke.GOLDEN_EYE, fov=np.pi / 2, device=device), config, "queue")
    del demo, hero20k, soup

    # the 2M-triangle hero: the group walks
    hero = prepare_scene(procedural.hero_scene(), device)
    cb = hero.cbvh
    mcb = with_mxu_blocks(cb, cb.blk_branch)
    walks = {
        "blk": lambda r: ki.blk_intersect(cb.blk_bbox_t, cb.blk_const, r, 1e-5, True),
        "hbm": lambda r: ki.hbm_intersect(cb.oct_bbox_t, cb.tri_const, r, 1e-5, cb.oct_branch,
                                          True),
        "blk_mxu": lambda r: ki.blk_mxu_intersect(mcb.blk_bbox_t, mcb.mxu_const, r, 1e-5, True),
    }

    def keys(r):
        return (ki.first_block_keys(cb.blk_bbox_t, r, 1e-5),)

    sets, _ = smoke.main_path_rays(hero, np.random.default_rng(SEED), device)
    for kind, (o, d, t_max) in sets.items():
        rays = ki.prep_rays(o, d, None, t_max)
        for name in WALKS:
            record(f"{name} {kind}", walks[name], rays, REPS[name])
        record(f"first_block_keys {kind}", keys, rays, REPS["first_blocks"])
    camera = Camera.create(smoke.BENCH_EYE, pitch=smoke.BENCH_PITCH, fov=np.pi / 2,
                           device=device)
    config = RenderConfig(width=smoke.HERO_W, height=smoke.HERO_H,
                          max_bounces=smoke.HERO_BOUNCES, ray_chunk=0)
    for kernel in ("blk", "hbm"):
        one_pass(f"hero 640x360x6 ({kernel})", hero, camera, config, kernel)
    one_pass("hero 640x360x6 (blk, ISAKLM_BLK_SORT=block)", hero, camera, config, "blk", "block")
    return out


def run_child(tree: Path) -> dict:
    env = {**os.environ, "PYTHONPATH": str(tree)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, __file__, "--child"], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=900)
    print(f"child in {tree}: rc {proc.returncode}, {time.perf_counter() - t0:.1f} s", flush=True)
    if proc.returncode:
        raise RuntimeError(f"the child in {tree} failed:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    if Path(result["package"]).resolve() != (tree / "isaklm_raytracer_tpu_torch").resolve():
        raise RuntimeError(f"the child in {tree} imported the package of {result['package']}")
    return result


def sass(tree: Path, source: str):
    """The instructions of the library that ``tree`` built from
    csrc/<source> (its newest), without addresses, encodings and kernel
    names, or None when there is no such library or no cuobjdump."""
    libs = sorted((tree / "isaklm_raytracer_tpu_torch" / "_build").glob(
        f"lib{Path(source).stem}_*.so"), key=lambda p: p.stat().st_mtime)
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not libs or not os.path.exists(tool):
        return None
    dump = subprocess.run([tool, "-sass", str(libs[-1])], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return [re.sub(r"0x[0-9a-f]+", "X", " ".join(m.group(1).split()))
            for m in (re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(.*?);", line)
                      for line in dump.splitlines()) if m]


def main(argv) -> int:
    if argv[1:] == ["--child"]:
        print(json.dumps(child()), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    others = [Path(a).resolve() for a in argv[1:]]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    runs = {tree: [] for tree in (*others, REPO)}
    for tree in (*others, REPO, REPO, *others[::-1]):
        runs[tree].append(run_child(tree))
    ok = True
    mine = runs[REPO]
    for other in others:
        theirs = runs[other]
        print(f"{other} (other) against {REPO} (this):", flush=True)
        for key, first in mine[0]["walks"].items():
            ws = [r["walks"][key] for r in mine + theirs]
            rays_same = len({w["rays_sha256"] for w in ws}) == 1
            same = len({w["sha256"] for w in ws}) == 1
            counted = all(w["stats_sha256"] is not None for w in ws)
            stats_same = counted and len({w["stats_sha256"] for w in ws}) == 1
            ok &= rays_same and same and (stats_same or not counted)
            print(f"  {key}, {first['rays']} rays: rays {'equal' if rays_same else 'DIFFER'}, "
                  f"per-ray (t, id) or keys {'equal' if same else 'DIFFER'}"
                  + (f", per-ray (visits, clusters) {'equal' if stats_same else 'DIFFER'}; sums "
                     f"this {first['sums']}, other {theirs[0]['walks'][key]['sums']} (group "
                     "visits, clusters intersected)" if counted else
                     f"; sums this {first['sums']} (the other counts none)")
                  + "; kernel alone, ms: other "
                  + "/".join(f"{r['walks'][key]['ms']:.4f}" for r in theirs) + ", this "
                  + "/".join(f"{r['walks'][key]['ms']:.4f}" for r in mine) + f" [{card}]",
                  flush=True)
        for label in mine[0]["s_per_sample"]:
            print(f"  {label} ray_chunk 0, s/sample: other "
                  + "/".join(f"{r['s_per_sample'][label]:.4f}" for r in theirs) + ", this "
                  + "/".join(f"{r['s_per_sample'][label]:.4f}" for r in mine) + f" [{card}]",
                  flush=True)
        for source in sorted(p.name for p in (REPO / "isaklm_raytracer_tpu_torch" / "csrc")
                             .glob("*.cu")):
            a, b = sass(other, source), sass(REPO, source)
            if a is not None and b is not None:
                print(f"  SASS of {source}: " + ("identical" if a == b else
                                                 f"differs ({len(a)} against {len(b)} "
                                                 "instructions, other against this)"), flush=True)
    if not ok:
        print("compare_walks: the checkouts differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
