#!/usr/bin/env python3
"""The group-walk kernels and the hero's one-pass render of checkouts of
this repository, side by side on one CUDA card.

Usage (from anywhere, on a machine with a CUDA card):

    python3 isaklm_raytracer_tpu_torch/tools/compare_walks.py OTHER_DIR [OTHER_DIR ...]

runs a child process for each checkout in turns: the others in order, this
checkout twice, the others in reverse order. Each child imports the
``isaklm_raytracer_tpu_torch`` of its own checkout, so it builds the
kernels from that checkout's sources and calls them through that
checkout's wrappers; the checkouts need not share a C interface. Each child builds the 2M-triangle hero, makes the camera,
bounce and NEE wavefronts of ``chip_smoke.py`` (this checkout's
``hero_ray_sets``) from one seed, and

- runs blk, hbm and blk_mxu with per-ray stats on each wavefront, and times
  each alone by CUDA events;
- times one pass of the hero at 640x360x6 (ray_chunk 0) under the auto
  rule (blk) and under ISAKLM_INTERSECTOR=hbm, as chip_smoke's perf phase.

Then, for each other checkout, one line per kernel and wavefront: the
sums of group visits and clusters intersected, whether the rays and the
per-ray (t, id, visits, clusters) have the same SHA-256 in both checkouts,
and each checkout's two times; and the s/sample of each. Exits non-zero if
a child fails or a digest differs.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
WALKS = ("blk", "hbm", "blk_mxu")
REPS = {"blk": 10, "hbm": 3, "blk_mxu": 10}  # hbm at 3: the older oct walk takes ~0.3 s
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
    hero = prepare_scene(procedural.hero_scene(), device)
    cb = hero.cbvh
    mcb = with_mxu_blocks(cb, cb.blk_branch)
    walks = {
        "blk": lambda r: ki.blk_intersect(cb.blk_bbox_t, cb.blk_const, r, 1e-5, True),
        "hbm": lambda r: ki.hbm_intersect(cb.oct_bbox_t, cb.tri_const, r, 1e-5, cb.oct_branch,
                                          True),
        "blk_mxu": lambda r: ki.blk_mxu_intersect(mcb.blk_bbox_t, mcb.mxu_const, r, 1e-5, True),
    }
    sets, _ = smoke.hero_ray_sets(hero, np.random.default_rng(SEED), device)
    out = {"package": os.path.dirname(port.__file__), "walks": {}, "s_per_sample": {}}
    for kind, (o, d, t_max) in sets.items():
        rays = ki.prep_rays(o, d, None, t_max)
        for name in WALKS:
            ms, (t, ids, stats) = smoke.cuda_ms(lambda: walks[name](rays), reps=REPS[name])
            out["walks"][f"{name} {kind}"] = {
                "rays": rays.shape[0], "rays_sha256": _digest(rays), "ms": ms,
                "sums": stats.long().sum(dim=0).tolist(), "sha256": _digest(t, ids, stats)}
    camera = Camera.create((0.0, 1.2, -1.8), pitch=0.15, fov=np.pi / 2, device=device)
    config = RenderConfig(width=smoke.HERO_W, height=smoke.HERO_H,
                          max_bounces=smoke.HERO_BOUNCES, ray_chunk=0)
    for name in (None, "hbm"):
        ki.COUNTS.reset()
        with smoke.intersector_env(name):
            seconds, _ = smoke.sample_seconds(render, hero, camera, config, ki.COUNTS)
        kernel = name or "blk"
        if getattr(ki.COUNTS, f"{kernel}_kernel") == 0:
            raise RuntimeError(f"the hero pass under {kernel} did not launch its kernel")
        out["s_per_sample"][kernel] = seconds
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
            ok &= rays_same and same
            print(f"  {key}, {first['rays']} rays: rays {'equal' if rays_same else 'DIFFER'}, "
                  f"per-ray (t, id, visits, clusters) {'equal' if same else 'DIFFER'}; sums this "
                  f"{first['sums']}, other {theirs[0]['walks'][key]['sums']} (group visits, "
                  f"clusters intersected); kernel alone, ms: other "
                  + "/".join(f"{r['walks'][key]['ms']:.3f}" for r in theirs) + ", this "
                  + "/".join(f"{r['walks'][key]['ms']:.3f}" for r in mine) + f" [{card}]",
                  flush=True)
        for kernel in mine[0]["s_per_sample"]:
            print(f"  hero 640x360x6 ray_chunk 0 under {kernel}, s/sample: other "
                  + "/".join(f"{r['s_per_sample'][kernel]:.4f}" for r in theirs) + ", this "
                  + "/".join(f"{r['s_per_sample'][kernel]:.4f}" for r in mine) + f" [{card}]",
                  flush=True)
    if not ok:
        print("compare_walks: the checkouts differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
