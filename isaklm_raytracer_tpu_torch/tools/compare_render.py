#!/usr/bin/env python3
"""The render's steps in this checkout and in another, in turns on one CUDA
card.

Usage (from anywhere, on a machine with a CUDA card):

    python3 isaklm_raytracer_tpu_torch/tools/compare_render.py OTHER_DIR

runs one child process four times in turns: OTHER_DIR, this checkout
twice, OTHER_DIR. Each child is started in its checkout and imports that
checkout's package (the kernels are built first, in a child of each
checkout, so no timed run pays for nvcc). On the JAX bench's presets, demo
(512x512, 8 bounces, the flat kernel) and the 2M-triangle hero (640x360, 6
bounces, the blocked kernel), with the bench camera, each child reports

- at ``ray_chunk`` 0 and 16384: seconds a full step run eagerly
  (``render_step``) and replayed from its CUDA graph (``make_step_fn``,
  after its eager call and its capture), three timed steps in one pass
  and one at 16384; the graph's capture and instantiation seconds and its
  pool; one replayed step under torch.profiler (this checkout's
  ``tools/profiling.py`` in both children): its CUDA records, their
  summed device time, the device span of the trace, the sampler kernel's
  records and time (``threefry_uniforms_kernel``; none where the checkout
  draws its variates one tensor op at a time), the shading kernels'
  (``shade_bounce_kernel``, ``finish_bounce_kernel``; none where the
  checkout shades one tensor op at a time) and the most frequent kernel
  names with their records and time; the SHA-256 of the G-buffers of the
  eager and the replayed steps;
- bench.py's fwd+bwd in one pass (loss = mean(render_sample), leaf = the
  material albedo): seconds a sample over two after a warm-up, and the
  peak device memory over those two;
- two ranks on this card over gloo (``dist.launch`` with ``cuda:0``):
  each rank's seconds a full step of ``render_sharded`` on a (2, 1) mesh
  in one pass (two timed steps after one; a rank's steps run eagerly),
  and the SHA-256 of the gathered G-buffer.

Every G-buffer digest must be equal in all four runs (the checkouts render
the same bits), else the tool exits 1. It prints one line per run, the
card's name and power limit as ``nvidia-smi`` gives them, and, as its last
line, the runs as JSON.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

CHILD = r'''
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

from isaklm_raytracer_tpu_torch.accel import prepare_scene
from isaklm_raytracer_tpu_torch.camera import Camera
from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.integrator import render as R
from isaklm_raytracer_tpu_torch.math import rng
from isaklm_raytracer_tpu_torch.scene import procedural
from isaklm_raytracer_tpu_torch.scene.types import GBuffer

EYE, PITCH = (0.0, 1.2, -1.8), 0.15  # bench.py's camera
PRESETS = {"demo": (512, 512, 8), "hero": (640, 360, 6)}
TOP_NAMES = 15  # kernel names of a profiled step, the most frequent first
SAMPLER = "threefry_uniforms_kernel"
SHADE = ("shade_bounce_kernel", "finish_bounce_kernel")


def sha(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def scene_of(label, device):
    build = procedural.material_demo_scene if label == "demo" else procedural.hero_scene
    return prepare_scene(build(), device)


def config_of(label, chunk):
    w, h, b = PRESETS[label]
    return RenderConfig(width=w, height=h, max_bounces=b, ray_chunk=chunk)


def clear_steps():
    for factory in (R.make_step_fn, R.make_compact_step_fn, R.make_tail_step_fn):
        factory.cache_clear()


def load_profiling():
    """tools/profiling.py of the checkout that runs the comparison (the
    other checkout may have none), loaded from its file."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("compare_render_profiling",
                                                  os.environ["COMPARE_RENDER_PROFILING"])
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


profiling = load_profiling()


def profiled(fn):
    """fn under profiling.cuda_profile (CUDA records only, idle pads and
    filler kernels ahead of fn, left out of the records)."""
    with profiling.cuda_profile() as prof:
        fn()
    recs = profiling.device_records(prof)
    start, end = min(t for _, t, _ in recs), max(t + d for _, t, d in recs)
    drawn = [d for name, _, d in recs if SAMPLER in name]
    shaded = [d for name, _, d in recs if any(k in name for k in SHADE)]
    names, times = {}, {}
    for name, _, d in recs:
        names[name] = names.get(name, 0) + 1
        times[name] = times.get(name, 0) + d
    top = sorted(names, key=lambda k: -names[k])[:TOP_NAMES]
    return {"records": len(recs), "kernel_s": sum(d for _, _, d in recs) / 1e9,
            "span_s": (end - start) / 1e9, "sampler_records": len(drawn),
            "sampler_s": sum(drawn) / 1e9, "shade_records": len(shaded),
            "shade_s": sum(shaded) / 1e9,
            "by_name": [[k[:90], names[k], times[k] / 1e9] for k in top]}


def steps(label, scene, camera, chunk):
    config = config_of(label, chunk)
    samples = 1 if chunk else 3
    step = R.make_step_fn(config)
    runs = {"eager": lambda gb, k: R.render_step(scene, camera, gb, k, config, False),
            "replay": lambda gb, k: step(scene, camera, gb, k, False)}
    out = {}
    for how in ("eager", "replay"):
        gb = GBuffer.create(config.num_pixels, scene.device)
        warm = 2 if how == "replay" else 1  # the replay: its eager call and its capture
        for i in range(warm):
            gb = runs[how](gb, rng.sample_key_words(0, i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(samples):
            gb = runs[how](gb, rng.sample_key_words(0, warm + i))
        torch.cuda.synchronize()
        out[how + "_s"] = (time.perf_counter() - t0) / samples
        out[how + "_sha"] = sha(gb.frame, gb.sq_luminance, gb.count)
    graph = step.graphs.last
    out.update(capture_s=graph.capture_s, instantiate_s=graph.instantiate_s,
               pool_mib=graph.pool_bytes / 2**20, bounces=config.max_bounces)
    out["profile"] = profiled(lambda: step(scene, camera, gb, rng.sample_key_words(0, 9), False))
    clear_steps()
    return out


def fwd_bwd(label, scene, camera):
    config = config_of(label, 0)
    albedo = scene.materials.albedo

    def one(i):
        leaf = albedo.detach().clone().requires_grad_(True)
        s = scene.replace(materials=scene.materials.replace(albedo=leaf))
        loss = R.render_sample(s, camera, rng.sample_key_words(0, i), config).mean()
        return torch.autograd.grad(loss, leaf)[0]

    one(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    grads = [one(i) for i in (1, 2)]
    torch.cuda.synchronize()
    return {"fwd_bwd_s": (time.perf_counter() - t0) / 2,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "allocated_before_gib": before / 2**30,
            "grads_finite": all(bool(torch.isfinite(g).all()) for g in grads)}


def sharded_rank(rank, world, label):
    import torch.distributed as dist

    from isaklm_raytracer_tpu_torch.dist import sharding

    device = torch.device("cuda", 0)
    scene = scene_of(label, device)
    camera = Camera.create(EYE, pitch=PITCH, fov=np.pi / 2, device=device)
    config = config_of(label, 0)
    tile = sharding.make_render_mesh(world, 1, device=device)
    gb = sharding.render_sharded(scene, camera, config, 1, tile)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    gb = sharding.render_sharded(scene, camera, config, 2, tile, gbuffer=gb, sample_offset=1)
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / 2
    full = sharding.unshard_gbuffer(gb, config, tile)
    return {"s_per_sample": seconds, "sha": sha(full.frame, full.sq_luminance, full.count)}


def main():
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    camera = Camera.create(EYE, pitch=PITCH, fov=np.pi / 2, device=device)
    out = {"package": R.__file__, "presets": {}}
    for label in PRESETS:
        scene = scene_of(label, device)
        out["presets"][label] = {
            "steps": {chunk: steps(label, scene, camera, chunk) for chunk in (0, 16384)},
            "fwd_bwd": fwd_bwd(label, scene, camera)}
        del scene
    from isaklm_raytracer_tpu_torch.dist.launch import launch

    for label in PRESETS:
        ranks = launch(sharded_rank, 2, label, device="cuda:0")
        out["presets"][label]["sharded"] = ranks
    out["wall_s"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
'''

BUILD = ("from isaklm_raytracer_tpu_torch.kernels import build, intersect as ki; "
         "build.build_all(ki.SOURCES)")


def run_child(tree: Path, script: str) -> dict:
    env = {**os.environ, "PYTHONPATH": str(tree),
           "COMPARE_RENDER_PROFILING": str(REPO / "isaklm_raytracer_tpu_torch/tools/profiling.py")}
    proc = subprocess.run([sys.executable, script], cwd=tree, env=env, capture_output=True,
                          text=True, timeout=3000)
    if proc.returncode:
        raise RuntimeError(f"the child in {tree} failed:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    if Path(result["package"]).resolve().parents[1] != tree / "isaklm_raytracer_tpu_torch":
        raise RuntimeError(f"the child in {tree} imported {result['package']}")
    return result


def digests(run: dict) -> dict:
    """Every G-buffer digest of a run, by where it was taken."""
    out = {}
    for label, preset in run["presets"].items():
        for chunk, s in preset["steps"].items():
            out[f"{label} {chunk} eager"] = s["eager_sha"]
            out[f"{label} {chunk} replay"] = s["replay_sha"]
        for rank, r in enumerate(preset["sharded"]):
            out[f"{label} sharded rank {rank}"] = r["sha"]
    return out


def summary(run: dict) -> str:
    parts = []
    for label, preset in run["presets"].items():
        for chunk, s in preset["steps"].items():
            p = s["profile"]
            parts.append(
                f"{label} {chunk}: eager {s['eager_s']:.4f}, replay {s['replay_s']:.4f} s/sample, "
                f"capture {s['capture_s']:.3f} s, instantiate {s['instantiate_s']:.3f} s, pool "
                f"{s['pool_mib']:.0f} MiB; profiled replay {p['records']} records, kernels "
                f"{p['kernel_s'] * 1e3:.2f} ms in a span of {p['span_s'] * 1e3:.2f} ms (busy "
                f"{p['kernel_s'] / p['span_s']:.1%}), sampler {p['sampler_records']} records "
                f"{p['sampler_s'] * 1e3:.3f} ms, shading kernels {p.get('shade_records', 0)} "
                f"records {p.get('shade_s', 0) * 1e3:.3f} ms")
            if not chunk or chunk == "0":
                bounces = s["bounces"]
                parts.append(f"{label} {chunk} records a bounce by kernel name: " + "; ".join(
                    f"{n / bounces:g} x {name} ({t * 1e3:.3f} ms)"
                    for name, n, t in p.get("by_name", [])))
        fb = preset["fwd_bwd"]
        parts.append(f"{label} fwd+bwd {fb['fwd_bwd_s']:.4f} s/sample, peak {fb['peak_gib']:.3f} "
                     f"GiB ({fb['allocated_before_gib']:.3f} allocated before)")
        parts.append(f"{label} sharded (2, 1) on one card, s/sample rank 0/1: "
                     + "/".join(f"{r['s_per_sample']:.4f}" for r in preset["sharded"]))
    return "\n  ".join(parts)


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(argv[1]).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    for tree in (other, REPO):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", BUILD], cwd=tree, check=True, timeout=900,
                       env={**os.environ, "PYTHONPATH": str(tree)})
        print(f"kernels of {tree} built in {time.perf_counter() - t0:.1f} s", flush=True)
    runs = []
    with tempfile.TemporaryDirectory(prefix="compare_render_") as tmp:
        script = os.path.join(tmp, "child.py")  # a file: the sharded ranks re-import it
        with open(script, "w") as f:
            f.write(CHILD)
        for label, tree in (("other", other), ("this", REPO), ("this", REPO), ("other", other)):
            r = run_child(tree, script)
            r["tree"] = label
            runs.append(r)
            print(f"{label} ({tree}), {r['wall_s']:.1f} s [{card}]:\n  {summary(r)}", flush=True)
    first = digests(runs[0])
    same = all(digests(r) == first for r in runs)
    print(f"G-buffer digests of the four runs {'equal' if same else 'DIFFER'}: {first}",
          flush=True)
    print(card, flush=True)
    print(json.dumps(runs), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
