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
- bench.py's fwd+bwd (loss = mean(render_sample), leaf = the material
  albedo) at ``ray_chunk`` 0 and 16384: seconds a sample over two (one at
  16384) after a warm-up, the peak device memory over those, the SHA-256
  of the losses; at 0 one more sample's backward under torch.profiler: its
  CUDA records and their device time, the backward shading kernel's
  (``bounce_backward_kernel``; none where the checkout differentiates the
  shading one tensor op at a time);
- a fwd+bwd sample whose leaves are every float material field, the
  texel atlas and the camera position (as ``chip_smoke.py`` phase
  shade_grad) at ``ray_chunk`` 0 and 16384, through a stand-in for
  ``kernels.shade.bounce_backward`` that records each call: the SHA-256
  of its per-ray gradients (ray origin, direction, throughput) and its
  material gradients; the texel gradients summed over the calls (to a
  file beside the child's script); the loss's SHA-256; at 0 the device
  time of a ``bounce_backward`` call on bounce 0's saved inputs (a CUDA
  graph of 20 calls, replayed three times between CUDA events), and of
  three probes of what holds it: the rays sorted by class first (metal,
  specular, specular inside, transmission, diffuse with its shadow ray
  on the light, diffuse without, dead), no material or texel sums, and,
  where the checkout's ``csrc/shade_backward.cu`` launches one kernel with
  ``__launch_bounds__(kShadeThreads)``, that source built here with a
  minimum of 3 and 4 resident blocks (ptxas's registers and spills
  printed);
- ``sharded_value_and_grad_fn`` on an NCCL world-1 (1, 1) mesh at
  ``ray_chunk`` 0: the seconds of five calls on one key (where the
  checkout replays graphs: its eager call, its capture, three replays),
  the graphs' capture record (capture and instantiation seconds, pool)
  and the SHA-256 of the losses;
- two ranks on this card over gloo (``dist.launch`` with ``cuda:0``):
  each rank's seconds of a full step of ``render_sharded`` on a (2, 1)
  mesh in one pass, its first and second calls (this checkout: the eager
  call and the capture) and two steps after them, the step graph's
  capture record, and the SHA-256 of the gathered G-buffer; on the demo,
  three calls of the decorrelated value_and_grad on a (1, 2) mesh (their
  seconds, the losses' SHA-256, the graphs' record) and three
  ``sharded_train_step_fn`` steps (seconds a step, the SHA-256 of the
  first step's loss; the later ones follow grads that atomics sum).

Every G-buffer digest, every loss digest and every backward call's
per-ray digest must be equal in all four runs (the checkouts render and
differentiate the same bits), and the material and texel gradients must
agree within tests/test_torch_shade_grad.py's sum tolerance (rtol 1e-4,
atol 1e-6: atomics add them in another order each run), else the tool
exits 1. It prints one line per run, the
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
import ctypes
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
from isaklm_raytracer_tpu_torch.kernels import shade
from isaklm_raytracer_tpu_torch.math import rng
from isaklm_raytracer_tpu_torch.scene import procedural
from isaklm_raytracer_tpu_torch.scene.types import GBuffer

EYE, PITCH = (0.0, 1.2, -1.8), 0.15  # bench.py's camera
PRESETS = {"demo": (512, 512, 8), "hero": (640, 360, 6)}
TOP_NAMES = 15  # kernel names of a profiled step, the most frequent first
SAMPLER = "threefry_uniforms_kernel"
SHADE = ("shade_bounce_kernel", "finish_bounce_kernel")
BACKWARD = "bounce_backward_kernel"
VG_KEY = (0, 13)  # the sharded value_and_grad's key words


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


def fwd_bwd(label, scene, camera, chunk):
    config = config_of(label, chunk)
    albedo = scene.materials.albedo
    samples = 1 if chunk else 2

    def forward(i):
        leaf = albedo.detach().clone().requires_grad_(True)
        s = scene.replace(materials=scene.materials.replace(albedo=leaf))
        return leaf, R.render_sample(s, camera, rng.sample_key_words(0, i), config).mean()

    def one(i):
        leaf, loss = forward(i)
        return loss.detach(), torch.autograd.grad(loss, leaf)[0]

    one(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    outs = [one(i) for i in range(1, samples + 1)]
    torch.cuda.synchronize()
    out = {"fwd_bwd_s": (time.perf_counter() - t0) / samples,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "allocated_before_gib": before / 2**30,
           "grads_finite": all(bool(torch.isfinite(g).all()) for _, g in outs),
           "loss_sha": sha(*(loss for loss, _ in outs))}
    if not chunk:
        leaf, loss = forward(9)
        torch.cuda.synchronize()
        with profiling.cuda_profile() as prof:
            torch.autograd.grad(loss, leaf)
        recs = profiling.device_records(prof)
        mine = [d for name, _, d in recs if BACKWARD in name]
        out["backward_profile"] = {"records": len(recs),
                                   "kernel_s": sum(d for _, _, d in recs) / 1e9,
                                   "bounce_backward_records": len(mine),
                                   "bounce_backward_s": sum(mine) / 1e9}
    return out


def graph_ms(fn, reps=20):
    """Device ms a call of fn: captured reps times into a CUDA graph, the
    graph replayed three times between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (3 * reps)


def class_order(saved):
    """The rays of a backward call by class (metal, specular from outside,
    from inside, transmission, diffuse seeing the light, diffuse not, dead),
    ray order within a class: the forward recomputed for its lobes."""
    p = shade.shade_bounce(saved.scene, saved.ray_o, saved.ray_d, saved.idx, saved.hit,
                           saved.active, saved.throughput, saved.radiance, saved.inside,
                           saved.prev_diffuse, saved.u, saved.lobe_ratio_grad)
    scene, live = saved.scene, saved.active & saved.hit
    safe = saved.idx.clamp_min(0).long()
    mat = (scene.shade_table[safe, 24].long() if scene.shade_table is not None
           else scene.mat_id[safe].long())
    metal = live & (scene.materials.extinction[mat] > 0)
    diffuse = live & p.prev_diffuse
    trans = live & (p.inside != saved.inside)
    spec = live & ~metal & ~diffuse & ~trans
    visible = diffuse & saved.shadow_hit & (saved.shadow_idx == p.light_idx)
    cls = torch.full_like(saved.idx, 6)
    for k, m in enumerate((metal, spec & ~saved.inside, spec & saved.inside, trans, visible,
                           diffuse & ~visible)):
        cls[m] = k
    return torch.sort(cls, stable=True).indices


def permuted(saved, grads, order):
    """A backward call's saved inputs and output gradients in ``order``."""
    n = saved.ray_o.shape[0]
    kw = {}
    for f, v in vars(saved).items():
        if isinstance(v, torch.Tensor) and f == "u":
            v = v[:, order].contiguous()
        elif isinstance(v, torch.Tensor) and v.shape[:1] == (n,):
            v = v[order].contiguous()
        kw[f] = v
    return type(saved)(**kw), [g[order].contiguous() for g in grads]


def variant_call(path):
    """A call of the checkout's bounce_backward entry point in the library
    at ``path`` (its own source built with other launch bounds)."""
    fn = ctypes.CDLL(path).bounce_backward
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(saved, grads):
        made = shade.backward_args(saved, grads)
        s_args, args = made[-2], made[-1]
        err = fn(saved.ray_o.device.index or 0, ctypes.addressof(s_args), ctypes.addressof(args),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the variant at {path} failed to launch: CUDA error {err}")
        return made

    return call


def backward_calls(label, scene, camera, chunk):
    """One fwd+bwd sample with every float material field, the atlas and
    the camera position as leaves, each bounce_backward call recorded."""
    import dataclasses

    config = config_of(label, chunk)
    real = shade.bounce_backward
    calls, texels, last = [], [], {}

    def recorded(saved, grad_outputs, needs=None):
        got = real(saved, grad_outputs, needs)
        calls.append({"rays": int(saved.ray_o.shape[0]), "sha": sha(*got[:3]),
                      "material": [g.double().cpu().tolist() for g in got[4:9]]})
        texels.append(got[10].double().cpu())
        last["saved"], last["grads"] = saved, [g.contiguous() for g in grad_outputs[:4]]
        return got

    m = scene.materials
    leaves = [getattr(m, f).detach().clone().requires_grad_(True) for f in shade.MATERIAL_FIELDS]
    atlas = scene.textures.buffer.detach().clone().requires_grad_(True)
    position = camera.position.detach().clone().requires_grad_(True)
    s = scene.replace(materials=m.replace(**dict(zip(shade.MATERIAL_FIELDS, leaves))),
                      textures=dataclasses.replace(scene.textures, buffer=atlas))
    shade.bounce_backward = recorded
    try:
        loss = R.render_sample(s, camera.replace(position=position), (3, 4), config).mean()
        torch.autograd.grad(loss, [*leaves, atlas, position])
    finally:
        shade.bounce_backward = real
    torch.cuda.synchronize()
    out = {"calls": calls, "loss_sha": sha(loss.detach())}
    path = os.path.join(os.environ["COMPARE_RENDER_DIR"], f"texels_{label}_{chunk}.npy")
    np.save(path, torch.stack(texels).sum(dim=0).numpy())
    out["texels"] = path
    if not chunk:  # bounce 0's inputs: the last call
        saved, grads = last["saved"], last["grads"]
        with torch.no_grad():
            out["bounce_backward_ms"] = graph_ms(lambda: shade.bounce_backward(saved, grads))
            ps, pg = permuted(saved, grads, class_order(saved))
            out["sorted_ms"] = graph_ms(lambda: shade.bounce_backward(ps, pg))
            no_sums = [True] * 4 + [False] * 7
            out["no_sums_ms"] = graph_ms(lambda: shade.bounce_backward(saved, grads, no_sums))
            variants = json.loads(os.environ.get("COMPARE_RENDER_VARIANTS", "{}"))
            for blocks, path in variants.items():
                call = variant_call(path)
                out[f"min_blocks_{blocks}_ms"] = graph_ms(lambda: call(saved, grads))
    return out


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def graph_record(graphs):
    """The capture record of a checkout's graph step (None where the
    checkout runs the step eagerly)."""
    step = None if graphs is None else graphs.last
    if step is None or getattr(step, "graph", None) is None:
        return None
    return {"capture_s": step.capture_s, "instantiate_s": step.instantiate_s,
            "pool_mib": step.pool_bytes / 2**20, "replays": step.replays}


def vg_calls(scene, camera, config, mesh, calls, decorrelate=False):
    """``calls`` calls of the checkout's sharded value_and_grad on one key
    (this checkout: the eager call, the capture, replays): each call's
    seconds, the losses' SHA-256 and the graphs' capture record."""
    from isaklm_raytracer_tpu_torch.dist import sharding

    with torch.no_grad():
        target = R.render_sample(scene, camera, rng.fold_in(VG_KEY, 0), config)
    params = scene.materials.replace(albedo=scene.materials.albedo * 0.6)
    vg = sharding.sharded_value_and_grad_fn(scene, config, mesh, decorrelate=decorrelate)
    seconds, losses = [], []
    for _ in range(calls):
        s, (loss, grads) = timed(lambda: vg(params, camera, target, VG_KEY))
        seconds.append(s)
        losses.append(loss)
    return {"seconds": seconds, "loss_sha": sha(*losses),
            "graph": graph_record(getattr(vg, "graphs", None))}


def world1_vg(label, scene, camera):
    """vg on the NCCL world-1 (1, 1) mesh at ray_chunk 0: five calls."""
    from isaklm_raytracer_tpu_torch.dist import sharding

    mesh = sharding.make_render_mesh(1, 1, device=scene.device)
    return vg_calls(scene, camera, config_of(label, 0), mesh, 5)


def sharded_rank(rank, world, label):
    import torch.distributed as dist

    from isaklm_raytracer_tpu_torch.dist import sharding

    device = torch.device("cuda", 0)
    scene = scene_of(label, device)
    camera = Camera.create(EYE, pitch=PITCH, fov=np.pi / 2, device=device)
    config = config_of(label, 0)
    tile = sharding.make_render_mesh(world, 1, device=device)
    gb, first = None, []
    for i in range(2):  # this checkout: the eager call, the capture
        dist.barrier()
        s, gb = timed(lambda: sharding.render_sharded(scene, camera, config, 1, tile, gbuffer=gb,
                                                      sample_offset=i))
        first.append(s)
    dist.barrier()
    seconds, gb = timed(lambda: sharding.render_sharded(scene, camera, config, 2, tile,
                                                        gbuffer=gb, sample_offset=2))
    full = sharding.unshard_gbuffer(gb, config, tile)
    rank_steps = getattr(sharding, "_rank_steps", None)
    out = {"eager_s": first[0], "capture_call_s": first[1], "s_per_sample": seconds / 2,
           "sha": sha(full.frame, full.sq_luminance, full.count),
           "graph": graph_record(rank_steps and rank_steps(config).step.graphs)}
    if label == "demo":  # value_and_grad and the train step on a (1, world) mesh
        streams = sharding.make_render_mesh(1, world, device=device)
        dist.barrier()
        out["vg"] = vg_calls(scene, camera, config, streams, 3, decorrelate=True)
        with torch.no_grad():
            target = R.render_sample(scene, camera, rng.fold_in(VG_KEY, 0), config)
        step = sharding.sharded_train_step_fn(scene, config, streams)
        p, losses = scene.materials.replace(albedo=scene.materials.albedo * 0.6), []
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(3):
            p, loss = step(p, camera, target, rng.fold_in(VG_KEY, 10 + i))
            losses.append(loss)
        torch.cuda.synchronize()
        out["train_s_per_step"] = (time.perf_counter() - t0) / 3
        # the first step's loss: the later ones follow grads that atomics sum
        out["train_loss_sha"] = sha(losses[0])
    return out


def main():
    t0 = time.perf_counter()
    device = torch.device("cuda", 0)
    camera = Camera.create(EYE, pitch=PITCH, fov=np.pi / 2, device=device)
    out = {"package": R.__file__, "presets": {}}
    for label in PRESETS:
        scene = scene_of(label, device)
        out["presets"][label] = {
            "steps": {chunk: steps(label, scene, camera, chunk) for chunk in (0, 16384)},
            "fwd_bwd": {chunk: fwd_bwd(label, scene, camera, chunk) for chunk in (0, 16384)},
            "backward": {chunk: backward_calls(label, scene, camera, chunk)
                         for chunk in (0, 16384)}}
        del scene
    from isaklm_raytracer_tpu_torch.dist.launch import launch

    import torch.distributed as dist

    from isaklm_raytracer_tpu_torch.dist.launch import free_port

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0, device_id=device)
    try:
        for label in PRESETS:
            scene = scene_of(label, device)
            out["presets"][label]["vg_world1"] = world1_vg(label, scene, camera)
            del scene
    finally:
        dist.destroy_process_group()
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


def launch_bound_variants(tree: Path, tmp: str) -> tuple:
    """({minimum blocks: library}, ptxas lines) of ``tree``'s
    csrc/shade_backward.cu built with ``__launch_bounds__(kShadeThreads,
    n)`` for n = 3, 4 (this checkout's nvcc flags), where that source
    launches one kernel with ``__launch_bounds__(kShadeThreads)``; else
    none."""
    sys.path.insert(0, str(REPO))
    from isaklm_raytracer_tpu_torch.kernels import build

    src = tree / "isaklm_raytracer_tpu_torch" / "csrc" / "shade_backward.cu"
    text, pattern = src.read_text(), "__launch_bounds__(kShadeThreads)"
    libs, lines = {}, []
    if pattern not in text:
        return libs, lines
    for blocks in (3, 4):
        d = Path(tmp) / f"min_blocks_{blocks}"
        d.mkdir(parents=True)
        (d / "shade_backward.cu").write_text(
            text.replace(pattern, f"__launch_bounds__(kShadeThreads, {blocks})"))
        lib = d / "libshade_backward.so"
        proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(src.parent), "-o",
                               str(lib), str(d / "shade_backward.cu")], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src} with {blocks} blocks:\n{proc.stderr}")
        lines.append(f"{src} with __launch_bounds__(kShadeThreads, {blocks}): " + "; ".join(
            ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln))
        libs[blocks] = str(lib)
    return libs, lines


def run_child(tree: Path, script: str, out_dir: str, variants: dict) -> dict:
    env = {**os.environ, "PYTHONPATH": str(tree), "COMPARE_RENDER_DIR": out_dir,
           "COMPARE_RENDER_VARIANTS": json.dumps(variants),
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
            if "vg" in r:
                out[f"{label} sharded rank {rank} vg losses"] = r["vg"]["loss_sha"]
                out[f"{label} sharded rank {rank} train losses"] = r["train_loss_sha"]
        out[f"{label} world-1 vg losses"] = preset["vg_world1"]["loss_sha"]
        for chunk, fb in preset["fwd_bwd"].items():
            out[f"{label} {chunk} fwd+bwd loss"] = fb["loss_sha"]
        for chunk, bw in preset["backward"].items():
            out[f"{label} {chunk} all-leaves loss"] = bw["loss_sha"]
            for k, call in enumerate(bw["calls"]):
                out[f"{label} {chunk} backward call {k}"] = call["sha"]
    return out


# tests/test_torch_shade_grad.py SUM_RTOL, SUM_ATOL: the material and texel sums
SUM_RTOL, SUM_ATOL = 1e-4, 1e-6


def sums_differ(run: dict, first: dict) -> list:
    """Where ``run``'s material and texel gradients leave the sum tolerance
    of ``first``'s: [(what, max |difference|)]."""
    import numpy as np

    off = []
    for label, preset in run["presets"].items():
        for chunk, bw in preset["backward"].items():
            ref = first["presets"][label]["backward"][chunk]
            pairs = [(f"{label} {chunk} texels", np.load(bw["texels"]), np.load(ref["texels"]))]
            pairs += [(f"{label} {chunk} call {k} materials",
                       np.array([x for f in call["material"] for x in np.ravel(f)]),
                       np.array([x for f in want["material"] for x in np.ravel(f)]))
                      for k, (call, want) in enumerate(zip(bw["calls"], ref["calls"]))]
            for what, got, want in pairs:
                err = np.abs(got - want)
                if got.shape != want.shape or (err > SUM_ATOL + SUM_RTOL * np.abs(want)).any():
                    off.append((what, float(err.max()) if got.shape == want.shape else None))
    return off


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
        for chunk, fb in preset["fwd_bwd"].items():
            bp = fb.get("backward_profile")
            parts.append(f"{label} {chunk} fwd+bwd {fb['fwd_bwd_s']:.4f} s/sample, peak "
                         f"{fb['peak_gib']:.3f} GiB ({fb['allocated_before_gib']:.3f} allocated "
                         "before)" + (f"; a profiled backward {bp['records']} records, kernels "
                                      f"{bp['kernel_s'] * 1e3:.3f} ms, bounce_backward "
                                      f"{bp['bounce_backward_records']} records "
                                      f"{bp['bounce_backward_s'] * 1e3:.3f} ms" if bp else ""))
        for chunk, bw in preset["backward"].items():
            probes = "; ".join(f"{k[:-3].replace('_', ' ')} {v:.5f}" for k, v in bw.items()
                               if k.endswith("_ms") and k != "bounce_backward_ms")
            parts.append(f"{label} {chunk} all-leaves fwd+bwd: {len(bw['calls'])} bounce_backward "
                         "calls" + (f", bounce 0's call {bw['bounce_backward_ms']:.5f} ms device "
                                    f"time (CUDA graph of 20; probes: {probes})"
                                    if "bounce_backward_ms" in bw else ""))
        sh = preset["sharded"]
        parts.append(f"{label} sharded (2, 1) on one card, rank 0/1: a full step's first call "
                     + "/".join(f"{r['eager_s']:.4f}" for r in sh) + " s, second call "
                     + "/".join(f"{r['capture_call_s']:.4f}" for r in sh) + " s, then "
                     + "/".join(f"{r['s_per_sample']:.4f}" for r in sh) + " s/sample; graph "
                     + f"{sh[0]['graph']}")
        if "vg" in sh[0]:
            parts.append(f"{label} sharded value_and_grad (1, 2), decorrelated, seconds a call "
                         f"rank 0/1: {[round(x, 4) for x in sh[0]['vg']['seconds']]}/"
                         f"{[round(x, 4) for x in sh[1]['vg']['seconds']]}, graph "
                         f"{sh[0]['vg']['graph']}; three train steps "
                         + "/".join(f"{r['train_s_per_step']:.4f}" for r in sh) + " s a step")
        w1 = preset["vg_world1"]
        parts.append(f"{label} value_and_grad, NCCL world 1 (1, 1), seconds a call: "
                     f"{[round(x, 5) for x in w1['seconds']]}, graph {w1['graph']}")
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
        variants = {}
        for name, tree in (("other", other), ("this", REPO)):
            variants[name], lines = launch_bound_variants(tree, os.path.join(tmp, name))
            for line in lines:
                print(f"{line} [{card}]", flush=True)
        script = os.path.join(tmp, "child.py")  # a file: the sharded ranks re-import it
        with open(script, "w") as f:
            f.write(CHILD)
        for k, (label, tree) in enumerate((("other", other), ("this", REPO), ("this", REPO),
                                           ("other", other))):
            run_dir = os.path.join(tmp, f"run{k}")
            os.makedirs(run_dir)
            r = run_child(tree, script, run_dir, variants[label])
            r["tree"] = label
            runs.append(r)
            print(f"{label} ({tree}), {r['wall_s']:.1f} s [{card}]:\n  {summary(r)}", flush=True)
        first = digests(runs[0])
        same = all(digests(r) == first for r in runs)
        off = [x for r in runs[1:] for x in sums_differ(r, runs[0])]
    print(f"G-buffer, loss and backward-call digests of the four runs "
          f"{'equal' if same else 'DIFFER'}: {first}", flush=True)
    print(f"material and texel gradients of the four runs within rtol {SUM_RTOL:g} atol "
          f"{SUM_ATOL:g} of the first run's: {'yes' if not off else off}", flush=True)
    print(card, flush=True)
    print(json.dumps(runs), flush=True)
    return 0 if same and not off else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
