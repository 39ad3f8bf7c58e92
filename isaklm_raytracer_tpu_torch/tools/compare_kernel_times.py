#!/usr/bin/env python3
"""The backward's binning, its reverse and the KD walk's triangle table in
this checkout and in another, in turns on one CUDA card.

Usage (from anywhere, on a machine with a CUDA card):

    python3 isaklm_raytracer_tpu_torch/tools/compare_kernel_times.py OTHER_DIR

runs one child process four times in turns: OTHER_DIR, this checkout
twice, OTHER_DIR. Each child is started in its checkout and imports that
checkout's package (the kernels are built first, in a child of each
checkout, so no timed run pays for nvcc). A child reports:

- on the JAX bench's presets, demo (512x512, 8 bounces, the flat kernel)
  and the 2M-triangle hero (640x360, 6 bounces, the blocked kernel), with
  the bench camera, in one pass: one fwd+bwd sample with every float
  material field, the texel atlas and the camera position as leaves,
  through a stand-in for ``kernels.shade.bounce_backward`` that keeps each
  call's inputs; on bounce 0's call (the last) the device time of a call
  of ``shade.bounce_bin`` (the binning, with whatever fill the checkout's
  wrapper launches) and of ``shade.bounce_backward`` (both kernels and
  the rest of the call), each a CUDA graph of 20 calls replayed three
  times between CUDA events, and one replay of each graph under
  torch.profiler (this checkout's ``tools/profiling.py`` in both
  children): the binning kernel's own duration, the reverse's, and every
  other record's (the fills); the backward of two more fwd+bwd samples as
  it runs, under torch.profiler: its CUDA records, their device time, the
  binning's and the reverse's; the SHA-256 of the loss, of every backward
  call's per-ray gradients, of each class's rays the binning listed
  (sorted) and of the dead lanes' pass-through;
- on the corners of ``hero_scene(20_000)`` and ``hero_scene(300_000)``
  (19,688 and 299,704 triangles) the table kernel's launch (the
  wrapper's entry point into a table allocated outside the graph) timed
  the same way, its own duration, its own duration after a 128 MiB write
  (the L2 cache cold), and the SHA-256 of the table.

Every digest must be equal in all four runs, else the tool exits 1. It
prints one line per run, the card's name and power limit as
``nvidia-smi`` gives them, and, as its last line, the runs as JSON.
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
import dataclasses
import hashlib
import importlib.util
import json
import os

import numpy as np
import torch

from isaklm_raytracer_tpu_torch.accel import prepare_scene
from isaklm_raytracer_tpu_torch.camera import Camera
from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.integrator import render as R
from isaklm_raytracer_tpu_torch.kernels import intersect as ki
from isaklm_raytracer_tpu_torch.kernels import shade
from isaklm_raytracer_tpu_torch.scene import procedural

EYE, PITCH = (0.0, 1.2, -1.8), 0.15  # bench.py's camera
PRESETS = {"demo": (procedural.material_demo_scene, 512, 512, 8),
           "hero": (procedural.hero_scene, 640, 360, 6)}
TABLES = {"hero20k": 20_000, "hero300k": 300_000}
REPS = 20


def sha(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


spec = importlib.util.spec_from_file_location("compare_profiling", os.environ["COMPARE_PROFILING"])
profiling = importlib.util.module_from_spec(spec)
spec.loader.exec_module(profiling)


def timed(fn, names):
    """Device ms a call of fn (a CUDA graph of REPS calls replayed three
    times between CUDA events), and from one replay under torch.profiler
    the mean own ms a call of the records named like each of ``names`` and
    of all the others."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    out = {"ms": start.elapsed_time(stop) / (3 * REPS)}
    with profiling.cuda_profile() as prof:
        graph.replay()
    recs = profiling.device_records(prof)
    rest = list(recs)
    for key, name in names.items():
        own = [d for n, _, d in recs if name in n]
        if len(own) != REPS:
            raise RuntimeError(f"{len(own)} records of {name} in a replay of {REPS} calls")
        out[key + "_own_ms"] = sum(own) / REPS / 1e6
        rest = [r for r in rest if name not in r[0]]
    out["others_ms"] = sum(d for _, _, d in rest) / REPS / 1e6
    out["others"] = sorted({n[:60] for n, _, _ in rest})
    del graph
    return out


def binned(outs):
    """Each class's listed rays, sorted."""
    counts = outs.class_counts.tolist()
    return [torch.sort(outs.ray_list[c, :counts[c]].long()).values
            for c in range(len(shade.RAY_CLASSES))]


def backward(label, device, camera):
    build, w, h, b = PRESETS[label]
    scene = prepare_scene(build(), device)
    config = RenderConfig(width=w, height=h, max_bounces=b, ray_chunk=0)
    real = shade.bounce_backward
    calls, last = [], {}

    def recorded(saved, grad_outputs, needs=None):
        got = real(saved, grad_outputs, needs)
        calls.append(sha(*got[:3]))
        last["saved"], last["grads"] = saved, [g.contiguous() for g in grad_outputs[:4]]
        return got

    def forward(key):
        m = scene.materials
        leaves = [getattr(m, f).detach().clone().requires_grad_(True)
                  for f in shade.MATERIAL_FIELDS]
        atlas = scene.textures.buffer.detach().clone().requires_grad_(True)
        position = camera.position.detach().clone().requires_grad_(True)
        s = scene.replace(materials=m.replace(**dict(zip(shade.MATERIAL_FIELDS, leaves))),
                          textures=dataclasses.replace(scene.textures, buffer=atlas))
        loss = R.render_sample(s, camera.replace(position=position), (3, key), config).mean()
        return loss, [*leaves, atlas, position]

    shade.bounce_backward = recorded
    try:
        loss, leaves = forward(4)
        torch.autograd.grad(loss, leaves)
    finally:
        shade.bounce_backward = real
    torch.cuda.synchronize()
    eager = []
    for key in (5, 6):  # a fwd+bwd sample's backward as it runs, under torch.profiler
        loss_k, leaves = forward(key)
        torch.cuda.synchronize()
        with profiling.cuda_profile() as prof:
            torch.autograd.grad(loss_k, leaves)
            torch.cuda.synchronize()
        recs = profiling.device_records(prof)
        eager.append({"records": len(recs), "ms": sum(d for _, _, d in recs) / 1e6,
                      "bin_ms": sum(d for n, _, d in recs if "bounce_bin_kernel" in n) / 1e6,
                      "reverse_ms": sum(d for n, _, d in recs
                                        if "bounce_backward_kernel" in n) / 1e6})
    saved, grads = last["saved"], last["grads"]
    out = {"loss_sha": sha(loss.detach()), "calls": calls, "rays": int(saved.ray_o.shape[0]),
           "eager": eager}
    with torch.no_grad():
        outs = shade.bounce_bin(saved, grads)
        lists = binned(outs)
        dead = ~(saved.active & saved.hit)
        out["classes"] = [sha(x) for x in lists]
        out["counts"] = [int(x.numel()) for x in lists]
        out["pass_through_sha"] = sha(*(o[dead] for o in outs[:3]))
        out["bin"] = timed(lambda: shade.bounce_bin(saved, grads), {"bin": "bounce_bin_kernel"})
        out["backward"] = timed(lambda: shade.bounce_backward(saved, grads),
                                {"bin": "bounce_bin_kernel", "reverse": "bounce_backward_kernel"})
    return out


def table(n, device):
    src = torch.from_numpy(procedural.hero_scene(n).vertices.reshape(-1, 9)).to(device)
    dst = torch.empty((src.shape[0], ki.TRI_RECORD), dtype=torch.float32, device=device)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=device)

    def launch():
        ki._launch("tri_consts", src, src.data_ptr(), src.shape[0], dst.data_ptr())

    def cold():
        flush.fill_(1)  # out of the L2 cache: the corners, the last table
        launch()

    out = {"triangles": int(src.shape[0]), **timed(launch, {"table": "tri_consts_kernel"}),
           "cold_own_ms": timed(cold, {"table": "tri_consts_kernel"})["table_own_ms"]}
    torch.cuda.synchronize()
    out["sha"] = sha(dst.view(torch.int32))
    return out


def main():
    device = torch.device("cuda", 0)
    camera = Camera.create(EYE, pitch=PITCH, fov=np.pi / 2, device=device)
    out = {"package": R.__file__,
           "backward": {label: backward(label, device, camera) for label in PRESETS},
           "tables": {label: table(n, device) for label, n in TABLES.items()}}
    print(json.dumps(out), flush=True)


main()
'''

BUILD = ("from isaklm_raytracer_tpu_torch.kernels import build, intersect as ki; "
         "build.build_all(ki.SOURCES)")


def run_child(tree: Path, script: str) -> dict:
    env = {**os.environ, "PYTHONPATH": str(tree),
           "COMPARE_PROFILING": str(REPO / "isaklm_raytracer_tpu_torch" / "tools" / "profiling.py")}
    proc = subprocess.run([sys.executable, script], cwd=tree, env=env, capture_output=True,
                          text=True, timeout=1200)
    if proc.returncode:
        raise RuntimeError(f"the child in {tree} failed:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    if Path(result["package"]).resolve().parents[1] != tree / "isaklm_raytracer_tpu_torch":
        raise RuntimeError(f"the child in {tree} imported {result['package']}")
    return result


def digests(run: dict) -> dict:
    """What must be equal in every run."""
    out = {f"{k} tri_consts": v["sha"] for k, v in run["tables"].items()}
    for label, b in run["backward"].items():
        out.update({f"{label} loss": b["loss_sha"], f"{label} calls": tuple(b["calls"]),
                    f"{label} classes": tuple(b["classes"]),
                    f"{label} pass-through": b["pass_through_sha"]})
    return out


def line(label: str, tree: Path, run: dict, card: str) -> str:
    parts = []
    for preset, b in run["backward"].items():
        bn, bw = b["bin"], b["backward"]
        parts.append(
            f"{preset} bounce 0 ({b['rays']} rays, classes {b['counts']}): bounce_bin "
            f"{bn['ms']:.5f} ms a call (own {bn['bin_own_ms']:.5f}, other records "
            f"{bn['others_ms']:.5f}: {bn['others']}), bounce_backward {bw['ms']:.5f} ms a call "
            f"(binning {bw['bin_own_ms']:.5f}, reverse {bw['reverse_own_ms']:.5f}, other records "
            f"{bw['others_ms']:.5f}); a sample's backward as it runs: " + ", ".join(
                f"{e['records']} records {e['ms']:.4f} ms (binning {e['bin_ms']:.4f}, reverse "
                f"{e['reverse_ms']:.4f})" for e in b["eager"]))
    for name, t in run["tables"].items():
        parts.append(f"tri_consts {name} ({t['triangles']} triangles) {t['ms']:.5f} ms a call "
                     f"(own {t['table_own_ms']:.5f}; after a 128 MiB write, the L2 cache cold, "
                     f"own {t['cold_own_ms']:.5f})")
    return f"{label} ({tree}) [{card}]: " + "; ".join(parts)


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
    with tempfile.TemporaryDirectory(prefix="compare_kernel_times_") as tmp:
        script = os.path.join(tmp, "child.py")
        with open(script, "w") as f:
            f.write(CHILD)
        for label, tree in (("other", other), ("this", REPO), ("this", REPO), ("other", other)):
            r = run_child(tree, script)
            r["tree"] = label
            runs.append(r)
            print(line(label, tree, r, card), flush=True)
    first = digests(runs[0])
    differ = sorted({k for r in runs for k, v in digests(r).items() if first.get(k) != v})
    print("digests (tables, losses, every backward call's per-ray gradients, each class's rays, "
          "the pass-through): " + ("equal in all four runs" if not differ else f"DIFFER: {differ}"),
          flush=True)
    print(card, flush=True)
    print(json.dumps(runs), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
