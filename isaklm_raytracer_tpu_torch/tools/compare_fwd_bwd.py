#!/usr/bin/env python3
"""bench.py's fwd+bwd step in this checkout and in another, in many turns on
one CUDA card.

Usage (from anywhere, on a machine with a CUDA card):

    python3 isaklm_raytracer_tpu_torch/tools/compare_fwd_bwd.py OTHER_DIR [PAIRS [SAMPLES]]

runs 2 x PAIRS child processes, in the order other, this, this, other,
other, this, ... (PAIRS defaults to 5). Each child is started in its
checkout and imports that checkout's package (the kernels are built first,
in a child of each checkout, so no timed run pays for nvcc). On the JAX
bench's presets, demo (512x512, 8 bounces) and the 2M-triangle hero
(640x360, 6 bounces), with the bench camera, in one pass (``ray_chunk``
0), a child times SAMPLES (default 10) fwd+bwd samples one by one (loss =
mean(render_sample), leaf = the material albedo; bench.py:329-345) after
two warm-up samples, each ended by ``torch.cuda.synchronize()``, and
reports each sample's seconds and the SHA-256 of the losses. The losses'
digests must be equal in every child of both checkouts, else the tool exits
1. It prints each child's line, then for each preset each checkout's
median s/sample over its children (the median of each child's median),
their quartiles, and how many pairs each checkout won, the card's name and
power limit as ``nvidia-smi`` gives them, and, as its last line, the runs
as JSON.

It measures a host-bound step: time on the host's clock, which moves more
than device time between calls, so only children of one call compare.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

CHILD = r'''
import hashlib
import json
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

EYE, PITCH = (0.0, 1.2, -1.8), 0.15  # bench.py's camera
PRESETS = {"demo": (procedural.material_demo_scene, 512, 512, 8),
           "hero": (procedural.hero_scene, 640, 360, 6)}


def main(samples):
    device = torch.device("cuda", 0)
    camera = Camera.create(EYE, pitch=PITCH, fov=np.pi / 2, device=device)
    out = {"package": R.__file__, "presets": {}}
    for label, (build, w, h, b) in PRESETS.items():
        scene = prepare_scene(build(), device)
        config = RenderConfig(width=w, height=h, max_bounces=b, ray_chunk=0)

        def one(i):
            leaf = scene.materials.albedo.detach().clone().requires_grad_(True)
            s = scene.replace(materials=scene.materials.replace(albedo=leaf))
            loss = R.render_sample(s, camera, rng.sample_key_words(0, i), config).mean()
            torch.autograd.grad(loss, leaf)
            torch.cuda.synchronize()
            return loss.detach()

        for i in range(2):
            one(i)
        seconds, losses = [], []
        for i in range(2, 2 + samples):
            t0 = time.perf_counter()
            losses.append(one(i))
            seconds.append(time.perf_counter() - t0)
        digest = hashlib.sha256(torch.stack(losses).cpu().numpy().tobytes()).hexdigest()[:16]
        out["presets"][label] = {"seconds": seconds, "loss_sha": digest}
        del scene
    print(json.dumps(out), flush=True)


main(int(sys.argv[1]))
'''

BUILD = ("from isaklm_raytracer_tpu_torch.kernels import build, intersect as ki; "
         "build.build_all(ki.SOURCES)")


def run_child(tree: Path, script: str, samples: int) -> dict:
    proc = subprocess.run([sys.executable, script, str(samples)], cwd=tree,
                          env={**os.environ, "PYTHONPATH": str(tree)}, capture_output=True,
                          text=True, timeout=1200)
    if proc.returncode:
        raise RuntimeError(f"the child in {tree} failed:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    if Path(result["package"]).resolve().parents[1] != tree / "isaklm_raytracer_tpu_torch":
        raise RuntimeError(f"the child in {tree} imported {result['package']}")
    return result


def quartiles(xs) -> tuple:
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else [xs[0]] * 3
    return q[0], q[2]


def main(argv) -> int:
    if len(argv) not in (2, 3, 4):
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(argv[1]).resolve()
    pairs = int(argv[2]) if len(argv) > 2 else 5
    samples = int(argv[3]) if len(argv) > 3 else 10
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    for tree in (other, REPO):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", BUILD], cwd=tree, check=True, timeout=900,
                       env={**os.environ, "PYTHONPATH": str(tree)})
        print(f"kernels of {tree} built in {time.perf_counter() - t0:.1f} s", flush=True)
    order = [("other", other), ("this", REPO), ("this", REPO), ("other", other)]
    runs = []
    with tempfile.TemporaryDirectory(prefix="compare_fwd_bwd_") as tmp:
        script = os.path.join(tmp, "child.py")
        with open(script, "w") as f:
            f.write(CHILD)
        for k in range(2 * pairs):
            label, tree = order[k % 4]
            r = run_child(tree, script, samples)
            r["tree"] = label
            runs.append(r)
            print(f"{label} ({tree}) [{card}]: " + "; ".join(
                f"{p} fwd+bwd median {statistics.median(v['seconds']):.4f} s/sample (min "
                f"{min(v['seconds']):.4f}, max {max(v['seconds']):.4f}), losses {v['loss_sha']}"
                for p, v in r["presets"].items()), flush=True)
    same = True
    for preset in runs[0]["presets"]:
        medians = {t: [statistics.median(r["presets"][preset]["seconds"]) for r in runs
                       if r["tree"] == t] for t in ("other", "this")}
        wins = sum(a < b for a, b in zip(medians["this"], medians["other"]))
        digests = {r["presets"][preset]["loss_sha"] for r in runs}
        same = same and len(digests) == 1
        print(f"{preset}: fwd+bwd s/sample, the median of {pairs} children's medians: this "
              f"{statistics.median(medians['this']):.4f} (quartiles "
              "{:.4f}-{:.4f}), other {:.4f} (quartiles {:.4f}-{:.4f}); this faster in {} of {} "
              "pairs (the k-th child of each checkout); losses {} [{}]".format(
                  *quartiles(medians["this"]), statistics.median(medians["other"]),
                  *quartiles(medians["other"]), wins, pairs,
                  "equal in every child" if len(digests) == 1 else f"DIFFER: {digests}", card),
              flush=True)
    print(card, flush=True)
    print(json.dumps(runs), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
