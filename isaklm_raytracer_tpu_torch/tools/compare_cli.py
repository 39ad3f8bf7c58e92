#!/usr/bin/env python3
"""The CLI as users run it, in this checkout and in another, in turns on
one CUDA card.

Usage (from anywhere, on a machine with a CUDA card):

    python3 isaklm_raytracer_tpu_torch/tools/compare_cli.py OTHER_DIR [CLI_ARG ...]

runs ``python -m isaklm_raytracer_tpu_torch.cli.render CLI_ARG ...`` (the
CLI's defaults where no argument is given) four times in turns: OTHER_DIR,
this checkout twice, OTHER_DIR. Each run is a child process started in its
checkout, which imports that checkout's package; before the first timed run
each checkout builds its kernels in a child of its own, so no timed run
pays for nvcc. Each child reports

- ``wall_s``: seconds from the child's first line to the CLI's return
  (imports, scene build, every sample, the PNG);
- ``first_sample_s``: seconds from the child's first line to the end of
  the first progressive sample (the first call of the package's
  ``render`` is split into its first sample and the rest, the same steps
  with the same keys, so the image does not change);
- ``captures``: the CUDA graphs the run captured
  (``integrator.render.GraphStep.captures``; null where the checkout has
  no graph steps);
- ``samples``: the samples of the CLI's last progress line.

The PNGs of all runs must be byte-equal (every step of either checkout is
bit-equal to an eager step), else the tool exits 1. It prints one line per
run, the card's name and power limit as ``nvidia-smi`` gives them, and, as
its last line, the runs as JSON.
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

CHILD = r"""
import time
T0 = time.perf_counter()
import json, sys
import torch
from isaklm_raytracer_tpu_torch.cli import render as cli
from isaklm_raytracer_tpu_torch.integrator import render as R

first = {}
real_render = R.render


def render(scene, camera, config, num_samples, seed=0, adaptive=False, gbuffer=None,
           sample_offset=0):
    if first:
        return real_render(scene, camera, config, num_samples, seed, adaptive, gbuffer,
                           sample_offset)
    gbuffer = real_render(scene, camera, config, 1, seed, adaptive, gbuffer, sample_offset)
    if gbuffer.frame.is_cuda:
        torch.cuda.synchronize()
    first["s"] = time.perf_counter() - T0
    if num_samples == 1:
        return gbuffer
    return real_render(scene, camera, config, num_samples - 1, seed, adaptive, gbuffer,
                       sample_offset + 1)


R.render = render
rc = cli.main(sys.argv[1:])
if torch.cuda.is_available():
    torch.cuda.synchronize()
wall = time.perf_counter() - T0
graph_step = getattr(R, "GraphStep", None)
print(json.dumps({"rc": rc, "wall_s": wall, "first_sample_s": first.get("s"),
                  "captures": None if graph_step is None else graph_step.captures,
                  "package": R.__file__}), flush=True)
"""

BUILD = ("from isaklm_raytracer_tpu_torch.kernels import build, intersect as ki; "
         "build.build_all(ki.SOURCES)")


def run_child(tree: Path, args, out: str) -> dict:
    env = {**os.environ, "PYTHONPATH": str(tree)}
    proc = subprocess.run([sys.executable, "-c", CHILD, *args, "--out", out], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=3000)
    if proc.returncode:
        raise RuntimeError(f"the CLI in {tree} failed:\n{proc.stdout[-4000:]}\n"
                           f"{proc.stderr[-4000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    if Path(result["package"]).resolve().parents[1] != tree / "isaklm_raytracer_tpu_torch":
        raise RuntimeError(f"the child in {tree} imported {result['package']}")
    progress = [line for line in proc.stderr.splitlines() if line.startswith("sample ")]
    result["samples"] = progress[-1].split()[1].rstrip(":") if progress else None
    result["last_progress"] = progress[-1] if progress else None
    with open(out, "rb") as f:
        result["png"] = f.read()
    return result


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other, args = Path(argv[1]).resolve(), argv[2:]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    for tree in (other, REPO):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", BUILD], cwd=tree, check=True, timeout=900,
                       env={**os.environ, "PYTHONPATH": str(tree)})
        print(f"kernels of {tree} built in {time.perf_counter() - t0:.1f} s", flush=True)
    runs = []
    with tempfile.TemporaryDirectory(prefix="compare_cli_") as tmp:
        for i, (label, tree) in enumerate((("other", other), ("this", REPO), ("this", REPO),
                                           ("other", other))):
            r = run_child(tree, args, os.path.join(tmp, f"run{i}.png"))
            r["tree"] = label
            runs.append(r)
            print(f"{label} ({tree}): wall {r['wall_s']:.2f} s, first sample at "
                  f"{r['first_sample_s']:.2f} s, {r['samples']} samples, captures "
                  f"{r['captures']}; {r['last_progress']} [{card}]", flush=True)
    same = len({r.pop("png") for r in runs}) == 1
    print(f"PNGs of the four runs {'byte-equal' if same else 'DIFFER'}; CLI arguments "
          f"{args or '(the defaults)'}", flush=True)
    print(card, flush=True)
    print(json.dumps(runs), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
