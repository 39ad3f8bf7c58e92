"""The harness: one run of one cell of ``BENCHMARK.json``.

``main`` finds the cell, its configuration (``configs/<name>.json``, as
``BENCHMARK.json`` names the file), its traffic mix
(``traffic/<mix>.json``, whose ``driver`` names the module of
``drivers/`` that runs it) and the readers of its per-layer metrics
(``metrics/<metric>.py``), all by name: a cell, a mix or a metric is added
by adding files and entries, never by editing one.

A run sets up (the scene, the program's objects, every shape warmed up),
measures for ``--seconds`` (``--trace 1``: under torch.profiler, for the
mix's ``trace_seconds`` at most), reads the peak memory, frees the
program's state, holds what the window produced to the plain reference,
and prints one JSON line last.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "isaklm_raytracer_tpu")


class Unfit(RuntimeError):
    """The machine cannot run the cell (no card, too few cards)."""


class Forbidden(RuntimeError):
    """A process of the run loaded JAX or the JAX package."""


@dataclasses.dataclass
class Check:
    """One number compared with the reference, beside its limit; it
    passes at or under the limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Window:
    """What a measured window did: its seconds, the units of work it
    completed (frames, images, train steps), the end-to-end metrics it
    measured, and for a traced window the steps and rays in it."""

    seconds: float
    units: int
    measures: dict
    steps: int = 0
    rays: float = 0.0


@dataclasses.dataclass
class Context:
    """What a driver is handed: the cell's entry, its configuration and
    traffic files as dicts, the seed, the window's seconds, whether it is
    traced, and the device."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path}: no BENCHMARK.json")
    return json.loads(path.read_text())


def find(entries: list, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_cell(bench: dict, workload: str, root: Path = ROOT):
    """(cell, configuration dict, traffic dict) of a workload, by name."""
    cell = find(bench["workloads"], workload, "workload")
    entry = find(bench["configs"], cell["config"], "configuration")
    config = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def cell_metrics(bench: dict, workload: str, section: str) -> list:
    """The entries of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those whose ``workloads`` list it, and those without the
    key that move (per-layer) or are (end-to-end) a metric the cell
    reports."""
    listed = [m for m in bench[section] if workload in m.get("workloads", (workload,))]
    if section == "end_to_end":
        return listed
    e2e = {m["name"] for m in cell_metrics(bench, workload, "end_to_end")}
    return [m for m in listed if "workloads" in m or m["moves"] in e2e]


def load_reader(name: str, root: Path = ROOT):
    """The ``read(summary)`` of ``metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def cache_dirs(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    base = root / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(base / sub)


def device_of(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise Unfit("torch.cuda.is_available() is False: no card")
    if torch.cuda.device_count() < chips:
        raise Unfit(f"the cell needs {chips} cards, torch sees {torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def parse(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(ctx: Context, bench: dict, t0: float):
    """Set up, measure, check: (the result's dict, the checks). On a CPU
    device (the CPU tests' tiny cells) nothing is traced and the device
    readings are left out."""
    import torch

    from perfbench import trace as tracing

    driver = importlib.import_module(f"perfbench.drivers.{ctx.traffic['driver']}")
    on_card = ctx.device.type == "cuda"
    print(f"perfbench: {time.perf_counter() - t0:.2f} s to the driver", file=sys.stderr)
    cell = driver.Cell(ctx)
    result = {}
    if ctx.trace:
        seconds = min(ctx.seconds, float(ctx.traffic.get("trace_seconds", ctx.seconds)))
        if getattr(cell, "traces_itself", False):  # a rank of its own profiles the window
            window = cell.window(seconds, t0)
            summary = cell.summary
        else:
            with tracing.cuda_profile() as prof:
                window = cell.window(seconds, t0)
            summary = tracing.summarize(tracing.device_records(prof), window.steps,
                                        window.rays, ctx.traffic["kind"], window.units)
        metrics = {}
        for m in cell_metrics(bench, ctx.cell["name"], "per_layer"):
            value = load_reader(m["name"])(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_extra = {"busy_s": summary.busy_s, "window_s": summary.window_s}
        result["breakdown"] = summary.breakdown()
    else:
        window = cell.window(ctx.seconds, t0)
        metrics, device_extra = {}, {}
        for m in cell_metrics(bench, ctx.cell["name"], "end_to_end"):
            if m["name"] not in window.measures:
                raise RuntimeError(f"the window measured no {m['name']}")
            metrics[m["name"]] = {"value": window.measures[m["name"]], "unit": m["unit"]}
    device = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if on_card:
        torch.cuda.synchronize(ctx.device)
        # a cell whose ranks are processes of their own reads their fullest card
        peak = getattr(cell, "peak", None) or torch.cuda.max_memory_allocated(ctx.device)
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": ctx.cell["chips"], "memory_peak_bytes": int(peak), **device_extra}
    cell.release()
    if on_card:
        torch.cuda.empty_cache()
    began = time.perf_counter()
    checks = cell.check()
    print(f"perfbench: the check took {time.perf_counter() - began:.1f} s", file=sys.stderr)
    correct = all(c.ok for c in checks)
    # units that failed: those the check found wrong, and those that failed
    # by themselves (a train step whose loss is not finite)
    failed = getattr(cell, "failed_steps", 0) + (0 if correct else cell.checked_units())
    result = {"correct": correct, "attempted": window.units, "failed": failed, "metrics": metrics,
              "device": device, **result,
              "checks": {c.name: {"value": c.value if math.isfinite(c.value) else None,
                                  "limit": c.limit} for c in checks}}
    return result, checks


def main(argv, t0: float) -> int:
    args = parse(argv)
    cache_dirs()
    bench = load_benchmark()
    cell, config, traffic = load_cell(bench, args.workload)
    try:
        device = device_of(cell["chips"])
    except Unfit as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(4)
    ctx = Context(cell, config, traffic, args.seed, args.seconds, bool(args.trace), device)
    try:
        result, checks = run(ctx, bench, t0)
        found = forbidden_modules()
        if found:
            raise Forbidden(f"the process loaded {found}")
    except Forbidden as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result))
    return 0
