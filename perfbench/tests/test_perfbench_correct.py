"""``correct`` on tiny CPU cells: true for the program, false for the
lower-precision control, and false with each planted fault; a run whose
rank loads JAX is refused."""

import importlib
import json
import time

import pytest
import torch

import tiny
from perfbench import core, faults

BENCH = core.load_benchmark()
WORKLOADS = BENCH["workloads"]
CELLS = tuple(w["name"] for w in WORKLOADS if w["chips"] == 1)
# cells of several ranks, each a spawned process: one test a cell, so that no
# two of their launches run at once
RANKED = tuple(w["name"] for w in WORKLOADS if w["chips"] > 1)


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct_and_control_is_not(name):
    bench = core.load_benchmark()
    ctx = tiny.context(name, bench=bench)
    driver = importlib.import_module(f"perfbench.drivers.{ctx.traffic['driver']}")
    cell = driver.Cell(ctx)
    cell.window(ctx.seconds, time.perf_counter())
    cell.release()
    assert all(c.ok for c in cell.check())
    control = driver.control(cell)
    assert not all(c.ok for c in control), control


def _driver(name: str) -> str:
    return core.load_cell(BENCH, name)[2]["driver"]


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS for f in faults.of(_driver(n))])
def test_a_planted_fault_is_not_correct(name, fault):
    bench = core.load_benchmark()
    ctx = tiny.context(name, bench=bench)
    with faults.planted(fault, ctx):
        result, checks = core.run(ctx, bench, time.perf_counter())
    assert result["correct"] is False, (fault, result["checks"])


@pytest.mark.parametrize("name", RANKED)
def test_a_ranked_cell_is_correct_and_its_control_and_faults_are_not(name):
    """The same for a cell whose ranks are spawned processes (gloo ranks
    on the CPU), the faults planted in the ranks."""
    test_program_is_correct_and_control_is_not(name)
    bench = core.load_benchmark()
    driver = importlib.import_module(
        f"perfbench.drivers.{tiny.context(name, bench=bench).traffic['driver']}")
    for fault in faults.of(_driver(name)):
        cell = driver.Cell(tiny.context(name, bench=bench), fault)
        cell.window(1.0, time.perf_counter())
        assert not all(c.ok for c in cell.check()), fault


@pytest.mark.parametrize("name", RANKED)
def test_a_run_whose_rank_loads_jax_is_refused(name, monkeypatch, capsys):
    """A module named jax loaded in a spawned rank (not in the harness's
    own process): ``main`` exits non-zero and prints no result."""
    ctx = tiny.context(name)
    driver = importlib.import_module(f"perfbench.drivers.{ctx.traffic['driver']}")
    init = driver.Cell.__init__
    monkeypatch.setattr(core, "load_cell", lambda bench, w: (ctx.cell, ctx.config, ctx.traffic))
    monkeypatch.setattr(core, "device_of", lambda chips: torch.device("cpu"))
    monkeypatch.setattr(driver.Cell, "__init__",
                        lambda self, c, fault=None: init(self, c, "loads_jax"))
    rc = core.main(["--workload", name, "--seed", str(tiny.SEED), "--seconds", "1",
                    "--trace", "0"], time.perf_counter())
    out, err = capsys.readouterr()
    assert rc != 0 and out == "", out
    assert "jax" in err and "rank" in err, err
    assert not core.forbidden_modules()


def test_the_train_check_reads_replayed_steps():
    """The steps the train check holds to the reference are the window's
    first, after the set-up's eager call, capture and replay."""
    ctx = tiny.context("demo-train")
    driver = importlib.import_module("perfbench.drivers.train")
    cell = driver.Cell(ctx)
    warm = cell.calls
    cell.window(ctx.seconds, time.perf_counter())
    cell.release()
    assert warm == driver.WARMUP_STEPS == 3
    assert cell.out["first"] == warm and len(cell.out["losses"]) == ctx.traffic["checked_steps"]
    assert all(c.ok for c in cell.check())
    json.dumps(cell.out["losses"])


@pytest.mark.cuda
def test_a_run_on_the_card(card):
    """One short run of the demo's train cell on the card."""
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "demo-train",
                           "--seed", "5", "--seconds", "2", "--trace", "0"],
                          capture_output=True, text=True, cwd=core.ROOT, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert '"correct": true' in proc.stdout.splitlines()[-1]
