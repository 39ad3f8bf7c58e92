"""BENCHMARK.json's shape, discovery by name, the result's last line, and
the modules the benchmark loads."""

import json
import re
import shutil
import subprocess
import sys

import pytest

import tiny
from perfbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return core.load_benchmark()


def test_benchmark_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in bench[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    for text in [c["why"] for c in bench["configs"]] + [w["why"] for w in bench["workloads"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    assert layers <= {"device", "step graphs", "intersector kernels",
                      "shading and sampler kernels", "backward kernels", "collectives"}
    for w in bench["workloads"]:
        e2e = {m["name"] for m in core.cell_metrics(bench, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        per_layer = core.cell_metrics(bench, w["name"], "per_layer")
        assert per_layer, w["name"]
        for m in per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_discovery_by_name(bench):
    for w in bench["workloads"]:
        cell, config, traffic = core.load_cell(bench, w["name"])
        assert cell is w and config["width"] > 0 and traffic["driver"]
    for m in bench["per_layer"]:
        assert callable(core.load_reader(m["name"]))
    for c in bench["configs"]:
        assert c["file"].startswith("perfbench/configs/")


def test_a_cell_is_added_by_files_and_an_entry(tmp_path, bench):
    """A new configuration, mix and metric go in as new files and new
    entries of BENCHMARK.json; no file of the harness changes."""
    shutil.copytree(core.PACKAGE, tmp_path / "perfbench")
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    demo = json.loads((core.ROOT / "perfbench/configs/demo-512.json").read_text())
    (tmp_path / "perfbench/configs/demo-64.json").write_text(json.dumps({**demo, "width": 64}))
    mix = json.loads((core.ROOT / "perfbench/traffic/adaptive.json").read_text())
    (tmp_path / "perfbench/traffic/adaptive-small.json").write_text(json.dumps(mix))
    (tmp_path / "perfbench/metrics/steps_traced.py").write_text(
        "def read(summary):\n    return float(summary.steps) or None\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "demo-64", "source": "x", "file":
                           "perfbench/configs/demo-64.json", "reduced": ["width"], "why": "x"})
    new["workloads"].append({"name": "demo64-adaptive", "config": "demo-64",
                             "traffic": "adaptive-small", "chips": 1, "why": "x"})
    new["end_to_end"][0]["workloads"].append("demo64-adaptive")
    new["per_layer"].append({"name": "steps_traced", "unit": "steps", "better": "higher",
                             "source": "device_trace", "layer": "device",
                             "moves": "rays_per_s", "workloads": ["demo64-adaptive"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    loaded = core.load_benchmark(tmp_path)
    cell, config, traffic = core.load_cell(loaded, "demo64-adaptive", tmp_path)
    assert config["width"] == 64 and traffic["driver"] == "offline"
    assert [m["name"] for m in core.cell_metrics(loaded, "demo64-adaptive", "per_layer")] == \
        ["steps_traced"]
    read = core.load_reader("steps_traced", tmp_path)
    assert read(type("S", (), {"steps": 3})()) == 3.0
    for path, data in before.items():
        assert path.read_bytes() == data


def test_last_line_shape():
    result, checks = tiny.run("demo-train")
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"train_step_ms", "setup_s"}
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"] in ("ms", "s")
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert {c.name for c in checks} == set(result["checks"])
    json.loads(json.dumps(result))


def test_main_without_a_card_prints_no_result():
    """No card: a non-zero exit and nothing on standard output."""
    proc = subprocess.run([sys.executable, str(core.PACKAGE / "run.py"), "--workload",
                           "demo-train", "--seed", "3", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=core.ROOT, timeout=120,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout == ""
    assert "card" in proc.stderr


def test_main_refuses_a_tree_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files
    has no program to run: a non-zero exit and no result."""
    shutil.copytree(core.PACKAGE, tmp_path / "perfbench")
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "demo-train",
                           "--seed", "3", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_no_module_of_jax_or_the_jax_package():
    """Everything the benchmark imports, with the port and the reference,
    leaves no module named jax, jaxlib, flax or isaklm_raytracer_tpu
    (the part before the first dot, compared whole)."""
    code = ("import sys; sys.path.insert(0, '.');"
            "import perfbench.core, perfbench.trace, perfbench.faults, perfbench.calibrate;"
            "from perfbench.drivers import common, viewer, offline, train;"
            "import isaklm_raytracer_tpu_torch.viewer, isaklm_raytracer_tpu_torch.dist.sharding;"
            "import isaklm_raytracer_tpu_torch.integrator.render;"
            "print(perfbench.core.forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=core.ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
    assert core.forbidden_modules(["isaklm_raytracer_tpu_torch.viewer", "jaxtyping"]) == []
    assert core.forbidden_modules(["isaklm_raytracer_tpu.integrator", "jax.numpy"]) == \
        ["isaklm_raytracer_tpu", "jax"]


def test_nothing_reads_the_jax_bench():
    for path in core.PACKAGE.rglob("*.py"):
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "bench.py" not in text and "BENCH_" not in text, path


def test_run_seconds_fit_the_check():
    bench = core.load_benchmark()
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
