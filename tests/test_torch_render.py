"""Port, whole slice: goldens, compacted adaptive steps, the CLI.

Golden tolerance. The committed goldens were rendered by the JAX package
under jit, where XLA on the CPU contracts multiply-adds into FMAs and
replaces 1/sqrt with an approximate rsqrt. The port rounds every operation
as written, like the JAX package's own ops run one by one -- and the JAX
package rendered op by op misses the goldens by the same amount the port
does: at most 1.48e-4 (cornell_64) and 1.23e-4 (demo_textured_64), at 3
channel values each, all others within 1e-4. So every value must be within
atol 1e-4, except at most 8 of the 12,288 values of an image, which must
be within 3e-4. The compacted and tail steps must be BIT-identical to the
masked full step, as in tests/test_render_e2e.py.
"""

import os
import struct
import subprocess
import sys
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu_torch.accel import prepare_scene
from isaklm_raytracer_tpu_torch.camera import Camera
from isaklm_raytracer_tpu_torch.cli import render as cli
from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.integrator.adaptive import needs_sample
from isaklm_raytracer_tpu_torch.accel.traverse import nearest_hit_brute
from isaklm_raytracer_tpu_torch.integrator.render import (
    compact_bucket,
    compact_step,
    make_trace_fn,
    render,
    render_step,
    resolve_image,
)
from isaklm_raytracer_tpu_torch.math import rng
from isaklm_raytracer_tpu_torch.scene import procedural
from isaklm_raytracer_tpu_torch.scene.types import GBuffer

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    # as tests/golden_cases.py
    "cornell_64": (lambda: procedural.cornell_box(glossy=True),
                   lambda: Camera.create((0.0, 0.0, -0.9), fov=np.pi / 2, device="cpu"), 4),
    "demo_textured_64": (lambda: procedural.material_demo_scene(textured=True),
                         lambda: Camera.create((0.0, 1.2, -1.8), pitch=0.15, fov=np.pi / 2,
                                                       device="cpu"), 2),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_golden_image(name):
    scene_fn, camera_fn, spp = CASES[name]
    config = RenderConfig(width=64, height=64, max_bounces=4, ray_chunk=0, min_samples=1)
    gb = render(prepare_scene(scene_fn(), "cpu"), camera_fn(), config, num_samples=spp, seed=11)
    got = resolve_image(gb, config).numpy()
    with np.load(os.path.join(GOLDEN_DIR, f"{name}.npz")) as data:
        want = data["image"]
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    assert (err > 1e-4).sum() <= 8, (err > 1e-4).sum()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-4)


@pytest.fixture(scope="module")
def cornell():
    return (
        prepare_scene(procedural.cornell_box(include_blockers=False), "cpu"),
        Camera.create((0.0, 0.0, -0.9), fov=np.pi / 2, device="cpu"),
    )


def _assert_gbuffer_equal(a: GBuffer, b: GBuffer):
    assert torch.equal(a.count, b.count)
    assert torch.equal(a.frame, b.frame)
    assert torch.equal(a.sq_luminance, b.sq_luminance)


def test_compact_step_matches_full_masked_step(cornell):
    scene, camera = cornell
    cfg = RenderConfig(width=32, height=32, max_bounces=4, min_samples=1,
                       max_samples=64, ray_chunk=128)
    gb = render(scene, camera, cfg, num_samples=2, seed=5)
    converged = np.random.default_rng(0).random(cfg.num_pixels) < 0.85
    gb.count[torch.from_numpy(converged)] = cfg.max_samples
    n_active = int((~converged).sum())
    bucket = compact_bucket(n_active, cfg.num_pixels, cfg.ray_chunk)
    assert n_active <= bucket < cfg.num_pixels  # the launch actually shrank

    key = rng.sample_key_words(9, 0)
    full = render_step(scene, camera, gb, key, cfg, adaptive=True)
    compact = compact_step(scene, camera, gb, key, cfg, bucket)
    _assert_gbuffer_equal(full, compact)


def test_tail_mode_render_matches_masked_steps(cornell):
    """render(adaptive=True) enters tail mode once the active set shrinks;
    it must match the loop of full masked steps bit for bit, for an odd
    pixel count too."""
    scene, camera = cornell
    cfg = RenderConfig(width=21, height=19, max_bounces=3, min_samples=2,
                       max_samples=64, max_tolerance=0.5, min_wavefront=16)
    steps = 12
    fast = render(scene, camera, cfg, num_samples=steps, seed=9, adaptive=True)
    ref = GBuffer.create(cfg.num_pixels)
    for i in range(steps):
        ref = render_step(scene, camera, ref, rng.sample_key_words(9, i), cfg, adaptive=True)
    _assert_gbuffer_equal(fast, ref)
    assert (fast.count < steps).any()  # tail mode engaged
    assert not needs_sample(fast, cfg).all()


def test_trace_fn_without_cluster_tables_is_cpu_only():
    """An unprepared scene gets the brute oracle on the CPU; on CUDA the pick
    raises instead of tracing outside the kernel."""
    raw = procedural.cornell_box()
    cfg = RenderConfig(width=8, height=8)
    cpu = SimpleNamespace(cbvh=None, device=torch.device("cpu"),
                          vertices=torch.as_tensor(raw.vertices))
    assert make_trace_fn(cpu, cfg).func is nearest_hit_brute
    cuda = SimpleNamespace(cbvh=None, device=torch.device("cuda", 0), vertices=None)
    with pytest.raises(ValueError, match="prepare_scene"):
        make_trace_fn(cuda, cfg)


def test_ray_chunking_does_not_change_the_image(cornell):
    scene, camera = cornell
    base = dict(width=16, height=12, max_bounces=3, min_samples=1)
    whole = render(scene, camera, RenderConfig(**base, ray_chunk=0), num_samples=2, seed=3)
    chunked = render(scene, camera, RenderConfig(**base, ray_chunk=50), num_samples=2, seed=3)
    _assert_gbuffer_equal(whole, chunked)


def _read_png(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    idat = data[data.index(b"IDAT") + 4: data.index(b"IEND") - 8]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    return rows[:, 1:].reshape(h, w, 3)


def test_cli_renders_png(tmp_path):
    out = str(tmp_path / "demo.png")
    assert cli.main([
        "--scene", "demo", "--width", "32", "--height", "32", "--max-bounces", "3",
        "--min-samples", "2", "--max-samples", "4", "--camera", "0", "1.2", "-1.8", "0", "0.15",
        "--out", out, "--device", "cpu",
    ]) == 0
    img = _read_png(out)
    assert img.shape == (32, 32, 3) and img.mean() > 5


@pytest.mark.parametrize("flags", [
    ["--devices", "2"], ["--checkpoint", "x.npz"], ["--preview"], ["--multihost"],
    ["--devices", "4"], ["--no-kd"], ["--scene", "scene.json"],
])
def test_cli_rejects_unported_flags(flags):
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main([*flags, "--width", "8", "--height", "8"])


def test_cli_without_card_raises_unless_cpu(monkeypatch, tmp_path):
    """--device cuda (the default) names the missing card instead of
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["--scene", "demo", "--width", "8", "--height", "8",
                   "--out", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax and flax unloaded, and
    the package holds no torch.compile."""
    pkg = os.path.join(REPO, "isaklm_raytracer_tpu_torch")
    modules = sorted(
        "isaklm_raytracer_tpu_torch." + os.path.relpath(os.path.join(root, f), pkg)[:-3]
        .replace(os.sep, ".").removesuffix(".__init__")
        for root, _, files in os.walk(pkg) for f in files if f.endswith(".py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m.removesuffix('.'))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "print(len(sys.modules)); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    assert "torch.compile" not in fh.read(), f
