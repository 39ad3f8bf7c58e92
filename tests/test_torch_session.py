"""Port parity: checkpoint/resume, the CLI's checkpoint loop, camera
movement, the interactive session and the terminal preview.

Tolerances. The port adds the same numbers in the same order whether a
render runs straight through or stops, saves and resumes, and whether a
session or ``render`` draws the samples, so those are held BIT for bit
(G-buffers, PNG bytes); the JAX test allows 1e-5 (tests/test_io_cli.py).
Checkpoint files, their keys and the leaves each package loads from the
other's file are EXACT. Images the JAX package renders are held to the
golden tolerance of tests/test_torch_render.py (every value within 1e-4
but at most 8, which stay within 3e-4: jitted XLA contracts FMAs). Camera
poses after a move are within 1e-6 of JAX's (``rotation_matrix``, torch
against XLA, tests/test_torch_math.py); the terminal frames are exact.
"""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu.camera import Camera as JCamera
from isaklm_raytracer_tpu.camera.camera import camera_movement as jcamera_movement
from isaklm_raytracer_tpu.cli import preview as jpreview
from isaklm_raytracer_tpu.config import RenderConfig as JRenderConfig
from isaklm_raytracer_tpu.integrator.render import render as jrender
from isaklm_raytracer_tpu.integrator.render import resolve_image as jresolve_image
from isaklm_raytracer_tpu.io import checkpoint as jcheckpoint
from isaklm_raytracer_tpu.scene.procedural import cornell_box as jcornell_box
from isaklm_raytracer_tpu.scene.types import GBuffer as JGBuffer
from isaklm_raytracer_tpu.viewer import InteractiveSession as JInteractiveSession
from isaklm_raytracer_tpu_torch import interop
from isaklm_raytracer_tpu_torch.accel import prepare_scene
from isaklm_raytracer_tpu_torch.camera import Camera
from isaklm_raytracer_tpu_torch.camera.camera import camera_movement
from isaklm_raytracer_tpu_torch.cli import preview
from isaklm_raytracer_tpu_torch.cli import render as cli
from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.integrator import render as integ_render
from isaklm_raytracer_tpu_torch.integrator.render import render, resolve_image
from isaklm_raytracer_tpu_torch.io.checkpoint import (
    FORMAT_VERSION,
    load_checkpoint,
    save_checkpoint,
)
from isaklm_raytracer_tpu_torch.scene.procedural import cornell_box
from isaklm_raytracer_tpu_torch.viewer import InteractiveSession

torch.set_num_threads(1)  # the test workers share the host's cores

FIELDS = dict(width=16, height=16, max_bounces=3, min_samples=1, max_samples=8)
CONFIG = RenderConfig(**FIELDS)
GOLDEN_ATOL, GOLDEN_OUTLIERS, GOLDEN_MAX = 1e-4, 8, 3e-4
POSE_ATOL = 1e-6
EYE = (0.0, 0.0, -0.9)
CLI_ARGS = ["--scene", "cornell", "--device", "cpu", "--width", "12", "--height", "12",
            "--max-bounces", "3", "--min-samples", "2", "--max-tolerance", "0.3",
            "--camera", "0", "0", "-0.9", "0", "0", "--aperture", "0"]


@pytest.fixture(scope="module")
def scene():
    return prepare_scene(cornell_box(include_blockers=False), "cpu")


def _camera(**kwargs):
    return Camera.create(EYE, fov=np.pi / 2, device="cpu", **kwargs)


def _gbuffer_equal(got, want):
    for k in ("frame", "sq_luminance", "count"):
        np.testing.assert_array_equal(np.asarray(interop._np(getattr(got, k))),
                                      np.asarray(interop._np(getattr(want, k))), err_msg=k)


def _golden_close(got, want):
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert np.isfinite(got).all()
    assert (err > GOLDEN_ATOL).sum() <= GOLDEN_OUTLIERS and err.max() <= GOLDEN_MAX, (
        err.max(), int((err > GOLDEN_ATOL).sum()))


# ---------------------------------------------------------------------------
# io/checkpoint
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("adaptive", [False, True], ids=["full", "adaptive"])
def test_checkpoint_resume_exact(tmp_path, scene, adaptive):
    """6 samples straight = 3 + save + load + 3, bit for bit; under the
    adaptive gate too, which must engage (uneven counts)."""
    config = RenderConfig(**{**FIELDS, "min_samples": 2, "max_tolerance": 0.3})
    camera = _camera()
    gb_full = render(scene, camera, config, num_samples=6, seed=3, adaptive=adaptive)
    gb_a = render(scene, camera, config, num_samples=3, seed=3, adaptive=adaptive)
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, gb_a, camera, seed=3, next_sample=3)
    gb_b, cam_b, seed_b, next_b = load_checkpoint(path, "cpu")
    assert (seed_b, next_b) == (3, 3)
    assert cam_b.position.device.type == "cpu" and gb_b.frame.device.type == "cpu"
    gb_resumed = render(scene, cam_b, config, num_samples=3, seed=seed_b, gbuffer=gb_b,
                        sample_offset=next_b, adaptive=adaptive)
    _gbuffer_equal(gb_resumed, gb_full)
    counts = gb_full.count.numpy()
    assert (counts.min() < counts.max()) == adaptive and counts.max() == 6


def test_checkpoint_file_matches_jax(tmp_path):
    """The same state saved by each package gives the same keys, arrays and
    meta (FORMAT_VERSION 1)."""
    rng = np.random.default_rng(8)
    leaves = {"frame": rng.random((256, 3)).astype(np.float32),
              "sq_luminance": rng.random(256).astype(np.float32),
              "count": rng.integers(0, 9, 256).astype(np.int32)}
    cam = dict(position=(0.25, -1.5, 2.0), yaw=0.3, pitch=-0.2, fov=1.1, aperture_radius=0.01)
    save_checkpoint(str(tmp_path / "p.npz"), interop.gbuffer_from_numpy(**leaves, device="cpu"),
                    Camera.create(**cam, device="cpu"), seed=5, next_sample=17)
    jcheckpoint.save_checkpoint(
        str(tmp_path / "j.npz"), JGBuffer(**{k: jnp.asarray(v) for k, v in leaves.items()}),
        JCamera.create(cam["position"], cam["yaw"], cam["pitch"], cam["fov"],
                       cam["aperture_radius"]), seed=5, next_sample=17)
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
        assert sorted(p.files) == sorted(j.files) == sorted(
            ["frame", "sq_luminance", "count", "camera_position", "camera_scalars", "meta"])
        for k in p.files:
            assert p[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)
    assert FORMAT_VERSION == jcheckpoint.FORMAT_VERSION == 1
    assert not list(tmp_path.glob("*.tmp.npz"))  # the atomic rename left nothing


def test_jax_checkpoint_loads_in_port_and_continues(tmp_path, scene):
    """The port renders 3 samples, the JAX package saves that state, the port
    loads it (every leaf exact) and continues to its straight-through
    G-buffer bit for bit."""
    camera = _camera(yaw=0.1)
    gb_full = render(scene, camera, CONFIG, num_samples=6, seed=4)
    gb_a = render(scene, camera, CONFIG, num_samples=3, seed=4)
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save_checkpoint(
        path, JGBuffer(**{k: jnp.asarray(v) for k, v in interop.gbuffer_to_numpy(gb_a).items()}),
        JCamera.create(EYE, 0.1, 0.0, np.pi / 2, 0.0), seed=4, next_sample=3)
    gb_b, cam_b, seed_b, next_b = load_checkpoint(path, "cpu")
    _gbuffer_equal(gb_b, gb_a)
    for k, v in interop.camera_to_numpy(camera).items():
        np.testing.assert_array_equal(interop.camera_to_numpy(cam_b)[k], v, err_msg=k)
    gb = render(scene, cam_b, CONFIG, num_samples=3, seed=seed_b, gbuffer=gb_b,
                sample_offset=next_b)
    _gbuffer_equal(gb, gb_full)


def test_port_checkpoint_loads_in_jax_and_continues(tmp_path, scene):
    """The port saves after 3 samples; the JAX package loads every leaf
    exactly and continues 3 samples to an image within the golden
    tolerance of the port's straight-through render."""
    camera = _camera()
    gb_full = render(scene, camera, CONFIG, num_samples=6, seed=3)
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, render(scene, camera, CONFIG, num_samples=3, seed=3), camera,
                    seed=3, next_sample=3)
    gb_b, cam_b, seed_b, next_b = jcheckpoint.load_checkpoint(path)
    port_gb, _, _, _ = load_checkpoint(path, "cpu")
    _gbuffer_equal(gb_b, port_gb)
    np.testing.assert_array_equal(np.asarray(cam_b.position), np.float32(EYE))
    jconfig = JRenderConfig(**FIELDS)
    gb = jrender(jcornell_box(include_blockers=False), cam_b, jconfig, num_samples=3,
                 seed=seed_b, gbuffer=gb_b, sample_offset=next_b)
    np.testing.assert_array_equal(np.asarray(gb.count), gb_full.count.numpy())
    _golden_close(np.asarray(jresolve_image(gb, jconfig)), resolve_image(gb_full, CONFIG))


def test_load_checkpoint_without_card_raises_unless_cpu(tmp_path, monkeypatch):
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, interop.gbuffer_from_numpy(np.zeros((4, 3)), np.zeros(4),
                                                     np.zeros(4), device="cpu"),
                    _camera(), seed=0, next_sample=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        load_checkpoint(path)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none.npz"), "cpu")


# ---------------------------------------------------------------------------
# cli/render: --checkpoint, --checkpoint-every, the retry loop
# ---------------------------------------------------------------------------


def _cli(tmp_path, name, *flags):
    out = str(tmp_path / f"{name}.png")
    assert cli.main([*CLI_ARGS, *flags, "--out", out]) == 0
    with open(out, "rb") as f:
        return f.read()


@pytest.mark.parametrize("adaptive", [False, True], ids=["no_adaptive", "adaptive"])
def test_cli_checkpoint_resume_bit_equal(tmp_path, adaptive, capsys):
    """8 samples straight = 4, stop, resume to 8 on the same checkpoint file:
    the PNG and the saved G-buffer bit for bit."""
    flags = [] if adaptive else ["--no-adaptive"]
    straight_ck, split_ck = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    straight = _cli(tmp_path, "straight", *flags, "--max-samples", "8",
                    "--checkpoint", straight_ck)
    _cli(tmp_path, "half", *flags, "--max-samples", "4", "--checkpoint", split_ck)
    assert "resumed" not in capsys.readouterr().err
    resumed = _cli(tmp_path, "resumed", *flags, "--max-samples", "8", "--checkpoint", split_ck)
    assert "resumed at sample 4" in capsys.readouterr().err
    assert resumed == straight
    a, b = load_checkpoint(straight_ck, "cpu"), load_checkpoint(split_ck, "cpu")
    _gbuffer_equal(b[0], a[0])
    assert a[3] == b[3] == 8
    counts = a[0].count.numpy()
    assert (counts.min() < counts.max()) == adaptive


def test_cli_batch_failure_recovers_from_checkpoint(tmp_path, monkeypatch, capsys):
    """A fault mid-batch loses at most one checkpoint batch: the CLI reloads
    the last atomic checkpoint, retries, and writes the image of a run
    without the fault, byte for byte."""
    straight = _cli(tmp_path, "straight", "--no-adaptive", "--max-samples", "6")
    real_render = integ_render.render
    calls = {"n": 0}

    def flaky_render(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:  # the second batch dies mid-flight
            raise RuntimeError("injected device fault")
        return real_render(*a, **kw)

    monkeypatch.setattr(integ_render, "render", flaky_render)
    recovered = _cli(tmp_path, "recovered", "--no-adaptive", "--max-samples", "6",
                     "--checkpoint-every", "2", "--checkpoint", str(tmp_path / "ck.npz"))
    assert calls["n"] == 4  # 3 good batches + the injected failure
    assert "injected device fault" in capsys.readouterr().err
    assert recovered == straight


def test_cli_batch_failure_without_checkpoint_raises(tmp_path, monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(integ_render, "render", broken)
    with pytest.raises(RuntimeError, match="injected"):
        _cli(tmp_path, "x", "--max-samples", "2")


# ---------------------------------------------------------------------------
# camera_movement, viewer.InteractiveSession
# ---------------------------------------------------------------------------


def test_interactive_session_reset_on_input(scene):
    """Two steps, a move (accumulation restarts), two steps: the image equals
    ``render`` of two samples from the moved camera bit for bit."""
    sess = InteractiveSession(scene, _camera(), CONFIG, adaptive=False)
    sess.step()
    sess.step()
    assert sess.sample_count == 2 and int(sess.gbuffer.count.max()) == 2
    assert sess.handle_input({"w"}, time_step=0.1)
    assert sess.sample_count == 0 and int(sess.gbuffer.count.max()) == 0
    assert float(sess.camera.position[2]) > EYE[2]  # moved forward
    img = sess.run(max_samples=2)
    assert sess.sample_count == 2 and img.shape == (16, 16, 3)
    gb = render(scene, sess.camera, CONFIG, num_samples=2, adaptive=False)
    np.testing.assert_array_equal(img, resolve_image(gb, CONFIG).numpy())
    _gbuffer_equal(sess.gbuffer, gb)


def test_session_matches_jax(scene):
    """The same inputs through both packages' sessions: the moved pose within
    POSE_ATOL, the image within the golden tolerance."""
    jsess = JInteractiveSession(jcornell_box(include_blockers=False),
                                JCamera.create(EYE, fov=jnp.pi / 2), JRenderConfig(**FIELDS),
                                adaptive=False)
    sess = InteractiveSession(scene, _camera(), CONFIG, adaptive=False)
    for s in (jsess, sess):
        s.step()
        assert s.handle_input(["d", "up"], 0.25)
        s.step()
        assert s.handle_input(["space"], 0.5)
        s.step()
        s.step()
        assert s.sample_count == 2
    for k, v in interop.camera_to_numpy(jsess.camera).items():
        np.testing.assert_allclose(interop.camera_to_numpy(sess.camera)[k], v, rtol=0,
                                   atol=POSE_ATOL, err_msg=k)
    _golden_close(sess.image(), jsess.image())


def test_session_adaptive_converges_and_saves(scene, tmp_path):
    config = RenderConfig(**{**FIELDS, "min_samples": 2, "max_tolerance": 0.5})
    sess = InteractiveSession(scene, _camera(), config, seed=1, adaptive=True)
    img = sess.run(max_samples=64, save_path=str(tmp_path / "s.png"))
    assert sess.converged() and sess.sample_count < 64
    assert os.path.exists(tmp_path / "s.png") and np.isfinite(img).all()


def test_every_preview_binding_moves_the_camera():
    """Every key byte of cli.preview._KEYMAP maps to a name camera_movement
    acts on, moving the pose as the JAX package's does (POSE_ATOL)."""
    assert preview._KEYMAP == jpreview._KEYMAP
    camera = Camera.create((0.3, 0.4, -0.9), yaw=0.2, pitch=0.1, device="cpu")
    jcamera = JCamera.create((0.3, 0.4, -0.9), yaw=0.2, pitch=0.1)
    for byte, name in preview._KEYMAP.items():
        cam2, moved = camera_movement(camera, {name}, time_step=0.25)
        jcam2, jmoved = jcamera_movement(jcamera, {name}, time_step=0.25)
        assert moved and jmoved, f"binding {byte!r} -> {name!r} did not register"
        d_pos = float((cam2.position - camera.position).abs().max())
        d_rot = abs(float(cam2.yaw - camera.yaw)) + abs(float(cam2.pitch - camera.pitch))
        assert d_pos > 0 or d_rot > 0, f"binding {byte!r} -> {name!r} changed nothing"
        for k, v in interop.camera_to_numpy(jcam2).items():
            np.testing.assert_allclose(interop.camera_to_numpy(cam2)[k], v, rtol=0,
                                       atol=POSE_ATOL, err_msg=f"{name} {k}")
    same, moved = camera_movement(camera, {"q", "x"}, time_step=0.25)
    assert not moved and torch.equal(same.position, camera.position)


def test_preview_z_key_moves_down():
    """'z' is the terminal stand-in for GLFW_KEY_LEFT_SHIFT: world-down
    motion (camera.cuh:64-69)."""
    cam2, moved = camera_movement(Camera.create((0.0, 1.0, 0.0), device="cpu"),
                                  {preview._KEYMAP[b"z"]}, time_step=0.5)
    assert moved
    assert cam2.position.tolist() == [0.0, 0.75, 0.0]


# ---------------------------------------------------------------------------
# cli/preview
# ---------------------------------------------------------------------------


def test_render_ansi_exact():
    img = np.array([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]],
                    [[0.0, 0.0, 1.0], [1.0, 1.0, 1.0]]], np.float32)
    got = preview.render_ansi(img, max_cols=2, max_rows=1)
    assert got == (
        "\x1b[38;2;255;0;0m\x1b[48;2;0;0;255m▀"
        "\x1b[38;2;0;255;0m\x1b[48;2;255;255;255m▀"
        "\x1b[0m"
    )
    rng = np.random.default_rng(9)
    for shape, cols, rows in (((17, 23, 3), 9, 4), ((5, 4, 3), 80, 24), ((1, 7, 3), 3, 1)):
        img = rng.random(shape).astype(np.float32)
        assert preview.render_ansi(img, cols, rows) == jpreview.render_ansi(img, cols, rows)


def test_downsample_box_average():
    img = np.zeros((4, 4, 3), np.float32)
    img[:2, :2] = 1.0  # top-left quadrant white
    out = preview.downsample(img, 2, 2)
    assert out.shape == (2, 2, 3)
    np.testing.assert_array_equal(out[0, 0], 1.0)
    np.testing.assert_array_equal(out[0, 1], 0.0)
    np.testing.assert_array_equal(out[1, 1], 0.0)
    img = np.random.default_rng(10).random((31, 45, 3)).astype(np.float32)
    for cols, rows in ((7, 5), (45, 31), (100, 3)):
        np.testing.assert_array_equal(preview.downsample(img, cols, rows),
                                      jpreview.downsample(img, cols, rows))


def test_preview_loop_headless(scene):
    sess = InteractiveSession(scene, _camera(), CONFIG, adaptive=False)
    buf = io.StringIO()
    img = preview.run_preview(sess, max_samples=2, out=buf, interactive=False)
    text = buf.getvalue()
    assert "▀" in text and "sample 2/2" in text  # half-block frames were drawn
    assert sess.sample_count == 2
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    gb = render(scene, _camera(), CONFIG, num_samples=2, adaptive=False)
    np.testing.assert_array_equal(img, resolve_image(gb, CONFIG).numpy())


def test_read_keys_maps_terminal_bytes(monkeypatch):
    """_read_keys on a terminal: each binding's bytes give its name, esc and q
    give "quit", unknown bytes nothing; without a terminal, []. (ctrl-c
    reaches it only in raw mode: in cbreak mode the terminal turns it into
    a signal.)"""
    import pty
    import tty

    assert preview._read_keys(0.0) == []  # pytest's stdin is not a tty
    master, slave = pty.openpty()
    try:
        tty.setcbreak(slave)
        with os.fdopen(slave, "r", closefd=False) as stdin:
            monkeypatch.setattr("sys.stdin", stdin)
            for data, want in [*((b, [n]) for b, n in preview._KEYMAP.items()),
                               (b"q", ["quit"]), (b"\x1b", ["quit"]),
                               (b"x", []), (b"\x1b[A\x1b", ["up"])]:
                os.write(master, data)
                assert preview._read_keys(0.5) == want, data
            assert preview._read_keys(0.0) == []
    finally:
        os.close(master)
        os.close(slave)
