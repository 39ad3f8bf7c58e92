"""Port parity: multi-device rendering and inverse rendering (``dist/``).

Mirrors tests/test_sharding.py and tests/test_multihost.py case for case
(the graft entry's counterpart waits for the port's bench). The JAX package
shards over 8 virtual CPU devices in one process; the port runs one process
per rank, so each mesh here is CPU ranks over gloo started by
``dist.launch`` (at most 4 a spawn). One spawn serves several tests: a
module fixture runs it once and each test asserts on what it returned.
The rank functions live in this module, which imports JAX only inside the
tests that compare with it, so a rank loads no JAX.

Tolerances:
- the sharded renders with one sample stream, the tail mode, the resume
  and the CLI's PNGs against one device: bit for bit (each pixel's
  radiance is a function of the key words and its global pixel id);
- grads against a single-process hand-built objective of the same loss:
  rtol 1e-5 on the loss, rtol 1e-4 with atol 1e-7 on the grads (the JAX
  package's own limits; sums over ranks add in another order); grads
  across ranks: bit for bit;
- against the JAX package's sharded functions on the same numpy scene
  (JAX jitted on the conftest's 8 virtual CPU devices, which contracts
  multiply-adds into FMAs): each test's docstring states its limit and
  the maximum it measured.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from isaklm_raytracer_tpu_torch import interop
from isaklm_raytracer_tpu_torch.accel import prepare_scene
from isaklm_raytracer_tpu_torch.camera import Camera
from isaklm_raytracer_tpu_torch.cli import render as cli
from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.dist import sharding
from isaklm_raytracer_tpu_torch.dist.launch import free_port, launch
from isaklm_raytracer_tpu_torch.integrator.render import render, render_sample
from isaklm_raytracer_tpu_torch.io import checkpoint as checkpoint_io
from isaklm_raytracer_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from isaklm_raytracer_tpu_torch.math import rng
from isaklm_raytracer_tpu_torch.scene.procedural import cornell_box
from isaklm_raytracer_tpu_torch.scene.types import GBuffer

torch.set_num_threads(1)  # the test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT = 240  # seconds a spawn may take

# as tests/test_sharding.py
CONFIG = RenderConfig(width=24, height=24, max_bounces=4)
PROGRESSIVE = RenderConfig(width=24, height=24, max_bounces=3, min_samples=2, max_samples=64,
                           max_tolerance=0.5, min_wavefront=64)
TAIL = RenderConfig(width=48, height=48, max_bounces=3, min_samples=2, max_samples=64,
                    max_tolerance=0.5, min_wavefront=512)
RESUME = RenderConfig(width=16, height=16, max_bounces=3, min_samples=2, max_tolerance=0.5,
                      min_wavefront=32)
# the JAX parity cases, smaller: the JAX side compiles each sharded function
PARITY = RenderConfig(width=16, height=16, max_bounces=3)
FIELDS = sharding.FLOAT_FIELDS
CLI_BASE = ["--scene", "cornell", "--width", "16", "--height", "16", "--max-samples", "3",
            "--min-samples", "2", "--max-bounces", "3", "--ray-chunk", "0", "--device", "cpu"]


def _scene():
    return prepare_scene(cornell_box(include_blockers=False), "cpu")


def _camera():
    return Camera.create((0.0, 0.0, -0.9), fov=np.pi / 2, device="cpu")


def _np(gb: GBuffer) -> dict:
    return {k: getattr(gb, k).numpy() for k in ("frame", "sq_luminance", "count")}


def _grads(loss, grads) -> tuple:
    return float(loss), {k: v.numpy() for k, v in grads.items()}


def _scaled_albedo(materials, k):
    return materials.replace(albedo=materials.albedo * k)


# --- rank functions (run in spawned ranks) --------------------------------


def _four_ranks(rank, world, ck_path):
    scene, camera = _scene(), _camera()
    out = {"world": world}
    try:
        sharding.make_render_mesh(3, 1, device="cpu")
    except ValueError as e:
        out["bad_mesh"] = str(e)
    m22 = sharding.make_render_mesh(2, 2, device="cpu")
    m41 = sharding.make_render_mesh(4, 1, device="cpu")
    m14 = sharding.make_render_mesh(1, 4, device="cpu")
    out["coords"] = (m22.rank, m22.tile, m22.sample)

    run41, out["n41"] = sharding.sharded_render_fn(scene, CONFIG, m41)
    run14, out["n14"] = sharding.sharded_render_fn(scene, CONFIG, m14)
    out["tile_render"] = run41(camera, (0, 5)).numpy()
    out["variance"] = (run41(camera, (0, 2)).numpy(), run14(camera, (0, 2)).numpy())

    gb = sharding.render_sharded(scene, camera, PROGRESSIVE, 10, m41, seed=3, adaptive=True)
    out["progressive"] = _np(sharding.unshard_gbuffer(gb, PROGRESSIVE, m41))

    full = sharding.render_sharded(scene, camera, RESUME, 6, m41, seed=1, adaptive=True)
    half = sharding.render_sharded(scene, camera, RESUME, 3, m41, seed=1, adaptive=True)
    half = sharding.unshard_gbuffer(half, RESUME, m41)  # collective: every rank
    if rank == 0:
        save_checkpoint(ck_path, half, camera, 1, 3)
    dist.barrier()
    gb, cam2, seed2, next_sample = load_checkpoint(ck_path, "cpu")
    resumed = sharding.render_sharded(scene, cam2, RESUME, 3, m41, seed=seed2, adaptive=True,
                                      gbuffer=gb, sample_offset=next_sample)
    out["resume"] = (_np(sharding.unshard_gbuffer(full, RESUME, m41)),
                     _np(sharding.unshard_gbuffer(resumed, RESUME, m41)))

    key = (0, 13)
    target = render_sample(scene, camera, rng.fold_in(key, 0), CONFIG)
    vg = sharding.sharded_value_and_grad_fn(scene, CONFIG, m22)
    out["grads"] = _grads(*vg(_scaled_albedo(scene.materials, 0.6), camera, target, key))

    key = (0, 3)
    target = render_sample(scene, camera, rng.fold_in(key, 0), CONFIG)
    out["replicated"] = _grads(*vg(scene.materials, camera, target, key))
    step = sharding.sharded_train_step_fn(scene, CONFIG, m22, learning_rate=0.05)
    p, _ = step(scene.materials, camera, target, key)
    out["replicated_step"] = {f: getattr(p, f).numpy() for f in FIELDS}

    true_albedo = scene.materials.albedo.numpy()
    out["recover"] = {}
    step = sharding.sharded_train_step_fn(scene, CONFIG, m22, learning_rate=0.3)
    for seed in (3, 5):
        key = (0, seed)
        target = render_sample(scene, camera, rng.fold_in(key, 0), CONFIG)
        p = _scaled_albedo(scene.materials, 0.4)
        err0 = np.abs(p.albedo.numpy() - true_albedo).mean()
        losses = []
        for i in range(12):
            p, loss = step(p, camera, target, rng.fold_in(key, 10 + i))
            losses.append(float(loss))
        out["recover"][seed] = (err0, np.abs(p.albedo.numpy() - true_albedo).mean(), losses)
    return out


def _three_ranks(rank, world, leaves, target):
    scene, camera = _scene(), _camera()
    mesh = sharding.make_render_mesh(1, 3, device="cpu")
    key = (0, 17)
    t = render_sample(scene, camera, rng.fold_in(key, 0), CONFIG)
    params = _scaled_albedo(scene.materials, 0.6)
    out = {
        "decorrelated": _grads(*sharding.sharded_value_and_grad_fn(
            scene, CONFIG, mesh, decorrelate=True)(params, camera, t, key)),
        "plain": _grads(*sharding.sharded_value_and_grad_fn(
            scene, CONFIG, mesh)(params, camera, t, key)),
    }
    # the JAX parity cases, on the JAX package's scene
    jscene = interop.scene_from_numpy(leaves, device="cpu")
    params = _scaled_albedo(jscene.materials, 0.6)
    target = torch.from_numpy(target)
    out["jax_vg"] = _grads(*sharding.sharded_value_and_grad_fn(
        jscene, PARITY, mesh, decorrelate=True)(params, camera, target, key))
    p, loss = sharding.sharded_train_step_fn(jscene, PARITY, mesh)(params, camera, target, key)
    out["jax_step"] = (float(loss), {f: getattr(p, f).numpy() for f in FIELDS})
    return out


def _flaky(real):
    """``real`` that fails on its second call (an injected device fault)."""
    calls = {"n": 0}

    def call(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected device fault")
        return real(*a, **kw)

    return call


def _two_ranks(rank, world, leaves, tail_counts, tmp):
    scene, camera = _scene(), _camera()
    mesh = sharding.make_render_mesh(2, 1, device="cpu")
    out = {}

    calls = {"tail": 0}
    real_tail = sharding._sharded_tail_step

    def counting_tail(*a, **kw):
        calls["tail"] += 1
        return real_tail(*a, **kw)

    n = TAIL.num_pixels
    gb0 = GBuffer(torch.zeros((n, 3)), torch.zeros(n), torch.from_numpy(tail_counts))
    sharding._sharded_tail_step = counting_tail
    try:
        gb = sharding.render_sharded(scene, camera, TAIL, 4, mesh, seed=7, adaptive=True,
                                     gbuffer=gb0)
    finally:
        sharding._sharded_tail_step = real_tail
    out["tail"] = (calls["tail"], _np(sharding.unshard_gbuffer(gb, TAIL, mesh)))
    out["progress"] = sharding.gbuffer_progress(gb, TAIL, mesh)

    jscene = interop.scene_from_numpy(leaves, device="cpu")
    gb = sharding.render_sharded(jscene, camera, PROGRESSIVE, 6, mesh, seed=3, adaptive=True)
    out["jax_render"] = _np(sharding.unshard_gbuffer(gb, PROGRESSIVE, mesh))

    # the CLI under a group the caller set up (scripts/multihost_cli_worker.py)
    argv = [*CLI_BASE, "--seed", "5", "--devices", "auto", "--checkpoint-every", "2"]
    out_png = os.path.join(tmp, f"r{rank}.png")
    rc = cli.main([*argv, "--checkpoint", os.path.join(tmp, "ck.npz"), "--out", out_png])
    with open(out_png, "rb") as f:
        out["cli"] = (rc, f.read())

    # a batch fails on every rank: they retry from rank 0's checkpoint; no
    # other rank reads the file
    real_render, real_load = sharding.render_sharded, checkpoint_io.load_checkpoint
    sharding.render_sharded = _flaky(real_render)
    if rank != 0:
        checkpoint_io.load_checkpoint = _refuse
    out_png = os.path.join(tmp, f"retry{rank}.png")
    try:
        rc = cli.main([*argv, "--checkpoint", os.path.join(tmp, "retry.npz"), "--out", out_png])
    finally:
        sharding.render_sharded, checkpoint_io.load_checkpoint = real_render, real_load
    with open(out_png, "rb") as f:
        out["retry"] = (rc, f.read())
    return out


def _refuse(*a, **kw):
    raise AssertionError("a rank other than 0 read the checkpoint file")


def _failing_rank(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()  # waits for rank 1, which never comes: the launcher stops it


# --- fixtures ---------------------------------------------------------------


@pytest.fixture(scope="module")
def scene():
    return _scene()


@pytest.fixture(scope="module")
def camera():
    return _camera()


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("four") / "ck.npz")
    return launch(_four_ranks, 4, ck, device="cpu", timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def jax_case():
    """The JAX package's Cornell box (no blockers), its numpy leaves, its
    camera and the PARITY target of key PRNGKey(17)."""
    import jax
    import jax.numpy as jnp

    from isaklm_raytracer_tpu.camera import Camera as JCamera
    from isaklm_raytracer_tpu.config import RenderConfig as JConfig
    from isaklm_raytracer_tpu.integrator.render import render_sample as jrender_sample
    from isaklm_raytracer_tpu.scene.procedural import cornell_box as jcornell

    jscene = jcornell(include_blockers=False)
    jcam = JCamera.create((0.0, 0.0, -0.9), fov=jnp.pi / 2)
    jcfg = JConfig(**PARITY.__dict__)
    key = jax.random.PRNGKey(17)
    target = np.asarray(jrender_sample(jscene, jcam, jax.random.fold_in(key, 0), jcfg))
    return jscene, interop.scene_to_numpy(jscene), jcam, target


@pytest.fixture(scope="module")
def three(jax_case):
    _, leaves, _, target = jax_case
    return launch(_three_ranks, 3, leaves, target, device="cpu", timeout=SPAWN_TIMEOUT)


def _tail_counts():
    conv = np.random.default_rng(0).random(TAIL.num_pixels) < 0.95
    return np.where(conv, TAIL.max_samples, 0).astype(np.int32)


@pytest.fixture(scope="module")
def two(jax_case, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("two"))
    return tmp, launch(_two_ranks, 2, jax_case[1], _tail_counts(), tmp, device="cpu",
                       timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def cli_reference(tmp_path_factory):
    """The single-process CLI's PNG bytes of the two-process CLI runs."""
    out = str(tmp_path_factory.mktemp("ref") / "ref.png")
    assert cli.main([*CLI_BASE, "--seed", "5", "--devices", "1", "--out", out]) == 0
    with open(out, "rb") as f:
        return f.read()


def _gbuffer_equal(got: dict, want: GBuffer):
    for k, v in _np(want).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _hand_built_loss(scene, camera, params, target, key, num_sample, residual_stream=None):
    """The single-process objective, with leaves for the six float fields
    and the pose: the mean over streams of the full-image MSE or, with
    ``residual_stream(s)``, of the dual-buffer estimator that takes stream
    residual_stream(s)'s detached residual."""
    floats = [getattr(params, f).clone().requires_grad_() for f in FIELDS]
    pose = [x.clone().requires_grad_() for x in (camera.position, camera.yaw, camera.pitch)]
    s = scene.replace(materials=params.replace(**dict(zip(FIELDS, floats))))
    cam = camera.replace(position=pose[0], yaw=pose[1], pitch=pose[2])
    rad = [render_sample(s, cam, rng.fold_in(key, i), CONFIG) for i in range(num_sample)]
    norm = 3.0 * CONFIG.num_pixels
    total = 0.0
    for i in range(num_sample):
        if residual_stream is None:
            total = total + torch.sum((rad[i] - target) ** 2) / norm
        else:
            other = (rad[residual_stream(i)] - target).detach()
            total = total + 2.0 * torch.sum(other * rad[i]) / norm
    return total / num_sample, floats + pose


# --- mirrors of tests/test_sharding.py -------------------------------------


def test_four_ranks_available(four):
    """Four ranks, each at (r // 2, r % 2) of a (2, 2) mesh; a mesh that
    does not cover the world raises."""
    for r, out in enumerate(four):
        assert out["world"] == 4
        assert out["coords"] == (r, r // 2, r % 2)
        assert out["bad_mesh"] == "mesh 3x1 != 4 ranks"


def test_make_render_mesh_without_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group is up"):
        sharding.make_render_mesh(1, 1, device="cpu")


def test_tile_sharded_render_equals_single_device(four, scene, camera):
    """Same key => the (4, 1) image equals one device's, on every rank."""
    want = render_sample(scene, camera, rng.fold_in((0, 5), 0), CONFIG).numpy()
    for out in four:
        assert out["n41"] == 1
        np.testing.assert_array_equal(out["tile_render"], want)


def test_sample_axis_reduces_variance(four, scene, camera):
    ref = np.mean([render_sample(scene, camera, (0, 100 + i), CONFIG).numpy()
                   for i in range(16)], axis=0)
    run1, run4 = four[0]["variance"]
    assert four[0]["n14"] == 4
    e1 = np.abs(run1 - ref).mean()
    e4 = np.abs(run4 - ref).mean()
    assert e4 < e1  # 4 averaged sample streams must be closer to the mean


@pytest.mark.parametrize("seed", [3, 5])
def test_train_step_recovers_albedo(four, seed):
    """Inverse rendering at (2, 2), lr 0.3, 12 steps of the decorrelated
    gradient moves the albedo toward the true material (see
    tests/test_sharding.py: the parameter error is the signal, the loss is
    MC noise)."""
    err0, err, losses = four[0]["recover"][seed]
    assert np.isfinite(losses).all()
    assert err < 0.95 * err0, f"albedo error {err0:.4f} -> {err:.4f}"
    for out in four[1:]:
        assert out["recover"][seed] == four[0]["recover"][seed]


def test_sharded_grads_match_single_device(four, scene, camera):
    """The (2, 2) value_and_grad equals a single-process autograd of the
    same objective (the mean over 2 streams of the full-image MSE)."""
    key = (0, 13)
    target = render_sample(scene, camera, rng.fold_in(key, 0), CONFIG)
    params = _scaled_albedo(scene.materials, 0.6)
    loss_1, leaves = _hand_built_loss(scene, camera, params, target, key, 2)
    grads_1 = torch.autograd.grad(loss_1, leaves, allow_unused=True)
    loss_sh, grads_sh = four[0]["grads"]
    np.testing.assert_allclose(loss_sh, float(loss_1.detach()), rtol=1e-5)
    for name, g1, x in zip(FIELDS + sharding.POSE_FIELDS, grads_1, leaves):
        g1 = np.zeros(x.shape, np.float32) if g1 is None else g1.numpy()
        np.testing.assert_allclose(grads_sh[name], g1, rtol=1e-4, atol=1e-7,
                                   err_msg=f"gradient mismatch for {name}")
    for name in sharding.POSE_FIELDS:  # the pose grads ride the same all_reduce
        assert np.abs(grads_sh[name]).sum() > 0, f"{name} gradient is identically zero"


def test_train_step_grads_replicated(four):
    """Every rank holds the same loss and grads, bit for bit (one
    all_reduce over the world), and the train step's params are finite."""
    loss0, grads0 = four[0]["replicated"]
    assert np.isfinite(loss0)
    for out in four[1:]:
        loss, grads = out["replicated"]
        assert loss == loss0
        for f, g in grads0.items():
            assert np.isfinite(g).all(), f"{f}: non-finite gradient"
            np.testing.assert_array_equal(grads[f], g, err_msg=f"gradient for {f} differs")
        for f in FIELDS:
            np.testing.assert_array_equal(out["replicated_step"][f],
                                          four[0]["replicated_step"][f])
    assert np.isfinite(four[0]["replicated_step"]["albedo"]).all()


def test_decorrelated_grads_match_single_device_cross_estimator(three, scene, camera):
    """At (1, 3) the decorrelated gradient equals a single-process
    dual-buffer estimator in which stream s takes the detached residual of
    stream (s - 1) mod 3 -- the JAX code's ppermute direction -- and not
    the one of (s + 1) mod 3 (its docstring's). The reported loss is the
    plain MSE's, bit for bit."""
    key = (0, 17)
    target = render_sample(scene, camera, rng.fold_in(key, 0), CONFIG)
    params = _scaled_albedo(scene.materials, 0.6)
    loss_dec, grads_dec = three[0]["decorrelated"]
    assert loss_dec == three[0]["plain"][0]
    for direction, match in ((-1, True), (1, False)):
        pseudo, leaves = _hand_built_loss(scene, camera, params, target, key, 3,
                                          residual_stream=lambda s: (s + direction) % 3)
        grads_1 = torch.autograd.grad(pseudo, leaves[:len(FIELDS)], allow_unused=True)
        close = all(
            np.allclose(grads_dec[f], np.zeros_like(grads_dec[f]) if g is None else g.numpy(),
                        rtol=1e-4, atol=1e-7)
            for f, g in zip(FIELDS, grads_1))
        assert close == match, f"residual of stream s{direction:+d}: match {close}"
    for out in three[1:]:
        assert out["decorrelated"][0] == loss_dec
        for f, g in grads_dec.items():
            np.testing.assert_array_equal(out["decorrelated"][1][f], g)


def test_render_sharded_progressive_bit_equal(four, scene, camera):
    """render_sharded, adaptive, at (4, 1) is bit-equal to ``render``, and
    the compacted rungs ran (some pixel stopped early)."""
    want = render(scene, camera, PROGRESSIVE, num_samples=10, seed=3, adaptive=True)
    for out in four:
        _gbuffer_equal(out["progressive"], want)
    assert (four[0]["progressive"]["count"] < 10).any()


def test_render_sharded_tail_mode_engages_and_bit_equal(two, scene, camera):
    """At (2, 1) with 1,152 pixels a rank, a 95%-converged G-buffer drops
    the ladder to a 288-wide bucket a rank: the tail step runs (counted in
    the ranks) and the result is bit-equal to ``render``."""
    counts = torch.from_numpy(_tail_counts())
    n = TAIL.num_pixels
    gb0 = GBuffer(torch.zeros((n, 3)), torch.zeros(n), counts)
    want = render(scene, camera, TAIL, num_samples=4, seed=7, adaptive=True, gbuffer=gb0)
    for out in two[1]:
        calls, got = out["tail"]
        assert calls >= 1, "tail mode never engaged on the mesh"
        _gbuffer_equal(got, want)


def test_gbuffer_progress_matches_the_plain_buffer(two):
    """min spp, converged share and unconverged count of the sharded
    G-buffer, on every rank, equal the plain buffer's."""
    from isaklm_raytracer_tpu_torch.integrator.adaptive import needs_sample

    got = two[1][0]["tail"][1]
    gb = GBuffer(*(torch.from_numpy(got[k]) for k in ("frame", "sq_luminance", "count")))
    want = (int(gb.count.min()), float((gb.count >= TAIL.min_samples).float().mean()),
            int(needs_sample(gb, TAIL).sum()))
    for out in two[1]:
        mn, conv, needs = out["progress"]
        assert (mn, needs) == (want[0], want[2])
        assert conv == pytest.approx(want[1], abs=1e-12)


def test_render_sharded_resume_and_checkpoint(four):
    """Sharded render -> checkpoint (plain, rank 0) -> sharded resume ==
    one uninterrupted run, bit for bit."""
    for out in four:
        full, resumed = out["resume"]
        for k in full:
            np.testing.assert_array_equal(full[k], resumed[k], err_msg=k)


def test_cli_devices_flag(tmp_path):
    """``--devices 2 --device cpu`` spawns two ranks and writes the same
    PNG bytes as ``--devices 1``."""
    outs = [str(tmp_path / f"r{n}.png") for n in (1, 2)]
    base = [*CLI_BASE, "--seed", "4"]
    for n, out in zip((1, 2), outs):
        assert cli.main([*base, "--devices", str(n), "--out", out]) == 0
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        assert a.read() == b.read()


# --- mirrors of tests/test_multihost.py ------------------------------------


def test_two_process_render_matches_single_process(tmp_path, cli_reference):
    """Two OS processes started as torchrun starts them (the env://
    variables), each running the CLI with ``--multihost``: both write the
    single-process PNG."""
    port = free_port()
    outs = [str(tmp_path / f"r{i}.png") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "isaklm_raytracer_tpu_torch.cli.render", *CLI_BASE,
             "--seed", "5", "--multihost", "--out", outs[rank]],
            env=dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                     RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank), OMP_NUM_THREADS="1"),
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in range(2)
    ]
    results = [p.communicate(timeout=SPAWN_TIMEOUT) for p in procs]
    for p, (_, stderr) in zip(procs, results):
        assert p.returncode == 0, f"rank failed:\n{stderr[-3000:]}"
    assert "rank 1 of 2 on 'tile'" in results[1][1]
    for out in outs:
        with open(out, "rb") as f:
            assert f.read() == cli_reference


def test_two_process_cli_render_matches_single(two, cli_reference):
    """The CLI under a 2-rank group that the caller set up, with
    ``--checkpoint --checkpoint-every 2``: per-batch progress through
    ``gbuffer_progress``, the checkpoint gathered collectively and written
    by rank 0, and every rank's PNG byte-equal to the single-process one."""
    tmp, outs = two
    assert os.path.exists(os.path.join(tmp, "ck.npz")), "rank 0 never wrote the checkpoint"
    for out in outs:
        rc, png = out["cli"]
        assert rc == 0 and png == cli_reference


def test_two_process_cli_retries_from_the_broadcast_checkpoint(two, cli_reference):
    """A batch fails on both ranks: they agree to retry, rank 0 alone reads
    the checkpoint and broadcasts it, and both PNGs equal the straight
    run's."""
    for out in two[1]:
        rc, png = out["retry"]
        assert rc == 0 and png == cli_reference


# --- the launcher, the key fold, the device defaults -----------------------


def test_launch_fails_with_the_rank_traceback():
    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        launch(_failing_rank, 2, device="cpu", timeout=SPAWN_TIMEOUT)


@pytest.mark.parametrize("data", [0, 1, 2**31 - 1])
def test_fold_in_matches_jax(data):
    """Bit-equal to ``key_data(fold_in(key, data))``, once and nested."""
    import jax

    for seed in (0, 7, 2**32 - 1):
        key = jax.random.PRNGKey(seed)
        words = (0, seed)
        for d in (data, 3, data):
            key = jax.random.fold_in(key, d)
            words = rng.fold_in(words, d)
            assert words == tuple(int(x) for x in np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("name", ["scene", "camera", "gbuffer"])
def test_interop_from_numpy_without_card_raises(name, monkeypatch):
    """The state carried across from the JAX package lands on the card by
    default and names the missing card instead of staying on the CPU."""
    scene = cornell_box(include_blockers=False)
    args = {
        "scene": (interop.scene_from_numpy, (interop.scene_to_numpy(scene),), {}),
        "camera": (interop.camera_from_numpy, (), interop.camera_to_numpy(_camera())),
        "gbuffer": (interop.gbuffer_from_numpy, (),
                    interop.gbuffer_to_numpy(GBuffer.create(4, "cpu"))),
    }
    fn, pos, kw = args[name]
    assert fn(*pos, **kw, device="cpu") is not None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fn(*pos, **kw)


# --- against the JAX package's sharded functions ---------------------------


def test_render_sharded_matches_jax(two, jax_case):
    """render_sharded at (2, 1), adaptive, 6 samples, against the JAX
    package's render_sharded on a (2, 1) mesh of the same numpy scene:
    counts equal; frame and sq_luminance within the golden tolerance of
    tests/test_torch_render.py (atol 1e-4 but for at most 8 values, all
    within 3e-4). Measured: max |d| 1.91e-6 (frame) and 6.10e-5
    (sq_luminance, whose values reach 30), no value over 1e-4."""
    import jax

    from isaklm_raytracer_tpu.config import RenderConfig as JConfig
    from isaklm_raytracer_tpu.dist import sharding as jsharding

    jscene, _, jcam, _ = jax_case
    jcfg = JConfig(**PROGRESSIVE.__dict__)
    mesh = jsharding.make_render_mesh(2, 1, devices=jax.devices()[:2])
    want = jsharding.unshard_gbuffer(
        jsharding.render_sharded(jscene, jcam, jcfg, 6, mesh, seed=3, adaptive=True), jcfg)
    got = two[1][0]["jax_render"]
    np.testing.assert_array_equal(got["count"], np.asarray(want.count))
    for k in ("frame", "sq_luminance"):
        err = np.abs(got[k] - np.asarray(getattr(want, k)))
        assert int((err > 1e-4).sum()) <= 8 and err.max() <= 3e-4, (k, err.max())


def test_decorrelated_grads_match_jax(three, jax_case):
    """sharded_value_and_grad_fn at (1, 3) with decorrelate, against the
    JAX package's on a (1, 3) mesh of the same numpy scene and target:
    rtol 1e-4, atol 1e-6 on every gradient, rtol 1e-6 on the loss.
    Measured: at most 2.8e-5 relative (roughness) over the entries above
    1e-6, at most 1.43e-6 absolute (an IOR gradient of 0.97); the loss
    1.1e-7 relative."""
    import jax

    from isaklm_raytracer_tpu.config import RenderConfig as JConfig
    from isaklm_raytracer_tpu.dist import sharding as jsharding

    jscene, _, jcam, target = jax_case
    mesh = jsharding.make_render_mesh(1, 3, devices=jax.devices()[:3])
    vg = jsharding.sharded_value_and_grad_fn(jscene, JConfig(**PARITY.__dict__), mesh,
                                             decorrelate=True)
    params = jscene.materials.replace(albedo=jscene.materials.albedo * 0.6)
    loss, grads = vg(params, jcam, target, jax.random.PRNGKey(17))
    got_loss, got = three[0]["jax_vg"]
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-6)
    for name, g in grads.items():
        np.testing.assert_allclose(got[name], np.asarray(g), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_train_step_matches_jax(three, jax_case):
    """One sharded_train_step_fn step (lr 0.05, decorrelated) at (1, 3):
    the params against the JAX package's, rtol 1e-5, atol 1e-7, the loss
    rtol 1e-6. Measured: max |d| 5.96e-8 (IOR), the loss 1.1e-7
    relative."""
    import jax

    from isaklm_raytracer_tpu.config import RenderConfig as JConfig
    from isaklm_raytracer_tpu.dist import sharding as jsharding

    jscene, _, jcam, target = jax_case
    mesh = jsharding.make_render_mesh(1, 3, devices=jax.devices()[:3])
    step = jsharding.sharded_train_step_fn(jscene, JConfig(**PARITY.__dict__), mesh)
    params = jscene.materials.replace(albedo=jscene.materials.albedo * 0.6)
    p, loss = step(params, jcam, target, jax.random.PRNGKey(17))
    got_loss, got = three[0]["jax_step"]
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-6)
    for f in FIELDS:
        np.testing.assert_allclose(got[f], np.asarray(getattr(p, f)), rtol=1e-5, atol=1e-7,
                                   err_msg=f)
