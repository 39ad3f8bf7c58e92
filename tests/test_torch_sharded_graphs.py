"""Port parity: the graph steps of ``dist/sharding.py`` and the gradient
graph step under them (``integrator.render.GradGraphStep``), with
``torch.cuda``'s graph calls faked.

The real captures run on the card (``chip_smoke.py`` phase sharded). Here
``faked_graphs`` stands a ``FakeGraph`` in for ``torch.cuda.CUDAGraph``
(it records its calls and replays nothing) and forces the card's path
(``integrator.render._on_card``): a faked capture runs the captured
function on the static buffers, so the call that captures returns what
the real graphs would, through the copy-in, the eager loss between the
two graphs and the copy-out; a later call returns the capture's values.
Every all_gather and all_reduce is recorded with whether a faked capture
was open.

- ``GradGraphStep``: the first call eager, the second captures the
  forward and the backward (one pool) and replays both, later calls copy
  their inputs in and replay; launches tallied as ``GraphStep`` tallies
  them; a capture that raises leaves the step as it was;
- ``sharded_value_and_grad_fn`` and the train step over it: bit for bit
  the eager (CPU) path at the eager call and at the capturing one, both
  estimators, on a world-1 gloo group here and on three ranks
  (tests/test_torch_sharding.py's ``three`` fixture); against the JAX
  package's ``sharded_value_and_grad_fn`` at the tolerance of
  ``test_decorrelated_grads_match_jax`` (rtol 1e-4, atol 1e-6 on the
  grads, rtol 1e-6 on the loss);
- the render steps: ``render_sharded`` (full, adaptive and tail steps) and
  ``sharded_render_fn`` bit for bit their eager runs; no collective inside
  a faked capture;
- the graph cache: keyed on the mesh's shape, the rank, the tail's bucket
  and ``decorrelate``; a dead scene's graphs are dropped.
"""

import contextlib
import gc
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist

from isaklm_raytracer_tpu_torch import interop
from isaklm_raytracer_tpu_torch.accel import prepare_scene
from isaklm_raytracer_tpu_torch.camera import Camera
from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.dist import sharding
from isaklm_raytracer_tpu_torch.dist.launch import free_port
from isaklm_raytracer_tpu_torch.integrator import render as R
from isaklm_raytracer_tpu_torch.kernels.intersect import COUNTS
from isaklm_raytracer_tpu_torch.math import rng
from isaklm_raytracer_tpu_torch.scene.procedural import cornell_box
from isaklm_raytracer_tpu_torch.scene.types import GBuffer

torch.set_num_threads(1)  # the test workers share the host's cores

CONFIG = RenderConfig(width=16, height=16, max_bounces=3)
# a rank's bucket floor is 256 pixels: 1,024 pixels a rank reach tail mode
ADAPTIVE = RenderConfig(width=32, height=32, max_bounces=3, min_samples=2, max_samples=64,
                        max_tolerance=0.5, min_wavefront=32)
FIELDS = sharding.FLOAT_FIELDS + sharding.POSE_FIELDS


class FakeGraph:
    """Stands for torch.cuda.CUDAGraph: records its calls, replays
    nothing; ``pool()`` is a handle of its own."""

    def __init__(self, keep_graph=False):
        self.calls = []

    def instantiate(self):
        self.calls.append("instantiate")

    def replay(self):
        self.calls.append("replay")

    def pool(self):
        return ("pool", id(self))


class Faked:
    """What ``faked_graphs`` saw: each capture's graph and ``pool=``, the
    collectives as (name, whether a capture was open)."""

    def __init__(self):
        self.open = False
        self.captures = []
        self.collectives = []

    @contextlib.contextmanager
    def graph(self, g, pool=None):
        self.captures.append((g, pool))
        self.open = True
        try:
            yield
        finally:
            self.open = False

    def watch(self, name, real):
        def call(*a, **kw):
            self.collectives.append((name, self.open))
            return real(*a, **kw)

        return call


@contextlib.contextmanager
def faked_graphs():
    """The card's path of the graph steps on CPU tensors, the graph calls
    faked (the module docstring); the rank steps' caches cleared before
    and after. Plain patching, not a fixture: the spawned ranks of
    tests/test_torch_sharding.py use it too."""
    faked = Faked()
    patches = [
        (torch.cuda, "CUDAGraph", FakeGraph), (torch.cuda, "graph", faked.graph),
        (torch.cuda, "device", lambda d: contextlib.nullcontext()),
        (torch.cuda, "synchronize", lambda d=None: None),
        (torch.cuda, "memory_reserved", lambda d=None: 0),
        (R, "_on_card", lambda scene: True),
        (R, "_key_on", lambda words, device: rng.key_tensor(words, device)),
        (dist, "all_gather", faked.watch("all_gather", dist.all_gather)),
        (dist, "all_reduce", faked.watch("all_reduce", dist.all_reduce)),
    ]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    sharding._rank_steps.cache_clear()
    for obj, name, value in patches:
        setattr(obj, name, value)
    try:
        yield faked
    finally:
        for obj, name, value in saved:
            setattr(obj, name, value)
        sharding._rank_steps.cache_clear()


def vg_result(loss, grads) -> tuple:
    return float(loss), {k: v.numpy().copy() for k, v in grads.items()}


def assert_same(got, want) -> None:
    assert got[0] == want[0]
    for k in FIELDS:
        np.testing.assert_array_equal(got[1][k], want[1][k], err_msg=k)


def _np(gb: GBuffer) -> dict:
    return {k: getattr(gb, k).numpy().copy() for k in ("frame", "sq_luminance", "count")}


def assert_gb_equal(got, want) -> None:
    for k, v in _np(want).items():
        np.testing.assert_array_equal(_np(got)[k], v, err_msg=k)


# --- GradGraphStep -----------------------------------------------------------


def _toy(calls):
    """f(a, b, c, x) = a * x + b ** 2 (c unused), two launches tallied."""

    def fn(a, b, c, x):
        calls.append(1)
        COUNTS.flat_kernel += 2  # as two wrapper launches would
        return a * x + b ** 2

    return fn


def _toy_head(r):
    value = torch.sum(r * r)
    return value, 3.0 * value


def test_grad_graph_step_warms_up_captures_and_replays():
    calls = []
    fn = _toy(calls)
    leaves = [torch.tensor([1.0, 2.0]), torch.tensor([0.5, -1.0]), torch.tensor(7.0)]
    x = torch.tensor([3.0, 4.0])
    want = R.split_value_and_grad(fn, leaves, [x], _toy_head)
    # by hand: d/da 6 r x, d/db 6 r 2b, c unused
    r = leaves[0] * x + leaves[1] ** 2
    np.testing.assert_allclose(want[1][0].numpy(), (6 * r * x).numpy())
    np.testing.assert_allclose(want[1][1].numpy(), (12 * r * leaves[1]).numpy())
    assert float(want[1][2]) == 0.0
    leaves2 = [v + 1 for v in leaves]
    want2 = R.split_value_and_grad(fn, leaves2, [x], _toy_head)
    calls.clear()
    with faked_graphs() as faked:
        COUNTS.reset()
        R.GraphStep.reset_tallies()
        captures = R.GraphStep.captures
        step = R.GradGraphStep(torch.device("cpu"))
        value, grads = step(fn, leaves, [x], _toy_head)  # eager
        assert step.graph is None and len(calls) == 1 and COUNTS.flat_kernel == 2
        assert value == want[0] and all(torch.equal(g, w) for g, w in zip(grads, want[1]))

        calls.clear()
        value, grads = step(fn, leaves2, [x], _toy_head)  # both captures, both replays
        assert len(calls) == 1 and R.GraphStep.captures == captures + 1
        assert step.graph.calls == ["instantiate", "replay"]
        assert step.backward.calls == ["instantiate", "replay"]
        # two captures, the backward's into the forward's pool
        assert [(g, p) for g, p in faked.captures] == [(step.graph, None),
                                                       (step.backward, step.graph.pool())]
        assert value == want2[0] and all(torch.equal(g, w) for g, w in zip(grads, want2[1]))
        assert all(s.requires_grad for s in step.static_in[:3])
        assert not step.static_out.requires_grad and step.static_out.grad_fn is None
        assert step.launches == {"flat_kernel": 2} and step.replays == 1
        assert R.GraphStep.recorded == {"flat_kernel": 2}
        assert R.GraphStep.replayed == {"flat_kernel": 2}
        assert all(g is not s for g, s in zip(grads, step.static_grads))  # copies
        assert step.capture_s >= 0 and step.instantiate_s >= 0 and step.pool_bytes == 0

        leaves3 = [v * 2 for v in leaves]
        calls.clear()
        step(None, leaves3, [x + 1], _toy_head)  # replays only: inputs copied in
        assert calls == [] and step.replays == 2
        assert step.graph.calls[-1] == "replay" and step.backward.calls[-1] == "replay"
        for s, v in zip(step.static_in, [*leaves3, x + 1]):
            np.testing.assert_array_equal(s.detach().numpy(), v.numpy())
        # the head ran on the (faked, unreplayed) forward output
        np.testing.assert_array_equal(step.static_grad_out.numpy(),
                                      (6 * step.static_out).numpy())
        assert R.GraphStep.replayed == {"flat_kernel": 4} and COUNTS.flat_kernel == 4
    COUNTS.reset()
    R.GraphStep.reset_tallies()


class _Armed(torch.autograd.Function):
    """Identity whose backward raises while ``armed`` holds True."""

    armed = []

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        if _Armed.armed:
            raise RuntimeError("capture failed")
        return g


@pytest.mark.parametrize("where", ["forward", "head", "backward"])
def test_grad_graph_step_capture_that_raises_leaves_the_step_as_it_was(where):
    armed = []

    def fn(a, x):
        if where == "forward" and armed:
            raise RuntimeError("capture failed")
        return _Armed.apply(a * x)

    def head(r):
        if where == "head" and armed:
            raise RuntimeError("capture failed")
        return _toy_head(r)

    a, x = torch.tensor([1.0, -2.0]), torch.tensor([0.5, 3.0])
    with faked_graphs():
        R.GraphStep.reset_tallies()
        captures = R.GraphStep.captures
        step = R.GradGraphStep(torch.device("cpu"))
        want = step(fn, [a], [x], head)  # eager
        armed.append(True)
        if where == "backward":
            _Armed.armed.append(True)
        was = gc.isenabled()
        gc.enable()
        try:
            with pytest.raises(RuntimeError, match="capture failed"):
                step(fn, [a], [x], head)
            assert gc.isenabled()
        finally:
            (gc.enable if was else gc.disable)()
            _Armed.armed.clear()
        assert step.graph is None and step.backward is None
        assert step.static_in is None and step.static_out is None
        assert step.static_grads is None and step.launches == {} and step.replays == 0
        assert R.GraphStep.captures == captures and not R.GraphStep.recorded
        armed.clear()
        value, grads = step(fn, [a], [x], head)  # captures again, cleanly
        assert step.graph is not None and step.replays == 1
        assert value == want[0] and torch.equal(grads[0], want[1][0])
    R.GraphStep.reset_tallies()


# --- the sharded steps on a world-1 gloo group -------------------------------


@pytest.fixture(scope="module")
def world1():
    """A world-1 gloo group in this process, its (1, 1) mesh, the
    Cornell box without blockers and its camera; the group torn down
    after the module."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = sharding.make_render_mesh(1, 1, device="cpu")
        scene = prepare_scene(cornell_box(include_blockers=False), "cpu")
        camera = Camera.create((0.0, 0.0, -0.9), fov=np.pi / 2, device="cpu")
        yield mesh, scene, camera
    finally:
        dist.destroy_process_group()


def _target(scene, camera, key):
    return R.render_sample(scene, camera, rng.fold_in(key, 0), CONFIG)


@pytest.mark.parametrize("decorrelate", [False, True])
def test_vg_through_faked_graphs_equals_eager(world1, decorrelate):
    """vg's eager call and its capturing call equal the CPU path's bit for
    bit (the copy-in, the eager loss between the graphs, the copy-out);
    the replay after them copies its inputs into the static buffers; no
    collective runs inside a capture."""
    mesh, scene, camera = world1
    target = _target(scene, camera, (0, 5))
    params = scene.materials.replace(albedo=scene.materials.albedo * 0.6)
    keys = [(0, 5), (0, 6), (0, 7)]
    eager = sharding.sharded_value_and_grad_fn(scene, CONFIG, mesh, decorrelate)
    want = [vg_result(*eager(params, camera, target, k)) for k in keys[:2]]
    assert not eager.graphs.entries  # the CPU path builds no graph step
    with faked_graphs() as faked:
        vg = sharding.sharded_value_and_grad_fn(scene, CONFIG, mesh, decorrelate)
        got = vg_result(*vg(params, camera, target, keys[0]))
        step = vg.graphs.last
        assert step.graph is None and step.calls == 1
        assert_same(got, want[0])
        assert_same(vg_result(*vg(params, camera, target, keys[1])), want[1])
        assert step.graph is not None and step.backward is not None and step.replays == 1
        launches = dict(step.launches)
        moved = camera.replace(yaw=camera.yaw + 0.25)
        vg(params, moved, target, keys[2])
        assert step.replays == 2 and step.launches == launches
        words = rng.key_tensor(rng.fold_in(keys[2], mesh.sample))
        np.testing.assert_array_equal(step.static_in[-1].numpy(), words.numpy())
        assert float(step.static_in[7].detach()) == float(moved.yaw)
        assert not any(open_ for _, open_ in faked.collectives)
        assert [name for name, _ in faked.collectives] == ["all_reduce"] * 3


def test_train_step_through_faked_graphs_equals_eager(world1):
    """Two train steps (eager, capturing) equal the CPU path's bit for
    bit; the update stays eager."""
    mesh, scene, camera = world1
    target = _target(scene, camera, (0, 3))

    def two_steps():
        step = sharding.sharded_train_step_fn(scene, CONFIG, mesh, learning_rate=0.1)
        p, out = scene.materials.replace(albedo=scene.materials.albedo * 0.5), []
        for i in range(2):
            p, loss = step(p, camera, target, (0, 10 + i))
            out.append((float(loss), {f: getattr(p, f).numpy().copy()
                                      for f in sharding.FLOAT_FIELDS}))
        return step, out

    _, want = two_steps()
    with faked_graphs():
        step, got = two_steps()
        assert step.graphs.last.replays == 1
    for (loss, p), (loss_w, p_w) in zip(got, want):
        assert loss == loss_w
        for f in sharding.FLOAT_FIELDS:
            np.testing.assert_array_equal(p[f], p_w[f], err_msg=f)


@pytest.mark.parametrize("decorrelate", [False, True])
def test_vg_through_faked_graphs_matches_jax(world1, decorrelate):
    """The capturing call on the JAX package's numpy scene, against the
    JAX package's ``sharded_value_and_grad_fn`` on a (1, 1) mesh: rtol
    1e-4, atol 1e-6 on every gradient, rtol 1e-6 on the loss (as
    tests/test_torch_sharding.py::test_decorrelated_grads_match_jax)."""
    import jax
    import jax.numpy as jnp

    from isaklm_raytracer_tpu.camera import Camera as JCamera
    from isaklm_raytracer_tpu.config import RenderConfig as JConfig
    from isaklm_raytracer_tpu.dist import sharding as jsharding
    from isaklm_raytracer_tpu.integrator.render import render_sample as jrender_sample
    from isaklm_raytracer_tpu.scene.procedural import cornell_box as jcornell

    mesh, _, camera = world1
    jscene = jcornell(include_blockers=False)
    jcam = JCamera.create((0.0, 0.0, -0.9), fov=jnp.pi / 2)
    jcfg = JConfig(**CONFIG.__dict__)
    key = jax.random.PRNGKey(17)
    target = np.asarray(jrender_sample(jscene, jcam, jax.random.fold_in(key, 0), jcfg))
    jmesh = jsharding.make_render_mesh(1, 1, devices=jax.devices()[:1])
    jparams = jscene.materials.replace(albedo=jscene.materials.albedo * 0.6)
    loss, grads = jsharding.sharded_value_and_grad_fn(jscene, jcfg, jmesh, decorrelate=decorrelate)(
        jparams, jcam, target, key)

    target = np.array(target)  # writable, for torch.from_numpy
    scene = interop.scene_from_numpy(interop.scene_to_numpy(jscene), device="cpu")
    params = scene.materials.replace(albedo=scene.materials.albedo * 0.6)
    with faked_graphs():
        vg = sharding.sharded_value_and_grad_fn(scene, CONFIG, mesh, decorrelate)
        vg(params, camera, torch.from_numpy(target), (0, 17))  # eager
        got_loss, got = vg_result(*vg(params, camera, torch.from_numpy(target), (0, 17)))
        assert vg.graphs.last.replays == 1
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-6)
    for name, g in grads.items():
        np.testing.assert_allclose(got[name], np.asarray(g), rtol=1e-4, atol=1e-6, err_msg=name)


def test_render_sharded_through_faked_graphs_equals_eager(world1):
    """``render_sharded`` on the card's path: full steps (two: eager,
    capture), the adaptive steps down to tail mode (each rung's first two
    calls), and ``sharded_render_fn``'s sample: each bit for bit its eager
    run, the collectives outside the captures."""
    mesh, scene, camera = world1
    full = sharding.render_sharded(scene, camera, CONFIG, 2, mesh, seed=4)
    n = ADAPTIVE.num_pixels
    conv = np.random.default_rng(0).random(n) < 0.9
    gb0 = GBuffer(torch.zeros((n, 3)), torch.zeros(n),
                  torch.from_numpy(np.where(conv, ADAPTIVE.max_samples, 0).astype(np.int32)))
    tail = sharding.render_sharded(scene, camera, ADAPTIVE, 2, mesh, seed=2, adaptive=True,
                                   gbuffer=gb0)
    run, _ = sharding.sharded_render_fn(scene, CONFIG, mesh)
    samples = [run(camera, (0, k)).numpy() for k in (8, 9)]
    with faked_graphs() as faked:
        assert_gb_equal(sharding.render_sharded(scene, camera, CONFIG, 2, mesh, seed=4), full)
        steps = sharding._rank_steps(CONFIG)
        assert steps.step.graphs.last.replays == 1
        got = sharding.render_sharded(scene, camera, ADAPTIVE, 2, mesh, seed=2, adaptive=True,
                                      gbuffer=gb0)
        assert_gb_equal(got, tail)
        tail_step = sharding._rank_steps(ADAPTIVE).tail.graphs.last
        assert tail_step is not None and tail_step.replays == 1
        run, _ = sharding.sharded_render_fn(scene, CONFIG, mesh)
        for k, want in zip((8, 9), samples):
            np.testing.assert_array_equal(run(camera, (0, k)).numpy(), want)
        assert steps.sample.graphs.last.replays == 1
        assert faked.captures and faked.collectives
        assert not any(open_ for _, open_ in faked.collectives)


def test_rank_graphs_key_on_mesh_rank_bucket_and_decorrelate(world1):
    """One graph step a (scene, intersector, ray order) and variant: the
    mesh's shape, the rank, the tail's bucket (or ``adaptive``), and
    ``decorrelate`` for the gradient."""
    mesh, scene, camera = world1
    other_rank = sharding.RenderMesh(1, 2, 1, mesh.device, None, None)
    other_shape = sharding.RenderMesh(2, 1, 0, mesh.device, None, None)
    assert sharding._variant(mesh, 64) == (1, 1, 0, 64)
    assert sharding._variant(other_rank, 64) == (1, 2, 1, 64)
    assert sharding._variant(other_shape, 64) == (2, 1, 0, 64)
    target = _target(scene, camera, (0, 5))
    with faked_graphs():
        steps = sharding._rank_steps(ADAPTIVE)
        gb = GBuffer.create(ADAPTIVE.num_pixels, "cpu")
        _, ids, _ = sharding._tile_layout(ADAPTIVE, mesh)
        for bucket in (64, 32, 64):
            cand, _ = R.candidates(gb, ADAPTIVE, bucket)
            sharding._sharded_tail_step(scene, camera, gb, cand, (0, 1), ADAPTIVE, mesh, ids)
        buckets = [key[-1][-1] for key in steps.tail.graphs.entries]
        assert buckets == [32, 64] and steps.tail.graphs.last.calls == 2
        graphs = steps.tail.graphs
        assert graphs.get(scene, sharding._variant(other_rank, 64)) not in (
            graphs.get(scene, sharding._variant(mesh, 64)),
            graphs.get(scene, sharding._variant(other_shape, 64)))

        vgs = [sharding.sharded_value_and_grad_fn(scene, CONFIG, mesh, d) for d in (False, True)]
        for vg in vgs:
            vg(scene.materials, camera, target, (0, 5))
        entries = list(vgs[0].graphs.entries.values())
        assert vgs[0].graphs is vgs[1].graphs and len(entries) == 2
        assert entries[0][1] is not entries[1][1]
        assert [key[-1] for key in vgs[0].graphs.entries] == [(1, 1, 0, False), (1, 1, 0, True)]


def test_rank_graphs_drop_a_dead_scenes_graphs(world1):
    """The rank steps hold their scenes weakly: a dead scene's render and
    gradient graph steps (and their pools) go."""
    mesh, scene, camera = world1
    target = _target(scene, camera, (0, 5))
    with faked_graphs():
        other = scene.replace(materials=scene.materials)
        sharding.render_sharded(other, camera, CONFIG, 1, mesh)
        sharding.sharded_value_and_grad_fn(other, CONFIG, mesh)(scene.materials, camera,
                                                                target, (0, 5))
        steps = sharding._rank_steps(CONFIG)
        gone = [weakref.ref(steps.step.graphs.last), weakref.ref(steps.vg.graphs.last)]
        assert len(steps.step.graphs.entries) == 1 and len(steps.vg.graphs.entries) == 1
        del other
        gc.collect()
        assert all(ref() is None for ref in gone)
        assert not steps.step.graphs.entries and not steps.vg.graphs.entries
