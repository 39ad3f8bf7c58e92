"""Port parity: the step factories of ``integrator/render.py`` and the
sync-free pieces under them.

- ``_first_ids`` (a cumsum and a scatter, no host read) against
  ``jnp.nonzero(size=bucket, fill_value=0)``: ids and count exact, on
  hypothesis masks (none active, all active, more active than the bucket,
  odd pixel counts);
- ``uniforms`` with the key words as a (2,) int64 tensor against the same
  words as ints and against ``jax.random``'s stream: bit for bit;
- each of the five factories against its eager function bit for bit (on
  the CPU a factory runs the eager step), and against the JAX factory of
  the same name on a small Cornell box: counts, candidate ids and active
  counts exact, radiance sums within the golden tolerance of
  tests/test_torch_render.py (atol 1e-4 but for at most 8 values, all
  within 3e-4). The JAX side renders the unprepared scene through its
  brute force under jit, the port the prepared scene through flat, as
  tests/test_torch_sharding.py compares them;
- ``render`` over the adaptive ladder against the JAX package's ``render``
  (the same tolerance) and against an eager loop of ``render_step``,
  ``candidates`` and ``tail_step`` (bit for bit);
- ``GraphStep``'s bookkeeping (warm-up, capture, replay, launch counts
  and the tallies of recorded and replayed launches) with ``torch.cuda``'s
  graph calls faked, and the graph cache's key: a changed
  ``ISAKLM_INTERSECTOR`` or ``ISAKLM_BLK_SORT``, another scene or another
  variant gets a fresh step; a dead scene's graphs are dropped. The real capture runs on the card
  (``chip_smoke.py`` phase graphs).
"""

import contextlib
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from isaklm_raytracer_tpu.camera import Camera as JCamera
from isaklm_raytracer_tpu.config import RenderConfig as JConfig
from isaklm_raytracer_tpu.integrator import render as jrender
from isaklm_raytracer_tpu.integrator.render import sample_key_data
from isaklm_raytracer_tpu.math import rng as jrng
from isaklm_raytracer_tpu.scene.procedural import cornell_box as jcornell
from isaklm_raytracer_tpu.scene.types import GBuffer as JGBuffer
from isaklm_raytracer_tpu_torch.accel import prepare_scene
from isaklm_raytracer_tpu_torch.camera import Camera
from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.integrator import render as R
from isaklm_raytracer_tpu_torch.kernels.intersect import COUNTS
from isaklm_raytracer_tpu_torch.math import rng
from isaklm_raytracer_tpu_torch.scene.procedural import cornell_box
from isaklm_raytracer_tpu_torch.scene.types import GBuffer

torch.set_num_threads(1)  # the test workers share the host's cores

# as tests/test_torch_sharding.py's PROGRESSIVE: converges within a few
# samples, so the ladder goes down several buckets
CFG = RenderConfig(width=24, height=24, max_bounces=3, min_samples=2, max_samples=64,
                   max_tolerance=0.5, min_wavefront=64)
JCFG = JConfig(**CFG.__dict__)
# the same down to 16 pixels a wavefront: 8 adaptive samples take three
# buckets of the tail ladder
LADDER = RenderConfig(width=24, height=24, max_bounces=3, min_samples=2, max_samples=64,
                      max_tolerance=0.5, min_wavefront=16)


@pytest.fixture(scope="module")
def scenes():
    """(port scene, port camera, JAX scene, JAX camera): the Cornell box
    without blockers, prepared for the port, as built for the JAX package."""
    return (prepare_scene(cornell_box(include_blockers=False), "cpu"),
            Camera.create((0.0, 0.0, -0.9), fov=np.pi / 2, device="cpu"),
            jcornell(include_blockers=False), JCamera.create((0.0, 0.0, -0.9), fov=jnp.pi / 2))


def _np(gb) -> dict:
    return {k: np.asarray(getattr(gb, k)) for k in ("frame", "sq_luminance", "count")}


def _jgb(gb: GBuffer) -> JGBuffer:
    return JGBuffer(*(jnp.asarray(getattr(gb, k).numpy())
                      for k in ("frame", "sq_luminance", "count")))


def _jkey(seed: int, i: int):
    return jax.random.fold_in(jax.random.PRNGKey(seed), i)


def _assert_gb_close(got, want) -> None:
    """Counts exact; radiance sums within the golden tolerance."""
    got, want = _np(got), _np(want)
    np.testing.assert_array_equal(got["count"], want["count"])
    for k in ("frame", "sq_luminance"):
        err = np.abs(got[k] - want[k])
        assert int((err > 1e-4).sum()) <= 8 and err.max() <= 3e-4, (k, err.max())


def _assert_gb_equal(got, want) -> None:
    for k, v in _np(want).items():
        np.testing.assert_array_equal(_np(got)[k], v, err_msg=k)


def _mixed_gbuffer(seed: int, active_share: float) -> GBuffer:
    """A G-buffer whose gate is decided by the counts alone: count 1 (below
    min_samples) needs a sample, count 64 (max_samples) does not."""
    r = np.random.default_rng(seed)
    n = CFG.num_pixels
    active = r.random(n) < active_share
    count = np.where(active, 1, CFG.max_samples).astype(np.int32)
    frame = (r.random((n, 3)) * count[:, None]).astype(np.float32)
    return GBuffer(torch.from_numpy(frame), torch.from_numpy(frame.sum(1)),
                   torch.from_numpy(count))


# --- sync-free ids and tensor key words ------------------------------------


@st.composite
def masks(draw):
    n = draw(st.integers(1, 257))
    kind = draw(st.sampled_from(["none", "all", "random"]))
    if kind == "none":
        mask = np.zeros(n, bool)
    elif kind == "all":
        mask = np.ones(n, bool)
    else:
        mask = np.array(draw(st.lists(st.booleans(), min_size=n, max_size=n)), bool)
    return mask, draw(st.integers(1, n))


@settings(max_examples=60, deadline=None, derandomize=True)
@given(masks())
def test_first_ids_equal_jnp_nonzero(case):
    mask, bucket = case
    ids, n = R._first_ids(torch.from_numpy(mask), bucket)
    want = np.asarray(jnp.nonzero(jnp.asarray(mask), size=bucket, fill_value=0)[0])
    assert ids.dtype == torch.int32 and ids.shape == (bucket,)
    np.testing.assert_array_equal(ids.numpy(), want)
    assert isinstance(n, torch.Tensor) and int(n) == int(mask.sum())


@pytest.mark.parametrize("active_share,bucket", [(0.0, 288), (1.0, 576), (0.3, 288),
                                                 (0.9, 288), (0.5, 7)])
def test_candidates_and_count_match_jax(active_share, bucket):
    """Including more actives than the bucket (0.9 and 0.5 of 576 pixels
    into 288 and 7 slots): the ids are cut off, the count is not."""
    gb = _mixed_gbuffer(5, active_share)
    ids, n = R.make_candidates_fn(CFG, bucket)(gb)
    jids, jn = jrender.make_candidates_fn(JCFG, bucket)(_jgb(gb))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert isinstance(n, torch.Tensor) and int(n) == int(jn)
    count = R.make_active_count_fn(CFG)(gb)
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == int(jrender.make_active_count_fn(JCFG)(_jgb(gb)))
    assert int(count) == int(R.needs_sample(gb, CFG).sum())
    want_ids, want_n = R.candidates(gb, CFG, bucket)
    np.testing.assert_array_equal(ids.numpy(), want_ids.numpy())
    assert int(n) == int(want_n)


@pytest.mark.parametrize("stream,n", [(0, 9), (5, 9), (rng.CAMERA_STREAM, 4)])
def test_uniforms_tensor_key_words_bit_exact(stream, n):
    """The (2,) int64 key tensor, the same words as ints and the JAX
    package's stream of the same key give the same bits."""
    r = np.random.default_rng(stream)
    ids = torch.from_numpy(r.integers(0, 1920 * 1080, 2048).astype(np.int32))
    for seed, index in ((0, 0), (7, 3), (2**32 - 1, 2**31 + 5)):
        words = rng.sample_key_words(seed, index)
        as_ints = rng.uniforms(words, ids, stream, n)
        as_tensor = rng.uniforms(rng.key_tensor(words), ids, stream, n)
        kd = sample_key_data(_jkey(seed, index))
        want = np.asarray(jrng.uniforms(kd, jnp.asarray(ids.numpy()), stream, n))
        np.testing.assert_array_equal(as_tensor.numpy(), as_ints.numpy())
        np.testing.assert_array_equal(as_tensor.numpy(), want)


def test_threefry_takes_key_tensor_words():
    r = np.random.default_rng(1)
    words = tuple(int(x) for x in r.integers(0, 2**32, 2))
    key = rng.key_tensor(words)
    assert key.dtype == torch.int64 and key.shape == (2,)
    x0, x1 = (torch.from_numpy(r.integers(0, 2**32, 512)) for _ in range(2))
    for got, want in zip(rng.threefry2x32(key[0], key[1], x0, x1),
                         rng.threefry2x32(*words, x0, x1)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


# --- the factories against the eager steps and against JAX ----------------


@pytest.mark.parametrize("adaptive", [False, True])
def test_step_fn_equals_eager_and_matches_jax(scenes, adaptive):
    scene, camera, jscene, jcam = scenes
    step = R.make_step_fn(CFG)
    assert R.make_step_fn(CFG) is step  # one step a configuration, as lru_cache(config)
    gb = eager = GBuffer.create(CFG.num_pixels, "cpu")
    jgb = _jgb(gb)
    jstep = jrender.make_step_fn(JCFG)
    for i in range(3):
        words = rng.sample_key_words(4, i)
        key = rng.key_tensor(words) if i == 1 else words  # either form
        gb = step(scene, camera, gb, key, adaptive)
        eager = R.render_step(scene, camera, eager, words, CFG, adaptive)
        jgb = jstep(jscene, jcam, jgb, _jkey(4, i), adaptive)
        _assert_gb_equal(gb, eager)
    _assert_gb_close(gb, jgb)


def test_compact_step_fn_equals_eager_and_matches_jax(scenes):
    scene, camera, jscene, jcam = scenes
    gb = _mixed_gbuffer(2, 0.3)
    bucket = R.compact_bucket(int(R.make_active_count_fn(CFG)(gb)), CFG.num_pixels, 64)
    assert bucket < CFG.num_pixels
    words = rng.sample_key_words(3, 1)
    got = R.make_compact_step_fn(CFG, bucket)(scene, camera, gb, words)
    _assert_gb_equal(got, R.compact_step(scene, camera, gb, words, CFG, bucket))
    # the compacted step equals the masked full step
    _assert_gb_equal(got, R.render_step(scene, camera, gb, words, CFG, adaptive=True))
    want = jrender.make_compact_step_fn(JCFG, bucket)(jscene, jcam, _jgb(gb), _jkey(3, 1))
    _assert_gb_close(got, want)


def test_tail_step_fn_equals_eager_and_matches_jax(scenes):
    scene, camera, jscene, jcam = scenes
    gb = _mixed_gbuffer(3, 0.4)
    bucket = 288
    cand, _ = R.make_candidates_fn(CFG, bucket)(gb)
    words = rng.sample_key_words(6, 2)
    gb2, cand2, n = R.make_tail_step_fn(CFG, bucket)(scene, camera, gb, cand, words)
    egb, ecand, en = R.tail_step(scene, camera, gb, cand, words, CFG)
    _assert_gb_equal(gb2, egb)
    np.testing.assert_array_equal(cand2.numpy(), ecand.numpy())
    assert isinstance(n, torch.Tensor) and int(n) == int(en)
    jcand, _ = jrender.make_candidates_fn(JCFG, bucket)(_jgb(gb))
    jgb2, jcand2, jn = jrender.make_tail_step_fn(JCFG, bucket)(
        jscene, jcam, _jgb(gb), jcand, _jkey(6, 2))
    _assert_gb_close(gb2, jgb2)
    np.testing.assert_array_equal(cand2.numpy(), np.asarray(jcand2))
    assert int(n) == int(jn)


def test_render_over_the_ladder_matches_jax_and_the_eager_loop(scenes):
    """Adaptive, 8 samples at LADDER: at least two buckets of the tail ladder."""
    scene, camera, jscene, jcam = scenes
    R.make_tail_step_fn.cache_clear()
    got = R.render(scene, camera, LADDER, 8, seed=3, adaptive=True)
    buckets = R.make_tail_step_fn.cache_info().currsize
    assert buckets >= 2, buckets
    _assert_gb_close(got, jrender.render(jscene, jcam, JConfig(**LADDER.__dict__), 8, seed=3,
                                        adaptive=True))

    # the eager loop render() stands for
    gb = GBuffer.create(LADDER.num_pixels, "cpu")
    cand, bucket = None, LADDER.num_pixels
    for i in range(8):
        words = rng.sample_key_words(3, i)
        if cand is None:
            n = int(R.needs_sample(gb, LADDER).sum())
            if n == 0:
                break
            bucket = R.compact_bucket(n, LADDER.num_pixels, LADDER.min_wavefront)
            if bucket < LADDER.num_pixels:
                cand, _ = R.candidates(gb, LADDER, bucket)
        if cand is not None:
            gb, cand, n = R.tail_step(scene, camera, gb, cand, words, LADDER)
            if int(n) == 0:
                break
            nb = R.compact_bucket(int(n), LADDER.num_pixels, LADDER.min_wavefront)
            if nb < bucket:
                cand, bucket = cand[:nb], nb
            continue
        gb = R.render_step(scene, camera, gb, words, LADDER, adaptive=True)
    _assert_gb_equal(got, gb)


# --- GraphStep and its cache, with torch.cuda's graph calls faked ----------


class _FakeGraph:
    """Stands for torch.cuda.CUDAGraph: records calls, replays nothing."""

    def __init__(self, keep_graph=False):
        self.calls = []

    def instantiate(self):
        self.calls.append("instantiate")

    def replay(self):
        self.calls.append("replay")


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 0)


def test_graph_step_warms_up_captures_and_counts_replays(fake_cuda):
    calls = []

    def fn(x, y):
        calls.append(1)
        COUNTS.flat_kernel += 2  # as two wrapper launches would
        COUNTS.blk_kernel += 1
        return x * 2.0, y + 1

    g = R.GraphStep(torch.device("cpu"))
    COUNTS.reset()
    R.GraphStep.reset_tallies()
    x, y = torch.arange(4.0), torch.zeros(3, dtype=torch.int32)
    out = g(fn, [x, y])  # warm-up: eager
    assert g.graph is None and len(calls) == 1 and COUNTS.flat_kernel == 2
    np.testing.assert_array_equal(out[0].numpy(), [0, 2, 4, 6])

    out = g(fn, [x + 1, y])  # capture (fn runs once, recorded) and one replay
    assert len(calls) == 2 and g.graph.calls == ["instantiate", "replay"]
    assert g.launches == {"flat_kernel": 2, "blk_kernel": 1} and g.replays == 1
    # the wrappers counted the launches they recorded into the graph; the
    # replay moved no count and is tallied apart
    assert (COUNTS.flat_kernel, COUNTS.blk_kernel) == (4, 2)
    assert R.GraphStep.recorded == {"flat_kernel": 2, "blk_kernel": 1}
    assert R.GraphStep.replayed == {"flat_kernel": 2, "blk_kernel": 1}
    np.testing.assert_array_equal(out[0].numpy(), [2, 4, 6, 8])
    assert all(o is not s for o, s in zip(out, g.static_out))  # the caller owns its copy
    assert g.capture_s >= 0 and g.instantiate_s >= 0 and g.pool_bytes == 0

    g(None, [x + 5, y + 3])  # replay only: inputs copied into the static ones
    assert len(calls) == 2 and g.graph.calls[-1] == "replay" and g.replays == 2
    assert (COUNTS.flat_kernel, COUNTS.blk_kernel) == (4, 2)
    assert R.GraphStep.replayed == {"flat_kernel": 4, "blk_kernel": 2}
    # what the card ran: the eager launches and the replays'
    ran = {k: getattr(COUNTS, k) - R.GraphStep.recorded[k] + R.GraphStep.replayed[k]
           for k in ("flat_kernel", "blk_kernel")}
    assert ran == {"flat_kernel": 6, "blk_kernel": 3}
    np.testing.assert_array_equal(g.static_in[0].numpy(), (x + 5).numpy())
    np.testing.assert_array_equal(g.static_in[1].numpy(), (y + 3).numpy())
    COUNTS.reset()
    R.GraphStep.reset_tallies()


def test_graph_cache_keys_on_scene_intersector_order_and_variant(scenes, monkeypatch):
    scene = scenes[0]
    monkeypatch.delenv("ISAKLM_INTERSECTOR", raising=False)
    monkeypatch.delenv("ISAKLM_BLK_SORT", raising=False)
    graphs = R._Graphs(maxsize=8)
    auto = graphs.get(scene, None)
    assert graphs.get(scene, None) is auto and graphs.last is auto
    monkeypatch.setenv("ISAKLM_INTERSECTOR", "flat")  # the auto rule's own pick
    assert graphs.get(scene, None) is auto
    monkeypatch.setenv("ISAKLM_INTERSECTOR", "queue")
    queue = graphs.get(scene, None)
    assert queue is not auto
    monkeypatch.setenv("ISAKLM_INTERSECTOR", "hbm")
    assert graphs.get(scene, None) not in (auto, queue)
    monkeypatch.delenv("ISAKLM_INTERSECTOR")
    monkeypatch.setenv("ISAKLM_BLK_SORT", "block")
    assert graphs.get(scene, None) is not auto
    monkeypatch.setenv("ISAKLM_BLK_SORT", "morton")
    assert graphs.get(scene, None) is auto
    assert graphs.get(scene, True) is not auto  # another variant (adaptive)
    other = scene.replace(materials=scene.materials)  # another scene object
    assert graphs.get(other, None) is not auto
    # the entries point at their scenes without keeping them alive,
    # least recently used dropped first
    assert all(ref() is scene or ref() is other for ref, _ in graphs.entries.values())
    small = R._Graphs(maxsize=1)
    first = small.get(scene, None)
    small.get(other, None)
    assert small.get(scene, None) is not first


def test_graph_cache_drops_a_scenes_graphs_when_the_scene_dies(scenes):
    """A dead scene's graphs (and with them their pools) go: the cache
    holds its scenes weakly, and a new object at a reused id gets a fresh
    step."""
    graphs = R._Graphs()
    keep = graphs.get(scenes[0], None)
    other = scenes[0].replace(materials=scenes[0].materials)
    step = graphs.get(other, None)
    assert graphs.last is step and len(graphs.entries) == 2
    gone = weakref.ref(step)
    del other, step
    gc.collect()
    assert gone() is None and graphs.last is None and len(graphs.entries) == 1
    assert graphs.get(scenes[0], None) is keep
    # a stale entry under a reused id is not handed out
    third = scenes[0].replace(materials=scenes[0].materials)
    key = next(iter(graphs.entries))
    graphs.entries[(id(third), *key[1:])] = (weakref.ref(scenes[0]), keep)
    assert graphs.get(third, None) is not keep


def test_factory_step_on_the_card_path_replays_a_fresh_graph_per_intersector(
        scenes, fake_cuda, monkeypatch):
    """The card's path of ``make_step_fn`` with the graph calls faked: the
    first call of a key runs eagerly and equals ``render_step``, the second
    captures; a changed ISAKLM_INTERSECTOR starts a fresh step (eager
    again) instead of replaying the other kernel's graph."""
    scene, camera = scenes[0], scenes[1]
    monkeypatch.setattr(R, "_on_card", lambda s: True)
    monkeypatch.setattr(R, "_key_on", lambda words, device: rng.key_tensor(words, device))
    monkeypatch.delenv("ISAKLM_INTERSECTOR", raising=False)
    cfg = RenderConfig(width=8, height=8, max_bounces=2)
    step = R.make_step_fn(cfg)
    gb0 = GBuffer.create(cfg.num_pixels, "cpu")
    words = rng.sample_key_words(1, 0)
    want = R.render_step(scene, camera, gb0, words, cfg, adaptive=False)
    _assert_gb_equal(step(scene, camera, gb0, words, False), want)  # eager
    flat = step.graphs.last
    assert flat.graph is None
    _assert_gb_equal(step(scene, camera, gb0, words, False), want)  # capture + replay
    assert flat.graph is not None and step.graphs.last is flat
    monkeypatch.setenv("ISAKLM_INTERSECTOR", "queue")
    _assert_gb_equal(step(scene, camera, gb0, words, False), want)
    assert step.graphs.last is not flat and step.graphs.last.graph is None
    R.make_step_fn.cache_clear()


def test_jax_factories_do_not_retrace_when_the_intersector_changes(monkeypatch):
    """The staleness the port's cache key avoids (ROADMAP C.17): the JAX
    package's ``make_step_fn(config)`` is cached on the configuration and
    its jit on the arguments' shapes, so a call after ISAKLM_INTERSECTOR
    changes replays the program traced under the old value: the
    intersector is picked (``make_trace_fn``) once."""
    picks = []
    real = jrender.make_trace_fn

    def counting(scene, config):
        picks.append(__import__("os").environ.get("ISAKLM_INTERSECTOR", "auto"))
        return real(scene, config)

    monkeypatch.setattr(jrender, "make_trace_fn", counting)
    cfg = JConfig(width=8, height=8, max_bounces=2)
    jrender.make_step_fn.cache_clear()
    step = jrender.make_step_fn(cfg)
    scene = jcornell(include_blockers=False)
    cam = JCamera.create((0.0, 0.0, -0.9), fov=jnp.pi / 2)
    gb = JGBuffer.create(cfg.num_pixels)
    monkeypatch.setenv("ISAKLM_INTERSECTOR", "flat")
    gb = step(scene, cam, gb, _jkey(0, 0), False)  # donates the G-buffer
    monkeypatch.setenv("ISAKLM_INTERSECTOR", "queue")
    assert jrender.make_step_fn(cfg) is step
    step(scene, cam, gb, _jkey(0, 1), False)
    assert picks == ["flat"]
    jrender.make_step_fn.cache_clear()
