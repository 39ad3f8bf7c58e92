"""The port's spans (``isaklm_raytracer_tpu_torch.telemetry``) and the
benchmark's readers of them, on the CPU.

- spans nest: a child carries its parent's id and step id, a span with no
  parent starts a request, and ``step=`` joins one;
- spans record only under ``torch.profiler.profile``; with no profiler a
  site gets the shared null context and the buffer stays empty;
- ``render``'s steps: the ``lanes`` and ``active`` of every
  ``render.step`` and ``render.tail`` span equal the bucket and the active
  count recomputed from the G-buffer before that step, and the loop reads
  the host as often with the profiler as without;
- the train step's span tree (``train.step`` and its five parts) on a
  one-rank gloo group, the viewer's frame (``viewer.step`` and
  ``viewer.image`` under one step id), and ``GraphStep``'s
  ``graph.replay`` with ``torch.cuda``'s graph calls faked;
- the readers of ``perfbench/metrics/`` on synthetic records and spans:
  None without spans (and without the module, as on a program that has
  none), only idle time under a span counted, never more than the
  window's idle time; ``tools.profiling.idle_gaps`` ends each gap at the
  launch of the record after it, and ``idle_by_span`` gives the gap to
  the innermost span open at that launch.
"""

import contextlib
import random
import socket
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from isaklm_raytracer_tpu_torch import telemetry  # noqa: E402
from isaklm_raytracer_tpu_torch.accel import prepare_scene  # noqa: E402
from isaklm_raytracer_tpu_torch.camera import Camera  # noqa: E402
from isaklm_raytracer_tpu_torch.config import RenderConfig  # noqa: E402
from isaklm_raytracer_tpu_torch.integrator import render as R  # noqa: E402
from isaklm_raytracer_tpu_torch.math import rng  # noqa: E402
from isaklm_raytracer_tpu_torch.scene.procedural import cornell_box  # noqa: E402
from isaklm_raytracer_tpu_torch.tools.profiling import idle_by_span  # noqa: E402
from perfbench import core  # noqa: E402
from perfbench.trace import summarize  # noqa: E402

torch.set_num_threads(1)  # the test workers share the host's cores

# converges within a few samples, so 8 adaptive samples go down three
# buckets of the tail ladder (tests/test_torch_steps.py's LADDER)
LADDER = RenderConfig(width=24, height=24, max_bounces=3, min_samples=2, max_samples=64,
                      max_tolerance=0.5, min_wavefront=16)
SAMPLES = 8
IDLE_READERS = {"host_idle_ms_per_step.adaptive": "render",
                "host_idle_ms_per_step.render": "render",
                "host_idle_ms_per_step.train": "train"}
READERS = [*IDLE_READERS, "lane_use_pct.adaptive"]


@contextlib.contextmanager
def recording():
    """A CPU torch.profiler session over the block, the buffer emptied
    before it; yields the list the block's spans are put in on exit."""
    telemetry.clear()
    got = []
    with profile(activities=[ProfilerActivity.CPU]):
        yield got
    got.extend(telemetry.spans())
    telemetry.clear()


@pytest.fixture(scope="module")
def scene():
    return (prepare_scene(cornell_box(include_blockers=False), "cpu"),
            Camera.create((0.0, 0.0, -0.9), fov=np.pi / 2, device="cpu"))


# --- the spans -------------------------------------------------------------


def test_spans_nest_with_parent_ids_and_one_step_id_a_request():
    with recording() as got:
        with telemetry.span("a") as a:
            a.count("n", 3)
            with telemetry.span("b") as b:
                with telemetry.span("c"):
                    pass
            with telemetry.span("d"):
                pass
        with telemetry.span("e") as e:
            pass
        with telemetry.span("f", step=a.step):
            pass
    spans = {s.name: s for s in got}
    assert [s.name for s in got] == ["a", "b", "c", "d", "e", "f"]
    assert spans["a"].parent is None and spans["a"].step == spans["a"].id
    assert spans["b"].parent == a.id and spans["c"].parent == b.id
    assert spans["d"].parent == a.id
    assert {spans[k].step for k in "abcdf"} == {a.id}
    assert spans["e"].parent is None and e.step == e.id != a.id
    assert spans["f"].parent is None
    assert spans["a"].counts == {"n": 3} and spans["b"].counts == {}
    assert len({s.id for s in got}) == len(got)
    for s in got:
        assert s.start_ns <= s.end_ns
    assert spans["a"].start_ns <= spans["b"].start_ns <= spans["c"].start_ns
    assert spans["c"].end_ns <= spans["b"].end_ns <= spans["a"].end_ns


def test_spans_record_under_the_profiler_and_nothing_outside_it():
    telemetry.clear()
    with telemetry.span("before") as s:
        s.count("n", 1)
    assert s is telemetry.NULL and s.step is None
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.span("inside") as s:
            pass
    assert isinstance(s, telemetry.Span)
    with telemetry.span("after") as s:
        pass
    assert s is telemetry.NULL
    assert [x.name for x in telemetry.spans()] == ["inside"]
    telemetry.clear()
    assert telemetry.spans() == []


def test_the_clock_is_the_profilers():
    """A span and a ``record_function`` opened one after the other start
    within a millisecond on the profiler's clock."""
    telemetry.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("mine") as s:
            with torch.profiler.record_function("theirs"):
                torch.ones(4).sum()
    (event,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "theirs"]
    assert s.start_ns <= event.start_ns() + 1_000_000
    assert abs(event.start_ns() - s.start_ns) < 1_000_000
    telemetry.clear()


def test_the_off_path_leaves_the_buffer_empty(scene):
    telemetry.clear()
    R.render(*scene, LADDER, SAMPLES, seed=3, adaptive=True)
    R.render(*scene, LADDER, 2, seed=3, adaptive=False)
    assert telemetry.spans() == []


class _Reads:
    """Counts the host reads of a tensor's value (``int()``, ``bool()``,
    ``float()``, ``.item()``, ``.tolist()``) made in the block."""

    NAMES = ("__int__", "__bool__", "__float__", "__index__", "item", "tolist")

    def __init__(self, monkeypatch):
        self.n = 0
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, **k):
                self.n += 1
                return _orig(t, *a, **k)

            monkeypatch.setattr(torch.Tensor, name, counted)


def _gbuffer_before(scene, k: int):
    """The G-buffer ``render`` has before its step k (k steps from fresh)."""
    return R.render(*scene, LADDER, k, seed=3, adaptive=True)


def test_render_step_spans_count_the_bucket_and_the_active_pixels(scene, monkeypatch):
    reads = _Reads(monkeypatch)
    got_off = R.render(*scene, LADDER, SAMPLES, seed=3, adaptive=True)
    reads_off, reads.n = reads.n, 0
    with recording() as spans:
        got_on = R.render(*scene, LADDER, SAMPLES, seed=3, adaptive=True)
    assert reads.n == reads_off  # no host read added under the profiler
    monkeypatch.undo()
    for k in ("frame", "sq_luminance", "count"):
        assert torch.equal(getattr(got_on, k), getattr(got_off, k))

    (call,) = [s for s in spans if s.name == "render"]
    assert call.counts == {"samples": SAMPLES, "adaptive": 1}
    steps = [s for s in spans if s.name in ("render.step", "render.tail")]
    assert all(s.parent == call.id and s.step == call.id for s in steps)
    names = [s.name for s in steps]
    assert "render.step" in names and names.count("render.tail") >= 3, names
    # the buckets recomputed from the G-buffers: a full step launches every
    # pixel; tail mode starts at the bucket of the count that entered it and
    # shrinks to the bucket of each step's count
    n, floor = LADDER.num_pixels, LADDER.min_wavefront
    bucket = n
    for k, s in enumerate(steps):
        active = int(R.needs_sample(_gbuffer_before(scene, k), LADDER).sum())
        if s.name == "render.step":
            bucket = R.compact_bucket(active, n, floor)
            assert bucket == n
        elif k == 0 or steps[k - 1].name == "render.step":
            bucket = R.compact_bucket(active, n, floor)
        assert s.counts == {"lanes": bucket, "active": active}, (k, s)
        if s.name == "render.tail":
            bucket = min(bucket, R.compact_bucket(active, n, floor))
    # one count read a step, in a render.count span; the tail step's inside it
    counts = [s for s in spans if s.name == "render.count"]
    assert reads_off == len(counts)  # each count read is the loop's one host read
    tails = {s.id for s in steps if s.name == "render.tail"}
    assert sum(s.parent in tails for s in counts) == len(tails)
    assert len([s for s in spans if s.name == "render.candidates"]) == 1


def test_a_render_without_the_gate_counts_every_lane_active(scene):
    with recording() as spans:
        R.render(*scene, LADDER, 2, seed=3, adaptive=False)
    steps = [s for s in spans if s.name == "render.step"]
    assert [s.counts for s in steps] == [{"lanes": LADDER.num_pixels,
                                          "active": LADDER.num_pixels}] * 2
    assert not [s for s in spans if s.name in ("render.count", "render.tail")]


def test_the_viewer_frame_and_its_image_share_a_step_id(scene):
    from isaklm_raytracer_tpu_torch.viewer import InteractiveSession

    session = InteractiveSession(*scene, RenderConfig(width=8, height=8, max_bounces=2), seed=1)
    with recording() as spans:
        session.step()
        session.image()
        session.step(keys=["w"])
        session.image()
    assert [s.name for s in spans] == ["viewer.step", "viewer.image"] * 2
    first, second = spans[:2], spans[2:]
    assert first[0].step == first[1].step != second[0].step == second[1].step
    assert all(s.parent is None for s in spans)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_the_train_step_spans_its_parts(scene):
    import torch.distributed as dist

    from isaklm_raytracer_tpu_torch.dist.sharding import (make_render_mesh,
                                                          sharded_train_step_fn)

    config = RenderConfig(width=8, height=8, max_bounces=2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        prepared, camera = scene
        step = sharded_train_step_fn(prepared, config, make_render_mesh(1, 1, "cpu"))
        params = prepared.materials
        target = torch.zeros((config.num_pixels, 3))
        with recording() as spans:
            for i in range(2):
                params, _ = step(params, camera, target, rng.sample_key_words(1, i))
    finally:
        dist.destroy_process_group()
    parts = ["train.forward", "train.loss", "train.backward", "train.all_reduce",
             "train.update"]
    assert [s.name for s in spans] == (["train.step"] + parts) * 2
    for root, *children in (spans[:6], spans[6:]):
        assert root.parent is None and root.step == root.id
        assert all(c.parent == root.id and c.step == root.id for c in children)
    assert spans[0].step != spans[6].step


def test_a_graph_step_replay_records_graph_replay(monkeypatch):
    class FakeGraph:
        def __init__(self, keep_graph=False):
            pass

        def instantiate(self):
            pass

        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d=None: 0)
    g = R.GraphStep(torch.device("cpu"))
    x = torch.arange(4.0)
    with recording() as spans:
        for _ in range(3):  # eager, capture and replay, replay
            g(lambda t: (t * 2.0,), [x])
    assert [s.name for s in spans] == ["graph.replay"] * 2
    R.GraphStep.reset_tallies()


# --- the readers -----------------------------------------------------------


def _span(name, start, end, sid=0, parent=None, **counts):
    return telemetry.Span(name, start, end, sid, parent, sid, dict(counts), [])


def _summary(records, kind="render", steps=4):
    return summarize(sorted(records, key=lambda r: r[1]), steps, 1.0, kind, steps)


# busy [100, 200), [300, 350), [330, 400), [600, 700): the window 100-700,
# idle [200, 300) and [400, 600), 300 ns
RECORDS = [("k", 100, 100), ("k", 300, 50), ("k", 330, 70), ("k", 600, 100)]


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_none_without_spans(name, monkeypatch):
    kind = IDLE_READERS.get(name, "render")
    monkeypatch.setattr(telemetry, "spans", lambda: [])
    assert core.load_reader(name)(_summary(RECORDS, kind)) is None
    # spans wholly outside the window
    monkeypatch.setattr(telemetry, "spans", lambda: [
        _span("render.step", 0, 90, lanes=4, active=2), _span("render", 710, 800)])
    assert core.load_reader(name)(_summary(RECORDS, kind)) is None
    # a program without the telemetry module (the parent of the readers)
    import isaklm_raytracer_tpu_torch

    monkeypatch.delattr(isaklm_raytracer_tpu_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "isaklm_raytracer_tpu_torch.telemetry", None)
    assert core.load_reader(name)(_summary(RECORDS, kind)) is None


@pytest.mark.parametrize("name", list(IDLE_READERS))
def test_an_idle_reader_counts_only_idle_time_under_a_span(name, monkeypatch):
    kind = IDLE_READERS[name]
    # [150, 250) covers 50 ns of the first gap; [450, 500) and its child
    # [460, 480) cover 50 of the second; [650, 690) none
    monkeypatch.setattr(telemetry, "spans", lambda: [
        _span("a", 150, 250, 0), _span("b", 450, 500, 1), _span("c", 460, 480, 2, 1),
        _span("d", 650, 690, 3)])
    assert core.load_reader(name)(_summary(RECORDS, kind)) == pytest.approx(100 * 1e-6 / 4)
    # the wrong kind of window reads nothing
    other = "train" if kind == "render" else "render"
    assert core.load_reader(name)(_summary(RECORDS, other)) is None


@pytest.mark.parametrize("seed", range(6))
def test_an_idle_reader_never_reads_more_than_the_windows_idle_time(seed, monkeypatch):
    r = random.Random(seed)
    records = []
    for _ in range(200):
        start = r.randrange(0, 100_000)
        records.append(("k", start, r.randrange(1, 400)))
    summary = _summary(records, "render", steps=7)
    idle_ms = (summary.window_s - summary.busy_s) * 1e3 / 7
    spans = [_span("s", a, a + r.randrange(0, 30_000), i)
             for i, a in enumerate(r.randrange(-10_000, 110_000) for _ in range(12))]
    monkeypatch.setattr(telemetry, "spans", lambda: spans)
    read = core.load_reader("host_idle_ms_per_step.render")(summary)
    assert 0 <= read <= idle_ms * (1 + 1e-9)
    # one span over the whole window: all of its idle time is the program's
    monkeypatch.setattr(telemetry, "spans", lambda: [_span("all", -1, 10**6)])
    assert core.load_reader("host_idle_ms_per_step.render")(summary) == pytest.approx(
        idle_ms, rel=1e-9)


def test_lane_use_sums_the_window_steps_lanes_and_active_pixels(monkeypatch):
    monkeypatch.setattr(telemetry, "spans", lambda: [
        _span("render.step", 90, 150, 0, lanes=100, active=80),  # overlaps the start
        _span("render.tail", 200, 300, 1, lanes=50, active=10),
        _span("render.count", 210, 220, 2, 1),
        _span("render", 80, 720, 3, samples=50, adaptive=1),
        _span("render.tail", 710, 800, 4, lanes=50, active=50),  # after the window
    ])
    read = core.load_reader("lane_use_pct.adaptive")
    assert read(_summary(RECORDS)) == pytest.approx(100.0 * 90 / 150)
    assert read(_summary(RECORDS, "train")) is None


def test_idle_by_span_takes_the_innermost_span_open_at_the_launch():
    spans = [_span("outer", 10, 100, 0), _span("inner", 20, 30, 1, 0),
             _span("later", 50, 60, 2, 0)]
    # (idle ns, the launch that ended the gap, its record's start)
    gaps = [(5, 25, 0), (7, 40, 0), (9, 55, 0), (11, 5, 0), (13, None, 0), (17, 100, 0),
            (19, 10, 0)]
    assert idle_by_span(gaps, spans) == {"inner": 5, "outer": 26, "later": 9, None: 41}
    assert idle_by_span(gaps, []) == {None: 81}


class _Event:
    def __init__(self, name, start, dur, corr, device):
        self._v = name, start, dur, corr, device

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]


def test_idle_gaps_end_at_the_launch_of_the_next_record(monkeypatch):
    from torch.autograd import DeviceType

    from isaklm_raytracer_tpu_torch.tools import profiling

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_Event("cudaLaunchKernel", 5, 2, 1, cpu), _Event("filler", 8, 1, 1, cuda),
              _Event("cudaGraphLaunch", 90, 3, 2, cpu), _Event("k", 100, 100, 2, cuda),
              _Event("k", 300, 50, 2, cuda), _Event("k", 330, 70, 2, cuda),
              _Event("cudaMemcpyAsync", 550, 4, 3, cpu), _Event("copy", 600, 100, 3, cuda),
              _Event("k", 800, 10, 4, cuda)]  # launched before the profile
    prof = type("Prof", (), {})()
    prof.profiler = type("P", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self: events})()
    monkeypatch.setattr(profiling, "filler_name", lambda: "filler")
    assert profiling.idle_gaps(prof) == [(100, 90, 300), (200, 550, 600), (100, None, 800)]


