"""demo-train's window on tiny CPU cells: the steps it runs and checks
follow from the seed alone, a non-finite loss ends its job, and every
update is clamped to the mix's domain."""

import time

import pytest
import torch

import tiny
from perfbench.drivers import train


def _cell():
    return train.Cell(tiny.context("demo-train"))


def _recorded(cell):
    """The key words of every call of the cell's train step, from now on."""
    keys, step = [], cell.step_fn

    def recording(params, camera, target, key):
        keys.append(tuple(key))
        return step(params, camera, target, key)

    cell.step_fn = recording
    return keys


def _first_job(seconds, profiled):
    cell = _cell()
    keys = _recorded(cell)
    if profiled:  # the port's spans record under a profiler
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            window = cell.window(seconds, time.perf_counter())
    else:
        window = cell.window(seconds, time.perf_counter())
    cell.release()
    return cell, keys, window


def test_the_checked_steps_follow_from_the_seed_alone():
    """A short window and a longer traced one run the same first job and
    check the same steps on the same key words."""
    checked = cell_steps = None
    for seconds, profiled in ((0.0, False), (2.0, True)):
        cell, keys, window = _first_job(seconds, profiled)
        n = cell.ctx.traffic["checked_steps"]
        seed = train.common.word(cell.train_seed, 0)
        assert cell.out["seed"] == seed and cell.out["first"] == train.WARMUP_STEPS
        assert keys[:n] == [tuple(cell.key_words(seed, i)) for i in range(n)]
        if checked is None:
            checked, cell_steps = cell.out, window.units
            assert cell_steps == n
            continue
        assert window.units > cell_steps
        assert cell.out["losses"] == checked["losses"]
        for a, b in zip(cell.out["history"], checked["history"]):
            assert all(torch.equal(a[f], b[f]) for f in train.FIELDS)
    assert all(c.ok for c in cell.check())


class _Fake:
    """A train step that moves every leaf by ``push`` and returns the loss
    ``loss(call)``, calls counted from the window's first."""

    def __init__(self, push, loss=lambda call: 1.0):
        self.push, self.loss, self.calls, self.keys = push, loss, 0, []

    def __call__(self, params, camera, target, key):
        self.keys.append(tuple(key))
        loss = torch.tensor(self.loss(self.calls))
        self.calls += 1
        return params.replace(**{f: getattr(params, f) + self.push.get(f, 0.0)
                                 for f in train.FIELDS}), loss


@pytest.mark.parametrize("lag", [0, 2])
def test_a_non_finite_loss_ends_its_job_and_fails_its_steps_from_there(lag, monkeypatch):
    monkeypatch.setattr(train, "LAG", lag)
    cell = _cell()
    k, jobs = 5, cell.ctx.traffic["job_steps"]
    fake = _Fake({}, lambda call: float("nan") if call == k else 1.0)
    cell.step_fn = fake
    window = cell.window(0.5, time.perf_counter())
    # job 0 ran its step k and the lag's steps launched before the host read
    # its loss, and all of them failed; job 1 started from the start on its
    # own seed
    ran = k + 1 + lag
    job0, job1 = (train.common.word(cell.train_seed, j) for j in (0, 1))
    assert fake.keys[:ran] == [tuple(cell.key_words(job0, i)) for i in range(ran)]
    assert fake.keys[ran] == tuple(cell.key_words(job1, 0))
    assert cell.failed_steps == 1 + lag and window.units > ran + jobs
    job2 = train.common.word(cell.train_seed, 2)
    assert fake.keys[ran + jobs] == tuple(cell.key_words(job2, 0))
    # the failed steps are not counted as train steps taken
    good = window.units - cell.failed_steps
    assert window.measures["train_step_ms"] == pytest.approx(1e3 * window.seconds / good)
    cell.release()


def test_an_update_out_of_range_is_clamped_in_the_driver_and_the_reference(monkeypatch):
    cell = _cell()
    lo, hi = cell.domain["albedo"][0], cell.domain["roughness"][1]
    cell.step_fn = _Fake({"albedo": -100.0, "roughness": 100.0})
    cell.window(0.0, time.perf_counter())
    assert torch.all(cell.params.albedo == lo) and torch.all(cell.params.roughness == hi)
    cell.release()
    # the check's first gradient is the update before the clamp
    unclamped = cell.out["unclamped"]
    assert torch.equal(unclamped["albedo"], cell.start["albedo"].cpu() - 100.0)
    assert torch.equal(unclamped["roughness"], cell.start["roughness"].cpu() + 100.0)

    # radiance far over the target that falls as the albedos fall and the
    # roughness rises
    def radiance(scene, trace, camera, sets, keys, ids):
        m = scene.materials
        return (1e6 + 1e3 * (m["albedo"].sum() - m["roughness"].sum())).expand(ids.shape[0], 3)

    monkeypatch.setattr(train.plain, "radiance", radiance)
    _, history, unclamped = cell.reference()
    for h in history[1:]:
        assert torch.all(h["albedo"] == lo) and torch.all(h["roughness"] == hi)
    assert torch.all(unclamped["albedo"] < lo) and torch.all(unclamped["roughness"] > hi)


def test_the_start_lies_in_the_domain():
    cell = _cell()
    for f, (lo, hi) in cell.domain.items():
        assert lo is None or torch.all(cell.start[f] >= lo), f
        assert hi is None or torch.all(cell.start[f] <= hi), f
    cell.window(0.0, time.perf_counter())
    cell.release()
    ctx = tiny.context("demo-train")
    ctx.traffic["domain"] = {**ctx.traffic["domain"], "albedo": [0.0, 0.5]}
    try:
        with pytest.raises(ValueError, match="outside the domain"):
            train.Cell(ctx)
    finally:
        torch.distributed.destroy_process_group()
