"""Inverse rendering of materials: ``dist.sharding.sharded_train_step_fn``
on a one-rank NCCL mesh (1, 1), with its defaults (SGD, lr 0.05).

The task is the repo's material recovery task (``scripts/recipe_sweep.py``):
recover the materials of a rendered image from a perturbed start. Set-up
brings up the process group (a store on a free localhost port), renders the
target with the plain reference at the scene's own materials
(``target_samples`` samples a pixel, key words drawn from ``--seed``), draws
the starting materials (the scene's albedos scaled by a factor in
[0.7, 1.3) each) from the mix's ``start_seed``, and runs three steps through
the same ``train_step`` object that the window then drives: the eager call,
the capture, a replay, on key words of their own.

The window runs jobs of at most ``job_steps`` steps, each from the same
start. Job j draws a seed of its own from the train seed and j, and its
step i the key words of sample i of that seed: a seed a run and a key a
step's position, as ``scripts/recipe_sweep.py`` keys its runs. So the steps
a window runs, and the steps it checks, follow from ``--seed`` alone, not
from the program's speed or from tracing. After every step each material
leaf is clamped in place to its range in the mix's ``domain`` (projected
SGD). A job ends at its first loss that is not finite, and the next job
starts. The host reads each loss ``LAG`` steps after the step that made
it, so that it never waits for the card's latest work: that step and the
steps the job ran on in the lag failed. The window ends in a sync, and
its seconds over its steps that did not fail give ``train_step_ms``.

The check: the first ``checked_steps`` steps of the window's first job,
all replays of the captured graphs; the reference follows them from the
same start with the same key words in plain autograd (its own renders,
losses, gradients, SGD updates and clamps). The median over the steps of
the loss's gap, and the median over the leaves of the gaps of the first
gradient as the update shows it before its clamp ((p0 - p1) / lr) and of
the change of the parameters over the checked steps, are held to it.
"""

from __future__ import annotations

import collections
import math
import statistics
import sys
import time

import torch

from perfbench.core import Check, Window
from perfbench.drivers import common
from perfbench.reference import plain

FIELDS = ("albedo", "emittance", "roughness", "ior", "extinction", "transparent")
# the train step's first call runs eagerly, its second captures and
# replays, the third replays: set-up runs all three
WARMUP_STEPS = 3
# steps between a loss's step and the host's read of it
LAG = 16


def _group(device) -> None:
    """A one-rank NCCL group with its store on a free localhost port."""
    import socket

    import torch.distributed as dist

    if dist.is_initialized():
        return
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, device_id=device if backend == "nccl" else None)


def project(params: dict, ranges: dict) -> dict:
    """``params`` with every leaf clamped to its range."""
    return {f: torch.clamp(v, *ranges[f]) for f, v in params.items()}


class Losses:
    """The window's losses, each read on the host ``LAG`` steps after the
    step that made it (on the card through a copy to pinned memory and an
    event). ``first_bad`` maps each job whose loss stopped being finite to
    the position of its first loss that is not."""

    def __init__(self, device) -> None:
        self.on_card = device.type == "cuda"
        self.pending = collections.deque()
        self.first_bad = {}

    def put(self, job: int, pos: int, loss: torch.Tensor) -> None:
        if self.on_card:
            host = torch.empty((), dtype=loss.dtype, pin_memory=True)
            host.copy_(loss.detach(), non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = loss.detach(), None
        self.pending.append((job, pos, host, event))
        while len(self.pending) > LAG:
            self._read()

    def drain(self) -> None:
        while self.pending:
            self._read()

    def _read(self) -> None:
        job, pos, host, event = self.pending.popleft()
        if event is not None:
            event.synchronize()
        if not math.isfinite(float(host)) and job not in self.first_bad:
            self.first_bad[job] = pos


class Cell:
    def __init__(self, ctx) -> None:
        from isaklm_raytracer_tpu_torch.dist.sharding import (make_render_mesh,
                                                              sharded_train_step_fn)
        from isaklm_raytracer_tpu_torch.math import rng

        self.ctx, t = ctx, ctx.traffic
        device = ctx.device
        marks = [time.perf_counter()]
        self.arrays = common.scene_arrays(ctx.config)
        self.scene = common.program_scene(self.arrays, device)
        self.config = common.render_config(ctx.config)
        self.camera = common.program_camera(ctx.config, device)
        self.lights = common.light_order(self.arrays, self.scene)
        marks.append(time.perf_counter())
        _group(device)
        self.mesh = make_render_mesh(1, 1, device)
        self.lr = t["learning_rate"]
        self.step_fn = sharded_train_step_fn(self.scene, self.config, self.mesh,
                                             learning_rate=self.lr)
        self.key_words = rng.sample_key_words
        marks.append(time.perf_counter())
        self.target = self._target()
        marks.append(time.perf_counter())
        # one start for every seed: the materials set how long paths live, and
        # so the work of a step
        start = torch.Generator(device=device)
        start.manual_seed(t["start_seed"])
        scale = 0.7 + 0.6 * torch.rand(self.arrays.materials["albedo"].shape, generator=start,
                                       device=device)
        self.start = {f: torch.as_tensor(self.arrays.materials[f], device=device)
                      for f in FIELDS}
        self.start["albedo"] = self.start["albedo"] * scale
        # each leaf's (low, high) range; None leaves that side open
        self.domain = {f: tuple(t["domain"][f]) for f in FIELDS}
        inside = project(self.start, self.domain)
        outside = [f for f in FIELDS if not torch.equal(self.start[f], inside[f])]
        if outside:
            raise ValueError(f"the start lies outside the domain in {outside}")
        self.train_seed = common.word(ctx.seed, 5)
        self.params = self._fresh()
        self.calls = 0
        warmup_seed = common.word(ctx.seed, 7)
        for i in range(WARMUP_STEPS):
            self._step(self.key_words(warmup_seed, i))
        common.sync(device)
        marks.append(time.perf_counter())
        spans = [b - a for a, b in zip(marks, marks[1:])]
        print("perfbench: set-up s: scene %.2f, group %.2f, target %.2f, warm-up steps %.2f"
              % tuple(spans), file=sys.stderr)

    def _target(self) -> torch.Tensor:
        """The (H*W, 3) target: the reference's render at the scene's own
        materials, the mean of ``target_samples`` samples a pixel. The
        program's peak is read from after it."""
        t, c, device = self.ctx.traffic, self.ctx.config, self.ctx.device
        scene, trace = common.reference_scene(self.arrays, self.lights, device)
        n, samples = self.config.num_pixels, t["target_samples"]
        ids = torch.arange(n, dtype=torch.int32, device=device)
        keys = common.sample_keys(common.word(self.ctx.seed, 6), range(samples), device)
        with torch.no_grad():
            rad = common.path_radiance(scene, trace, common.reference_camera(c, device),
                                       common.settings(c), keys.repeat_interleave(n, dim=0),
                                       ids.repeat(samples), t["check_batch"])
        target = rad.reshape(samples, n, 3).mean(dim=0).contiguous()
        del scene, trace, rad
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        return target

    def _fresh(self):
        return self.scene.materials.replace(**{f: v.clone() for f, v in self.start.items()})

    def _step(self, key, unclamped=None):
        """One train step on ``key``, its parameters clamped in place; a
        copy of them before the clamp goes into the dict ``unclamped``."""
        self.params, loss = self.step_fn(self.params, self.camera, self.target, key)
        if unclamped is not None:
            unclamped.update({f: getattr(self.params, f).detach().clone() for f in FIELDS})
        with torch.no_grad():
            for f, (lo, hi) in self.domain.items():
                getattr(self.params, f).clamp_(lo, hi)
        self.calls += 1
        return loss

    def window(self, seconds: float, t0: float) -> Window:
        t = self.ctx.traffic
        setup_s = time.perf_counter() - t0
        losses = Losses(self.ctx.device)
        steps, job, pos = 0, 0, 0
        seed = common.word(self.train_seed, job)
        self.params = self._fresh()
        # the first job's first steps are kept on the card for the check, and
        # its first step's parameters before their clamp
        checked = {"first": self.calls, "seed": seed, "losses": [], "params": [self.start],
                   "unclamped": {}}
        # the steps each job ran
        ran = {}
        start = time.perf_counter()
        while time.perf_counter() - start < seconds or steps < t["checked_steps"]:
            first = job == 0 and pos == 0
            loss = self._step(self.key_words(seed, pos), checked["unclamped"] if first else None)
            if job == 0 and pos < t["checked_steps"]:
                checked["losses"].append(loss)
                checked["params"].append({f: getattr(self.params, f).detach().clone()
                                          for f in FIELDS})
            losses.put(job, pos, loss)
            steps, pos = steps + 1, pos + 1
            ran[job] = pos
            if pos == t["job_steps"] or job in losses.first_bad:
                # the next job, from the same start
                job, pos = job + 1, 0
                seed = common.word(self.train_seed, job)
                self.params = self._fresh()
        common.sync(self.ctx.device)
        elapsed = time.perf_counter() - start
        losses.drain()
        self.checked = checked
        # a job's steps from its first loss that is not finite on failed
        self.failed_steps = sum(ran[j] - p for j, p in losses.first_bad.items())
        good = max(steps - self.failed_steps, 1)
        return Window(elapsed, steps, {"setup_s": setup_s,
                                       "train_step_ms": 1e3 * elapsed / good},
                      steps=steps, rays=0.0)

    def release(self) -> None:
        job = self.checked
        self.out = {
            "first": job["first"], "seed": job["seed"],
            "losses": [float(x) for x in job["losses"]],
            "history": [{f: v[f].detach().cpu().clone() for f in FIELDS}
                        for v in job["params"]],
            "unclamped": {f: v.cpu() for f, v in job["unclamped"].items()}}
        del self.scene, self.step_fn, self.params, self.mesh, self.checked
        import torch.distributed as dist

        dist.destroy_process_group()

    def checked_units(self) -> int:
        return self.ctx.traffic["checked_steps"]

    def reference(self, dtype=torch.float32):
        """The reference's losses and parameters over the checked steps,
        from the start, on the key words of the checked job's steps, each
        update clamped to the domain; and its first step's parameters
        before their clamp."""
        from torch import autograd

        device = self.ctx.device
        t, c = self.ctx.traffic, self.ctx.config
        scene, trace = common.reference_scene(self.arrays, self.lights, device, dtype)
        camera = common.reference_camera(c, device, dtype)
        sets = common.settings(c)
        params = {f: v.to(dtype) for f, v in self.start.items()}
        target = self.target.to(dtype)
        n = self.config.num_pixels
        ids = torch.arange(n, dtype=torch.int32, device=device)
        losses, history = [], [{f: v.float().cpu() for f, v in params.items()}]
        unclamped = None
        for step in range(t["checked_steps"]):
            # the one sample stream of the (1, 1) mesh folds in its index 0
            key = plain.fold_in(plain.sample_key_words(self.out["seed"], step), 0)
            keys = torch.tensor([key], dtype=torch.int64, device=device)
            leaves = {f: v.detach().clone().requires_grad_() for f, v in params.items()}
            scene.materials = {**scene.materials, **leaves}
            loss = torch.zeros((), dtype=torch.float64, device=device)
            grads = {f: torch.zeros_like(v, dtype=torch.float64) for f, v in leaves.items()}
            for lo in range(0, n, t["check_batch"]):
                part = ids[lo:lo + t["check_batch"]]
                rad = plain.radiance(scene, trace, camera, sets,
                                     keys.expand(part.shape[0], 2), part)
                err = rad - target[lo:lo + part.shape[0]]
                value = torch.sum(err * err) / (3.0 * n)
                g = autograd.grad(value, [leaves[f] for f in FIELDS], allow_unused=True)
                loss += value.detach().double()
                for f, gf in zip(FIELDS, g):
                    if gf is not None:
                        grads[f] += gf.double()
            losses.append(loss.item())
            params = {f: params[f] - self.lr * grads[f].to(dtype) for f in FIELDS}
            if unclamped is None:
                unclamped = {f: v.float().cpu() for f, v in params.items()}
            params = project(params, self.domain)
            history.append({f: v.float().cpu() for f, v in params.items()})
        return losses, history, unclamped

    def check(self, outputs=None) -> list:
        """The checks of the program's first steps (or of ``outputs``,
        (losses, parameter history, first step's parameters before their
        clamp), put in their place)."""
        lim = self.ctx.traffic["limits"]
        gaps = self.gaps(outputs)
        return [Check("loss_gap", statistics.median(gaps["loss"]), lim["loss_gap"]),
                Check("grad_gap", statistics.median(gaps["grad"].values()), lim["grad_gap"]),
                Check("change_gap", statistics.median(gaps["change"].values()),
                      lim["change_gap"])]

    def gaps(self, outputs=None) -> dict:
        """Each checked step's loss gap, and each kept leaf's gap of the
        first gradient and of the change (``leaf_gaps``)."""
        if not hasattr(self, "_ref"):
            self._ref = self.reference()
        ref_losses, ref_hist, ref_first = self._ref
        if outputs is None:
            outputs = self.out["losses"], self.out["history"], self.out["unclamped"]
        losses, hist, first = outputs
        grad = {f: (hist[0][f].double() - first[f].double()) / self.lr for f in FIELDS}
        ref_grad = {f: (ref_hist[0][f].double() - ref_first[f].double()) / self.lr
                    for f in FIELDS}
        change = {f: hist[-1][f].double() - hist[0][f].double() for f in FIELDS}
        ref_change = {f: ref_hist[-1][f].double() - ref_hist[0][f].double() for f in FIELDS}
        return {"loss": [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)],
                "grad": leaf_gaps(grad, ref_grad, ref_grad),
                "change": leaf_gaps(change, ref_change, ref_grad)}


def leaf_gaps(got: dict, ref: dict, ref_grad: dict) -> dict:
    """Each leaf's gap between the program's norm of it and the
    reference's, over the larger of the reference's norm of that leaf and
    of the median leaf. The check takes the median and not the worst leaf:
    one path in 10,000 takes another turn in the program than in the
    reference (rounding in the intersector), and the roughness leaf's
    gradient, which the glass at roughness 0.001 dominates, can then move
    by 10-76% in one step (PERF.md). Leaves whose reference gradient is
    under a thousandth of the median leaf's move by rounding alone, and
    are left out."""
    gnorm = {f: float(torch.linalg.vector_norm(ref_grad[f])) for f in ref_grad}
    median_g = statistics.median(gnorm.values())
    kept = [f for f in ref if gnorm[f] >= 1e-3 * median_g]
    norms = {f: float(torch.linalg.vector_norm(ref[f])) for f in kept}
    median = statistics.median(norms.values())
    return {f: abs(float(torch.linalg.vector_norm(got[f])) - norms[f]) / max(norms[f], median)
            for f in kept}


def control(cell: Cell) -> list:
    """The checks with the reference in bfloat16 put in the program's
    place."""
    return cell.check(cell.reference(torch.bfloat16))

