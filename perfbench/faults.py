"""Faults planted in the program's timed path, to show that ``correct``
catches them (``calibrate.py --fault``, ``tests/test_perfbench_faults.py``).

- ``unchanged``: a step returns its state unchanged (the G-buffer's
  sums, or the train step's parameters);
- ``half``: half of the batch left out (the radiance of the second half
  of every render call's pixels zeroed; the train step's loss and
  gradient over the first half of the pixels);
- ``altered``: every radiance sample scaled by 1 + 2**-7 where the render
  produces it;
- ``stale_key`` (train only): every train step after the second runs on
  the second's key words, as a replay of the graphs captured in the
  second call would if it ignored the key copied in; the eager first
  call and the capture are sound.

A one-rank mesh has no exchange between cards to leave out.

``loads_jax`` is no fault of ``correct``: it puts a module named ``jax``
in ``sys.modules`` for the block, so that a run can be seen refused when
a process of it (a spawned rank too) has loaded JAX.
"""

from __future__ import annotations

import contextlib
import sys
import types
from unittest import mock


def _render_sample(original, change):
    def render_sample(*args, **kwargs):
        return change(original(*args, **kwargs))

    return render_sample


def _halved(radiance):
    import torch

    rows = torch.arange(radiance.shape[0] // 2, radiance.shape[0], device=radiance.device)
    return radiance.index_fill(0, rows, 0.0)


def _patches(name: str, driver: str) -> list:
    from isaklm_raytracer_tpu_torch.dist import sharding
    from isaklm_raytracer_tpu_torch.integrator import render

    if name == "unchanged":
        if driver == "train":
            original = sharding.sharded_train_step_fn

            def train_fn(*args, **kwargs):
                step = original(*args, **kwargs)

                def train_step(params, camera, target, key_words):
                    _, loss = step(params, camera, target, key_words)
                    return params, loss

                return train_step

            return [mock.patch.object(sharding, "sharded_train_step_fn", train_fn)]
        return [mock.patch.object(render, "add_sample", lambda gb, radiance, took: gb),
                mock.patch.object(render, "scatter_sample", lambda gb, ids, rad, valid: gb)]
    if name == "half":
        if driver == "train":
            original = sharding._tile_layout

            def tile_layout(config, mesh):
                per_tile, ids, valid = original(config, mesh)
                half = per_tile // 2
                return half, ids[:half], valid[:half]

            return [mock.patch.object(sharding, "_tile_layout", tile_layout)]
        return [mock.patch.object(render, "render_sample",
                                  _render_sample(render.render_sample, _halved))]
    if name == "stale_key":
        original = sharding.sharded_train_step_fn

        def stale_fn(*args, **kwargs):
            step = original(*args, **kwargs)
            keys = []

            def train_step(params, camera, target, key_words):
                keys.append(key_words)
                return step(params, camera, target, keys[min(len(keys), 2) - 1])

            return train_step

        return [mock.patch.object(sharding, "sharded_train_step_fn", stale_fn)]
    if name == "loads_jax":
        return [mock.patch.dict(sys.modules, {"jax": types.ModuleType("jax")})]
    if name == "altered":
        def scale(radiance):
            return radiance * (1.0 + 2.0 ** -7)

        return [mock.patch.object(render, "render_sample",
                                  _render_sample(render.render_sample, scale)),
                mock.patch.object(sharding, "render_sample",
                                  _render_sample(sharding.render_sample, scale))]
    raise ValueError(f"unknown fault {name!r}")


FAULTS = ("unchanged", "half", "altered")
# faults that only one driver's timed path can have
OWN = {"train": ("stale_key",)}


def of(driver: str) -> tuple:
    """The faults that ``correct`` has to catch in a cell of ``driver``."""
    return FAULTS + OWN.get(driver, ())


@contextlib.contextmanager
def planted(name, ctx):
    """The block with fault ``name`` planted (none for None)."""
    if name is None:
        yield
        return
    with contextlib.ExitStack() as stack:
        for patch in _patches(name, ctx.traffic["driver"]):
            stack.enter_context(patch)
        yield
