"""Port parity: the entry points (``isaklm_raytracer_tpu_torch/entry.py``)
against ``__graft_entry__.py``.

- The port of ``tests/test_sharding.py::test_graft_entry_contract``:
  ``entry("cpu")``'s ``fn`` gives finite radiance, and
  ``dryrun_multichip(4, "cpu")`` runs on four gloo ranks (the most that
  tests/test_torch_sharding.py spawns; the JAX test takes 8 virtual
  devices), its loss finite and its gathered frame bit-equal to a single
  process's ``render`` of the same samples (one sample stream a tile).
- ``entry()``'s output against the JAX ``entry()``'s under ``jax.jit``:
  every value within atol 1e-4 (measured 4.3e-6). The JAX entry traces
  through the KD walk, the port's through flat (its ``prepare_scene``
  builds no tree); the two part only on knife-edge rays (ROADMAP C.14),
  of which this view has none, and XLA's FMAs move the last bits.
- The dry run's loss against the JAX dry run's on its (2, 2) mesh of
  virtual devices: rtol 1e-5 (measured 1.3e-7).
- Without a card both entry points raise unless the caller asks for the
  CPU.
"""

import contextlib
import importlib.util
import io
import os
import re

import jax
import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu_torch import entry as pentry
from isaklm_raytracer_tpu_torch.integrator.render import render

torch.set_num_threads(1)  # the test workers share the host's cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graft_entry():
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dryrun():
    return pentry.dryrun_multichip(4, "cpu")


def test_graft_entry_contract(dryrun):
    fn, args = pentry.entry("cpu")
    out = fn(*args)
    assert out.shape == (32 * 32, 3) and torch.isfinite(out).all()
    assert args[1].dtype == torch.int64 and args[1].tolist() == [0, 0]
    assert dryrun["mesh"] == (2, 2) and np.isfinite(dryrun["loss"])
    assert np.isfinite(dryrun["frame"]).all()
    scene, camera, config = pentry._small_scene_and_config("cpu", width=16, height=16,
                                                           bounces=3)
    want = render(scene, camera, config, 2, adaptive=True)
    np.testing.assert_array_equal(dryrun["frame"], want.frame.numpy())
    np.testing.assert_array_equal(dryrun["count"], want.count.numpy())


def test_entry_matches_jax_entry():
    mod = _graft_entry()
    jfn, jargs = mod.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = pentry.entry("cpu")
    got = fn(*args).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_dryrun_loss_matches_jax_dryrun(dryrun):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _graft_entry().dryrun_multichip(4)
    loss = float(re.search(r"loss=([-0-9.e]+)", out.getvalue()).group(1))
    assert "'tile': 2, 'sample': 2" in out.getvalue()
    np.testing.assert_allclose(dryrun["loss"], loss, rtol=1e-5)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pentry.entry()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pentry.dryrun_multichip(1)
