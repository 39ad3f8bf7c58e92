"""The port's finite-difference harness (``diff/fd.py``): where it runs the
function, and its quotient against the JAX package's.

- A tensor ``x`` keeps its own device; anything numpy takes goes to the
  ``device`` argument, the card by default (``config.resolve_device``):
  without a card that raises, and ``device="cpu"`` runs on the CPU.
- ``central_difference`` of a closed-form function equals the JAX
  package's ``central_difference`` of the same function written in
  ``jnp``, on the same numpy ``x`` from a seed. Both evaluate ``f`` in
  float32 and form (f(x + h) - f(x - h)) / 2h in float64 from the two
  float32 values: each f may differ by a few float32 ulps between XLA's
  and PyTorch's CPU code (the order of a sum, sin's last bit), so the
  quotients agree within FD_ULPS ulps of the largest |f| over 2h.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu.diff.fd import central_difference as jcentral_difference
from isaklm_raytracer_tpu_torch.diff import central_difference, check_grad_vs_fd

torch.set_num_threads(1)  # the test workers share the host's cores

H = 1e-3
FD_ULPS = 4


def _x(seed: int = 0, n: int = 6) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=n).astype(np.float32)


def _f_torch(t: torch.Tensor) -> torch.Tensor:
    return (torch.sin(t) * t * t).sum() + t[0] * t[1] - 0.5 * t[2]


def _f_jax(t):
    return (jnp.sin(t) * t * t).sum() + t[0] * t[1] - 0.5 * t[2]


class _Devices:
    """An ``f`` that records the device of every tensor it is given."""

    def __init__(self):
        self.seen = set()

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        self.seen.add(t.device.type)
        return _f_torch(t)


@pytest.mark.parametrize("harness", ["central_difference", "check_grad_vs_fd"])
def test_numpy_x_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch, harness):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"central_difference": central_difference, "check_grad_vs_fd": check_grad_vs_fd}[harness]
    f = _Devices()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fn(f, _x())
    assert not f.seen  # f never ran: nothing fell back to the CPU
    fn(f, _x(), device="cpu")
    assert f.seen == {"cpu"}


@pytest.mark.parametrize("harness", ["central_difference", "check_grad_vs_fd"])
def test_tensor_x_keeps_its_device(monkeypatch, harness):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"central_difference": central_difference, "check_grad_vs_fd": check_grad_vs_fd}[harness]
    f = _Devices()
    fn(f, torch.from_numpy(_x()))  # the default "cuda" is not consulted for a tensor
    assert f.seen == {"cpu"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_central_difference_equals_the_jax_package(seed):
    x = _x(seed)
    got = central_difference(_f_torch, x, H, device="cpu")
    want = jcentral_difference(_f_jax, x, H)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == x.shape
    f_max = max(abs(float(_f_torch(torch.from_numpy(x + s * H)))) for s in (-1.0, 1.0))
    atol = FD_ULPS * float(np.spacing(np.float32(f_max))) / (2.0 * H)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=atol)
    # and both are the derivative: sin(x) x^2 + the linear terms, to O(h^2)
    exact = np.sin(x.astype(np.float64)) * 2 * x + np.cos(x.astype(np.float64)) * x * x
    exact[0] += x[1]
    exact[1] += x[0]
    exact[2] -= 0.5
    np.testing.assert_allclose(got, exact, rtol=0.0, atol=1e-2)
