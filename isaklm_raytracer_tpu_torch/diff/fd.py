"""Finite-difference gradient checking harness.

Port of ``isaklm_raytracer_tpu/diff/fd.py`` (BASELINE.json's metric "grad
allclose vs FD"). Monte-Carlo rendering makes naive FD useless, so the
harness relies on COMMON RANDOM NUMBERS: the function must be deterministic
in its key words, so f(theta + h) - f(theta - h) differences the very same
light paths and the FD quotient estimates the reparameterized derivative
that backpropagation computes. Discrete decisions (lobe selection, RR,
light pick, hit topology) flip only when a uniform crosses a moving
threshold, an O(h) probability per path.

``f`` takes a float32 tensor and returns a scalar tensor. A tensor ``x``
keeps its own device; anything else that numpy takes goes to ``device``,
the card unless the caller asks for the CPU (``config.resolve_device``:
without a card it raises, nothing falls back to the CPU).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from isaklm_raytracer_tpu_torch.config import resolve_device


def _host_and_device(x, device):
    """``x`` as float32 numpy, and the device ``f`` runs on: a tensor's
    own, else ``device`` resolved."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float32), x.device
    return np.asarray(x, np.float32), resolve_device(device)


@torch.no_grad()
def central_difference(
    f: Callable[[torch.Tensor], torch.Tensor], x, h: float = 1e-3, device="cuda"
) -> np.ndarray:
    """Per-coordinate central differences of a scalar function, in float32,
    one coordinate at a time, ``f`` run on the device of a tensor ``x``,
    else on ``device`` (the card unless the caller passes ``"cpu"``)."""
    x, device = _host_and_device(x, device)
    flat = x.reshape(-1)
    grad = np.zeros_like(flat)
    for i in range(flat.size):
        xp = flat.copy()
        xm = flat.copy()
        xp[i] += h
        xm[i] -= h
        fp = float(f(torch.from_numpy(xp.reshape(x.shape)).to(device)))
        fm = float(f(torch.from_numpy(xm.reshape(x.shape)).to(device)))
        grad[i] = (fp - fm) / (2.0 * h)
    return grad.reshape(x.shape)


def check_grad_vs_fd(
    f: Callable[[torch.Tensor], torch.Tensor],
    x,
    h: float = 1e-3,
    rtol: float = 0.05,
    atol: float = 1e-4,
    device="cuda",
):
    """Returns (autodiff_grad, fd_grad) as numpy arrays; raises
    AssertionError on mismatch. ``f`` runs where ``central_difference``
    runs it: on the device of a tensor ``x``, else on ``device``.

    Tolerances are loose by design: fp32 render accumulation and O(h)
    discrete flips bound the achievable agreement.
    """
    host, device = _host_and_device(x, device)
    leaf = torch.from_numpy(host.copy()).to(device).requires_grad_(True)
    (auto,) = torch.autograd.grad(f(leaf), leaf)
    auto = auto.cpu().numpy()
    fd = central_difference(f, x, h, device)
    np.testing.assert_allclose(auto, fd, rtol=rtol, atol=atol)
    return auto, fd
