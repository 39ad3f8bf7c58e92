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
without a card it raises, nothing falls back to the CPU). On the card the
finite differences replay one CUDA graph of ``f``, the counterpart of the
JAX package's jit of ``f`` (``central_difference``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from isaklm_raytracer_tpu_torch.config import resolve_device
from isaklm_raytracer_tpu_torch.integrator.render import GraphStep


def _host_and_device(x, device):
    """``x`` as float32 numpy, and the device ``f`` runs on: a tensor's
    own, else ``device`` resolved."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float32), x.device
    return np.asarray(x, np.float32), resolve_device(device)


def _on_card(device: torch.device) -> bool:
    return device.type == "cuda"


def _evaluator(f, device: torch.device):
    """``f`` as ``central_difference`` evaluates it on ``device``: itself
    on the CPU; on the card through one ``GraphStep`` made here, its
    single input the tensor ``f`` takes (an eager first call, one capture,
    then replays), where a capture that fails raises."""
    if not _on_card(device):
        return f
    step = GraphStep(device)

    def fn(t):
        return (f(t),)

    def evaluate(t):
        capturing = step.calls == 1
        try:
            return step(fn, [t])[0]
        except Exception as err:  # whatever f raised while it was captured
            if not capturing:
                raise
            raise RuntimeError(
                f"central_difference: capturing f into a CUDA graph failed ({type(err).__name__}: "
                f"{err}); f must be capturable, as jax.jit needs f traceable: its tensors on the "
                "card, no .item(), float() or nonzero inside, its tables built before the call"
            ) from err

    return evaluate


@torch.no_grad()
def central_difference(
    f: Callable[[torch.Tensor], torch.Tensor], x, h: float = 1e-3, device="cuda"
) -> np.ndarray:
    """Per-coordinate central differences of a scalar function, in float32,
    one coordinate at a time, ``f`` run on the device of a tensor ``x``,
    else on ``device`` (the card unless the caller passes ``"cpu"``).

    The JAX package jits ``f`` once and runs the compiled program at every
    evaluation; here, on the card, ``f`` goes through one CUDA graph
    (``integrator.render.GraphStep``, made for this call and dropped with
    its pool at the end): the first of the 2n evaluations runs ``f``
    eagerly (its tables are built, its kernels loaded), the second copies
    its input into the graph's static buffer, captures ``f`` once and
    replays it, and every later one copies its input in and replays. A
    replay runs what the capture recorded, so the quotient equals that of
    2n eager calls bit for bit. A capture that fails raises; nothing falls
    back to calling ``f`` eagerly. ``f`` is capturable when its tensors are
    on the card already, it reads nothing on the host inside (no
    ``.item()``, ``float()`` or ``nonzero``) and every table it uses is
    built by the eager first call (a KD tree's triangle table for new
    vertices is not: it raises). Key words given as Python ints go to the
    sampler by value, so they are capturable. On the CPU ``f`` runs
    eagerly 2n times.

    Each f is a scalar tensor; the 2n values are read with one transfer at
    the end, and each quotient (f(x + h) - f(x - h)) / 2h is formed in
    float64 from the two float32 values."""
    x, device = _host_and_device(x, device)
    evaluate = _evaluator(f, device)
    flat = x.reshape(-1)
    values = []
    for i in range(flat.size):
        xp = flat.copy()
        xm = flat.copy()
        xp[i] += h
        xm[i] -= h
        for xs in (xp, xm):
            values.append(evaluate(torch.from_numpy(xs.reshape(x.shape)).to(device)).reshape(()))
    if not values:
        return np.zeros_like(x)
    fp, fm = torch.stack(values).double().cpu().numpy().reshape(-1, 2).T
    return ((fp - fm) / (2.0 * h)).astype(np.float32).reshape(x.shape)


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
    runs it: on the device of a tensor ``x``, else on ``device``. The
    autodiff side is one eager call of ``f`` and its backward (the JAX
    package's grad is not jitted either); the finite differences go
    through ``central_difference``.

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
