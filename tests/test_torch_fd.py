"""The port's finite-difference harness (``diff/fd.py``): where it runs the
function, how it evaluates it on the card, and its quotient against the
JAX package's.

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
- On the card ``f`` goes through one ``GraphStep`` a call: eager once,
  captured once, replayed at the capturing call and at every later one.
  ``faked_card`` runs that path on CPU tensors with ``torch.cuda``'s graph
  calls faked by ``ReplayingGraph``, whose replay runs the captured
  function again into the captured outputs, so a replay returns real
  values; the quotient equals the CPU harness's bit for bit. The
  ``cuda``-marked test holds the real graphs to the eager loop on a card.

JAX is imported inside the test that compares with the JAX package only,
so ``chip_smoke.card_test`` can load this file on a machine without it.
"""

import contextlib

import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu_torch.diff import central_difference, check_grad_vs_fd
from isaklm_raytracer_tpu_torch.diff import fd
from isaklm_raytracer_tpu_torch.integrator import render as R
from isaklm_raytracer_tpu_torch.kernels.intersect import COUNTS

torch.set_num_threads(1)  # the test workers share the host's cores

H = 1e-3
FD_ULPS = 4


def _x(seed: int = 0, n: int = 6) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=n).astype(np.float32)


def _f_torch(t: torch.Tensor) -> torch.Tensor:
    return (torch.sin(t) * t * t).sum() + t[0] * t[1] - 0.5 * t[2]


def _f_jax(t):
    import jax.numpy as jnp

    return (jnp.sin(t) * t * t).sum() + t[0] * t[1] - 0.5 * t[2]


def eager_central_difference(f, x, h: float) -> np.ndarray:
    """The harness as an eager loop on the device of the tensor ``x``: two
    calls of ``f`` a coordinate, each value read with ``float()``."""
    host, device = x.detach().cpu().numpy().astype(np.float32), x.device
    flat = host.reshape(-1)
    grad = np.zeros_like(flat)
    with torch.no_grad():
        for i in range(flat.size):
            xp = flat.copy()
            xm = flat.copy()
            xp[i] += h
            xm[i] -= h
            fp = float(f(torch.from_numpy(xp.reshape(host.shape)).to(device)))
            fm = float(f(torch.from_numpy(xm.reshape(host.shape)).to(device)))
            grad[i] = (fp - fm) / (2.0 * h)
    return grad.reshape(host.shape)


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
    from isaklm_raytracer_tpu.diff.fd import central_difference as jcentral_difference

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


# --- the card's path, with torch.cuda's graph calls faked -------------------


class FakedCard:
    """What ``faked_card`` saw: the graphs made, and whether a faked replay
    is running (an ``f`` tells its body's Python calls from replays)."""

    def __init__(self):
        self.graphs = []
        self.replaying = False


@contextlib.contextmanager
def faked_card():
    """The card's path of ``central_difference`` on CPU tensors: the
    device counts as the card (``fd._on_card``), ``torch.cuda``'s graph
    calls are faked and a ``ReplayingGraph`` stands for
    ``torch.cuda.CUDAGraph``: the capture runs the function on the static
    buffers (``integrator.render._record``, which the fake wraps to keep
    the function and its outputs), a replay runs it again and copies its
    values into those outputs, as a real replay writes them."""
    card = FakedCard()

    class ReplayingGraph:
        def __init__(self, keep_graph=False):
            self.calls = []
            self.fn = self.out = None
            card.graphs.append(self)

        def instantiate(self):
            self.calls.append("instantiate")

        def replay(self):
            self.calls.append("replay")
            card.replaying = True
            try:
                values = self.fn()
            finally:
                card.replaying = False
            for out, value in zip(self.out, values):
                out.copy_(value)

    record = R._record

    def keeping(graph, device, fn, **pool):
        out = record(graph, device, fn, **pool)
        graph.fn, graph.out = fn, out[0]
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "CUDAGraph", ReplayingGraph)
        mp.setattr(torch.cuda, "graph", lambda g, **pool: contextlib.nullcontext())
        mp.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
        mp.setattr(torch.cuda, "synchronize", lambda d=None: None)
        mp.setattr(torch.cuda, "memory_reserved", lambda d=None: 0)
        mp.setattr(R, "_record", keeping)
        mp.setattr(fd, "_on_card", lambda device: True)
        yield card


class _Counted:
    """``_f_torch`` that records each call of its body: True for a faked
    replay, False for a Python call (eager or captured); a Python call
    adds one launch to ``COUNTS.flat_kernel``, as a wrapper would (a real
    replay runs no wrapper). ``raise_at`` raises at that Python call."""

    def __init__(self, card=None, raise_at=None):
        self.card, self.raise_at = card, raise_at
        self.calls = []

    def python_calls(self) -> int:
        return self.calls.count(False)

    def __call__(self, t):
        replay = self.card is not None and self.card.replaying
        self.calls.append(replay)
        if not replay:
            if self.python_calls() == self.raise_at:
                raise RuntimeError("a host read inside the capture")
            COUNTS.flat_kernel += 1
        return _f_torch(t)


def test_on_the_card_f_runs_eagerly_once_is_captured_once_and_replayed():
    x = torch.from_numpy(_x(3))
    n = x.numel()
    want = central_difference(_f_torch, x, H)  # the CPU harness
    COUNTS.reset()
    R.GraphStep.reset_tallies()
    captures = R.GraphStep.captures
    with faked_card() as card:
        f = _Counted(card)
        got = central_difference(f, x, H)
    assert f.python_calls() == 2  # the eager first call, then the capture
    (graph,) = card.graphs
    # the capturing call replays too: 2n - 1 replays, 2n - 2 of them later calls'
    assert graph.calls == ["instantiate"] + ["replay"] * (2 * n - 1)
    assert f.calls.count(True) == 2 * n - 1
    assert R.GraphStep.captures == captures + 1
    assert COUNTS.flat_kernel == 2
    assert R.GraphStep.recorded == {"flat_kernel": 1}
    assert R.GraphStep.replayed == {"flat_kernel": 2 * n - 1}
    # what the card ran: COUNTS - recorded + replayed, one f a evaluation
    assert COUNTS.flat_kernel - 1 + (2 * n - 1) == 2 * n
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, eager_central_difference(_f_torch, x, H))


def test_a_capture_that_fails_raises_and_f_is_not_called_again():
    with faked_card() as card:
        f = _Counted(card, raise_at=2)
        with pytest.raises(RuntimeError, match="f must be capturable") as err:
            central_difference(f, torch.from_numpy(_x()), H)
    assert "a host read inside the capture" in str(err.value)
    assert isinstance(err.value.__cause__, RuntimeError)
    assert f.calls == [False, False]  # eager, the failed capture; nothing fell back
    assert not card.graphs[0].calls  # never instantiated nor replayed


def test_on_the_cpu_f_runs_eagerly_and_no_graph_step_is_made(monkeypatch):
    def no_step(device):
        raise AssertionError("a GraphStep was made on the CPU")

    monkeypatch.setattr(fd, "GraphStep", no_step)
    x = _x(4)
    f = _Counted()
    got = central_difference(f, x, H, device="cpu")
    assert f.calls == [False] * (2 * x.size)
    np.testing.assert_array_equal(got, eager_central_difference(_f_torch, torch.from_numpy(x), H))


def test_check_grad_vs_fd_on_the_card_goes_through_the_graph():
    x = torch.from_numpy(_x(5))
    n = x.numel()
    want_auto, want_fd = check_grad_vs_fd(_f_torch, x, H)
    with faked_card() as card:
        f = _Counted(card)
        auto, got_fd = check_grad_vs_fd(f, x, H)
    # the autodiff side's one eager call, then the finite differences' two
    assert f.python_calls() == 3 and f.calls.count(True) == 2 * n - 1
    (graph,) = card.graphs
    assert graph.calls.count("replay") == 2 * n - 1
    np.testing.assert_array_equal(auto, want_auto)
    np.testing.assert_array_equal(got_fd, want_fd)


def _cornell_loss(scene, camera, config, make_scene=None):
    """The mean of one sample of the Cornell box at ``config`` as a
    function of the albedo; ``make_scene`` (the scene with the albedo) as
    the f of tests/test_estimator.py's albedo check."""
    from isaklm_raytracer_tpu_torch.integrator.render import render_sample

    make_scene = make_scene or (lambda a: scene.replace(
        materials=scene.materials.replace(albedo=a)))

    def loss(albedo):
        return render_sample(make_scene(albedo), camera, (0, 11), config).mean()

    return loss


@pytest.mark.cuda
def test_cuda_central_difference_replays_equal_the_eager_loop():
    """On the card: ``central_difference`` of a closed-form f and of a
    small Cornell render equals the eager loop bit for bit, each through
    one capture and 2n - 1 replays; an f whose capture would build a KD
    triangle table (new vertices every call, the KD walk) raises, and the
    harness calls it no more."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA graph has no CPU mode")
    from isaklm_raytracer_tpu_torch.accel import prepare_scene
    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.scene import procedural

    dev = torch.device("cuda", 0)
    x = torch.from_numpy(_x(6)).to(dev)
    cornell = procedural.cornell_box(include_blockers=False)
    scene = prepare_scene(cornell, dev)
    camera = Camera.create((0.0, 0.0, -0.9), fov=np.pi / 2, device=dev)
    config = RenderConfig(width=8, height=8, max_bounces=2, rr_start_bounce=2)
    for label, f, xs, h in (("closed form", _f_torch, x, H),
                            ("Cornell 8x8", _cornell_loss(scene, camera, config),
                             scene.materials.albedo, 2e-3)):
        R.GraphStep.reset_tallies()
        captures = R.GraphStep.captures
        got = central_difference(f, xs, h)
        assert R.GraphStep.captures == captures + 1, label
        if label != "closed form":  # its f launches no kernel
            assert R.GraphStep.recorded and R.GraphStep.replayed, label
        np.testing.assert_array_equal(got, eager_central_difference(f, xs, h), err_msg=label)

    kd = prepare_scene(cornell, dev, build_kd=True).replace(cbvh=None, wkd=None)
    calls = []

    def fresh_vertices(albedo):
        calls.append(1)
        return kd.replace(vertices=kd.vertices.clone(),
                          materials=kd.materials.replace(albedo=albedo))

    with pytest.raises(RuntimeError, match="f must be capturable") as err:
        central_difference(_cornell_loss(kd, camera, config, fresh_vertices),
                           kd.materials.albedo, 2e-3)
    assert "tri_consts" in str(err.value)
    assert len(calls) == 2  # eager, the failed capture
    torch.cuda.synchronize()
