"""Port parity: colour pipeline, transforms and sampling warps.

The same numpy inputs (from a seed) go through both packages. Tolerance:
atol 1e-6 (float32; XLA on the CPU contracts multiply-adds into FMAs and
uses an approximate rsqrt inside fused code, so last-bit differences are
expected). Terms with a pole or a cancellation -- the conductor Fresnel
ratio, the Smith lambda and the specular weight at grazing angles -- also
get rtol 1e-5, since they amplify a last-bit difference of their inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu.math import color as jc
from isaklm_raytracer_tpu.math import sampling as js
from isaklm_raytracer_tpu.math import transforms as jt
from isaklm_raytracer_tpu_torch.math import color as pc
from isaklm_raytracer_tpu_torch.math import sampling as ps
from isaklm_raytracer_tpu_torch.math import transforms as pt

torch.set_num_threads(1)  # the test workers share the host's cores

ATOL = 1e-6
N = 2048


def _unit(r, n=N):
    v = r.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _frame(r):
    n = _unit(r)
    t = np.cross(n, _unit(r))
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    return n, t.astype(np.float32), np.cross(n, t).astype(np.float32)


def _cmp(jax_fn, torch_fn, *args, rtol=0.0):
    want = np.asarray(jax_fn(*(jnp.asarray(a) for a in args)))
    got = torch_fn(*(torch.from_numpy(np.asarray(a)) for a in args)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ATOL)


@pytest.mark.parametrize("name", [
    "gamma_correction", "aces_curve", "aces_tone_mapping", "correct_color", "luminance",
])
def test_color(name):
    r = np.random.default_rng(1)
    rgb = (r.random((N, 3)) * 4.0 - 0.5).astype(np.float32)
    _cmp(getattr(jc, name), getattr(pc, name), rgb)


def test_transforms():
    r = np.random.default_rng(2)
    a, b = r.normal(size=(2, N, 3)).astype(np.float32)
    _cmp(jt.normalize, pt.normalize, a)
    _cmp(jt.cross, pt.cross, a, b)
    for yaw, pitch, roll in r.uniform(-3, 3, (8, 3)):
        np.testing.assert_allclose(
            pt.rotation_matrix(yaw, pitch, roll).numpy(),
            np.asarray(jt.rotation_matrix(yaw, pitch, roll)), rtol=0, atol=ATOL,
        )


def test_scale_invert_and_orthonormal_frame():
    """scale_matrix exact; orthonormal_frame within ATOL; invert within
    rtol 1e-4 of the inverse's largest entry: both take an LU in float32,
    with another pivoting's rounding, so they are not bit-equal."""
    r = np.random.default_rng(6)
    for s in (0.5, 2.0, -3.25):
        np.testing.assert_array_equal(pt.scale_matrix(s).numpy(),
                                      np.asarray(jt.scale_matrix(s)))
    np.testing.assert_array_equal(pt.scale_matrix(torch.tensor(1.5)).numpy(),
                                  np.asarray(jt.scale_matrix(1.5)))
    for _ in range(16):
        m = (r.normal(size=(3, 3)) + 2.0 * np.eye(3)).astype(np.float32)
        got, want = pt.invert(torch.from_numpy(m)).numpy(), np.asarray(jt.invert(m))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
        np.testing.assert_allclose(got @ m, np.eye(3), atol=1e-5)
    n, t, _ = _frame(r)
    edge = r.normal(size=(N, 3)).astype(np.float32)
    for got, want in zip(pt.orthonormal_frame(torch.from_numpy(n), torch.from_numpy(edge)),
                         jt.orthonormal_frame(jnp.asarray(n), jnp.asarray(edge))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_hemisphere_and_ggx_warps():
    r = np.random.default_rng(3)
    u1, u2 = r.random((2, N)).astype(np.float32)
    rough = r.uniform(0.001, 1.0, N).astype(np.float32)
    n, t, b = _frame(r)
    _cmp(js.cosine_hemisphere, ps.cosine_hemisphere, u1, u2, n, t, b)
    _cmp(js.ggx_half_vector, ps.ggx_half_vector, u1, u2, rough, n, t, b)


def test_fresnel_terms():
    r = np.random.default_rng(4)
    wi, half = _unit(r), _unit(r)
    n1 = r.uniform(1.0, 2.0, N).astype(np.float32)
    n2 = r.uniform(1.0, 2.0, N).astype(np.float32)
    k = r.uniform(0.0, 4.0, N).astype(np.float32)
    _cmp(js.fresnel_dielectric, ps.fresnel_dielectric, wi, half, n1, n2)
    _cmp(js.fresnel_conductor, ps.fresnel_conductor, wi, half, n1 * 0.3, k, rtol=1e-5)


def test_microfacet_weights():
    r = np.random.default_rng(5)
    wi, wo, half, normal = _unit(r), _unit(r), _unit(r), _unit(r)
    rough = r.uniform(0.001, 1.0, N).astype(np.float32)
    _cmp(js.smith_lambda, ps.smith_lambda, wi, normal, rough, rtol=1e-5)
    _cmp(js.specular_weight, ps.specular_weight, wi, wo, half, normal, rough, rtol=1e-5)


def test_reflect_refract_triangle_disc():
    r = np.random.default_rng(6)
    wi, half = _unit(r), _unit(r)
    n1 = r.uniform(1.0, 2.0, N).astype(np.float32)
    n2 = r.uniform(1.0, 2.0, N).astype(np.float32)
    u1, u2 = r.random((2, N)).astype(np.float32)
    p1, p2, p3 = r.normal(size=(3, N, 3)).astype(np.float32)
    _cmp(js.reflect, ps.reflect, wi, half)
    _cmp(js.refract, ps.refract, wi, half, n1, n2)
    _cmp(js.uniform_triangle, ps.uniform_triangle, u1, u2, p1, p2, p3)
    radius = np.float32(0.3)
    jx, jy = js.disc_aperture(jnp.asarray(u1), jnp.asarray(u2), radius)
    px, py = ps.disc_aperture(torch.from_numpy(u1), torch.from_numpy(u2), float(radius))
    np.testing.assert_allclose(px.numpy(), np.asarray(jx), rtol=0, atol=ATOL)
    np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=0, atol=ATOL)
