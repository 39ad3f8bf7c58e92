"""Port parity: hit shading, BSDF sampling, NEE, path tracing, adaptive gate.

Both packages get the same prepared scene (JAX ``prepare_scene`` leaves
carried over with ``interop``), the same numpy rays and uniforms, and the
brute-force oracle as intersector. The JAX side runs op by op
(``jax.disable_jit``): jitted XLA code on the CPU contracts multiply-adds
into FMAs and uses an approximate rsqrt, which the port (like the JAX
package's own eager ops) does not, so op by op is the like-for-like
reference. Tolerances, float32: 2e-5 absolute on unit vectors, positions
and weights; path radiance 1e-4 relative (+1e-5 absolute) after four
bounces of glossy and transmissive events, which amplify last-bit
differences of sin/cos/pow between the two libraries. Masks and ids are
exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu.accel import prepare_scene as jprepare
from isaklm_raytracer_tpu.accel.traverse import HitAttributes as JHit
from isaklm_raytracer_tpu.accel.traverse import hit_attributes as jhit_attributes
from isaklm_raytracer_tpu.accel.traverse import nearest_hit_brute as jbrute
from isaklm_raytracer_tpu.config import RenderConfig as JConfig
from isaklm_raytracer_tpu.integrator.adaptive import needs_sample as jneeds
from isaklm_raytracer_tpu.integrator.bsdf import scatter as jscatter
from isaklm_raytracer_tpu.integrator.nee import sample_direct_light as jdirect
from isaklm_raytracer_tpu.integrator.path_trace import trace_paths as jtrace
from isaklm_raytracer_tpu.scene import procedural as jproc
from isaklm_raytracer_tpu.scene.types import GBuffer as JGBuffer
from isaklm_raytracer_tpu_torch import interop
from isaklm_raytracer_tpu_torch.accel.traverse import HitAttributes, hit_attributes
from isaklm_raytracer_tpu_torch.accel.traverse import nearest_hit_brute
from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.integrator.adaptive import needs_sample
from isaklm_raytracer_tpu_torch.integrator.bsdf import scatter
from isaklm_raytracer_tpu_torch.integrator.nee import sample_direct_light
from isaklm_raytracer_tpu_torch.integrator.path_trace import trace_paths

torch.set_num_threads(1)  # the test workers share the host's cores

ATOL = 2e-5
N = 1024


@pytest.fixture(scope="module")
def scenes():
    jscene = jprepare(jproc.material_demo_scene())
    return jscene, interop.scene_from_numpy(interop.scene_to_numpy(jscene), device="cpu")


def _rays(r, jscene, n=N):
    v = np.asarray(jscene.vertices).reshape(-1, 3)
    lo, hi = v.min(axis=0), v.max(axis=0)
    o = (r.random((n, 3)) * (hi - lo) + lo).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _hits(scenes, r):
    jscene, pscene = scenes
    o, d = _rays(r, jscene)
    _, idx, hit = jbrute(jnp.asarray(o), jnp.asarray(d), jscene.vertices)
    with jax.disable_jit():
        jattrs = jhit_attributes(jscene, jnp.asarray(o), jnp.asarray(d), idx, hit)
    pattrs = hit_attributes(pscene, torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(np.array(idx)), torch.from_numpy(np.array(hit)))
    return o, d, np.array(hit), jattrs, pattrs


def _close(got, want, atol=ATOL, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def test_hit_attributes(scenes):
    _, _, hit, jattrs, pattrs = _hits(scenes, np.random.default_rng(0))
    assert hit.mean() > 0.3
    for name in ("albedo", "emittance", "roughness", "ior", "extinction",
                 "transparent", "triangle_index"):
        np.testing.assert_array_equal(
            getattr(pattrs, name).numpy(), np.asarray(getattr(jattrs, name)), err_msg=name
        )
    for name in ("position", "normal", "tangent", "bitangent"):
        _close(getattr(pattrs, name)[hit], np.asarray(getattr(jattrs, name))[hit])
    _close(pattrs.t[hit], np.asarray(jattrs.t)[hit], rtol=1e-5)


def test_scatter(scenes):
    r = np.random.default_rng(1)
    _, d, hit, jattrs, _ = _hits(scenes, r)
    # one hit record for both sides: the JAX package's
    leaves = {f: np.array(getattr(jattrs, f)) for f in JHit.__dataclass_fields__}
    pattrs = HitAttributes(**{k: torch.from_numpy(v) for k, v in leaves.items()})
    inside = r.random(N) < 0.3
    u = r.random((5, N)).astype(np.float32)
    with jax.disable_jit():
        want = jscatter(JHit(**{k: jnp.asarray(v) for k, v in leaves.items()}),
                        jnp.asarray(d), jnp.asarray(inside), *map(jnp.asarray, u))
    got = scatter(pattrs, torch.from_numpy(d), torch.from_numpy(inside),
                  *map(torch.from_numpy, u))
    np.testing.assert_array_equal(got.is_diffuse.numpy(), np.asarray(want.is_diffuse))
    np.testing.assert_array_equal(got.inside_medium.numpy(), np.asarray(want.inside_medium))
    _close(got.direction[hit], np.asarray(want.direction)[hit])
    _close(got.weight[hit], np.asarray(want.weight)[hit], rtol=1e-5)


def test_sample_direct_light(scenes):
    jscene, pscene = scenes
    r = np.random.default_rng(2)
    _, _, hit, jattrs, pattrs = _hits(scenes, r)
    u = r.random((3, N)).astype(np.float32)
    active = hit & (r.random(N) < 0.8)
    with jax.disable_jit():
        want = jdirect(
            jscene, jattrs.position, jattrs.normal, *map(jnp.asarray, u),
            lambda o, d, active=None, t_max=None: jbrute(o, d, jscene.vertices, active=active),
            active=jnp.asarray(active),
        )
    got = sample_direct_light(
        pscene, pattrs.position, pattrs.normal, *map(torch.from_numpy, u),
        lambda o, d, active=None, t_max=None: nearest_hit_brute(o, d, pscene.vertices, active=active),
        active=torch.from_numpy(active),
    )
    want = np.asarray(want)
    assert (want[active] > 0).any()
    _close(got, want, atol=1e-5, rtol=1e-4)


def test_trace_paths(scenes):
    jscene, pscene = scenes
    r = np.random.default_rng(3)
    o, d = _rays(r, jscene, 512)
    ids = r.choice(4096, 512, replace=False).astype(np.int32)
    key = (int(r.integers(0, 2**32)), int(r.integers(0, 2**32)))
    cfg = dict(width=64, height=64, max_bounces=4, ray_chunk=0)
    with jax.disable_jit():
        want = jtrace(
            jscene, lambda o, d, active=None, t_max=None: jbrute(o, d, jscene.vertices, active=active),
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(key, jnp.uint32), jnp.asarray(ids),
            JConfig(**cfg),
        )
    got = trace_paths(
        pscene, lambda o, d, active=None, t_max=None: nearest_hit_brute(o, d, pscene.vertices, active=active),
        torch.from_numpy(o), torch.from_numpy(d), key, torch.from_numpy(ids), RenderConfig(**cfg),
    )
    want = np.asarray(want)
    assert want.max() > 0.1
    _close(got, want, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("min_samples,tol", [(1, 0.05), (4, 0.2)])
def test_needs_sample_masks_equal(min_samples, tol):
    r = np.random.default_rng(min_samples)
    n = 4096
    count = r.integers(0, 12, n).astype(np.int32)
    frame = (r.random((n, 3)) * count[:, None]).astype(np.float32)
    lum = frame @ np.asarray([0.2126, 0.7152, 0.0722], np.float32)
    sq = (lum * lum / np.maximum(count, 1) * r.uniform(1.0, 1.5, n)).astype(np.float32)
    jcfg = JConfig(width=64, height=64, min_samples=min_samples, max_samples=10, max_tolerance=tol)
    pcfg = RenderConfig(width=64, height=64, min_samples=min_samples, max_samples=10, max_tolerance=tol)
    want = np.asarray(jneeds(JGBuffer(jnp.asarray(frame), jnp.asarray(sq), jnp.asarray(count)), jcfg))
    got = needs_sample(interop.gbuffer_from_numpy(frame, sq, count, device="cpu"), pcfg).numpy()
    assert 0 < want.sum() < n
    np.testing.assert_array_equal(got, want)
