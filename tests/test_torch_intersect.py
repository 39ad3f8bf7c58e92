"""Port parity: the flat intersector's plain version and the oracle.

The port's plain flat version (what ``flat_intersect`` runs on a CPU
tensor) against the JAX package's ``nearest_hit_cluster_flat`` in Pallas
interpret mode and against ``nearest_hit_brute``, on the same numpy rays
and tables. Tolerance: hit masks and ids exact; t to 1e-5 relative. XLA on
the CPU contracts the dot products into FMAs where the port rounds every
product, and the plane offset minus the origin dot cancels, so one last-bit
difference in the dot becomes up to 6e-6 of a short hit distance
(measured: 5.8e-6 at most over these cases).

The CUDA kernel itself runs only on the card: its test is marked ``cuda``
and skips without one. ``python3 chip_smoke.py`` checks the kernel on the
card at the main path's shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu.accel.cluster import build_cluster_bvh as jbuild
from isaklm_raytracer_tpu.accel.cluster import cluster_order as jorder
from isaklm_raytracer_tpu.accel.traverse import nearest_hit_brute as jbrute
from isaklm_raytracer_tpu.kernels.intersect import nearest_hit_cluster_flat
from isaklm_raytracer_tpu_torch.accel.cluster import build_cluster_bvh
from isaklm_raytracer_tpu_torch.accel.traverse import nearest_hit_brute
from isaklm_raytracer_tpu_torch.integrator.render import intersector_name
from isaklm_raytracer_tpu_torch.kernels import intersect as ki


def _soup(r, n):
    base = r.uniform(-2.0, 2.0, (n, 1, 3))
    verts = (base + r.uniform(-0.4, 0.4, (n, 3, 3))).astype(np.float32)
    return verts[jorder(verts)]


def _rays(r, n):
    o = r.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


CASES = {
    "all": lambda r, n: (None, None),
    "active": lambda r, n: (r.random(n) > 0.3, None),
    "window": lambda r, n: (r.random(n) > 0.3, r.uniform(0.0, 4.0, n).astype(np.float32)),
    "none": lambda r, n: (np.zeros(n, bool), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("num_tris,num_rays", [(300, 777), (900, 512)])
def test_plain_flat_matches_pallas_interpret(case, num_tris, num_rays):
    r = np.random.default_rng(num_tris + num_rays)
    verts = _soup(r, num_tris)
    o, d = _rays(r, num_rays)
    act, t_max = CASES[case](r, num_rays)

    jt, ji, jh = nearest_hit_cluster_flat(
        jbuild(verts), jnp.asarray(o), jnp.asarray(d),
        active=None if act is None else jnp.asarray(act),
        t_max=None if t_max is None else jnp.asarray(t_max),
        interpret=True,
    )
    pt, pi, ph = ki.nearest_hit_flat(
        build_cluster_bvh(verts).to("cpu"), torch.from_numpy(o), torch.from_numpy(d),
        active=None if act is None else torch.from_numpy(act),
        t_max=None if t_max is None else torch.from_numpy(t_max),
    )
    jh, ji, jt = np.asarray(jh), np.asarray(ji), np.asarray(jt)
    np.testing.assert_array_equal(ph.numpy(), jh)
    np.testing.assert_array_equal(pi.numpy(), ji)
    np.testing.assert_allclose(pt.numpy()[jh], jt[jh], rtol=1e-5, atol=0)
    assert np.isinf(pt.numpy()[~jh]).all()
    if case == "none":
        assert not ph.any() and (pi == -1).all()
    if act is not None:
        assert not ph.numpy()[~act].any()

    # and against the oracle, in both packages
    bt, bi, bh = nearest_hit_brute(torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(verts))
    jbt, jbi, jbh = jbrute(jnp.asarray(o), jnp.asarray(d), jnp.asarray(verts))
    np.testing.assert_array_equal(bh.numpy(), np.asarray(jbh))
    np.testing.assert_array_equal(bi.numpy(), np.asarray(jbi))
    want = bh.numpy().copy()
    if act is not None:
        want &= act
    if t_max is not None:
        want &= bt.numpy() < t_max
    np.testing.assert_array_equal(ph.numpy(), want)
    np.testing.assert_array_equal(pi.numpy()[want], bi.numpy()[want])
    np.testing.assert_allclose(pt.numpy()[want], bt.numpy()[want], rtol=1e-4, atol=1e-6)


def test_cpu_wrapper_runs_plain_version_without_launch():
    r = np.random.default_rng(1)
    verts = _soup(r, 200)
    cbvh = build_cluster_bvh(verts).to("cpu")
    o, d = _rays(r, 64)
    rays = ki.prep_rays(torch.from_numpy(o), torch.from_numpy(d))
    tri = cbvh.tri_const[: cbvh.real_clusters]
    ki.COUNTS.reset()
    got = ki.flat_intersect(tri, rays, 1e-5)
    want = ki.flat_intersect_plain(tri, rays, 1e-5)
    assert ki.COUNTS.flat_kernel == 0 and ki.COUNTS.flat_plain_cuda == 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError):
        ki.flat_intersect(tri[:, :8], rays, 1e-5)
    with pytest.raises(TypeError):
        ki.flat_intersect(tri.double(), rays, 1e-5)


def test_large_scene_on_cuda_names_the_kernel_to_port():
    r = np.random.default_rng(2)
    cbvh = build_cluster_bvh(_soup(r, 65 * 128))
    assert cbvh.real_clusters == 65
    assert intersector_name(cbvh, "cpu") == "flat"
    with pytest.raises(NotImplementedError, match="_vmem_kernel"):
        intersector_name(cbvh, "cuda")
    assert intersector_name(build_cluster_bvh(_soup(r, 64 * 128)), "cuda") == "flat"


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_bit_for_bit():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    r = np.random.default_rng(3)
    cbvh = build_cluster_bvh(_soup(r, 6000)).to("cuda")
    tri = cbvh.tri_const[: cbvh.real_clusters]
    for case in sorted(CASES):
        o, d = _rays(r, 777)
        act, t_max = CASES[case](r, 777)
        rays = ki.prep_rays(
            torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda(),
            None if act is None else torch.from_numpy(act).cuda(),
            None if t_max is None else torch.from_numpy(t_max).cuda(),
        )
        kt, kid = ki.flat_intersect(tri, rays, 1e-5)
        pt, pid = ki.flat_intersect_plain(tri, rays, 1e-5)
        torch.cuda.synchronize()
        assert torch.equal(kt, pt) and torch.equal(kid, pid), case
