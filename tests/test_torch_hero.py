"""Port parity for mid-size and big scenes: the queue and blocked paths.

Scenes and tables are numpy in both packages and held to EXACT equality:
``hero_scene``, ``glass_box_scene``, ``triangle_soup``, ``prepare_scene``
on the 20k hero and the blocked layout.

The queue and blocked intersectors' plain versions (what ``queue_intersect``
and ``blk_intersect`` run on a CPU tensor) are held to the JAX package's
``nearest_hit_cluster`` and ``nearest_hit_cluster_blk(per_ray=True,
packet=128)`` in Pallas interpret mode, on the same numpy rays: random
rays and bounce-like rays that start 1e-3 from a vertex, all / partly /
not active, with and without t_max windows. Hit masks and ids exact; t
within rtol 1e-5 plus the rounding bound of the plane equation on the hit
triangle, 16 ulp of its operands: |dt| <= 1e-5 t + 16 * 2**-24 *
(|n.p1| + sum |o_i n_i|) / |d.n|. The JAX kernels run under XLA, which
contracts the dot products into FMAs where the port rounds every product.
For a hit near the ray origin or a grazing one the cancellation in
t = (n.p1 - n.o) / (d.n) turns that last-bit difference into far more
than 1e-5 of t (measured: up to 8% of a t of 5e-5 on bounce rays); the
second term bounds exactly that and vanishes for well-conditioned hits.

The slice as a whole: ``hero_small_32`` against its golden through the
queue path, and the same render through the blocked path (branch 32)
equal to the queue path.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu.accel import prepare_scene as jprepare
from isaklm_raytracer_tpu.accel.cluster import _build_blocks_np as j_build_blocks
from isaklm_raytracer_tpu.accel.cluster import build_cluster_bvh as jbuild
from isaklm_raytracer_tpu.accel.cluster import cluster_order as jorder
from isaklm_raytracer_tpu.accel.cluster import with_blocks as jwith_blocks
from isaklm_raytracer_tpu.kernels.intersect import (
    nearest_hit_cluster,
    nearest_hit_cluster_blk,
)
from isaklm_raytracer_tpu.scene import procedural as jproc
from isaklm_raytracer_tpu_torch import interop
from isaklm_raytracer_tpu_torch.accel import prepare_scene, with_blocks
from isaklm_raytracer_tpu_torch.accel.cluster import build_cluster_bvh
from isaklm_raytracer_tpu_torch.camera import Camera
from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.integrator.render import (
    intersector_name,
    render,
    resolve_image,
)
from isaklm_raytracer_tpu_torch.kernels import intersect as ki
from isaklm_raytracer_tpu_torch.scene import procedural

torch.set_num_threads(1)  # the test workers share the host's cores

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif want is None:
        assert got is None, path
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


SCENES = {
    "hero_20k": (lambda: jproc.hero_scene(20_000), lambda: procedural.hero_scene(20_000)),
    "glass_box": (jproc.glass_box_scene, procedural.glass_box_scene),
    "soup_3000": (lambda: jproc.triangle_soup(3000), lambda: procedural.triangle_soup(3000)),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_big_scene_builders_identical(name):
    jax_fn, port_fn = SCENES[name]
    _assert_tree_equal(interop.scene_to_numpy(port_fn()), interop.scene_to_numpy(jax_fn()))


def test_prepare_hero_20k_identical():
    """Permutation, tri_const, clu_bbox, clu_bbox_t, shading rows and the
    light list of the queue kernel's scene, bit for bit; neither package
    builds blocked tables for it."""
    want = interop.scene_to_numpy(jprepare(jproc.hero_scene(20_000), build_kd=False))
    got = interop.scene_to_numpy(prepare_scene(procedural.hero_scene(20_000), "cpu"))
    _assert_tree_equal(got, want)
    assert got["cbvh"]["blk_const"] is None and got["cbvh"]["num_triangles"] == 19_688


@pytest.mark.parametrize("branch", [16, 128])
def test_blocked_tables_identical(branch):
    verts = np.asarray(procedural.hero_scene(20_000).vertices)
    verts = verts[jorder(verts)]
    want = jbuild(verts)
    blk, blk_bbox_t = j_build_blocks(
        np.asarray(want.tri_const), np.asarray(want.clu_bbox), branch
    )
    for got in (build_cluster_bvh(verts, blk_branch=branch),
                with_blocks(build_cluster_bvh(verts).to("cpu"), branch)):
        np.testing.assert_array_equal(np.asarray(got.blk_const), blk)
        np.testing.assert_array_equal(np.asarray(got.blk_bbox_t), blk_bbox_t)
        assert got.blk_branch == branch
    np.testing.assert_array_equal(
        np.asarray(jwith_blocks(want, branch).blk_const), blk
    )


def test_prepare_scene_blocks_only_big_scenes(monkeypatch):
    """The JAX package's rule: blocked tables once the padded cluster table
    exceeds 6 MB (768 clusters), ISAKLM_BLK_BRANCH clusters per block."""
    from isaklm_raytracer_tpu_torch.accel import _blk_branch

    assert _blk_branch(768 * 128) is None
    assert _blk_branch(768 * 128 + 1) == 128
    assert _blk_branch(2_000_000) == 128
    monkeypatch.setenv("ISAKLM_BLK_BRANCH", "64")
    assert _blk_branch(2_000_000) == 64
    verts = _soup(np.random.default_rng(8), 300)
    for branch in (0, 129):  # a header tile has 128 lanes
        with pytest.raises(ValueError, match="blk_branch"):
            build_cluster_bvh(verts, blk_branch=branch)


def _soup(r, n):
    base = r.uniform(-2.0, 2.0, (n, 1, 3))
    verts = (base + r.uniform(-0.4, 0.4, (n, 3, 3))).astype(np.float32)
    return verts[jorder(verts)]


def _rays(r, verts, n):
    """Random rays, and a third bounce-like: from 1e-3 off a vertex
    (tests/test_cluster_kernel.py's surface-origin population)."""
    o = r.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    k = n // 3
    o[:k] = verts[r.integers(0, verts.shape[0], k), 0] + 1e-3
    d = r.normal(size=(n, 3)).astype(np.float32)
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


CASES = {
    "all": lambda r, n: (None, None),
    "active": lambda r, n: (r.random(n) > 0.3, None),
    "window": lambda r, n: (r.random(n) > 0.3, r.uniform(0.0, 4.0, n).astype(np.float32)),
    "none": lambda r, n: (np.zeros(n, bool), None),
}


def _t_tolerance(tri_const, ids, o, d, t):
    """rtol 1e-5 plus 16 ulp of the plane equation's operands over |d.n|,
    per hit (see the module docstring)."""
    slot = tri_const[ids // 128, :, ids % 128].astype(np.float64)  # (H, 16)
    n = slot[:, 0:3]
    cancel = np.abs(slot[:, 9]) + np.abs(o.astype(np.float64) * n).sum(axis=1)
    ddn = np.abs((d.astype(np.float64) * n).sum(axis=1))
    return 1e-5 * t + 16 * 2.0**-24 * cancel / ddn


def _compare(jax_out, port_out, act, tri_const, o, d):
    jt, ji, jh = (np.asarray(x) for x in jax_out)
    pt, pi, ph = (x.numpy() for x in port_out)
    np.testing.assert_array_equal(ph, jh)
    np.testing.assert_array_equal(pi, ji)
    dt = np.abs(pt[jh] - jt[jh])
    tol = _t_tolerance(tri_const, ji[jh], o[jh], d[jh], jt[jh])
    assert (dt <= tol).all(), (dt.max(), (dt / tol).max())
    assert np.isinf(pt[~jh]).all()
    if act is not None:
        assert not ph[~act].any()
    return int(jh.sum())


def _args(o, d, act, t_max, to):
    return (to(o), to(d)), {
        "active": None if act is None else to(act),
        "t_max": None if t_max is None else to(t_max),
    }


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("num_rays", [2048, 777])
def test_plain_queue_matches_pallas_interpret(case, num_rays):
    r = np.random.default_rng(num_rays + len(case))
    verts = _soup(r, 9000)
    cbvh = build_cluster_bvh(verts)
    assert cbvh.real_clusters > 64
    o, d = _rays(r, verts, num_rays)
    act, t_max = CASES[case](r, num_rays)
    jargs, jkw = _args(o, d, act, t_max, jnp.asarray)
    pargs, pkw = _args(o, d, act, t_max, torch.from_numpy)
    hits = _compare(
        nearest_hit_cluster(jbuild(verts), *jargs, **jkw, interpret=True),
        ki.nearest_hit_queue(cbvh.to("cpu"), *pargs, **pkw),
        act, cbvh.tri_const, o, d,
    )
    assert (hits == 0) == (case == "none")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("num_tris,branch,num_rays", [
    (1800, 16, 2048), (1800, 16, 777), (17000, 128, 2048), (17000, 128, 777),
])
def test_plain_blk_matches_pallas_interpret(case, num_tris, branch, num_rays):
    r = np.random.default_rng(num_tris + num_rays + len(case))
    verts = _soup(r, num_tris)
    cbvh = build_cluster_bvh(verts, blk_branch=branch)
    assert cbvh.blk_const.shape[0] >= 2
    o, d = _rays(r, verts, num_rays)
    act, t_max = CASES[case](r, num_rays)
    jargs, jkw = _args(o, d, act, t_max, jnp.asarray)
    pargs, pkw = _args(o, d, act, t_max, torch.from_numpy)
    hits = _compare(
        nearest_hit_cluster_blk(
            jwith_blocks(jbuild(verts), branch), *jargs, **jkw,
            interpret=True, per_ray=True, packet=128,
        ),
        ki.nearest_hit_blk(cbvh.to("cpu"), *pargs, **pkw),
        act, cbvh.tri_const, o, d,
    )
    assert (hits == 0) == (case == "none")


def test_cpu_wrappers_run_plain_versions_without_launch():
    r = np.random.default_rng(6)
    verts = _soup(r, 1800)
    cbvh = build_cluster_bvh(verts, blk_branch=16).to("cpu")
    o, d = _rays(r, verts, 300)
    rays = ki.prep_rays(torch.from_numpy(o), torch.from_numpy(d))
    ki.COUNTS.reset()
    q = ki.queue_intersect(cbvh.clu_bbox_t, cbvh.tri_const, rays, 1e-5)
    b = ki.blk_intersect(cbvh.blk_bbox_t, cbvh.blk_const, rays, 1e-5)
    f = ki.flat_intersect(cbvh.tri_const[: cbvh.real_clusters], rays, 1e-5)
    assert ki.COUNTS.queue_kernel == ki.COUNTS.blk_kernel == ki.COUNTS.plain_cuda() == 0
    # without pruning, every intersector finds the same nearest hit
    for got in (q, b):
        assert torch.equal(got[0], f[0]) and torch.equal(got[1], f[1])
    with pytest.raises(ValueError, match="stats"):
        ki.blk_intersect(cbvh.blk_bbox_t, cbvh.blk_const, rays, 1e-5, stats=True)
    with pytest.raises(ValueError):
        ki.queue_intersect(cbvh.clu_bbox_t[:, :10], cbvh.tri_const, rays, 1e-5)
    with pytest.raises(ValueError):
        ki.blk_intersect(cbvh.blk_bbox_t, cbvh.blk_const[:, :, :8], rays, 1e-5)
    with pytest.raises(TypeError):
        ki.queue_intersect(cbvh.clu_bbox_t, cbvh.tri_const.double(), rays, 1e-5)


@pytest.fixture(scope="module")
def hero_small():
    """hero_small_32 as tests/golden_cases.py renders it."""
    config = RenderConfig(width=32, height=32, max_bounces=3, ray_chunk=0, min_samples=1)
    camera = Camera.create((0.0, 2.0, -6.0), fov=np.pi / 2, device="cpu")
    return prepare_scene(procedural.hero_scene(20_000), "cpu"), camera, config


def test_golden_hero_small_32_through_queue(hero_small):
    """Within the golden rule of tests/test_torch_render.py: every value
    within 1e-4 except at most 8, all within 3e-4."""
    scene, camera, config = hero_small
    assert intersector_name(scene.cbvh) == "queue"
    got = resolve_image(render(scene, camera, config, num_samples=2, seed=11), config).numpy()
    with np.load(os.path.join(GOLDEN_DIR, "hero_small_32.npz")) as data:
        want = data["image"]
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    assert (err > 1e-4).sum() <= 8, (err > 1e-4).sum()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-4)


def test_blk_path_renders_as_queue_path(hero_small, monkeypatch):
    scene, camera, config = hero_small
    queue = resolve_image(render(scene, camera, config, num_samples=2, seed=11), config)
    blocked = scene.replace(cbvh=with_blocks(scene.cbvh, 32))
    monkeypatch.setenv("ISAKLM_INTERSECTOR", "blk")
    assert intersector_name(blocked.cbvh) == "blk"
    blk = resolve_image(render(blocked, camera, config, num_samples=2, seed=11), config)
    np.testing.assert_allclose(blk.numpy(), queue.numpy(), rtol=0, atol=1e-6)
