"""Port parity for the JAX package's other intersectors: oct, flat MXU and
blocked MXU, and the fixed-cost probe.

Tables (numpy in both packages) are held to EXACT equality: the oct tables
at every oct branch, the MXU tile pairs and the MXU blocks at every branch,
and ``prepare_scene``'s MXU tiles of the demo. Mixed block branches raise
(the JAX package would walk one layout with the other's block boxes).

The plain versions (what ``hbm_intersect``, ``flat_mxu_intersect`` and
``blk_mxu_intersect`` run on a CPU tensor) against ``nearest_hit_cluster_hbm``,
``nearest_hit_cluster_flat_mxu`` and ``nearest_hit_cluster_blk(mxu=True)``
in Pallas interpret mode, on the same numpy rays (random, and a third
bounce-like from 1e-3 off a vertex), all / partly / not active, with and
without t_max windows, on soups whose cluster count is padded. Hit masks
and ids exact; t within rtol 1e-5 plus 16 ulp of the plane equation's
operands over |d.n| (tests/test_torch_hero.py: XLA contracts the dot
products, and the MXU variants' ``dot_general``, into FMAs, where the port
rounds every product; the cancellation in t = (n.p1 - n.o) / (d.n) turns
that last bit into more than 1e-5 of t for near-origin and grazing hits).

Within the port no tolerance: plain hbm equals plain queue, plain flat_mxu
plain flat and plain blk_mxu plain blk bit for bit, and renders through the
three overrides equal the default intersector's render bit for bit.

The CUDA kernels run only on the card: their tests are marked ``cuda`` and
skip without one; ``python3 chip_smoke.py`` checks them at the main path's
shapes.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu.accel import prepare_scene as jprepare
from isaklm_raytracer_tpu.accel import cluster as jcluster
from isaklm_raytracer_tpu.kernels.intersect import (
    nearest_hit_cluster_blk,
    nearest_hit_cluster_flat_mxu,
    nearest_hit_cluster_hbm,
)
from isaklm_raytracer_tpu.scene import procedural as jproc
from isaklm_raytracer_tpu_torch import interop
from isaklm_raytracer_tpu_torch.accel import (
    prepare_scene,
    with_blocks,
    with_mxu_blocks,
    with_mxu_tiles,
    with_oct_branch,
)
from isaklm_raytracer_tpu_torch.accel.cluster import build_cluster_bvh
from isaklm_raytracer_tpu_torch.camera import Camera
from isaklm_raytracer_tpu_torch.cli import render as cli
from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.integrator.render import intersector_name, render
from isaklm_raytracer_tpu_torch.kernels import intersect as ki
from isaklm_raytracer_tpu_torch.scene import procedural

torch.set_num_threads(1)  # the test workers share the host's cores


def _soup(r, n):
    base = r.uniform(-2.0, 2.0, (n, 1, 3))
    verts = (base + r.uniform(-0.4, 0.4, (n, 3, 3))).astype(np.float32)
    return verts[jcluster.cluster_order(verts)]


def _rays(r, verts, n):
    """Random rays, and a third bounce-like: from 1e-3 off a vertex."""
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


def _args(o, d, act, t_max, to):
    return (to(o), to(d)), {
        "active": None if act is None else to(act),
        "t_max": None if t_max is None else to(t_max),
    }


def _compare(jax_out, port_out, act, tri_const, o, d):
    """Hits and ids exact, t within the rule of the module docstring."""
    jt, ji, jh = (np.asarray(x) for x in jax_out)
    pt, pi, ph = (x.numpy() for x in port_out)
    np.testing.assert_array_equal(ph, jh)
    np.testing.assert_array_equal(pi, ji)
    slot = tri_const[ji[jh] // 128, :, ji[jh] % 128].astype(np.float64)  # (H, 16)
    n = slot[:, 0:3]
    cancel = np.abs(slot[:, 9]) + np.abs(o[jh].astype(np.float64) * n).sum(axis=1)
    ddn = np.abs((d[jh].astype(np.float64) * n).sum(axis=1))
    tol = 1e-5 * jt[jh] + 16 * 2.0**-24 * cancel / ddn
    dt = np.abs(pt[jh] - jt[jh])
    assert (dt <= tol).all(), (dt.max(), (dt / tol).max())
    assert np.isinf(pt[~jh]).all()
    if act is not None:
        assert not ph[~act].any()
    return int(jh.sum())


# --- tables -----------------------------------------------------------------


@pytest.mark.parametrize("branch", [16, 32])
def test_oct_and_mxu_tables_identical(branch):
    verts = _soup(np.random.default_rng(branch), 1200)
    want = jcluster.build_cluster_bvh(verts, mxu_branch=branch, mxu_tiles=True)
    got = build_cluster_bvh(verts, mxu_branch=branch, mxu_tiles=True)
    for name in ("oct_bbox", "oct_bbox_t", "mxu_const", "blk_bbox_t", "mxu_tiles"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.mxu_branch == branch and got.oct_branch == jcluster.OCT_BRANCH
    # the with_* builders, from tables already on a device
    plain = build_cluster_bvh(verts).to("cpu")
    jplain = jcluster.build_cluster_bvh(verts)
    for got, want in (
        (with_oct_branch(plain, branch), jcluster.with_oct_branch(jplain, branch)),
        (with_mxu_blocks(plain, branch), jcluster.with_mxu_blocks(jplain, branch)),
        (with_mxu_tiles(plain), jcluster.with_mxu_tiles(jplain)),
    ):
        for name in ("oct_bbox", "oct_bbox_t", "mxu_const", "blk_bbox_t", "mxu_tiles"):
            if getattr(want, name) is not None:
                np.testing.assert_array_equal(getattr(got, name).numpy(),
                                              np.asarray(getattr(want, name)), err_msg=name)
    assert with_oct_branch(plain, branch).oct_branch == branch
    with pytest.raises(ValueError, match="oct_branch"):
        with_oct_branch(plain, 48)  # does not divide the 64 clusters


def test_prepare_scene_builds_mxu_tiles_and_oct_tables():
    """As the JAX package: MXU tiles and oct tables for the demo, exactly
    its arrays (tests/test_torch_scene.py holds the whole prepared scene)."""
    want = interop.scene_to_numpy(jprepare(jproc.material_demo_scene(), build_kd=False))["cbvh"]
    got = interop.scene_to_numpy(prepare_scene(procedural.material_demo_scene(), "cpu"))["cbvh"]
    for name in ("mxu_tiles", "oct_bbox", "oct_bbox_t"):
        assert got[name] is not None
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got["mxu_const"] is None and want["mxu_const"] is None


def test_mixed_block_branches_raise():
    """Both block layouts read one blk_bbox_t: the port refuses tables whose
    branches differ, where the JAX package would walk one layout with the
    other's block boxes; equal branches share the one table."""
    verts = _soup(np.random.default_rng(7), 1200)
    with pytest.raises(ValueError, match="blk_branch 16 and mxu_branch 32"):
        build_cluster_bvh(verts, blk_branch=16, mxu_branch=32)
    blocked = build_cluster_bvh(verts, blk_branch=16).to("cpu")
    with pytest.raises(ValueError, match="differ"):
        with_mxu_blocks(blocked, 32)
    with pytest.raises(ValueError, match="differ"):
        with_blocks(with_mxu_blocks(build_cluster_bvh(verts).to("cpu"), 32), 16)
    both = with_mxu_blocks(blocked, 16)
    assert torch.equal(both.blk_bbox_t, blocked.blk_bbox_t)
    np.testing.assert_array_equal(
        build_cluster_bvh(verts, blk_branch=16, mxu_branch=16).blk_bbox_t,
        blocked.blk_bbox_t.numpy())


# --- plain versions against the Pallas kernels in interpret mode ------------


def _pair(r, num_tris, num_rays, case):
    verts = _soup(r, num_tris)
    o, d = _rays(r, verts, num_rays)
    act, t_max = CASES[case](r, num_rays)
    return verts, o, d, act, t_max, _args(o, d, act, t_max, jnp.asarray), \
        _args(o, d, act, t_max, torch.from_numpy)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("oct_branch", [8, 16])
def test_plain_hbm_matches_pallas_interpret(case, oct_branch):
    r = np.random.default_rng(oct_branch + len(case))
    verts, o, d, act, _, (jargs, jkw), (pargs, pkw) = _pair(r, 1200, 777, case)
    cbvh = build_cluster_bvh(verts).to("cpu")
    if oct_branch != 8:
        cbvh = with_oct_branch(cbvh, oct_branch)
    jcbvh = jcluster.with_oct_branch(jcluster.build_cluster_bvh(verts), oct_branch)
    hits = _compare(
        nearest_hit_cluster_hbm(jcbvh, *jargs, **jkw, oct_branch=oct_branch, interpret=True),
        ki.nearest_hit_hbm(cbvh, *pargs, **pkw), act, cbvh.tri_const.numpy(), o, d,
    )
    assert (hits == 0) == (case == "none")


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flat_mxu_matches_pallas_interpret(case):
    r = np.random.default_rng(20 + len(case))
    verts, o, d, act, _, (jargs, jkw), (pargs, pkw) = _pair(r, 700, 300, case)
    cbvh = build_cluster_bvh(verts, mxu_tiles=True).to("cpu")
    hits = _compare(
        nearest_hit_cluster_flat_mxu(jcluster.build_cluster_bvh(verts, mxu_tiles=True),
                                     *jargs, **jkw, interpret=True),
        ki.nearest_hit_flat_mxu(cbvh, *pargs, **pkw), act, cbvh.tri_const.numpy(), o, d,
    )
    assert (hits == 0) == (case == "none")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("branch", [16, 32])
def test_plain_blk_mxu_matches_pallas_interpret(case, branch):
    r = np.random.default_rng(branch + 40 + len(case))
    verts, o, d, act, _, (jargs, jkw), (pargs, pkw) = _pair(r, 1800, 777, case)
    cbvh = build_cluster_bvh(verts, mxu_branch=branch).to("cpu")
    hits = _compare(
        nearest_hit_cluster_blk(jcluster.build_cluster_bvh(verts, mxu_branch=branch),
                                *jargs, **jkw, mxu=True, interpret=True),
        ki.nearest_hit_blk_mxu(cbvh, *pargs, **pkw), act, cbvh.tri_const.numpy(), o, d,
    )
    assert (hits == 0) == (case == "none")


# --- exact equalities within the port ---------------------------------------


@pytest.mark.parametrize("branch", [8, 32])
def test_plain_variants_equal_their_vpu_counterparts(branch):
    """Without pruning every intersector finds the same nearest hit: plain
    hbm == plain queue, flat_mxu == flat, blk_mxu == blk, bit for bit, on a
    soup whose cluster count is padded (pad clusters' inverted row-15 boxes
    included)."""
    r = np.random.default_rng(50 + branch)
    verts = _soup(r, 1200)
    cbvh = with_oct_branch(
        build_cluster_bvh(verts, blk_branch=branch, mxu_branch=branch, mxu_tiles=True).to("cpu"),
        branch)
    o, d = _rays(r, verts, 500)
    act = torch.from_numpy(r.random(500) > 0.2)
    t_max = torch.from_numpy(r.uniform(0.0, 6.0, 500).astype(np.float32))
    rays = ki.prep_rays(torch.from_numpy(o), torch.from_numpy(d), act, t_max)
    tiles = (cbvh.tri_const[: cbvh.real_clusters], cbvh.mxu_tiles[: cbvh.real_clusters])
    for got, want in (
        (ki.hbm_intersect_plain(cbvh.oct_bbox_t, cbvh.tri_const, rays, 1e-5, branch),
         ki.queue_intersect_plain(cbvh.clu_bbox_t, cbvh.tri_const, rays, 1e-5)),
        (ki.flat_mxu_intersect_plain(tiles[1], rays, 1e-5),
         ki.flat_intersect_plain(tiles[0], rays, 1e-5)),
        (ki.blk_mxu_intersect_plain(cbvh.blk_bbox_t, cbvh.mxu_const, rays, 1e-5),
         ki.blk_intersect_plain(cbvh.blk_bbox_t, cbvh.blk_const, rays, 1e-5)),
    ):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((want[1] != ki._BIG_ID).sum()) > 50


# --- the slice as a whole ---------------------------------------------------


def _image(scene, camera, config, spp):
    gb = render(scene, camera, config, num_samples=spp, seed=11)
    return gb.frame / gb.count.clamp_min(1)[:, None].float()


@pytest.mark.parametrize("override", ["hbm", "flat_mxu"])
def test_override_renders_cornell_64_as_default(override, monkeypatch):
    """cornell_64's scene, camera and config (tests/golden_cases.py), one
    sample: the override's render equals the default (flat) render bit for
    bit; the golden tests hold the default render to the golden."""
    scene = prepare_scene(procedural.cornell_box(glossy=True), "cpu")
    camera = Camera.create((0.0, 0.0, -0.9), fov=np.pi / 2, device="cpu")
    config = RenderConfig(width=64, height=64, max_bounces=4, ray_chunk=0, min_samples=1)
    monkeypatch.delenv("ISAKLM_INTERSECTOR", raising=False)
    assert intersector_name(scene.cbvh) == "flat"
    want = _image(scene, camera, config, 1)
    monkeypatch.setenv("ISAKLM_INTERSECTOR", override)
    assert intersector_name(scene.cbvh) == override
    assert torch.equal(_image(scene, camera, config, 1), want)


def test_blk_mxu_renders_hero_small_32_as_default(monkeypatch):
    """hero_small_32's scene, camera and config with MXU blocks of 32
    clusters, one sample: equal to the default (queue) render bit for bit."""
    scene = prepare_scene(procedural.hero_scene(20_000), "cpu")
    camera = Camera.create((0.0, 2.0, -6.0), fov=np.pi / 2, device="cpu")
    config = RenderConfig(width=32, height=32, max_bounces=3, ray_chunk=0, min_samples=1)
    monkeypatch.delenv("ISAKLM_INTERSECTOR", raising=False)
    assert intersector_name(scene.cbvh) == "queue"
    want = _image(scene, camera, config, 1)
    monkeypatch.setenv("ISAKLM_INTERSECTOR", "blk_mxu")
    scene = scene.replace(cbvh=with_mxu_blocks(scene.cbvh, 32))
    assert torch.equal(_image(scene, camera, config, 1), want)


@pytest.mark.parametrize("override", ["hbm", "flat_mxu"])
def test_cli_renders_under_override_on_the_cpu(override, monkeypatch, tmp_path):
    monkeypatch.setenv("ISAKLM_INTERSECTOR", override)
    out = str(tmp_path / "c.png")
    assert cli.main(["--scene", "cornell", "--width", "16", "--height", "16",
                     "--max-bounces", "2", "--min-samples", "1", "--max-samples", "1",
                     "--out", out, "--device", "cpu"]) == 0
    assert os.path.getsize(out) > 100


# --- wrappers on the CPU, the probe -------------------------------------------


def test_cpu_wrappers_run_plain_versions_without_launch():
    r = np.random.default_rng(60)
    verts = _soup(r, 1200)
    cbvh = build_cluster_bvh(verts, mxu_branch=16, mxu_tiles=True).to("cpu")
    o, d = _rays(r, verts, 300)
    rays = ki.prep_rays(torch.from_numpy(o), torch.from_numpy(d))
    ki.COUNTS.reset()
    h = ki.hbm_intersect(cbvh.oct_bbox_t, cbvh.tri_const, rays, 1e-5, cbvh.oct_branch)
    f = ki.flat_mxu_intersect(cbvh.mxu_tiles[: cbvh.real_clusters], rays, 1e-5)
    b = ki.blk_mxu_intersect(cbvh.blk_bbox_t, cbvh.mxu_const, rays, 1e-5)
    zt, zi = ki.null_intersect(rays, 7 * cbvh.mxu_const.shape[0])
    assert all(getattr(ki.COUNTS, f"{k}_kernel") == 0 for k in ki.COUNTS.KERNELS)
    assert ki.COUNTS.plain_cuda() == 0
    for got in (f, b):
        assert torch.equal(got[0], h[0]) and torch.equal(got[1], h[1])
    assert zt.dtype == torch.float32 and zi.dtype == torch.int32
    assert zt.shape == zi.shape == (300,) and not zt.any() and not zi.any()
    for fn, args in ((ki.hbm_intersect, (cbvh.oct_bbox_t, cbvh.tri_const, rays, 1e-5, 8)),
                     (ki.blk_mxu_intersect, (cbvh.blk_bbox_t, cbvh.mxu_const, rays, 1e-5))):
        with pytest.raises(ValueError, match="stats"):
            fn(*args, stats=True)
    with pytest.raises(ValueError, match="oct_branch"):
        ki.hbm_intersect(cbvh.oct_bbox_t, cbvh.tri_const, rays, 1e-5, 48)
    with pytest.raises(ValueError):
        ki.blk_mxu_intersect(cbvh.blk_bbox_t, cbvh.mxu_const[:, :32], rays, 1e-5)
    with pytest.raises(ValueError):
        ki.flat_mxu_intersect(cbvh.tri_const, rays, 1e-5)
    with pytest.raises(TypeError):
        ki.flat_mxu_intersect(cbvh.mxu_tiles.double(), rays, 1e-5)
    for fn in (ki.nearest_hit_flat_mxu, ki.nearest_hit_blk_mxu):
        with pytest.raises(ValueError, match="needs cbvh"):
            fn(build_cluster_bvh(verts).to("cpu"), rays[:, 0:3], rays[:, 3:6])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["hbm", "flat_mxu", "blk_mxu", "null"])
def test_cuda_variant_kernels_match_plain_versions(kernel):
    """Each kernel against its plain version on the card at the bench's
    ray counts in the four activity cases: bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    r = np.random.default_rng(70)
    verts = _soup(r, 17000)
    cbvh = build_cluster_bvh(verts, mxu_branch=32, mxu_tiles=True).to("cuda")
    run, plain = {
        "hbm": (lambda x: ki.hbm_intersect(cbvh.oct_bbox_t, cbvh.tri_const, x, 1e-5, 8),
                lambda x: ki.hbm_intersect_plain(cbvh.oct_bbox_t, cbvh.tri_const, x, 1e-5, 8)),
        "flat_mxu": (lambda x: ki.flat_mxu_intersect(cbvh.mxu_tiles[:64], x, 1e-5),
                     lambda x: ki.flat_mxu_intersect_plain(cbvh.mxu_tiles[:64], x, 1e-5)),
        "blk_mxu": (lambda x: ki.blk_mxu_intersect(cbvh.blk_bbox_t, cbvh.mxu_const, x, 1e-5),
                    lambda x: ki.blk_mxu_intersect_plain(cbvh.blk_bbox_t, cbvh.mxu_const, x,
                                                         1e-5)),
        "null": (lambda x: ki.null_intersect(x, 7 * 128), ki.null_intersect_plain),
    }[kernel]
    for n in (2048, 777):
        for case in sorted(CASES):
            o, d = _rays(r, verts, n)
            act, t_max = CASES[case](r, n)
            (o, d), kw = _args(o, d, act, t_max, lambda x: torch.from_numpy(x).cuda())
            rays = ki.prep_rays(o, d, kw["active"], kw["t_max"])
            kt, kid = run(rays)
            pt, pid = plain(rays)
            torch.cuda.synchronize()
            assert torch.equal(kt, pt) and torch.equal(kid, pid), (kernel, n, case)
