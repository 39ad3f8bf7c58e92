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

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu.accel.cluster import build_cluster_bvh as jbuild
from isaklm_raytracer_tpu.accel.cluster import cluster_order as jorder
from isaklm_raytracer_tpu.accel.traverse import nearest_hit_brute as jbrute
from isaklm_raytracer_tpu.kernels.intersect import nearest_hit_cluster_flat
from isaklm_raytracer_tpu_torch.accel.cluster import (
    build_cluster_bvh,
    with_blocks,
    with_mxu_blocks,
    with_mxu_tiles,
)
from isaklm_raytracer_tpu_torch.accel.traverse import nearest_hit_brute
from isaklm_raytracer_tpu_torch.integrator.render import intersector_name
from isaklm_raytracer_tpu_torch.kernels import intersect as ki

torch.set_num_threads(1)  # the test workers share the host's cores


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


def _flush(x):
    """x with its float32 subnormals set to zero, as XLA on the CPU treats
    its operands."""
    return np.where(np.abs(x) < np.finfo(np.float32).tiny, np.float32(0.0) * x, x)


def _both_flat(verts, o, d, act, t_max, t_eps):
    """(t, id, hit) of the JAX package's flat kernel (Pallas interpret
    mode) and of the port's plain flat version on the same numpy rays."""
    j = nearest_hit_cluster_flat(
        jbuild(verts), jnp.asarray(o), jnp.asarray(d), t_eps=t_eps, active=jnp.asarray(act),
        t_max=jnp.asarray(t_max), interpret=True)
    p = ki.nearest_hit_flat(build_cluster_bvh(verts).to("cpu"), torch.from_numpy(o),
                            torch.from_numpy(d), t_eps=t_eps, active=torch.from_numpy(act),
                            t_max=torch.from_numpy(t_max))
    return tuple(np.asarray(x) for x in j), tuple(x.numpy() for x in p)


def _assert_flat_equal(got, want, rows):
    """Hit masks and ids exact, t (NaN included) to 1e-5 relative, on rows."""
    (pt, pi, ph), (jt, ji, jh) = got, want
    np.testing.assert_array_equal(ph[rows], jh[rows])
    np.testing.assert_array_equal(pi[rows], ji[rows])
    np.testing.assert_allclose(pt[rows], jt[rows], rtol=1e-5, atol=0)


@pytest.mark.parametrize("t_eps", [1e-5, 0.0])
def test_plain_flat_matches_pallas_interpret_on_edge_rays(t_eps):
    """The rays of the flat kernel's exactness argument (tests/test_torch_flat.py):
    origins on a plane, rays parallel to it, zero, NaN and inf directions and
    origins, each with every window of WINDOWS (above 3.4e38, +inf, NaN, 0,
    at a hit and just past it), a third of them inactive, in one packet.

    XLA on the CPU treats subnormal operands as zero; the port keeps them
    (IEEE, on the CPU and in the kernels). So the rays whose direction is
    subnormal, against the planes at z = +-1e-40, hit at t = 1 in the port
    and not in the JAX package. With those directions flushed to zero,
    the port gives the JAX package's result on every ray."""
    from test_torch_flat import EDGE_RAYS, HANDMADE, WINDOWS
    from test_torch_flat import _soup as flat_soup

    verts = np.concatenate([HANDMADE, flat_soup(np.random.default_rng(5), 200)])
    edge_o, edge_d = (np.array(x, np.float32) for x in zip(*EDGE_RAYS))
    o = np.repeat(edge_o, len(WINDOWS), axis=0)
    d = np.repeat(edge_d, len(WINDOWS), axis=0)
    t_max = np.resize(WINDOWS, o.shape[0])
    act = np.arange(o.shape[0]) % 3 != 2
    subnormal = ((np.abs(d) < np.finfo(np.float32).tiny) & (d != 0.0)).any(axis=1)
    assert 0 < subnormal.sum() < o.shape[0] and o.shape[0] <= ki.DEFAULT_PACKET
    with np.errstate(invalid="ignore"):
        jax_raw, port_raw = _both_flat(verts, o, d, act, t_max, t_eps)
        jax_flushed, port_flushed = _both_flat(verts, o, _flush(d), act, t_max, t_eps)
    every = np.ones(o.shape[0], bool)
    _assert_flat_equal(jax_flushed, jax_raw, every)
    _assert_flat_equal(port_flushed, jax_raw, every)
    _assert_flat_equal(port_raw, jax_raw, ~subnormal)
    # the subnormal rays that reach the planes inside their windows
    pt, pi, ph = port_raw
    reach = subnormal & act & (t_max > 1.0)
    assert ph[reach].all() and not jax_raw[2][reach & (t_max <= np.float32(3.4e38))].any()
    if t_eps > 0.0:
        assert (pt[reach] == 1.0).all() and set(pi[reach]) == {1, 2}


def test_flat_windows_above_the_miss_value_pin_the_reference():
    """A flat ray whose window lies above 3.4e38 and that hits nothing: the
    JAX package gives (3.4e38, triangle 0), a hit, when it is active and when
    it is inactive in a packet with an active ray, because a rejected slot's
    3.4e38 beats the window; a packet of inactive rays only is skipped and
    misses. The port's plain version has no packets and gives (3.4e38, 0) to
    the inactive ray alone too; its kernel keeps an inactive ray's window
    (the cuda test of tests/test_torch_flat.py)."""
    verts = _soup(np.random.default_rng(6), 300)
    o = np.full((2, 3), 100.0, np.float32)
    d = np.array([[1.0, 0.0, 0.0]] * 2, np.float32)
    t_max = np.full(2, np.inf, np.float32)
    (jt, ji, jh), (pt, pi, ph) = _both_flat(verts, o, d, np.array([True, False]), t_max, 1e-5)
    for t, i, h in ((jt, ji, jh), (pt, pi, ph)):
        assert h.all() and (i == 0).all() and (t == np.float32(3.4e38)).all()
    (jt, ji, jh), (pt, pi, ph) = _both_flat(verts, o[:1], d[:1], np.array([False]), t_max[:1],
                                            1e-5)
    assert not jh.any() and (ji == -1).all() and np.isinf(jt).all()
    assert ph.all() and (pi == 0).all() and (pt == np.float32(3.4e38)).all()


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


def test_intersector_selection_by_size_and_override(monkeypatch):
    """The JAX package's rule, on every device, and the same name as its
    ``intersector_name`` in every case: flat up to 64 real clusters, queue
    up to a 6 MB cluster table (768 clusters), above it blk if the scene
    has blocked tables, else blk_mxu if it has MXU blocks, else hbm;
    ISAKLM_INTERSECTOR picks any of the six names, and one whose table the
    scene lacks raises, with JAX's message."""
    from isaklm_raytracer_tpu.integrator.render import intersector_name as jname

    r = np.random.default_rng(2)
    monkeypatch.delenv("ISAKLM_INTERSECTOR", raising=False)
    flat = build_cluster_bvh(_soup(r, 64 * 128))
    queue = build_cluster_bvh(_soup(r, 65 * 128))
    assert (flat.real_clusters, queue.real_clusters) == (64, 65)
    big = SimpleNamespace(num_triangles=769 * 128, real_clusters=769,
                          vmem_bytes=832 * 16 * 128 * 4, blk_const=None, mxu_const=None,
                          mxu_tiles=None)
    mxu_only = SimpleNamespace(**{**vars(big), "mxu_const": np.zeros((7, 257, 16, 128))})
    blocked = SimpleNamespace(**{**vars(mxu_only), "blk_const": np.zeros((7, 129, 16, 128))})
    for cbvh, want in ((flat, "flat"), (queue, "queue"), (big, "hbm"),
                       (mxu_only, "blk_mxu"), (blocked, "blk")):
        assert intersector_name(cbvh) == want == jname(cbvh)
    for name in ("flat", "queue", "hbm"):
        monkeypatch.setenv("ISAKLM_INTERSECTOR", name)
        assert intersector_name(queue) == name == jname(queue)
    for name, table, cbvh in (("blk", "blk_const", with_blocks(queue.to("cpu"), 16)),
                              ("blk_mxu", "mxu_const", with_mxu_blocks(queue.to("cpu"), 16)),
                              ("flat_mxu", "mxu_tiles", with_mxu_tiles(queue.to("cpu")))):
        monkeypatch.setenv("ISAKLM_INTERSECTOR", name)
        for fn in (intersector_name, jname):
            with pytest.raises(ValueError, match=f"needs cbvh.{table}"):
                fn(queue)
        assert intersector_name(cbvh) == name
    monkeypatch.setenv("ISAKLM_INTERSECTOR", "nope")
    with pytest.raises(ValueError, match="unknown intersector"):
        intersector_name(queue)


def test_library_path_hashes_the_headers(tmp_path, monkeypatch):
    """A changed header shared by the kernels gives a new library name, so a
    stale build is never loaded; no nvcc needed."""
    from isaklm_raytracer_tpu_torch.kernels import build

    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// v1\n")
    first = build.library_path("k.cu")
    assert build.library_path("k.cu") == first
    (tmp_path / "shared.cuh").write_text("// v2\n")
    second = build.library_path("k.cu")
    (tmp_path / "other.cuh").write_text("// new header\n")
    third = build.library_path("k.cu")
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n// edit\n')
    assert len({first, second, third, build.library_path("k.cu")}) == 4
    assert first.name.startswith("libk_") and first.suffix == ".so"


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


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["queue", "blk"])
def test_cuda_walk_kernels_match_plain_versions(kernel):
    """The queue and blocked kernels against their plain versions on the
    card, at the bench's ray counts: bit for bit, pruning included (a
    difference would need a cluster entry rounded past a hit inside it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    r = np.random.default_rng(4)
    verts = _soup(r, 17000)
    cbvh = build_cluster_bvh(verts, blk_branch=16).to("cuda")
    if kernel == "queue":
        args, run, plain = (cbvh.clu_bbox_t, cbvh.tri_const), ki.queue_intersect, ki.queue_intersect_plain
    else:
        args, run, plain = (cbvh.blk_bbox_t, cbvh.blk_const), ki.blk_intersect, ki.blk_intersect_plain
    for n in (2048, 777):
        for case in sorted(CASES):
            o, d = _rays(r, n)
            act, t_max = CASES[case](r, n)
            rays = ki.prep_rays(
                torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda(),
                None if act is None else torch.from_numpy(act).cuda(),
                None if t_max is None else torch.from_numpy(t_max).cuda(),
            )
            kt, kid = run(*args, rays, 1e-5)
            pt, pid = plain(*args, rays, 1e-5)
            torch.cuda.synchronize()
            assert torch.equal(kt, pt) and torch.equal(kid, pid), (kernel, n, case)
