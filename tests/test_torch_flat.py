"""The flat kernels' staged test (``csrc/flat_walk.cuh``, which
``flat_intersect.cu`` runs over the cluster tiles and
``flat_mxu_intersect.cu`` over the MXU tile pairs) in plain PyTorch:
``_flat_stages`` (the plane and window stages), ``flat_staged_plain`` (the
kernels' walk: slot by slot, each ray's running best, the stages decided
once a tile, pad slots skipped) and ``_tile_stage_counts`` (the same count
for one tile test of a walk kernel).

The stages may reject a pair only if the full test (``_tri_hits``, which
tests/test_torch_intersect.py holds to the JAX package's Pallas kernel)
rejects it, or if its candidate t lies at or beyond the ray's running best;
the plane stage alone only pairs the full test rejects. Applied walk by
walk, the staged walk gives the flat plain version's (t, id) bit for bit.
Both are checked on rays chosen to meet the hazards of the kernel's
exactness argument:

- origins on a triangle's plane (n.p1 - o.n == 0, also from -0) and rays
  parallel to it (d.n == 0);
- ±0 and subnormal n.p1 - o.n and d.n of the same sign, whose product
  underflows to 0 (a sign test by multiplication would lose the hit);
- NaN and inf directions and origins, t_max of +inf, above 3.4e38, NaN, 0
  and exactly at a hit, and t_eps = 0 (where the stages must not apply);
- the demo's and the Cornell box's own tiles, pad slots included.

The staged walk over the unpacked MXU pairs gives flat_mxu's plain version
bit for bit and the tiles' counts, and the pair rows that
``flat_mxu_intersect.cu`` reads are held to ``_mxu_unpack`` and to the JAX
package's ``with_mxu_tiles``.

No tolerance: every comparison is exact. The kernels themselves run only
on the card: their test (the demo's camera rays in caller and Morton
order, and the rays above) is marked ``cuda`` and skips without one.
"""

import re

import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu_torch.accel import prepare_scene
from isaklm_raytracer_tpu_torch.accel.cluster import build_cluster_bvh, with_mxu_tiles
from isaklm_raytracer_tpu_torch.camera import Camera
from isaklm_raytracer_tpu_torch.camera.camera import generate_rays
from isaklm_raytracer_tpu_torch.kernels import build
from isaklm_raytracer_tpu_torch.kernels import intersect as ki
from isaklm_raytracer_tpu_torch.scene import procedural

torch.set_num_threads(1)  # the test workers share the host's cores

TINY = np.float32(1e-40)  # subnormal in float32
# The handmade triangles: 0 lies in the plane z = 0 through the origin
# (n.p1 = 0), 1 and 2 in the planes z = +-TINY (n.p1 subnormal), 3 in the
# plane x = 2.
HANDMADE = np.array([
    [(0, 0, 0), (4, 0, 0), (0, 4, 0)],
    [(-1, -1, TINY), (3, -1, TINY), (-1, 3, TINY)],
    [(-1, -1, -TINY), (3, -1, -TINY), (-1, 3, -TINY)],
    [(2, -2, -2), (2, 2, -2), (2, -2, 2)],
], np.float32)
NAN, INF = np.float32(np.nan), np.float32(np.inf)
# (origin, direction) pairs at the edges of the argument
EDGE_RAYS = [
    ((0.5, 0.5, 0.0), (0.0, 0.0, TINY)),      # on plane 0; hits 1 at t = 1, num * ddn == 0
    ((0.5, 0.5, 0.0), (0.0, 0.0, -TINY)),     # hits 2 at t = 1, both negative
    ((0.5, 0.5, -0.0), (0.0, 0.0, 1.0)),      # num = 0 - (-0) on plane 0
    ((0.5, 0.5, 2 * TINY), (0.0, 0.0, -TINY)),  # above 1 and 2, heading down
    ((0.5, 0.5, 0.0), (1.0, 0.0, 0.0)),       # parallel to 0-2 (ddn == 0), hits 3
    ((0.5, 0.5, 1.0), (1.0, 0.0, -0.0)),
    ((0.5, 0.5, 0.5), (0.0, 0.0, 0.0)),       # zero direction: ddn == 0 everywhere
    ((0.5, 0.5, 0.5), (-0.0, -0.0, -0.0)),
    ((0.5, 0.5, 1.0), (NAN, 0.0, -1.0)),
    ((0.5, 0.5, 1.0), (0.0, NAN, 0.0)),
    ((0.5, 0.5, 1.0), (INF, 0.0, 0.0)),
    ((0.5, 0.5, 1.0), (0.0, 0.0, -INF)),
    ((0.5, 0.5, 1.0), (INF, INF, INF)),
    ((NAN, 0.5, 1.0), (0.0, 0.0, -1.0)),
    ((-INF, 0.5, 0.5), (1.0, 0.0, 0.0)),
    ((0.5, 0.5, INF), (0.0, 0.0, -1.0)),
]
# windows, cycled over the rays: the unbounded seed, +inf and another value
# above it, NaN, 0, exactly at the handmade hits (t = 1) and just past
WINDOWS = np.array([3.4e38, INF, 3.39e38, 3.402e38, NAN, 0.0, 1.0, 1.0000001, 0.5, 4.0],
                   np.float32)


def _soup(r, n):
    base = r.uniform(-2.0, 2.0, (n, 1, 3))
    return (base + r.uniform(-0.4, 0.4, (n, 3, 3))).astype(np.float32)


def _tables(name):
    """The real cluster tiles of one scene, their MXU tile pairs, and the
    scene's vertices."""
    if name == "handmade":
        verts = np.concatenate([HANDMADE, _soup(np.random.default_rng(5), 200)])
        cbvh, real = with_mxu_tiles(build_cluster_bvh(verts).to("cpu")), 2
    else:
        scene = {"demo": procedural.material_demo_scene,
                 "cornell": procedural.cornell_box}[name]()
        cbvh, verts = prepare_scene(scene, "cpu").cbvh, np.asarray(scene.vertices)
        real = cbvh.real_clusters
    return cbvh.tri_const[:real], cbvh.mxu_tiles[:real], verts


def _tiles(name):
    """The real cluster tiles of one scene, and its vertices."""
    tri, _, verts = _tables(name)
    return tri, verts


def _rays(name, verts, seed=11):
    """The edge rays (handmade) or random rays from inside the scene's box, a
    third from 1e-3 off a vertex, with the windows of WINDOWS; inactive
    rays only where the window is at most 3.4e38 (an inactive ray with a
    larger window: the kernel keeps its seed, the plain version gives
    (3.4e38, id 0); ROADMAP C)."""
    r = np.random.default_rng(seed)
    flat = verts.reshape(-1, 3)
    lo, hi = flat.min(axis=0), flat.max(axis=0)
    n = 600
    o = r.uniform(lo, hi, (n, 3)).astype(np.float32)
    o[: n // 3] = verts[r.integers(0, verts.shape[0], n // 3), 0] + 1e-3
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if name == "handmade":
        edge_o, edge_d = (np.array(x, np.float32) for x in zip(*EDGE_RAYS))
        o = np.concatenate([np.repeat(edge_o, len(WINDOWS), axis=0), o])
        d = np.concatenate([np.repeat(edge_d, len(WINDOWS), axis=0), d])
    t_max = np.resize(WINDOWS, o.shape[0])
    act = (r.random(o.shape[0]) > 0.2) | ~(t_max <= np.float32(3.4e38))
    with np.errstate(invalid="ignore"):
        return ki.prep_rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(act),
                            torch.from_numpy(t_max))


SCENES = ("handmade", "demo", "cornell")


def _bits(t):
    """float32 t as its bits: equal NaN windows compare equal."""
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("t_eps", [1e-5, 0.0])
@pytest.mark.parametrize("scene", SCENES)
def test_stages_reject_only_pairs_that_cannot_win(scene, t_eps):
    tri, verts = _tiles(scene)
    rays = _rays(scene, verts)
    best_final = ki.flat_intersect_plain(tri, rays, t_eps)[0]
    r = np.random.default_rng(3)
    bests = (rays[:, 7], best_final,
             torch.from_numpy(r.uniform(0.0, 2.0, rays.shape[0]).astype(np.float32)))
    act = rays[:, 6:7] > 0.0
    rejected = 0
    for tile in tri:
        tval = ki._tri_hits(tile, rays, t_eps)  # (R, 128), _INF where rejected
        for best in bests:
            fast = ki._stages_apply(best[:, None], t_eps)
            plane, window = ki._flat_stages(tile, rays, t_eps, best[:, None], fast)
            assert not (window & ~plane).any()
            assert (tval[act.expand_as(plane) & ~plane] == ki._INF).all()
            cut = act & ~window
            assert ((tval == ki._INF) | ~(tval < best[:, None]))[cut].all()
            rejected += int(cut.sum())
            # a walk's count keeps the ties at the best: only s > best is cut
            _, kept = ki._flat_stages(tile, rays, t_eps, best[:, None], fast, keep_ties=True)
            assert not (window & ~kept).any() and not (kept & ~plane).any()
            assert ((tval == ki._INF) | (tval > best[:, None]))[act & ~kept].all()
            if t_eps <= 0.0:
                assert torch.equal(window, act.expand_as(window))
    assert (rejected > 0) == (t_eps > 0.0)


@pytest.mark.parametrize("t_eps", [1e-5, 0.0])
@pytest.mark.parametrize("scene", SCENES)
def test_staged_walk_equals_flat(scene, t_eps):
    tri, verts = _tiles(scene)
    rays = _rays(scene, verts)
    t, ids, counts = ki.flat_staged_plain(tri, rays, t_eps)
    want_t, want_id = ki.flat_intersect_plain(tri, rays, t_eps)
    assert torch.equal(_bits(t), _bits(want_t)) and torch.equal(ids, want_id)
    assert counts.dtype == torch.int64 and counts.shape == (rays.shape[0], 3)
    assert (counts[:, 1] <= counts[:, 0]).all() and (counts[:, 2] <= counts[:, 1]).all()
    inactive = rays[:, 6] <= 0.0
    assert not counts[inactive].any()
    slots = tri.shape[0] * 128
    real = int((tri[:, :15] != 0.0).any(dim=1).sum())
    if t_eps > 0.0:
        # an active ray with a window of at most 3.4e38 visits the real slots
        # alone; the stages cut most of its pairs before the edge test
        plain = ~inactive & (rays[:, 7] <= ki._INF)
        assert (counts[plain, 0] == real).all()
        assert int(counts[plain, 2].sum()) < int(counts[plain, 0].sum()) // 2
    else:
        assert torch.equal(counts[~inactive], torch.full_like(counts[~inactive], slots))
    if scene != "handmade":
        assert real < slots  # the scene has pad slots


def test_subnormal_same_sign_hits_survive_the_plane_stage():
    """The hits on the planes z = +-1e-40 at t = 1: n.p1 - o.n and d.n are
    subnormal and of one sign, and their product underflows to 0."""
    tri, _ = _tiles("handmade")
    o = torch.tensor([[0.5, 0.5, 0.0], [0.5, 0.5, 0.0], [0.5, 0.5, 2 * TINY]])
    d = torch.tensor([[0.0, 0.0, TINY], [0.0, 0.0, -TINY], [0.0, 0.0, -TINY]])
    rays = ki.prep_rays(o, d)
    n = tri[0, 2, 1]
    assert float(n * TINY * n * TINY) == 0.0 and float(n * TINY) != 0.0
    t, ids, _ = ki.flat_staged_plain(tri, rays, 1e-5)
    assert t.tolist() == [1.0, 1.0, 1.0] and ids.tolist() == [1, 2, 1]
    assert torch.equal(ids, ki.flat_intersect_plain(tri, rays, 1e-5)[1])
    # an unbounded window and no hit: slot 0's rejected 3.4e38 beats +inf,
    # as in the plain version
    rays = ki.prep_rays(torch.tensor([[100.0, 100.0, 100.0]]), torch.tensor([[1.0, 0.0, 0.0]]),
                        None, torch.tensor([float("inf")]))
    t, ids, counts = ki.flat_staged_plain(tri, rays, 1e-5)
    assert ids.tolist() == [0] and t.item() == np.float32(3.4e38)
    # the stages apply from the tile after the one that brought the best to
    # 3.4e38, as the kernel decides at a tile's start: the first tile takes
    # the full test on all its slots, the second skips its pad slots
    tile1 = ki.flat_staged_plain(tri[1:], ki.prep_rays(rays[:, :3], rays[:, 3:6]), 1e-5)[2]
    assert counts[0].tolist() == [128 + 76, 128 + tile1[0, 1], 128 + tile1[0, 2]]
    assert tile1[0, 0] == 76 and tile1[0, 2] < 76


@pytest.mark.parametrize("t_eps", [1e-5, 0.0])
@pytest.mark.parametrize("scene", SCENES)
def test_tile_stage_counts_match_the_staged_walk(scene, t_eps):
    """A walk's count of one tile test (``_tile_stage_counts``, against the
    best at the test's start) against the staged walk over that one tile
    (its best running from slot to slot): the same slots visited and pairs
    reaching the division, and no fewer reaching the edge test."""
    tri, verts = _tiles(scene)
    rays = _rays(scene, verts)
    for tile in tri:
        walk = ki.flat_staged_plain(tile[None], rays, t_eps)[2]
        got = ki._tile_stage_counts(tile.expand(rays.shape[0], 16, 128), rays, t_eps, rays[:, 7])
        assert got.dtype == torch.int64 and torch.equal(got[:, :2], walk[:, :2])
        assert (got[:, 2] >= walk[:, 2]).all()


@pytest.mark.parametrize("t_eps", [1e-5, 0.0])
@pytest.mark.parametrize("scene", SCENES)
def test_staged_walk_over_unpacked_pairs_equals_flat_mxu(scene, t_eps):
    """flat_mxu runs the flat kernel's staged walk over the MXU pairs: that
    walk over the unpacked pairs gives flat_mxu's plain version bit for bit,
    and each ray meets the stages at the same pairs as over the tiles."""
    tri, pairs, verts = _tables(scene)
    rays = _rays(scene, verts)
    t, ids, counts = ki.flat_staged_plain(ki._mxu_unpack(pairs), rays, t_eps)
    want_t, want_id = ki.flat_mxu_intersect_plain(pairs, rays, t_eps)
    assert torch.equal(_bits(t), _bits(want_t)) and torch.equal(ids, want_id)
    assert torch.equal(counts, ki.flat_staged_plain(tri, rays, t_eps)[2])


def _pair_rows():
    """The pair rows (W1's 0-15, then W2's 16-31) that flat_mxu_intersect.cu
    reads for the 15 constants, from its ``kPairRows`` table."""
    source = (build.CSRC / "flat_mxu_intersect.cu").read_text()
    match = re.search(r"kPairRows\[kFlatRows\] = \{([^}]*)\}", source)
    assert match, "flat_mxu_intersect.cu lost its kPairRows table"
    rows = [int(x) for x in match.group(1).split(",")]
    assert len(rows) == 15 and len(set(rows)) == 15 and all(0 <= x < 32 for x in rows)
    return rows


def test_pair_rows_of_the_kernel_match_both_packages():
    """The rows flat_mxu_intersect.cu reads are the cluster tile's rows 0-14
    in the pairs of both packages' ``with_mxu_tiles`` and in ``_mxu_unpack``."""
    from isaklm_raytracer_tpu.accel.cluster import build_cluster_bvh as jbuild
    from isaklm_raytracer_tpu.accel.cluster import with_mxu_tiles as jwith_mxu_tiles

    rows = _pair_rows()
    verts = np.concatenate([HANDMADE, _soup(np.random.default_rng(5), 300)])
    jc = jwith_mxu_tiles(jbuild(verts))
    jpairs = np.asarray(jc.mxu_tiles)
    jtri = np.asarray(jc.tri_const)
    assert jpairs.shape == (jtri.shape[0], 2, 16, 128)
    np.testing.assert_array_equal(jpairs.reshape(-1, 32, 128)[:, rows], jtri[:, :15])
    pc = with_mxu_tiles(build_cluster_bvh(verts).to("cpu"))
    np.testing.assert_array_equal(pc.mxu_tiles.numpy(), jpairs)
    pairs = pc.mxu_tiles
    assert torch.equal(pairs.reshape(-1, 32, 128)[:, rows], ki._mxu_unpack(pairs)[:, :15])
    assert torch.equal(pairs.reshape(-1, 32, 128)[:, rows], pc.tri_const[:, :15])
    # every other row of a pair is zero: the kernel reads all it needs
    rest = [x for x in range(32) if x not in rows]
    assert not pairs.reshape(-1, 32, 128)[:, rest].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flat", "flat_mxu"])
def test_cuda_flat_kernel_on_coherent_and_edge_rays(kernel):
    """The kernel (flat over the tiles, or flat_mxu over the MXU pairs)
    equals its plain version bit for bit on camera rays of the demo in
    caller order (the order the render calls flat_mxu in) and Morton order
    (flat's), and on the rays above, at t_eps 1e-5 and 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    fn, plain = {"flat": (ki.flat_intersect, ki.flat_intersect_plain),
                 "flat_mxu": (ki.flat_mxu_intersect, ki.flat_mxu_intersect_plain)}[kernel]
    for scene in SCENES:
        tri, pairs, verts = _tables(scene)
        table = (tri if kernel == "flat" else pairs).cuda()
        sets = [_rays(scene, verts).cuda()]
        if scene == "demo":
            camera = Camera.create((0.0, 1.2, -1.8), pitch=0.15, fov=np.pi / 2, device="cuda")
            ids = torch.arange(128 * 128, device="cuda")
            u = torch.rand((ids.numel(), 4), generator=torch.Generator("cuda").manual_seed(0),
                           device="cuda")
            o, d = generate_rays(camera, 128, 128, ids % 128, ids // 128, u)
            rays = ki.prep_rays(o, d)
            sets += [rays, rays[ki.coherence_perm(o, d, rays[:, 6])].contiguous()]
        for rays in sets:
            for t_eps in (1e-5, 0.0):
                got, want = fn(table, rays, t_eps), plain(table, rays, t_eps)
                torch.cuda.synchronize()
                assert torch.equal(_bits(got[0]), _bits(want[0])), (kernel, scene)
                assert torch.equal(got[1], want[1]), (kernel, scene)
        # an inactive ray with an unbounded window: the kernel keeps its
        # window, the plain version gives (3.4e38, id 0) (ROADMAP C)
        rays = ki.prep_rays(torch.tensor([[100.0, 100.0, 100.0]] * 2, device="cuda"),
                            torch.tensor([[1.0, 0.0, 0.0]] * 2, device="cuda"),
                            torch.tensor([True, False], device="cuda"),
                            torch.tensor([float("inf")] * 2, device="cuda"))
        t, ids = fn(table, rays, 1e-5)
        assert t.tolist() == [np.float32(3.4e38), float("inf")] and ids.tolist() == [0, ki._BIG_ID]
        t, ids = plain(table, rays, 1e-5)
        assert t.tolist() == [np.float32(3.4e38)] * 2 and ids.tolist() == [0, 0]
