"""The group walk of the queue, blocked, MXU-blocked and oct kernels in
plain PyTorch (``queue_walk_plain``, ``blk_walk_plain``,
``blk_mxu_walk_plain``, ``hbm_walk_plain``).

The walk kernels (``csrc/group_walk.cuh``) prune: each ray visits groups
front to back and skips what lies behind its own best hit. Their plain
walk runs the same steps vectorised over rays and returns the per-ray
counts the kernels' ``stats=True`` give. Here, on the soups of
tests/test_torch_variants.py (single clusters, blocks of 16 and 32
clusters, octs of 8, cluster counts padded), in four activity cases:

- its (t, id) equal the unpruned plain versions' (``*_intersect_plain``,
  which the tests of tests/test_torch_hero.py and test_torch_variants.py
  hold to the Pallas kernels) bit for bit;
- its counts are plausible: no ray intersects more clusters than it
  pierces inside the groups it pierces, or visits more groups than it
  pierces, an inactive ray counts nothing, and a walk over single clusters
  (the queue's) visits exactly the clusters it intersects;
- the MXU blocked walk equals the blocked walk in every output.

The kernels against this walk, counts included, need the card: that test
is marked ``cuda`` and skips without one (``python3 chip_smoke.py`` holds
them to it at the hero's shapes).
"""

import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # the test workers share the host's cores

from isaklm_raytracer_tpu_torch.accel import with_oct_branch
from isaklm_raytracer_tpu_torch.accel.cluster import build_cluster_bvh, cluster_order
from isaklm_raytracer_tpu_torch.kernels import build
from isaklm_raytracer_tpu_torch.kernels import intersect as ki


def _soup(r, n):
    base = r.uniform(-2.0, 2.0, (n, 1, 3))
    verts = (base + r.uniform(-0.4, 0.4, (n, 3, 3))).astype(np.float32)
    return verts[cluster_order(verts)]


def _rays(r, verts, n, case):
    """Random rays, a third from 1e-3 off a vertex, with the case's
    activity and t_max windows."""
    o = r.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    k = n // 3
    o[:k] = verts[r.integers(0, verts.shape[0], k), 0] + 1e-3
    d = r.normal(size=(n, 3)).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    act = None if case == "all" else torch.from_numpy(
        np.zeros(n, bool) if case == "none" else r.random(n) > 0.3)
    t_max = torch.from_numpy(r.uniform(0.0, 4.0, n).astype(np.float32)) if case == "window" \
        else None
    return ki.prep_rays(torch.from_numpy(o), torch.from_numpy(d), act, t_max)


def _walks(layout, cbvh):
    """(walk_plain(rays, stages=False), intersect_plain, group boxes,
    cluster boxes, size) of a layout."""
    one_ray = torch.zeros((1, 8), device=cbvh.tri_const.device)  # for the tables. checks
    if layout == "queue":
        args = (cbvh.clu_bbox_t, cbvh.tri_const)
        boxes = cbvh.clu_bbox_t[:, : cbvh.tri_const.shape[0]]
        return (lambda x, stages=False: ki.queue_walk_plain(*args, x, 1e-5, stages),
                lambda x: ki.queue_intersect_plain(*args, x, 1e-5), boxes, boxes, 1)
    if layout == "hbm8":
        args = (cbvh.oct_bbox_t, cbvh.tri_const)
        groups = ki._oct_groups(*args, one_ray, 8)
        return (lambda x, stages=False: ki.hbm_walk_plain(*args, x, 1e-5, 8, stages),
                lambda x: ki.hbm_intersect_plain(*args, x, 1e-5, 8), *groups[:3])
    if layout.startswith("blk_mxu"):
        args = (cbvh.blk_bbox_t, cbvh.mxu_const)
        groups = ki._blk_mxu_groups(*args, one_ray)
        return (lambda x, stages=False: ki.blk_mxu_walk_plain(*args, x, 1e-5, stages),
                lambda x: ki.blk_mxu_intersect_plain(*args, x, 1e-5), *groups[:3])
    args = (cbvh.blk_bbox_t, cbvh.blk_const)
    groups = ki._blk_groups(*args, one_ray)
    return (lambda x, stages=False: ki.blk_walk_plain(*args, x, 1e-5, stages),
            lambda x: ki.blk_intersect_plain(*args, x, 1e-5), *groups[:3])


def _scene(layout, seed):
    verts = _soup(np.random.default_rng(seed), 1800 if layout.startswith("blk") else 1200)
    if layout == "queue":
        return verts, build_cluster_bvh(verts).to("cpu")
    branch = int(layout.lstrip("blk_mxuhb"))
    if layout.startswith("blk_mxu"):
        return verts, build_cluster_bvh(verts, mxu_branch=branch).to("cpu")
    if layout.startswith("blk"):
        return verts, build_cluster_bvh(verts, blk_branch=branch).to("cpu")
    return verts, with_oct_branch(build_cluster_bvh(verts).to("cpu"), branch)


CASES = ("all", "active", "window", "none")
LAYOUTS = ("blk16", "blk32", "blk_mxu16", "hbm8", "queue")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_walk_plain_equals_unpruned_and_counts_plausibly(layout, case):
    seed = 80 + len(layout) + CASES.index(case)
    verts, cbvh = _scene(layout, seed)
    walk, unpruned, group_t, clu_t, size = _walks(layout, cbvh)
    rays = _rays(np.random.default_rng(seed), verts, 777, case)
    t, ids, stats = walk(rays)
    want_t, want_id = unpruned(rays)
    assert torch.equal(t, want_t) and torch.equal(ids, want_id)
    assert stats.dtype == torch.int32 and stats.shape == (777, 2)

    num_groups = clu_t.shape[1] // size
    groups = ki._pierce(group_t[:, :num_groups], rays, 1e-5)
    clusters = groups.repeat_interleave(size, dim=1) & ki._pierce(clu_t, rays, 1e-5)
    assert (stats[:, 0] <= groups.sum(dim=1)).all()
    assert (stats[:, 1] <= clusters.sum(dim=1)).all()
    inactive = rays[:, 6] <= 0.0
    assert not stats[inactive].any()
    if size == 1:
        assert torch.equal(stats[:, 0], stats[:, 1])
    hits = int((ids != ki._BIG_ID).sum())
    assert (hits == 0) == (case == "none")
    if case != "none":  # the walk prunes: some pierced cluster goes untested
        assert int(stats[:, 1].sum()) < int(clusters.sum())


@pytest.mark.parametrize("layout", LAYOUTS)
def test_walk_stage_counts(layout):
    """With ``stages`` the walk gives the same (t, id, stats) and counts its
    cluster tests by the flat kernel's stages (chip_smoke.py's bounds): per
    ray, the real slots of the clusters it intersected (pad slots of a
    tile's tail left out), fewer pairs at each later stage, nothing for a
    ray that tests no cluster, and the edge test on under half the slots."""
    seed = 60 + len(layout)
    verts, cbvh = _scene(layout, seed)
    walk = _walks(layout, cbvh)[0]
    rays = _rays(np.random.default_rng(seed), verts, 777, "window")
    t, ids, stats, counts = walk(rays, stages=True)
    assert all(torch.equal(a, b) for a, b in zip((t, ids, stats), walk(rays)))
    assert counts.dtype == torch.int64 and counts.shape == (777, 3)
    assert (counts[:, 0] <= 128 * stats[:, 1]).all()
    assert (counts[:, 0] > 128 * (stats[:, 1] - 1)).all()  # at most one tile is short
    assert (counts[:, 1] <= counts[:, 0]).all() and (counts[:, 2] <= counts[:, 1]).all()
    assert not counts[stats[:, 1] == 0].any()
    assert 0 < int(counts[:, 2].sum()) < int(counts[:, 0].sum()) // 2


def test_mxu_walk_equals_blocked_walk():
    verts, cbvh = _scene("blk16", 90)
    cbvh = build_cluster_bvh(verts, blk_branch=16, mxu_branch=16).to("cpu")
    rays = _rays(np.random.default_rng(90), verts, 500, "window")
    got = ki.blk_mxu_walk_plain(cbvh.blk_bbox_t, cbvh.mxu_const, rays, 1e-5)
    want = ki.blk_walk_plain(cbvh.blk_bbox_t, cbvh.blk_const, rays, 1e-5)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert int(want[2][:, 1].sum()) > 0


def test_walk_shared_memory_is_counted():
    """Each of a block's warps keeps one 8-byte key per group; a table whose
    lists overflow a block's shared memory is refused before a launch."""
    assert ki.walk_shared_bytes(122) == ki._WALK_WARPS * 8 * 122
    most = ki._MAX_SHARED_BYTES // ki.walk_shared_bytes(1)
    ki._check_walk("walk", most, "group")
    with pytest.raises(ValueError, match="shared memory"):
        ki._check_walk("walk", most + 1, "group")


def test_walk_launch_shape_matches_the_kernel_source():
    """The wrapper counts the shared memory of the launch that
    csrc/group_walk.cuh makes: its warps per block and its 8-byte key per
    group and warp."""
    source = (build.CSRC / "group_walk.cuh").read_text()
    warps = re.search(r"constexpr int kWalkWarps = (\d+);", source)
    assert warps and int(warps.group(1)) == ki._WALK_WARPS
    assert re.search(r"walk_shared_bytes\(int num_groups\) \{\s*return sizeof\(unsigned long "
                     r"long\) \* kWalkWarps \* static_cast<size_t>\(num_groups\);", source)
    assert "extern __shared__ unsigned long long lists[];  // kWalkWarps * num_groups" in source


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["blk32", "blk_mxu32", "hbm8", "queue"])
def test_cuda_walk_kernels_equal_walk_plain(layout):
    """The kernels' (t, id) and per-ray stats equal the plain walk's, bit
    for bit, at the bench's ray counts in the four activity cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    verts, cbvh = _scene(layout, 95)
    cbvh = cbvh.to("cuda")
    kernel = {
        "blk32": lambda x: ki.blk_intersect(cbvh.blk_bbox_t, cbvh.blk_const, x, 1e-5, True),
        "blk_mxu32": lambda x: ki.blk_mxu_intersect(cbvh.blk_bbox_t, cbvh.mxu_const, x, 1e-5,
                                                    True),
        "hbm8": lambda x: ki.hbm_intersect(cbvh.oct_bbox_t, cbvh.tri_const, x, 1e-5, 8, True),
        "queue": lambda x: ki.queue_intersect(cbvh.clu_bbox_t, cbvh.tri_const, x, 1e-5, True),
    }[layout]
    walk = _walks(layout, cbvh)[0]
    r = np.random.default_rng(96)
    for n in (2048, 777):
        for case in CASES:
            rays = _rays(r, verts, n, case).cuda()
            got, want = kernel(rays), walk(rays)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (layout, n, case)
