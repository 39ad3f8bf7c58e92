"""Port parity: ray ordering and the first-block key.

The Morton permutation (``coherence_perm``) and the first-block keys
(``first_block_keys_plain``, what ``first_block_keys`` runs on a CPU
tensor) are held EXACTLY to the JAX package's ``_coherence_perm`` and
``first_block_keys`` in Pallas interpret mode, on the same numpy rays:
integer keys and permutations admit no tolerance. The rays include inactive
ones, rays that pierce no block, and rays whose origin lies on a block's
slab plane with a zero direction component (the NaN case of the slab test).
Every intersector gives the same (t, idx, hit) in every ordering as in the
caller's order, bit for bit: a ray's result never depends on its
neighbours.

The same holds on hand-made box tables whose invalid boxes lie between
valid ones, at odd widths, and the wrapper admits exactly the widest table
the kernel's shared memory holds.

The CUDA kernel runs only on the card: its test is marked ``cuda`` and
skips without one; ``python3 chip_smoke.py`` runs it (this module imports
JAX only inside the tests that compare with it, as the card's machine has
none) and checks the kernel at the hero's shapes.
"""

import functools
import re

import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu_torch.accel import move_scene, prepare_scene
from isaklm_raytracer_tpu_torch.accel.cluster import build_cluster_bvh, cluster_order, with_blocks
from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.integrator.render import blk_sort_mode, make_trace_fn
from isaklm_raytracer_tpu_torch.kernels import build
from isaklm_raytracer_tpu_torch.kernels import intersect as ki
from isaklm_raytracer_tpu_torch.scene import procedural

torch.set_num_threads(1)  # the test workers share the host's cores

BIG = 2**31 - 1


def _soup(r, n):
    base = r.uniform(-2.0, 2.0, (n, 1, 3))
    verts = (base + r.uniform(-0.4, 0.4, (n, 3, 3))).astype(np.float32)
    return verts[cluster_order(verts)]


def _rays(r, n, spread=3.0):
    o = r.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _edge_rays(r, o, d, bbox_t):
    """Overwrite the head of a ray batch with the edge cases: origins on a
    block's min-x / max-y slab plane with a +0 / -0 direction component
    there (0 * inf = NaN in the slab test), and rays that pierce nothing."""
    o, d = o.copy(), d.copy()
    valid = np.nonzero(bbox_t[6] > 0)[0]
    for i in range(min(8, len(o))):
        b = valid[i % valid.size]
        o[i] = (bbox_t[0:3, b] + bbox_t[3:6, b]) / 2
        axis, row = (0, 0) if i % 2 == 0 else (1, 4)
        o[i, axis] = bbox_t[row, b]
        d[i, axis] = 0.0 if i < 4 else -0.0
    o[8:16] = 100.0  # far outside, heading away
    d[8:16] = np.float32(1.0 / np.sqrt(3.0))
    return o, d


BLOCKED = {
    # the JAX package's own first-block test scene: 1.8k triangles in
    # 16-cluster blocks (one valid block, padded to 128 columns)
    "soup1800_b16": (1800, 16),
    # a block per cluster: 133 valid blocks in a table padded to 256 columns
    "soup17000_b1": (17000, 1),
}


@pytest.fixture(scope="module", params=sorted(BLOCKED))
def blocked(request):
    from isaklm_raytracer_tpu.accel.cluster import build_cluster_bvh as jbuild
    from isaklm_raytracer_tpu.accel.cluster import with_blocks as jwith_blocks

    num, branch = BLOCKED[request.param]
    r = np.random.default_rng(num)
    verts = _soup(r, num)
    jc = jwith_blocks(jbuild(verts), branch)
    pc = with_blocks(build_cluster_bvh(verts).to("cpu"), branch)
    np.testing.assert_array_equal(pc.blk_bbox_t.numpy(), np.asarray(jc.blk_bbox_t))
    return jc, pc, r


@pytest.mark.parametrize("n", [300, 3000])
def test_morton_permutation_equals_jax(n):
    import jax.numpy as jnp

    from isaklm_raytracer_tpu.kernels.intersect import _coherence_perm

    r = np.random.default_rng(n)
    o, d = _rays(r, n)
    o[:5] = o[5]  # equal keys: the stable order decides
    act = (r.random(n) > 0.3).astype(np.float32)
    want = np.asarray(_coherence_perm(jnp.asarray(o), jnp.asarray(d), jnp.asarray(act)))
    got = ki.coherence_perm(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(act))
    np.testing.assert_array_equal(got.numpy(), want)
    # inactive rays sort to the tail
    assert not act[got.numpy()[-int((act == 0).sum()):]].any()


def test_first_block_keys_equal_jax(blocked):
    import jax.numpy as jnp

    from isaklm_raytracer_tpu.kernels.intersect import first_block_keys as jfirst_block_keys

    jc, pc, r = blocked
    n = 1000
    o, d = _edge_rays(r, *_rays(r, n), pc.blk_bbox_t.numpy())
    act = r.random(n) > 0.2
    act[:16] = True
    want = np.asarray(jfirst_block_keys(
        jc, jnp.asarray(o), jnp.asarray(d), active=jnp.asarray(act), interpret=True))
    rays = ki.prep_rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(act))
    got = ki.first_block_keys(pc.blk_bbox_t, rays, 1e-5)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # every case is exercised: NaN-slab origins pierce (key 0 entry), the far
    # rays pierce nothing, inactive rays key to _BIG_ID
    assert (want[:8] < BIG - 1).all()
    assert (want[8:16] == BIG - 1).all()
    assert (want[~act] == BIG).all()
    assert np.unique(want[act & (want < BIG - 1)]).size > 1


def test_first_block_keys_lead_with_the_block_entered_first(blocked):
    """tests/test_cluster_kernel.py's oracle: the key's leading factor is
    the block whose box a numpy slab test says the ray enters first."""
    _, pc, r = blocked
    o, d = _rays(r, 300)
    act = np.ones(300, bool)
    act[::7] = False
    keys = ki.first_block_keys_plain(
        pc.blk_bbox_t,
        ki.prep_rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(act)), 1e-5,
    ).numpy()
    bb = pc.blk_bbox_t.numpy()
    n = bb.shape[1]
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        inv = 1.0 / d
        t1 = (bb[0:3].T[None] - o[:, None]) * inv[:, None]
        t2 = (bb[3:6].T[None] - o[:, None]) * inv[:, None]
    near = np.minimum(t1, t2).max(axis=2)
    far = np.maximum(t1, t2).min(axis=2)
    pierce = (near <= far) & (far >= 1e-5) & (bb[6] > 0)[None]
    first = np.where(pierce, np.maximum(near, 0.0), np.inf).argmin(axis=1)
    hit = pierce.any(axis=1) & act
    np.testing.assert_array_equal(keys[hit] // (8 * (n + 1)), first[hit])
    assert (keys[act & ~hit] == BIG - 1).all()
    assert (keys[~act] == BIG).all()


def test_key_capacity_at_the_largest_admitted_width():
    """Pure integers: the largest key of a ray that pierces a block,
    8n^2 + 8n - 1, stays below the 'pierces nothing' key _BIG_ID - 1 at the
    largest n the check admits, which is the largest the JAX package's
    assert (n + 1) * n * 8 < 2**31 admits."""
    n = 16383
    assert (n + 1) * n * 8 < 2**31 <= (n + 2) * (n + 1) * 8
    ki.check_key_capacity(n)
    with pytest.raises(ValueError, match="overflow"):
        ki.check_key_capacity(n + 1)
    # the key's own int32 arithmetic at (first, second, octant) = (n-1, n, 7)
    fidx = torch.tensor([n - 1], dtype=torch.int32)
    top = int(((fidx * (n + 1) + n) * 8 + 7)[0])
    assert top == 8 * n * n + 8 * n - 1 <= 2**31 - 9 < BIG - 1


def _gap_table(r, width):
    """A component-major (8, width) block box table of random boxes, about
    a third of them invalid and scattered between valid ones (rows 0-5
    min/max xyz, row 6 validity, row 7 zero)."""
    lo = r.uniform(-5.0, 5.0, (3, width))
    table = np.zeros((8, width), np.float32)
    table[0:3], table[3:6] = lo, lo + r.uniform(0.0, 3.0, (3, width))
    table[6] = r.random(width) > 0.35
    table[6, [0, 1, 2, 3, width - 1]] = [0.0, 1.0, 0.0, 1.0, 1.0]  # gaps from the first box on
    return table


def _key_block():
    """(rays a thread, threads a block) of csrc/first_block_keys.cu."""
    source = (build.CSRC / "first_block_keys.cu").read_text()
    rays = re.search(r"constexpr int kKeyRays = (\d+);", source)
    threads = re.search(r"constexpr int kKeyThreads = (\d+);", source)
    assert rays and threads, "first_block_keys.cu lost its launch shape"
    return int(rays.group(1)), int(threads.group(1))


@pytest.mark.parametrize("width,num_rays", [(5, 777), (131, 1023), (257, 129)])
def test_first_block_keys_equal_jax_on_tables_with_gaps(width, num_rays):
    """Invalid boxes between valid ones (the kernel stages only the valid
    ones and keeps their indices), at odd widths (not a multiple of the
    kernel's rays a thread), with edge rays on slab planes."""
    import jax.numpy as jnp

    from isaklm_raytracer_tpu.accel.cluster import build_cluster_bvh as jbuild
    from isaklm_raytracer_tpu.kernels.intersect import first_block_keys as jfirst_block_keys

    assert width % _key_block()[0] and num_rays % _key_block()[0]
    r = np.random.default_rng(width)
    table = _gap_table(r, width)
    valid = np.nonzero(table[6] > 0)[0]
    assert ((valid[:-1] + 1) != valid[1:]).any()  # a gap between valid boxes
    o, d = _edge_rays(r, *_rays(r, num_rays, spread=6.0), table)
    act = r.random(num_rays) > 0.2
    act[:16] = True
    jc = jbuild(_soup(r, 200)).replace(blk_bbox_t=jnp.asarray(table))
    want = np.asarray(jfirst_block_keys(
        jc, jnp.asarray(o), jnp.asarray(d), active=jnp.asarray(act), interpret=True))
    rays = ki.prep_rays(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(act))
    got = ki.first_block_keys(torch.from_numpy(table), rays, 1e-5)
    np.testing.assert_array_equal(got.numpy(), want)
    pierced = want[act & (want < BIG - 1)]
    assert pierced.size and set(pierced // (8 * (width + 1))) <= set(valid)
    assert (want[8:16] == BIG - 1).all() and (want[~act] == BIG).all()


def test_shared_box_limit_is_the_kernels():
    """The wrapper admits the widest table whose 28 bytes a box (and the
    kernel's per-warp counts) fit a block's 232,448 bytes of shared memory,
    and refuses one box more, saying so."""
    source = (build.CSRC / "first_block_keys.cu").read_text()
    assert "kBoxBytes = sizeof(float4) + sizeof(float2) + sizeof(int);" in source
    assert ki._KEY_BOX_BYTES == 16 + 8 + 4
    warps = _key_block()[1] // 32
    limit = ki._MAX_SHARED_BOXES
    assert limit * ki._KEY_BOX_BYTES + 4 * warps <= ki._MAX_SHARED_BYTES
    assert (limit + 1) * ki._KEY_BOX_BYTES > ki._MAX_SHARED_BYTES
    assert limit == 8301
    ki._check_shared(limit, "block")
    with pytest.raises(ValueError, match=f"8302 block boxes exceed the {limit} .* 232448 bytes"):
        ki._check_shared(limit + 1, "block")


def _scene_for(kernel):
    r = np.random.default_rng(7)
    verts = _soup(r, 4000)
    cbvh = build_cluster_bvh(verts).to("cpu")
    if kernel == "blk":
        cbvh = with_blocks(cbvh, 8)
    return cbvh, r


ORDERINGS = [("flat", True), ("queue", True), ("blk", True), ("blk", "block")]


@pytest.mark.parametrize("kernel,sort_rays", ORDERINGS)
def test_each_ordering_equals_caller_order(kernel, sort_rays):
    cbvh, r = _scene_for(kernel)
    fn = {"flat": ki.nearest_hit_flat, "queue": ki.nearest_hit_queue,
          "blk": ki.nearest_hit_blk}[kernel]
    n = 700
    o, d = (torch.from_numpy(x) for x in _rays(r, n))
    act = torch.from_numpy(r.random(n) > 0.3)
    t_max = torch.from_numpy(r.uniform(0.0, 4.0, n).astype(np.float32))
    rays = ki.prep_rays(o, d, act, t_max)
    perm = ki.ray_order(rays, sort_rays, 128, cbvh.blk_bbox_t)
    assert not torch.equal(perm, torch.arange(n))  # the order really changes
    for a, tm in ((None, None), (act, None), (act, t_max)):
        want = fn(cbvh, o, d, active=a, t_max=tm, sort_rays=False)
        got = fn(cbvh, o, d, active=a, t_max=tm, sort_rays=sort_rays)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (kernel, sort_rays)
        assert want[2].any()


def test_ordering_gates():
    """Sorted only above one packet; 'block' only for blk; anything else
    raises."""
    cbvh, r = _scene_for("blk")
    rays = ki.prep_rays(*(torch.from_numpy(x) for x in _rays(r, 256)))
    assert ki.ray_order(rays, True, 256) is None
    assert ki.ray_order(rays, "block", 256, cbvh.blk_bbox_t) is None
    assert ki.ray_order(rays, True, 255) is not None
    assert ki.ray_order(rays, False, 0) is None
    with pytest.raises(ValueError, match="sort_rays"):
        ki.ray_order(rays, "morton", 0)
    o, d = rays[:, 0:3], rays[:, 3:6]
    for fn in (ki.nearest_hit_flat, ki.nearest_hit_queue):
        with pytest.raises(ValueError, match="blk only"):
            fn(cbvh, o, d, sort_rays="block")


def test_blk_sort_mode_and_trace_fn(monkeypatch):
    """ISAKLM_BLK_SORT picks the blk ordering (morton by default, block);
    flat and queue always sort by Morton; an invalid value raises."""
    scene = move_scene(procedural.cornell_box(include_blockers=False), "cpu")
    blk_scene = prepare_scene(procedural.cornell_box(include_blockers=False), "cpu")
    blk_scene = blk_scene.replace(cbvh=with_blocks(blk_scene.cbvh, 8))
    config = RenderConfig(width=8, height=8)
    monkeypatch.delenv("ISAKLM_BLK_SORT", raising=False)
    monkeypatch.delenv("ISAKLM_INTERSECTOR", raising=False)
    assert blk_sort_mode() == "morton"
    trace = make_trace_fn(blk_scene, config)
    assert trace.func is ki.nearest_hit_flat and trace.keywords["sort_rays"] is True
    monkeypatch.setenv("ISAKLM_INTERSECTOR", "blk")
    assert make_trace_fn(blk_scene, config).keywords["sort_rays"] is True
    monkeypatch.setenv("ISAKLM_BLK_SORT", "block")
    assert blk_sort_mode() == "block"
    trace = make_trace_fn(blk_scene, config)
    assert trace.func is ki.nearest_hit_blk and trace.keywords["sort_rays"] == "block"
    monkeypatch.setenv("ISAKLM_INTERSECTOR", "queue")
    assert make_trace_fn(blk_scene, config).keywords["sort_rays"] is True
    assert isinstance(make_trace_fn(scene, config), functools.partial)
    for bad in ("Block", "none", ""):
        monkeypatch.setenv("ISAKLM_BLK_SORT", bad)
        with pytest.raises(ValueError, match="ISAKLM_BLK_SORT"):
            blk_sort_mode()
    for intersector in ("blk", "queue"):  # read for every scene, as in JAX
        monkeypatch.setenv("ISAKLM_INTERSECTOR", intersector)
        with pytest.raises(ValueError, match="ISAKLM_BLK_SORT"):
            make_trace_fn(blk_scene, config)


def test_cpu_wrapper_runs_plain_version_without_launch(blocked):
    _, pc, r = blocked
    rays = ki.prep_rays(*(torch.from_numpy(x) for x in _rays(r, 200)))
    ki.COUNTS.reset()
    got = ki.first_block_keys(pc.blk_bbox_t, rays, 1e-5)
    assert ki.COUNTS.first_blocks_kernel == 0 and ki.COUNTS.plain_cuda() == 0
    assert torch.equal(got, ki.first_block_keys_plain(pc.blk_bbox_t, rays, 1e-5))
    with pytest.raises(ValueError):
        ki.first_block_keys(pc.blk_bbox_t[:6], rays, 1e-5)
    with pytest.raises(TypeError):
        ki.first_block_keys(pc.blk_bbox_t.double(), rays, 1e-5)


@pytest.mark.cuda
def test_cuda_first_block_keys_match_plain_version():
    """The kernel against its plain version on the card, key for key, with
    the edge-case rays, at the bench's ray counts, at counts around the
    kernel's block of rays (its tail rays masked), on tables with invalid
    boxes between valid ones, and on the widest table the wrapper admits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    per_thread, threads = _key_block()
    block = per_thread * threads
    r = np.random.default_rng(5)
    soup = with_blocks(build_cluster_bvh(_soup(r, 17000)).to("cuda"), 1).blk_bbox_t
    counts = sorted({1, 127, 129, 777, 2048, block - 1, block + 1, 2 * block + per_thread - 1,
                     threads + 1})
    tables = [soup, *(torch.from_numpy(_gap_table(r, w)).cuda() for w in (131, ki._MAX_SHARED_BOXES))]
    for table in tables:
        for n in counts if table is soup else (777, block + 1):
            o, d = _edge_rays(r, *_rays(r, n, spread=6.0), table.cpu().numpy())
            act = torch.from_numpy(r.random(n) > 0.2).cuda()
            rays = ki.prep_rays(torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda(), act)
            got = ki.first_block_keys(table, rays, 1e-5)
            want = ki.first_block_keys_plain(table, rays, 1e-5)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (table.shape[1], n)
