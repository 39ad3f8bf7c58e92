"""The KD walk's triangle-constant table and the redesigned walk and brute
force.

``accel.wavefront.tri_consts_plain`` (the plain version of the table
kernel, csrc/tri_consts.cu) against an independent float32 computation of
``tri_hits``' terms, and a test that reads the table's records against
``tri_hits`` itself, bit for bit: on the cornell, demo, straddler and soup
fixtures, zero-area triangles (the 1e-30 floor of the normal) and NaN
corners. The tables' layout: 80-byte records, one a triangle, the id word
its row; the chunk rows' ids into the table (-1 pads at a row's tail,
chains, empty leaves, a tree without triangles); both trees' caches.

The ``cuda`` tests run the table kernel, the KD walk kernel (both layouts,
at the default depth, 32 and the largest its stack admits, on trees that
fill and overflow the stack) and the brute-force kernel (triangle counts around its
tile, ray counts around its block, every ray inactive, exact ties) against
their plain versions on the card, bit for bit; they skip without one, and
``python3 chip_smoke.py`` (phase kd) runs them there. This module imports
no JAX.
"""

import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu_torch.accel import build_kd_tree, build_wavefront_kd, nearest_hit_brute
from isaklm_raytracer_tpu_torch.accel.kd_traverse import kd_plain
from isaklm_raytracer_tpu_torch.accel.wavefront import tri_consts_plain, tri_hits, wavefront_plain
from isaklm_raytracer_tpu_torch.kernels import intersect as ki
from isaklm_raytracer_tpu_torch.scene import procedural
from isaklm_raytracer_tpu_torch.scene.types import KDTreeArrays

torch.set_num_threads(1)  # the test workers share the host's cores

SCENES = {
    "cornell": lambda: procedural.cornell_box(),
    "demo": lambda: procedural.material_demo_scene(),
    "soup": lambda: procedural.triangle_soup(3000, seed=3),
    "straddler": lambda: procedural.triangle_soup(64, seed=9, extent=2.0, tri_size=1.5),
}
KD_ARGS = {"cornell": (8, 4), "demo": (19, 7), "soup": (19, 7), "straddler": (10, 2)}
F32 = np.float32


def _verts(name) -> np.ndarray:
    """The fixture's (N, 3, 3) corners; "degenerate" is the cornell box with
    zero-area triangles (a point, a segment) and corners holding a NaN."""
    if name != "degenerate":
        return np.asarray(SCENES[name]().vertices, F32)
    v = _verts("cornell").copy()
    v[0] = v[0, 0]  # three equal corners
    v[1, 2] = v[1, 0] + 2.0 * (v[1, 1] - v[1, 0])  # collinear
    v[2, 1, 1] = np.nan
    v[3, 0, 0] = np.nan
    return v


def _words_numpy(p1, e1, e2, ids) -> np.ndarray:
    """The records of triangles (p1, e1, e2) with these ids, in numpy
    float32, term by term as ``tri_hits``
    forms them (cross, the squared norm floored at 1e-30, 1 / sqrt, the
    dot products summed left to right). The square root is torch's, the
    primitive ``tri_hits`` calls: on the CPU it is not correctly rounded
    on every build (AVX-512), while numpy's is."""
    def dot(a, b):
        return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]

    c = np.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                  e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                  e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        nn = dot(c, c)
        nn = np.where(nn < F32(1e-30), F32(1e-30), nn)  # NaN stays NaN
        n = c * (F32(1.0) / torch.sqrt(torch.from_numpy(nn)).numpy())[:, None]
        d00, d01, d11 = dot(e1, e1), dot(e1, e2), dot(e2, e2)
        inv_den = F32(1.0) / (d00 * d11 - d01 * d01)
    zero = np.zeros_like(d00)
    words = [n[:, 0], n[:, 1], n[:, 2], dot(n, p1), p1[:, 0], p1[:, 1], p1[:, 2],
             np.asarray(ids, np.int32).view(F32), e1[:, 0], e1[:, 1], e1[:, 2], d00,
             e2[:, 0], e2[:, 1], e2[:, 2], d11, d01, inv_den, zero, zero]
    return np.stack(words, axis=1).astype(F32)


def _same_bits(a, b) -> bool:
    """Bit for bit, a NaN matching a NaN (numpy's and torch's NaNs may carry
    other payloads)."""
    a, b = np.asarray(a), np.asarray(b)
    both_nan = np.isnan(a) & np.isnan(b)
    return a.shape == b.shape and bool(np.all((a.view(np.int32) == b.view(np.int32))
                                              | both_nan))


def table_hits(o, d, rec, t_eps: float) -> torch.Tensor:
    """The plain test read from the records (csrc/tri_test.cuh ``tri_t``):
    rays (..., 3) against records (..., 20), broadcasting."""
    def dot(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]

    n, np1, p1 = rec[..., 0:3], rec[..., 3], rec[..., 4:7]
    e1, d00, e2, d11 = rec[..., 8:11], rec[..., 11], rec[..., 12:15], rec[..., 15]
    d01, inv_den = rec[..., 16], rec[..., 17]
    ddn = dot(d, n)
    s = (np1 - dot(o, n)) / ddn
    v2 = o + s[..., None] * d - p1
    d20, d21 = dot(v2, e1), dot(v2, e2)
    b = (d11 * d20 - d01 * d21) * inv_den
    c = (d00 * d21 - d01 * d20) * inv_den
    a = 1.0 - b - c
    inside = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0) & (c >= 0.0) & (c <= 1.0)
    return torch.where((ddn != 0.0) & (s >= t_eps) & inside, s, float("inf"))


def _rays(v: np.ndarray, n: int, seed: int):
    """Random rays through the fixture's box, and rays aimed at random
    triangles' centroids (hits, many near edges of a neighbour)."""
    r = np.random.default_rng(seed)
    finite = v[np.isfinite(v).all(axis=(1, 2))].reshape(-1, 3)
    lo, hi = finite.min(axis=0), finite.max(axis=0)
    o = r.uniform(lo - 0.5, hi + 0.5, (n, 3)).astype(F32)
    d = r.normal(size=(n, 3)).astype(F32)
    target = v[r.integers(0, v.shape[0], n // 2)].mean(axis=1)
    d[: n // 2] = np.where(np.isfinite(target), target - o[: n // 2], d[: n // 2])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d)


FIXTURES = ["cornell", "demo", "straddler", "soup", "degenerate"]


def _one_leaf(v: np.ndarray, leaf_width: int = 8):
    """The chunk rows of a tree whose one leaf holds every triangle (chained
    rows of ``leaf_width`` in id order), for any fixture."""
    n = v.shape[0]
    kd = KDTreeArrays(child_a=np.zeros(1, np.int32), child_b=np.full(1, n, np.int32),
                      axis=np.zeros(1, np.int32), plane=np.zeros(1, F32),
                      is_leaf=np.ones(1, bool), tri_indices=np.arange(n, dtype=np.int32),
                      bbox_min=np.full(3, -1, F32), bbox_max=np.full(3, 1, F32), max_depth=4)
    return build_wavefront_kd(kd, v, leaf_width)


@pytest.mark.parametrize("corners", [True, False], ids=["corners", "edges"])
@pytest.mark.parametrize("scene", FIXTURES)
def test_tri_consts_plain_words_equal_tri_hits_terms(scene, corners):
    """Every word of ``tri_consts_plain`` equals the term ``tri_hits``
    forms, computed independently in numpy float32: from the corners, and
    from the chunk rows' p1 | e1 | e2 (what ``wavefront_plain`` hands
    ``tri_hits``) of every slot, its record read through the slot's id."""
    v = _verts(scene)
    got = tri_consts_plain(torch.from_numpy(v.reshape(-1, 9))).numpy()
    assert got.dtype == np.float32 and got.shape == (v.shape[0], 20)
    if corners:
        ids = np.arange(v.shape[0])
        want = _words_numpy(v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0], ids)
    else:
        wkd = _one_leaf(v)
        ids = wkd.chunk_tri[wkd.chunk_tri >= 0]
        data = wkd.chunk_data[wkd.chunk_tri >= 0]
        assert sorted(ids.tolist()) == list(range(v.shape[0]))
        want = _words_numpy(data[:, 0:3], data[:, 3:6], data[:, 6:9], ids)
    assert _same_bits(got[ids], want)
    assert (got[:, 7].view(np.int32) == np.arange(v.shape[0])).all()
    assert (got[:, 18:20] == 0.0).all()


@pytest.mark.parametrize("scene", FIXTURES)
def test_test_read_from_the_table_equals_tri_hits(scene):
    """A test that reads the records gives ``tri_hits``' s for every (ray,
    triangle) pair, bit for bit (the kernels' test reads the same words)."""
    v = _verts(scene)
    if v.shape[0] > 700:
        v = v[np.random.default_rng(1).choice(v.shape[0], 700, replace=False)]
    o, d = _rays(v, 256, seed=2)
    rec = tri_consts_plain(torch.from_numpy(v.reshape(-1, 9)))
    t = torch.from_numpy(v)
    p1 = t[:, 0]
    want = tri_hits(o[:, None], d[:, None], p1, t[:, 1] - p1, t[:, 2] - p1, 1e-5)
    got = table_hits(o[:, None], d[:, None], rec, 1e-5)
    assert torch.equal(got, want)
    assert torch.isfinite(want).any()  # the rays hit something
    if scene == "degenerate":
        assert torch.isinf(want[:, :4]).all()  # degenerate and NaN triangles never hit


def _host_tree(scene, leaf_width):
    v = _verts(scene)
    kd = build_kd_tree(v, *KD_ARGS[scene])
    return v, kd, build_wavefront_kd(kd, v, leaf_width)


@pytest.mark.parametrize("leaf_width", [8, 4, 3])
@pytest.mark.parametrize("scene", ["cornell", "straddler", "soup"])
def test_wavefront_table_layout(scene, leaf_width):
    """``WavefrontKD.tri_table``: (N, 20) float32, one 80-byte record a
    triangle, row = id (the id word), equal to ``tri_consts_plain`` of the
    corners (every triangle lies in some leaf), built once; the chunk rows'
    ids index it, their -1 pads only at a row's tail, each leaf
    ceil(count / L) rows, chained when it has more."""
    v, kd, host = _host_tree(scene, leaf_width)
    wkd = host.to("cpu")
    table = wkd.tri_table
    assert table.dtype == torch.float32 and table.shape == (v.shape[0], 20)
    assert table.element_size() * table.shape[-1] == 80 and table.is_contiguous()
    assert wkd.tri_table is table  # built once
    bits = table.view(torch.int32)
    assert torch.equal(bits[:, 7], torch.arange(v.shape[0], dtype=torch.int32))
    assert torch.equal(bits, tri_consts_plain(torch.from_numpy(v.reshape(-1, 9)))
                       .view(torch.int32))
    chunk_tri = wkd.chunk_tri
    assert int(chunk_tri.max()) == v.shape[0] - 1 and int(chunk_tri.min()) >= -1
    seen_pad = torch.cumsum((chunk_tri < 0).int(), dim=1) > 0
    assert torch.equal(seen_pad, chunk_tri < 0)
    counts = np.asarray(kd.child_b)[np.asarray(kd.is_leaf)]
    assert chunk_tri.shape[0] == int((-(-counts // leaf_width)).sum())
    if leaf_width < 8:
        assert (wkd.chunk_next >= 0).any()  # chains occur


def test_wavefront_table_with_empty_leaves():
    """Leaves emptied in a spine tree get no row (leaf_first -1); the table
    still holds every triangle's record, from the corners the tree keeps,
    those no row holds among them (never read)."""
    v, kd = spine_tree(12, 11)
    empty = np.array([3, 7, 13])  # the leaves of T_1, T_3 and T_6
    kd.child_b[empty] = 0
    wkd = build_wavefront_kd(kd, v, 8).to("cpu")
    assert (wkd.leaf_first[empty] == -1).all()
    assert wkd.chunk_tri[:, 0].tolist() == [k for k in range(13) if k not in (1, 3, 6)]
    assert (wkd.chunk_tri[:, 1:] == -1).all()
    assert torch.equal(wkd.corners, torch.from_numpy(v.reshape(-1, 9)))
    corners = tri_consts_plain(torch.from_numpy(v.reshape(-1, 9))).view(torch.int32)
    assert torch.equal(wkd.tri_table.view(torch.int32), corners)


def test_wavefront_table_of_a_tree_without_triangles():
    """A tree whose only leaf is empty: one padded row, and the table of
    every triangle of the scene all the same."""
    kd = KDTreeArrays(child_a=np.zeros(1, np.int32), child_b=np.zeros(1, np.int32),
                      axis=np.zeros(1, np.int32), plane=np.zeros(1, F32),
                      is_leaf=np.ones(1, bool), tri_indices=np.zeros(0, np.int32),
                      bbox_min=np.full(3, -1, F32), bbox_max=np.full(3, 1, F32), max_depth=4)
    v = _verts("cornell")
    wkd = build_wavefront_kd(kd, v, 8).to("cpu")
    assert (wkd.chunk_tri == -1).all()
    assert wkd.tri_table.shape == (v.shape[0], 20)


def test_tree_table_is_per_triangle_and_cached():
    """``KDTreeArrays.tri_table(vertices)``: (N, 20), row = triangle id (the
    id word), equal to ``tri_consts_plain`` of the corners; the same tensor
    again for the same vertices, a new one for others."""
    v = _verts("cornell")
    kd = build_kd_tree(v, *KD_ARGS["cornell"]).to("cpu")
    verts = torch.from_numpy(v)
    table = kd.tri_table(verts)
    assert table.shape == (v.shape[0], 20)
    assert torch.equal(table.view(torch.int32)[:, 7], torch.arange(v.shape[0], dtype=torch.int32))
    assert torch.equal(table.view(torch.int32),
                       tri_consts_plain(verts.reshape(-1, 9)).view(torch.int32))
    assert kd.tri_table(verts) is table
    other = verts + 1.0
    assert kd.tri_table(other) is not table
    assert kd.tri_table(other)[0, 4] == table[0, 4] + 1.0  # p1x moved


def test_tri_consts_wrapper_on_the_cpu_and_its_checks():
    """On a CPU tensor ``kernels.intersect.tri_consts`` is the plain
    version; a source not (num, 9) float32 raises; on a CUDA tensor it
    launches the kernel or raises (no card, no nvcc here) and never runs
    the plain version."""
    v = torch.from_numpy(_verts("demo"))
    src = v.reshape(-1, 9)
    assert torch.equal(ki.tri_consts(src).view(torch.int32),
                       tri_consts_plain(src).view(torch.int32))
    for bad in (v, src[:, :8], src.double()):
        with pytest.raises(ValueError):
            ki.tri_consts(bad)

    class CudaLike(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    ki.COUNTS.reset()
    with pytest.raises(RuntimeError):
        ki.tri_consts(src.as_subclass(CudaLike))
    assert ki.COUNTS.tri_consts_kernel == ki.COUNTS.plain_cuda() == 0


# --- on the card -----------------------------------------------------------


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


def spine_tree(inner: int, max_depth: int):
    """A KD tree whose spine of ``inner`` nodes splits x at 1, 2, ...: node
    2k is inner (plane x = k + 1), its child 2k + 1 a leaf holding the
    triangle T_k in the plane x = k + 0.5, and its other child 2k + 2 the
    next node (2 * inner the last leaf, holding T_inner). A ray going -x
    from beyond the last plane pushes one cell a node, ``inner`` in all:
    over the stack when ``max_depth`` + 2 is less. Returns (vertices,
    tree) on the host."""
    k = np.arange(inner + 1, dtype=F32)
    v = np.zeros((inner + 1, 3, 3), F32)
    v[:, :, 0] = (k + 0.5)[:, None]
    v[:, 1, 1] = 1.0
    v[:, 2, 2] = 1.0
    nodes = 2 * inner + 1
    child_a = np.zeros(nodes, np.int32)
    child_b = np.zeros(nodes, np.int32)
    is_leaf = np.ones(nodes, bool)
    plane = np.zeros(nodes, F32)
    spine = 2 * np.arange(inner)
    is_leaf[spine] = False
    child_a[spine], child_b[spine] = spine + 1, spine + 2
    plane[spine] = np.arange(1, inner + 1, dtype=F32)
    leaves = np.append(spine + 1, 2 * inner)
    child_a[leaves] = np.arange(inner + 1)  # offset
    child_b[leaves] = 1  # count
    tree = KDTreeArrays(child_a=child_a, child_b=child_b, axis=np.zeros(nodes, np.int32),
                        plane=plane, is_leaf=is_leaf,
                        tri_indices=np.arange(inner + 1, dtype=np.int32),
                        bbox_min=np.array([-0.01, -1.0, -1.0], F32),
                        bbox_max=np.array([inner + 1.01, 2.0, 2.0], F32), max_depth=max_depth)
    return v, tree


def spine_rays(inner: int, n: int, seed: int):
    """Rays going -x from beyond the last plane (half inside the triangles'
    y, z span: a hit at the end of a full stack; half outside: every leaf
    tested, the stack popped to the bottom), and random rays."""
    r = np.random.default_rng(seed)
    o = np.empty((n, 3), F32)
    d = r.normal(size=(n, 3)).astype(F32)
    half = n // 2
    o[:half, 0] = inner + 1.005
    o[:half, 1:] = r.uniform(0.05, 0.45, (half, 2))
    o[half // 2:half, 1] += 1.0  # y beyond the triangles
    d[:half] = [-1.0, 0.0, 0.0]
    o[half:] = r.uniform([-0.01, -1.0, -1.0], [inner + 1.01, 2.0, 2.0], (n - half, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("scene", FIXTURES)
def test_cuda_tri_consts_kernel_matches_plain_version(scene):
    """The table kernel against ``tri_consts_plain`` on the card, bit for
    bit, and on no triangles; and both trees' tables, built on the card,
    equal to the plain version's records."""
    _cuda_or_skip()
    v = torch.from_numpy(_verts(scene)).cuda()
    src = v.reshape(-1, 9)
    assert torch.equal(ki.tri_consts(src).view(torch.int32),
                       tri_consts_plain(src).view(torch.int32))
    assert ki.tri_consts(src[:0]).shape == (0, 20)
    if scene in KD_ARGS:
        host = build_kd_tree(v.cpu().numpy(), *KD_ARGS[scene])
        wkd = build_wavefront_kd(host, v.cpu().numpy(), 8).to("cuda")
        want = tri_consts_plain(src).view(torch.int32)
        assert torch.equal(wkd.tri_table.view(torch.int32), want)
        assert torch.equal(host.to("cuda").tri_table(v).view(torch.int32), want)


@pytest.mark.cuda
def test_cuda_tri_consts_kernel_at_block_edges():
    """The table kernel (blocks of 128 triangles staged through shared
    memory) against ``tri_consts_plain`` bit for bit at counts about its
    block's and from a source 36 bytes off a 16-byte boundary, which it
    reads a float at a time."""
    _cuda_or_skip()
    r = np.random.default_rng(11)
    rows = torch.from_numpy(r.normal(size=(1201, 9)).astype(F32)).cuda()
    for num in (1, 127, 128, 129, 255, 1000, 1200):
        for label, src in (("aligned", rows[:num]), ("unaligned", rows[1:num + 1])):
            assert (src.data_ptr() % 16 == 0) == (label == "aligned")
            assert torch.equal(ki.tri_consts(src).view(torch.int32),
                               tri_consts_plain(src).view(torch.int32)), (num, label)


@pytest.mark.cuda
@pytest.mark.parametrize("inner,max_depth", [(20, 19), (40, 30), (63, 62), (70, 62)],
                         ids=["depth21", "depth32-overflowed", "depth64", "depth64-overflowed"])
def test_cuda_kd_kernel_at_its_stack_depths(inner, max_depth):
    """Both layouts of the KD walk kernel against their plain versions in
    (t, id, stats), on spine trees at the default depth (21 slots), at 32
    and at the largest depth the kernel admits (64, its stack's slots),
    with as many pushes as slots and with more (the chunk layout's clamped
    push, the tree layout's dropped push and clamped pop)."""
    _cuda_or_skip()
    v, host = spine_tree(inner, max_depth)
    kd = host.to("cuda")
    verts = torch.from_numpy(v).cuda()
    o, d = spine_rays(inner, 1000, seed=inner)
    act = torch.from_numpy(np.random.default_rng(5).random(o.shape[0]) > 0.1).cuda()
    for layout in ("chunk rows", "tree lists"):
        if layout == "chunk rows":
            tree = build_wavefront_kd(host, v, 8).to("cuda")
            got = ki.kd_intersect(tree, o, d, 1e-5, act, stats=True)
            want = wavefront_plain(tree, o, d, 1e-5, act, stats=True)
        else:
            got = ki.kd_intersect(kd, o, d, 1e-5, act, vertices=verts, stats=True)
            want = kd_plain(kd, verts, o, d, 1e-5, act, stats=True)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (inner, max_depth, layout)
        assert int(got[2][:, 0].max()) >= inner  # a ray stepped down the whole spine


@pytest.mark.cuda
@pytest.mark.parametrize("num_tris", [1, 127, 128, 129, 1601])
def test_cuda_brute_kernel_edges(num_tris):
    """The brute-force kernel against ``nearest_hit_brute`` on the card:
    triangle counts around its 128-triangle tile, ray counts around its
    128-ray block, a partial and an empty active mask, and exact ties (every
    triangle duplicated at a higher id: the lower id wins)."""
    _cuda_or_skip()
    soup = np.asarray(procedural.triangle_soup(num_tris, seed=num_tris).vertices, F32)
    repeat = num_tris // 4  # the last quarter repeats the first
    soup[num_tris - repeat:] = soup[:repeat]
    v = torch.from_numpy(soup).cuda()
    for n in (1, 127, 129, 777):
        o, d = (x.cuda() for x in _rays(v.cpu().numpy(), n, seed=n))
        for act in (torch.from_numpy(np.random.default_rng(n).random(n) > 0.3).cuda(),
                    torch.zeros(n, dtype=torch.bool, device="cuda"), None):
            got = ki.brute_intersect(v, o, d, 1e-5, act)
            want = nearest_hit_brute(o, d, v, 1e-5, active=act)
            torch.cuda.synchronize()
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (num_tris, n)
    ties = torch.cat([v, v])  # every t found twice, the lower id must win
    o, d = (x.cuda() for x in _rays(v.cpu().numpy(), 777, seed=1))
    got = ki.brute_intersect(ties, o, d)
    want = nearest_hit_brute(o, d, ties)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bool((got[1] < v.shape[0]).all())
