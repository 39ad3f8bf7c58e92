"""Port parity: the KD tree, its chunk-row layout and both KD walks.

The port's host builders (``accel.kdtree.build_kd_tree``, numpy and
native, and ``accel.wavefront.build_wavefront_kd``) against the JAX
package's, array by array, bit for bit; the plain walks
(``wavefront_plain``, ``kd_plain``: what ``nearest_hit_wavefront`` and
``nearest_hit_kd`` run on CPU tensors) against the JAX package's
functions and against the brute-force oracle, on the same numpy rays.

Tolerance of the walks against JAX: hit masks and ids equal (an id may
differ only at a named tie: both triangles hit at the same t); t within
1e-6 relative plus 16 ulp of the plane equation's operands over |d.n|.
The JAX walks scale the normal by XLA's rsqrt, the port by 1 / sqrt
(the kernel's correctly rounded division and square root); the plane
equation n.p1 - o.n cancels for hits near the ray's origin, where one ulp
of the normal's scale becomes up to 1.8e-5 of t (measured on the
straddler fixture; 1.7e-7 with the JAX functions run op by op under a 1 /
sqrt in place of rsqrt).

The KD walk and brute-force kernels run only on the card: their tests are
marked ``cuda`` and skip without one; ``python3 chip_smoke.py`` (phase
kd) runs them there and checks the kernels at the main path's shapes.
This module imports JAX only inside the tests that compare with it, so
that the card's machine, which has no JAX, can run its ``cuda`` tests.
"""

import functools

import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu_torch import interop
from isaklm_raytracer_tpu_torch.accel import (
    KD_BUILD_LIMIT,
    build_kd_tree,
    build_wavefront_kd,
    nearest_hit_brute,
    nearest_hit_kd,
    nearest_hit_wavefront,
    prepare_scene,
)
from isaklm_raytracer_tpu_torch.accel.kd_traverse import kd_plain
from isaklm_raytracer_tpu_torch.accel.wavefront import tri_hits, wavefront_plain
from isaklm_raytracer_tpu_torch.kernels import intersect as ki
from isaklm_raytracer_tpu_torch.scene import procedural

torch.set_num_threads(1)  # the test workers share the host's cores

KD_FIELDS = ("child_a", "child_b", "axis", "plane", "is_leaf", "tri_indices", "bbox_min",
             "bbox_max")
WKD_FIELDS = ("child_a", "child_b", "axis", "plane", "is_leaf", "leaf_first", "chunk_next",
              "chunk_tri", "chunk_data", "bbox_min", "bbox_max")
SCENES = {  # as tests/test_kdtree.py, and the demo (the port's scenes equal the JAX package's)
    "cornell": lambda: procedural.cornell_box(),
    "demo": lambda: procedural.material_demo_scene(),
    "soup": lambda: procedural.triangle_soup(3000, seed=3),
    "straddler": lambda: procedural.triangle_soup(64, seed=9, extent=2.0, tri_size=1.5),
}
EXTENT = {"cornell": 0.95, "demo": 2.0, "soup": 12.0, "straddler": 3.0}
KD_ARGS = {"cornell": (8, 4), "demo": (19, 7), "soup": (19, 7), "straddler": (10, 2)}


def _verts(name) -> np.ndarray:
    return np.asarray(SCENES[name]().vertices, np.float32)


@functools.cache
def _jax_tree(name, depth, leaf):
    """The JAX package's numpy build, once per case (the straddler at depth
    19 has 1.9M nodes: seconds)."""
    from isaklm_raytracer_tpu.accel.kdtree import build_kd_tree as jax_build

    return jax_build(_verts(name), depth, leaf, use_native=False)


def _assert_same(want, got, fields):
    for f in fields:
        w, g = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
        assert w.dtype == g.dtype and w.shape == g.shape, (f, w.dtype, g.dtype, w.shape, g.shape)
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert want.max_depth == got.max_depth


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("depth_leaf", [(19, 7), (8, 4), (10, 2)])
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_build_kd_tree_matches_jax(scene, depth_leaf, native):
    """Both builders equal the JAX package's numpy builder bit for bit."""
    got = build_kd_tree(_verts(scene), *depth_leaf, use_native=native)
    _assert_same(_jax_tree(scene, *depth_leaf), got, KD_FIELDS)


@pytest.mark.parametrize("leaf_width", [8, 4])
@pytest.mark.parametrize("scene", ["cornell", "straddler", "soup"])
def test_build_wavefront_kd_matches_jax(scene, leaf_width):
    """The chunk-row layout equals the JAX package's bit for bit; at width
    4 the depth-capped leaves chain rows."""
    from isaklm_raytracer_tpu.accel.wavefront import build_wavefront_kd as jax_wbuild

    verts = _verts(scene)
    got = build_wavefront_kd(build_kd_tree(verts, *KD_ARGS[scene]), verts, leaf_width)
    want = jax_wbuild(_jax_tree(scene, *KD_ARGS[scene]), verts, leaf_width)
    _assert_same(want, got, WKD_FIELDS)
    assert got.leaf_width == want.leaf_width == leaf_width
    if leaf_width == 4:
        assert (got.chunk_next >= 0).any()  # chains occur


def _rays(name, n=512, seed=0):
    """tests/test_kdtree.py's random rays (its counts and extents, drawn
    with numpy), then the edge rays: origins on the root's splitting plane
    (either way across it), rays lying in it, origins on the padded box's
    faces with a zero direction component, and axis-aligned rays."""
    r = np.random.default_rng(seed)
    ext = EXTENT[name]
    o = r.uniform(-ext, ext, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    kd = build_kd_tree(_verts(name), *KD_ARGS[name])
    ax, plane = int(kd.axis[0]), np.float32(kd.plane[0])
    lo, hi = kd.bbox_min, kd.bbox_max
    edge_o = r.uniform(lo, hi, (24, 3)).astype(np.float32)
    edge_d = r.normal(size=(24, 3)).astype(np.float32)
    edge_o[0:12, ax] = plane  # on the splitting plane
    edge_d[8:12, ax] = 0.0  # ... and lying in it
    for k in range(3):  # on a face of the padded box, parallel to it
        edge_o[12 + 2 * k, k], edge_d[12 + 2 * k, k] = lo[k], 0.0
        edge_o[13 + 2 * k, k], edge_d[13 + 2 * k, k] = hi[k], 0.0
    edge_d[18:24] = np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1, 2]] * np.float32(
        [1, 1, 1, -1, -1, -1])[:, None]
    edge_d[:18] /= np.linalg.norm(edge_d[:18], axis=-1, keepdims=True)
    return np.concatenate([o, edge_o]), np.concatenate([d, edge_d])


def _plane_slack(verts, o, d, idx):
    """16 ulp of the larger plane-equation operand over |d.n| for the hit
    triangles, in float64: what one ulp of the normal's scale can move t by
    when n.p1 - o.n cancels."""
    tri = verts[np.maximum(idx, 0)].astype(np.float64)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    np1 = np.abs((n * tri[:, 0]).sum(-1))
    odn = np.abs((n * o).sum(-1))
    ddn = np.abs((n * d).sum(-1))
    return 16 * np.spacing(np.maximum(np1, odn).astype(np.float32)) / ddn


def _ties(verts, o, d, a, b):
    """Per ray, whether triangles a and b give the same t (the brute
    oracle's test; an id of -1 reads as triangle 0)."""
    def t_of(ids):
        p = torch.from_numpy(verts[np.maximum(ids, 0)])
        return tri_hits(torch.from_numpy(o), torch.from_numpy(d), p[:, 0], p[:, 1] - p[:, 0],
                        p[:, 2] - p[:, 0], 1e-5).numpy()

    return t_of(a) == t_of(b)


def _run_jax(walk, name, o, d, act):
    import jax.numpy as jnp

    from isaklm_raytracer_tpu.accel.kd_traverse import nearest_hit_kd as jax_kd
    from isaklm_raytracer_tpu.accel.wavefront import build_wavefront_kd as jax_wbuild
    from isaklm_raytracer_tpu.accel.wavefront import nearest_hit_wavefront as jax_wave

    verts = _verts(name)
    kd = _jax_tree(name, *KD_ARGS[name])
    if walk == "wavefront":
        out = jax_wave(jax_wbuild(kd, verts, 8), jnp.asarray(o), jnp.asarray(d),
                       active=jnp.asarray(act))
    else:
        out = jax_kd(kd, jnp.asarray(verts), jnp.asarray(o), jnp.asarray(d),
                     active=jnp.asarray(act))
    return [np.asarray(x) for x in out]


def _run_port(walk, name, o, d, act, stats=False):
    verts = _verts(name)
    kd = build_kd_tree(verts, *KD_ARGS[name]).to("cpu")
    o, d, act = (torch.from_numpy(x) for x in (o, d, act))
    if walk == "wavefront":
        return wavefront_plain(build_wavefront_kd(kd, verts, 8).to("cpu"), o, d, active=act,
                               stats=stats)
    return kd_plain(kd, torch.from_numpy(verts), o, d, active=act, stats=stats)


@pytest.mark.parametrize("walk", ["wavefront", "kd"])
@pytest.mark.parametrize("scene", ["cornell", "soup", "straddler"])
def test_plain_walk_matches_jax(scene, walk):
    verts = _verts(scene)
    o, d = _rays(scene)
    act = np.random.default_rng(1).random(o.shape[0]) > 0.2
    jt, ji, jh = _run_jax(walk, scene, o, d, act)
    pt, pi = (x.numpy() for x in _run_port(walk, scene, o, d, act))
    np.testing.assert_array_equal(pi >= 0, jh)
    differ = pi != ji
    assert _ties(verts, o, d, pi, ji)[differ].all(), np.nonzero(differ)
    assert (pi[~act] == -1).all() and np.isinf(pt[~act]).all()
    h = jh & ~differ
    slack = 1e-6 * np.abs(jt[h]) + _plane_slack(verts, o[h], d[h], ji[h])
    assert (np.abs(pt[h] - jt[h]) <= slack).all(), np.abs(pt[h] - jt[h]).max()
    edge = np.arange(o.shape[0]) >= 512
    assert not (pi >= 0)[edge][12:18].any()  # origin on a face, parallel: a miss
    assert (pi >= 0)[edge].any() and (pi >= 0).sum() > 50


@pytest.mark.parametrize("walk", ["wavefront", "kd"])
@pytest.mark.parametrize("scene", ["cornell", "demo", "straddler"])
def test_plain_walk_matches_brute(scene, walk):
    """The bench gate (bench.py:69-123) against the oracle: hit masks
    equal, relative t error at most 1e-3, ids differ only at ties."""
    verts = _verts(scene)
    o, d = _rays(scene, seed=2)
    act = np.ones(o.shape[0], bool)
    pt, pi, stats = (x.numpy() for x in _run_port(walk, scene, o, d, act, stats=True))
    bt, bi, bh = (x.numpy() for x in nearest_hit_brute(torch.from_numpy(o), torch.from_numpy(d),
                                                        torch.from_numpy(verts)))
    np.testing.assert_array_equal(pi >= 0, bh)
    assert (np.abs(pt[bh] - bt[bh]) / np.maximum(bt[bh], 1e-3)).max() <= 1e-3
    differ = pi != bi
    assert _ties(verts, o, d, pi, bi)[differ].all()
    assert stats[:, 0].sum() > 0 and (stats[:, 2] >= 0).all() and stats[bh, 2].min() >= 1


def test_walks_agree_with_each_other_and_through_the_interface():
    """nearest_hit_wavefront and nearest_hit_kd run the plain walks on CPU
    tensors; the two walks give the same bits here (the same test of the
    same triangles, found in the same leaf)."""
    verts = _verts("cornell")
    o, d = (torch.from_numpy(x) for x in _rays("cornell"))
    kd = build_kd_tree(verts, *KD_ARGS["cornell"]).to("cpu")
    wkd = build_wavefront_kd(kd, verts, 4).to("cpu")
    ki.COUNTS.reset()
    t_w, i_w, h_w = nearest_hit_wavefront(wkd, o, d, t_max=torch.zeros(o.shape[0]))
    t_k, i_k, h_k = nearest_hit_kd(kd, torch.from_numpy(verts), o, d)
    assert ki.COUNTS.kd_kernel == 0 and ki.COUNTS.kd_plain_cuda == 0
    assert torch.equal(t_w, t_k) and torch.equal(i_w, i_k) and torch.equal(h_w, i_w >= 0)
    assert torch.equal(h_w, torch.isfinite(t_w))


def test_make_trace_fn_order_on_the_cpu():
    """The JAX package's order: cluster tables, then wkd, then kd, then the
    brute force (brute_intersect, nearest_hit_brute on the CPU)."""
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.integrator.render import make_trace_fn, trace_name

    scene = prepare_scene(procedural.cornell_box(), "cpu", build_kd=True)
    cfg = RenderConfig(width=8, height=8)
    want = [(scene, "flat", ki.nearest_hit_flat),
            (scene.replace(cbvh=None), "wavefront kd", nearest_hit_wavefront),
            (scene.replace(cbvh=None, wkd=None), "kd", nearest_hit_kd),
            (scene.replace(cbvh=None, wkd=None, kd=None), "brute", ki.brute_intersect)]
    o, d = (torch.from_numpy(x) for x in _rays("cornell", n=64))
    ref = nearest_hit_brute(o, d, scene.vertices)
    for s, name, fn in want:
        trace = make_trace_fn(s, cfg)
        assert trace_name(s) == name and trace.func is fn
        t, idx, hit = trace(o, d)
        assert torch.equal(hit, ref[2]) and torch.equal(idx[hit], ref[1][hit])


def test_kd_render_matches_the_jax_cpu_render():
    """A 16x16 Cornell render with the cluster tables dropped goes through
    the plain wavefront walk; the JAX package's CPU render of the same
    scene takes its wavefront KD. Tolerance of tests/test_torch_render.py's
    goldens: every value within 1e-4 but at most 8, all within 3e-4."""
    from isaklm_raytracer_tpu.accel import prepare_scene as jprepare
    from isaklm_raytracer_tpu.camera import Camera as JCamera
    from isaklm_raytracer_tpu.config import RenderConfig as JConfig
    from isaklm_raytracer_tpu.integrator.render import render as jrender
    from isaklm_raytracer_tpu.integrator.render import resolve_image as jresolve
    from isaklm_raytracer_tpu.scene import procedural as jproc
    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.integrator.render import render, resolve_image

    cfg = dict(width=16, height=16, max_bounces=4, ray_chunk=0, min_samples=1)
    jscene = jprepare(jproc.cornell_box(glossy=True))
    jscene = jscene.replace(cbvh=None)
    want = np.asarray(jresolve(jrender(jscene, JCamera.create((0.0, 0.0, -0.9), fov=np.pi / 2),
                                       JConfig(**cfg), num_samples=2, seed=11), JConfig(**cfg)))
    scene = interop.scene_from_numpy(interop.scene_to_numpy(jscene), "cpu")
    assert scene.cbvh is None and scene.wkd is not None
    ki.COUNTS.reset()
    got = resolve_image(render(scene, Camera.create((0.0, 0.0, -0.9), fov=np.pi / 2, device="cpu"),
                               RenderConfig(**cfg), num_samples=2, seed=11),
                        RenderConfig(**cfg)).numpy()
    err = np.abs(got - want)
    assert np.isfinite(got).all() and (err > 1e-4).sum() <= 8, (err > 1e-4).sum()
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-4)


def test_no_kd_scene_differs_from_the_prepared_only_in_light_order():
    """The CLI's --no-kd scene (moved, not prepared) renders through the
    brute force in its own triangle and light order. With its light list
    put in prepare_scene's order, its image is the prepared scene's (NEE
    picks the same lights with the same random numbers), within
    chip_smoke.py's aggregate gate; without, it differs by sampling noise."""
    from isaklm_raytracer_tpu_torch.accel import move_scene
    from isaklm_raytracer_tpu_torch.accel.cluster import cluster_order
    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.integrator.render import render, resolve_image, trace_name

    raw = procedural.material_demo_scene()
    prepared = prepare_scene(raw, "cpu")
    order = cluster_order(np.asarray(raw.vertices))
    lights = order[prepared.light_indices.numpy()]
    assert not np.array_equal(lights, raw.light_indices)  # the demo's two lamps swap
    cfg = RenderConfig(width=16, height=16, max_bounces=3, ray_chunk=0)
    camera = Camera.create((0.0, 1.2, -1.8), pitch=0.15, fov=np.pi / 2, device="cpu")
    images = {}
    for name, scene in (("prepared", prepared), ("no-kd", move_scene(raw, "cpu")),
                        ("no-kd, prepared light order",
                         move_scene(raw.replace(light_indices=lights), "cpu"))):
        images[name] = resolve_image(render(scene, camera, cfg, num_samples=2, seed=0),
                                     cfg).numpy()
        assert trace_name(scene) == ("flat" if name == "prepared" else "brute")
    dev = {k: np.abs(v - images["prepared"]) for k, v in images.items()}
    ordered = dev["no-kd, prepared light order"]
    assert ordered.mean() < 2e-3 and (ordered.max(axis=-1) > 0.05).mean() < 0.01
    assert dev["no-kd"].mean() > 2e-3


def test_interop_carries_kd_and_wkd_both_ways():
    from isaklm_raytracer_tpu.accel.wavefront import build_wavefront_kd as jax_wbuild
    from isaklm_raytracer_tpu.scene import procedural as jproc

    verts = _verts("straddler")
    jscene = jproc.triangle_soup(64, seed=9, extent=2.0, tri_size=1.5)
    jkd = _jax_tree("straddler", 10, 2)
    jscene = jscene.replace(kd=jkd, wkd=jax_wbuild(jkd, verts, 4))
    leaves = interop.scene_to_numpy(jscene)
    port = interop.scene_from_numpy(leaves, "cpu")
    _assert_same(jscene.kd, port.kd, KD_FIELDS)
    _assert_same(jscene.wkd, port.wkd, WKD_FIELDS)
    assert port.wkd.leaf_width == 4 and isinstance(port.kd.child_a, torch.Tensor)
    back = interop.scene_to_numpy(port)
    for tree, fields in (("kd", KD_FIELDS), ("wkd", WKD_FIELDS)):
        for f in fields:
            np.testing.assert_array_equal(back[tree][f], leaves[tree][f])
    none = interop.scene_from_numpy({**leaves, "kd": None, "wkd": None}, "cpu")
    assert none.kd is None and none.wkd is None


def test_prepare_scene_builds_kd_by_the_limit(monkeypatch):
    """No KD tree by default (the port's renders take the cluster tables);
    build_kd=None, the JAX package's default, builds kd and wkd up to
    KD_BUILD_LIMIT triangles, with the JAX package's arguments
    (keyword-only after the device)."""
    import isaklm_raytracer_tpu_torch.accel as accel

    assert KD_BUILD_LIMIT == 300_000
    raw = procedural.cornell_box()
    default = prepare_scene(raw, "cpu", max_depth=6, leaf_size=3, leaf_width=4)
    assert default.kd is None and default.wkd is None
    scene = prepare_scene(raw, "cpu", max_depth=6, leaf_size=3, leaf_width=4, build_kd=None)
    assert scene.kd.max_depth == 6 and scene.wkd.leaf_width == 4
    want = build_kd_tree(scene.vertices.numpy(), 6, 3)
    _assert_same(want, scene.kd, KD_FIELDS)
    monkeypatch.setattr(accel, "KD_BUILD_LIMIT", raw.vertices.shape[0] - 1)
    skipped = prepare_scene(raw, "cpu", build_kd=None)
    assert skipped.kd is None and skipped.wkd is None
    assert prepare_scene(raw, "cpu", build_kd=True).wkd is not None
    with pytest.raises(TypeError):
        prepare_scene(raw, "cpu", 8)  # max_depth is keyword-only


def test_kd_wrappers_on_a_cuda_tensor_launch_or_raise():
    """A CUDA tensor goes to the kernel (here, with no card and no nvcc,
    the launch raises) and never to the plain version; a tree deeper than
    the kernel's stack raises before any launch."""

    class CudaLike(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    verts = _verts("cornell")
    kd = build_kd_tree(verts, *KD_ARGS["cornell"]).to("cpu")
    wkd = build_wavefront_kd(kd, verts, 8).to("cpu")
    o, d = (torch.from_numpy(x).as_subclass(CudaLike) for x in _rays("cornell", n=8))
    ki.COUNTS.reset()
    for call in (lambda: ki.kd_intersect(wkd, o, d),
                 lambda: ki.kd_intersect(kd, o, d, vertices=torch.from_numpy(verts)),
                 lambda: ki.brute_intersect(torch.from_numpy(verts), o, d)):
        with pytest.raises((RuntimeError, AssertionError)):
            call()
    assert ki.COUNTS.kd_kernel == ki.COUNTS.brute_kernel == ki.COUNTS.plain_cuda() == 0
    deep = build_wavefront_kd(kd, verts, 8).to("cpu")
    deep.max_depth = ki.KD_STACK - 1
    with pytest.raises(ValueError, match="stack"):
        ki.kd_intersect(deep, *(torch.from_numpy(x) for x in _rays("cornell", n=8)))


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("walk", ["wavefront", "kd"])
def test_cuda_kd_kernel_matches_plain_version(walk):
    """The KD walk kernel against its plain version on the card, on this
    file's random and edge rays with an active mask: (t, id, per-ray stats)
    bit for bit."""
    _cuda_or_skip()
    for scene in ("cornell", "soup", "straddler"):
        verts = _verts(scene)
        host = build_kd_tree(verts, *KD_ARGS[scene])
        kd = host.to("cuda")
        o, d = (torch.from_numpy(x).cuda() for x in _rays(scene))
        act = torch.from_numpy(np.random.default_rng(3).random(o.shape[0]) > 0.2).cuda()
        if walk == "wavefront":
            tree = build_wavefront_kd(host, verts, 4).to("cuda")
            got = ki.kd_intersect(tree, o, d, 1e-5, act, stats=True)
            want = wavefront_plain(tree, o, d, 1e-5, act, stats=True)
        else:
            v = torch.from_numpy(verts).cuda()
            got = ki.kd_intersect(kd, o, d, 1e-5, act, vertices=v, stats=True)
            want = kd_plain(kd, v, o, d, 1e-5, act, stats=True)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (scene, walk)


@pytest.mark.cuda
def test_cuda_brute_kernel_matches_nearest_hit_brute():
    _cuda_or_skip()
    for scene in ("cornell", "demo"):
        v = torch.from_numpy(_verts(scene)).cuda()
        o, d = (torch.from_numpy(x).cuda() for x in _rays(scene))
        act = torch.from_numpy(np.random.default_rng(4).random(o.shape[0]) > 0.2).cuda()
        got = ki.brute_intersect(v, o, d, 1e-5, act)
        want = nearest_hit_brute(o, d, v, 1e-5, active=act)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want)), scene
