"""Port parity: a bounce's shading split in two around the NEE call.

``kernels/shade.py`` splits the bounce body of ``trace_paths`` into
``shade_bounce_plain`` (hit attributes, texture lookup, emission, the BSDF
sample, the next ray state, the shadow rays) and ``finish_bounce_plain``
(the direct light, Russian roulette); the kernels of
``csrc/shade_bounce.cu`` equal them bit for bit on the card.

Inputs are made with numpy from a seed. An edge scene covers textured and
untextured materials (uv negative, >= 1, -0.0, a tiny negative that wraps
to 1.0, and large), metal, dielectric, transparent and unset-ior surfaces,
rays inside a medium (total internal reflection), Fresnel terms of exactly
0 and 1 (ior 1 outside, total internal reflection inside) under both
``lobe_ratio_grad``, back faces, miss and inactive lanes, 0, 1 and 2
lights, and both scene layouts (``shade_table`` rows, or the per-triangle
arrays). Tolerances:

- against the JAX package (its ``hit_attributes``, ``scatter`` and
  ``sample_direct_light`` composed as its bounce body, run op by op under
  ``jax.disable_jit``, with an intersector that returns fixed hits): masks
  and ids exact; positions and directions 2e-5 absolute; throughput and
  radiance 1e-4 relative + 1e-5 absolute (``test_torch_integrator.py``'s:
  sin/cos/pow differ in the last bits between the two libraries);
- ``trace_paths`` over 1-3 bounces against the JAX package's, through the
  brute-force oracle: ``test_torch_integrator.py``'s 1e-4 relative + 1e-5
  absolute;
- the split composition against the bounce body as it was before the
  split (kept below as ``_unsplit_trace``): bit for bit.

The ``cuda`` test holds both kernels to their plain versions bit for bit
on the card (``python3 chip_smoke.py`` runs it, phase shade). This module
imports JAX only inside the tests that compare with it, so that test runs
on a machine without JAX.
"""

import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu_torch import interop
from isaklm_raytracer_tpu_torch.accel import prepare_scene
from isaklm_raytracer_tpu_torch.accel.traverse import hit_attributes, nearest_hit_brute
from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.integrator import path_trace
from isaklm_raytracer_tpu_torch.integrator.bsdf import scatter
from isaklm_raytracer_tpu_torch.integrator.nee import sample_direct_light
from isaklm_raytracer_tpu_torch.kernels import intersect as ki
from isaklm_raytracer_tpu_torch.kernels import shade
from isaklm_raytracer_tpu_torch.math import rng
from isaklm_raytracer_tpu_torch.scene import procedural
from isaklm_raytracer_tpu_torch.scene import texture as ptexture

torch.set_num_threads(1)  # the test workers share the host's cores

N = 600
ATOL, RTOL_PATH, ATOL_PATH = 2e-5, 1e-4, 1e-5
# interpolated uvs that probe torch.remainder: -0.0, a tiny negative that
# wraps to exactly 1.0 (the texel index then points one past its row, as in
# the plain version), exact integers and a large value
EDGE_UVS = ((-1e-9, -0.0), (1.0, 2.0), (1e6 + 0.25, -3.0), (-0.0, -1e-9))


def edge_scene(proc, tex, lights: int):
    """The edge scene, built with the package ``proc`` (procedural) and its
    ``tex`` (texture) module: the port's or the JAX package's."""
    r = np.random.default_rng(100 + lights)
    b = proc.SceneBuilder()
    reg = tex.TextureRegistry()
    # non-square textures: a swapped width and height shows; texture 0 lies
    # before the larger texture 1, so a texel index one past texture 0's
    # last row stays inside the atlas
    t0 = reg.add_array((np.arange(36, dtype=np.float32).reshape(3, 4, 3) / 40.0) + 0.05)
    t1 = reg.add_array(r.uniform(0.1, 1.0, (6, 5, 3)).astype(np.float32))
    mats = [
        b.add_material(albedo=(0.8, 0.7, 0.6), roughness=0.5, ior=1.0, tex_id=t0),  # F = 0
        b.add_material(albedo=(0.6, 0.6, 0.7), roughness=0.3, ior=1.45, tex_id=t1),
        b.add_material(albedo=(0.95, 0.7, 0.3), roughness=0.08, ior=0.27, extinction=2.93),
        b.add_material(albedo=(0.99, 0.99, 0.99), roughness=0.005, ior=1.5, transparent=1.0),
        b.add_material(albedo=(0.9, 0.95, 1.0), roughness=0.2, ior=2.42, transparent=1.0),
        b.add_material(albedo=(0.5, 0.5, 0.5), roughness=0.7),  # ior unset: 0
    ]
    lamps = [b.add_material(albedo=(0.5, 0.5, 0.5), emittance=(6.0, 5.0, 4.0), roughness=0.4,
                            ior=1.2, tex_id=t0),
             b.add_material(albedo=(0.2, 0.2, 0.2), emittance=(3.0, 3.0, 3.0), roughness=0.4,
                            ior=1.0)]
    for k in range(48):
        p = r.uniform(-2.0, 2.0, (3, 3)).astype(np.float32)
        geo_n = np.cross(p[1] - p[0], p[2] - p[0])
        geo_n /= np.linalg.norm(geo_n)
        normals = geo_n + r.normal(0.0, 0.35, (3, 3)) if k % 3 else None
        mat = mats[k % len(mats)]
        if k < 2 * len(EDGE_UVS):  # on texture 0 and on a material without one
            uvs = np.asarray([EDGE_UVS[k // 2]] * 3, np.float32)
            mat = mats[0] if k % 2 else mats[3]
        else:
            uvs = r.uniform(-2.5, 2.5, (3, 2)).astype(np.float32)
        n1, n2, n3 = (None, None, None) if normals is None else normals.astype(np.float32)
        b.add_triangle(p[0], p[1], p[2], mat, n1, n2, n3, uvs=uvs)
    # a closed box around the soup, so that paths bounce and find the lights
    lo, hi = -3.0, 3.0
    b.add_quad((lo, lo, lo), (hi, lo, lo), (hi, lo, hi), (lo, lo, hi), mats[0], uv=True)
    b.add_quad((lo, hi, hi), (hi, hi, hi), (hi, hi, lo), (lo, hi, lo), mats[5])
    b.add_quad((lo, lo, hi), (hi, lo, hi), (hi, hi, hi), (lo, hi, hi), mats[1])
    b.add_quad((lo, lo, lo), (lo, hi, lo), (hi, hi, lo), (hi, lo, lo), mats[1])
    b.add_quad((lo, lo, lo), (lo, lo, hi), (lo, hi, hi), (lo, hi, lo), mats[5])
    b.add_quad((hi, lo, lo), (hi, hi, lo), (hi, hi, hi), (hi, lo, hi), mats[1])
    for k in range(lights):
        p = r.uniform(-1.0, 1.0, (3, 3)).astype(np.float32) + np.float32([0.0, 2.5, 0.0])
        b.add_triangle(p[0], p[1], p[2], lamps[k])
    return b.build(textures=reg.build())


def bounce_inputs(scene, seed: int, n: int = N, device="cpu") -> dict:
    """A bounce's state and its two intersector calls' fixed results: rays
    aimed at random points of random triangles (12% misses, 10% inactive),
    the shadow rays' hits on the lights, on other triangles or nothing."""
    r = np.random.default_rng(seed)
    verts = scene.vertices.cpu().numpy()
    num = verts.shape[0]
    idx = r.integers(0, num, n)
    bary = r.dirichlet((1.0, 1.0, 1.0), n)
    point = np.einsum("nk,nkc->nc", bary, verts[idx])
    d = r.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = point - r.uniform(0.3, 2.5, (n, 1)) * d
    active = r.random(n) < 0.9
    hit = (r.random(n) >= 0.12) & active
    throughput = r.uniform(0.05, 1.5, (n, 3))
    throughput[r.random(n) < 0.05] = 0.0
    radiance = r.uniform(0.0, 2.0, (n, 3))
    radiance[r.random(n) < 0.1] = -0.0
    u = r.random((9, n))
    u[:, r.random(n) < 0.03] = 0.0
    lights = scene.light_indices.cpu().numpy()
    shadow_idx = np.where(r.random(n) < 0.6, r.choice(lights, n), r.integers(0, num, n))
    shadow_hit = r.random(n) < 0.85
    f32 = np.float32

    def t(x, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(x if dtype is None else x.astype(dtype))
                                ).to(device)

    return {
        "ray_o": t(o, f32), "ray_d": t(d, f32),
        "idx": t(np.where(hit, idx, -1), np.int32), "hit": t(hit), "active": t(active),
        "throughput": t(throughput, f32), "radiance": t(radiance, f32),
        "inside": t(r.random(n) < 0.35), "prev_diffuse": t(r.random(n) < 0.5),
        "u": t(u, f32),
        "shadow_idx": t(np.where(shadow_hit, shadow_idx, -1), np.int32),
        "shadow_hit": t(shadow_hit),
    }


def port_bounce(scene, inp, lobe_ratio_grad: bool, roulette: bool,
                shade_fn=shade.shade_bounce_plain, finish_fn=shade.finish_bounce_plain):
    """(pending, the next state) of one bounce through the split."""
    pending = shade_fn(scene, inp["ray_o"], inp["ray_d"], inp["idx"], inp["hit"], inp["active"],
                       inp["throughput"], inp["radiance"], inp["inside"], inp["prev_diffuse"],
                       inp["u"], lobe_ratio_grad)
    lit = scene.has_lights
    nxt = finish_fn(scene, pending, inp["shadow_idx"] if lit else None,
                    inp["shadow_hit"] if lit else None, inp["u"][8], roulette)
    return pending, nxt


STATE = ("ray_o", "ray_d", "throughput", "radiance", "inside", "prev_diffuse", "active")


def _jax_bounce(jscene, inp, lobe_ratio_grad: bool, roulette: bool) -> dict:
    """The JAX package's bounce body on the same inputs, op by op."""
    import jax
    import jax.numpy as jnp

    from isaklm_raytracer_tpu.accel.traverse import hit_attributes as jhit_attributes
    from isaklm_raytracer_tpu.integrator.bsdf import scatter as jscatter
    from isaklm_raytracer_tpu.integrator.nee import sample_direct_light as jdirect

    j = {k: jnp.asarray(v.numpy()) for k, v in inp.items()}
    u = j["u"]

    def shadow_trace(o, d, active=None, t_max=None):
        return None, j["shadow_idx"], j["shadow_hit"]

    with jax.disable_jit():
        attrs = jhit_attributes(jscene, j["ray_o"], j["ray_d"], j["idx"], j["hit"])
        live = j["active"] & j["hit"]
        radiance = j["radiance"] + jnp.where((live & ~j["prev_diffuse"])[:, None],
                                             attrs.emittance * j["throughput"], 0.0)
        ev = jscatter(attrs, j["ray_d"], j["inside"], u[0], u[1], u[2], u[3], u[4],
                      lobe_ratio_grad=lobe_ratio_grad)
        new_t = j["throughput"] * ev.weight
        if jscene.has_lights:
            nee = live & ev.is_diffuse
            direct = jdirect(jscene, attrs.position, attrs.normal, u[5], u[6], u[7],
                             shadow_trace, active=nee)
            radiance = radiance + jnp.where(nee[:, None], direct * new_t, 0.0)
        survival = jnp.max(new_t, axis=-1)
        alive = (u[8] <= survival) | (not roulette)
        new_t = jnp.where((alive & roulette)[:, None],
                          new_t / jnp.maximum(survival, 1e-30)[:, None], new_t)
        out = {
            "ray_o": jnp.where(live[:, None], attrs.position, j["ray_o"]),
            "ray_d": jnp.where(live[:, None], ev.direction, j["ray_d"]),
            "throughput": jnp.where(live[:, None], new_t, j["throughput"]),
            "radiance": radiance,
            "inside": jnp.where(live, ev.inside_medium, j["inside"]),
            "prev_diffuse": jnp.where(live, ev.is_diffuse, j["prev_diffuse"]),
            "active": live & alive,
        }
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_scenes():
    """{lights: (the JAX package's edge scene, the port's on the CPU)}: the
    port prepares the scene (its triangle order, shading rows and light
    list), and the JAX package's ``build_scene`` takes the same leaves."""
    from isaklm_raytracer_tpu.scene import types as jtypes

    out = {}
    for lights in (0, 1, 2):
        pscene = prepare_scene(edge_scene(procedural, ptexture, lights), "cpu")
        leaves = interop.scene_to_numpy(pscene)
        jscene = jtypes.build_scene(
            leaves["vertices"], leaves["normals"], leaves["uvs"], leaves["mat_id"],
            jtypes.MaterialTable(**leaves["materials"]),
            jtypes.TextureAtlas(**leaves["textures"])).replace(
                shade_table=leaves["shade_table"])
        np.testing.assert_array_equal(np.asarray(jscene.light_indices), leaves["light_indices"])
        assert jscene.has_lights == pscene.has_lights
        out[lights] = (jscene, pscene)
    return out


def _layout(pair, table: bool):
    jscene, pscene = pair
    if table:
        return jscene, pscene
    return jscene.replace(shade_table=None), pscene.replace(shade_table=None)


@pytest.mark.parametrize("table", [True, False], ids=["table", "arrays"])
@pytest.mark.parametrize("lights,lobe_ratio_grad,roulette",
                         [(0, True, True), (1, True, False), (1, False, True), (2, True, True),
                          (2, False, False)])
def test_split_bounce_against_jax(jax_scenes, table, lights, lobe_ratio_grad, roulette):
    jscene, pscene = _layout(jax_scenes[lights], table)
    inp = bounce_inputs(pscene, seed=lights * 10 + int(table))
    want = _jax_bounce(jscene, inp, lobe_ratio_grad, roulette)
    pending, got = port_bounce(pscene, inp, lobe_ratio_grad, roulette)
    got = dict(zip(STATE, (t.numpy() for t in got)))
    live = pending.live.numpy()
    assert 0.5 < live.mean() < 0.95
    for name in ("inside", "prev_diffuse", "active"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("ray_o", "ray_d"):
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=ATOL, err_msg=name)
        np.testing.assert_array_equal(got[name][~live], inp[name].numpy()[~live])
    for name in ("throughput", "radiance"):
        np.testing.assert_allclose(got[name], want[name], rtol=RTOL_PATH, atol=ATOL_PATH,
                                   err_msg=name)
    # the cases the scene is built to reach
    inside, diffuse = inp["inside"].numpy(), got["prev_diffuse"] & live
    assert diffuse.any() and (live & (got["inside"] != inside)).any()  # refractions
    if lights:
        nee = pending.nee_mask.numpy()
        visible = nee & inp["shadow_hit"].numpy() & (
            inp["shadow_idx"].numpy() == pending.light_idx.numpy())
        assert visible.sum() > 5
        assert (got["radiance"][visible] != inp["radiance"].numpy()[visible]).any()


@pytest.mark.parametrize("bounces,table,lights", [(1, True, 2), (2, False, 1), (3, True, 1)])
def test_trace_paths_against_jax(jax_scenes, bounces, table, lights):
    import jax
    import jax.numpy as jnp

    from isaklm_raytracer_tpu.accel.traverse import nearest_hit_brute as jbrute
    from isaklm_raytracer_tpu.config import RenderConfig as JConfig
    from isaklm_raytracer_tpu.integrator.path_trace import trace_paths as jtrace

    jscene, pscene = _layout(jax_scenes[lights], table)
    r = np.random.default_rng(bounces)
    n = 256
    o = r.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ids = r.choice(4096, n, replace=False).astype(np.int32)
    key = (int(r.integers(0, 2**32)), int(r.integers(0, 2**32)))
    cfg = dict(width=64, height=64, max_bounces=bounces, ray_chunk=0, rr_start_bounce=1)
    with jax.disable_jit():
        want = jtrace(
            jscene, lambda o, d, active=None, t_max=None: jbrute(o, d, jscene.vertices,
                                                                 active=active),
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(key, jnp.uint32), jnp.asarray(ids),
            JConfig(**cfg))
    got = path_trace.trace_paths(
        pscene, lambda o, d, active=None, t_max=None: nearest_hit_brute(o, d, pscene.vertices,
                                                                        active=active),
        torch.from_numpy(o), torch.from_numpy(d), key, torch.from_numpy(ids),
        RenderConfig(**cfg))
    want = np.asarray(want)
    assert (want.max(axis=1) > 0).sum() > 5
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL_PATH, atol=ATOL_PATH)


# --- the port alone -------------------------------------------------------


def _unsplit_trace(scene, trace_fn, origins, directions, key_words, ray_ids, config):
    """``trace_paths`` as it was before the split: the bounce body of the
    JAX package, op for op."""
    num_rays = origins.shape[0]
    ray_o, ray_d = origins, directions
    throughput = torch.ones((num_rays, 3), dtype=torch.float32)
    radiance = torch.zeros((num_rays, 3), dtype=torch.float32)
    inside = torch.zeros((num_rays,), dtype=torch.bool)
    prev_diffuse = torch.zeros((num_rays,), dtype=torch.bool)
    active = torch.ones((num_rays,), dtype=torch.bool)
    for bounce in range(config.max_bounces):
        u = rng.uniforms(key_words, ray_ids, bounce, 9)
        _, idx, hit = trace_fn(ray_o, ray_d, active=active)
        attrs = hit_attributes(scene, ray_o, ray_d, idx, hit)
        live = active & hit
        emit_mask = live & (~prev_diffuse)
        radiance = radiance + torch.where(emit_mask[:, None], attrs.emittance * throughput, 0.0)
        event = scatter(attrs, ray_d, inside, u[0], u[1], u[2], u[3], u[4],
                        lobe_ratio_grad=config.lobe_ratio_grad)
        new_throughput = throughput * event.weight
        if scene.has_lights:
            nee_mask = live & event.is_diffuse
            direct = sample_direct_light(scene, attrs.position, attrs.normal, u[5], u[6], u[7],
                                         trace_fn, active=nee_mask)
            radiance = radiance + torch.where(nee_mask[:, None], direct * new_throughput, 0.0)
        survival = new_throughput.max(dim=-1).values.detach()
        if bounce >= config.rr_start_bounce:
            rr_alive = u[8] <= survival
            new_throughput = torch.where(
                rr_alive[:, None], new_throughput / torch.clamp_min(survival, 1e-30)[:, None],
                new_throughput)
        else:
            rr_alive = torch.ones_like(live)
        next_active = live & rr_alive
        ray_o = torch.where(live[:, None], attrs.position, ray_o)
        ray_d = torch.where(live[:, None], event.direction, ray_d)
        throughput = torch.where(live[:, None], new_throughput, throughput)
        inside = torch.where(live, event.inside_medium, inside)
        prev_diffuse = torch.where(live, event.is_diffuse, prev_diffuse)
        active = next_active
    return radiance


@pytest.fixture(scope="module")
def port_scenes():
    """Prepared scenes on the CPU, built by the port alone."""
    out = {f"edge{k}": prepare_scene(edge_scene(procedural, ptexture, k), "cpu")
           for k in (0, 1, 2)}
    out["demo"] = prepare_scene(procedural.material_demo_scene(textured=True), "cpu")
    return out


def _brute(scene):
    return lambda o, d, active=None, t_max=None: nearest_hit_brute(o, d, scene.vertices,
                                                                   active=active)


def _camera_rays(scene, r, n):
    v = scene.vertices.reshape(-1, 3).numpy()
    lo, hi = v.min(axis=0), v.max(axis=0)
    o = (r.random((n, 3)) * (hi - lo) + lo).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    return torch.from_numpy(o), torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("name,table,lobe_ratio_grad", [
    ("demo", True, True), ("edge2", True, False), ("edge1", False, True), ("edge2", False, False)])
def test_split_equals_unsplit_bit_for_bit(port_scenes, name, table, lobe_ratio_grad):
    scene = port_scenes[name]
    if not table:
        scene = scene.replace(shade_table=None)
    r = np.random.default_rng(7)
    o, d = _camera_rays(scene, r, 512)
    ids = torch.from_numpy(r.choice(1 << 16, 512, replace=False).astype(np.int32))
    config = RenderConfig(width=256, height=256, max_bounces=4, ray_chunk=0, rr_start_bounce=1,
                          lobe_ratio_grad=lobe_ratio_grad)
    got = path_trace.trace_paths(scene, _brute(scene), o, d, (5, 9), ids, config)
    want = _unsplit_trace(scene, _brute(scene), o, d, (5, 9), ids, config)
    assert want.abs().max() > 0.01
    assert torch.equal(_bits(got), _bits(want))


class _FakeCuda:
    """Stands for a CUDA tensor in shade_route's rule."""

    is_cuda = True

    def __init__(self, requires_grad: bool = False):
        self.requires_grad = requires_grad


@pytest.mark.parametrize("case,want", [
    ("cpu", "plain"), ("cpu, no grad", "plain"), ("cuda", "kernel"),
    ("cuda, rays require grad", "kernel"), ("cuda, rays require grad, no grad mode", "kernel"),
    ("cuda, albedo requires grad", "kernel"), ("cuda, texels require grad", "kernel")])
def test_shade_route(port_scenes, case, want):
    scene = port_scenes["demo"]
    rays = _FakeCuda(requires_grad="rays require" in case)
    if case.startswith("cpu"):
        rays = torch.zeros((4, 3), requires_grad=True)
    if "albedo" in case:
        m = scene.materials
        scene = scene.replace(materials=m.replace(albedo=m.albedo.clone().requires_grad_(True)))
    if "texels" in case:
        tex = scene.textures
        scene = scene.replace(textures=type(tex)(tex.buffer.clone().requires_grad_(True),
                                                 tex.offset, tex.width, tex.height))
    with torch.set_grad_enabled("no grad" not in case):
        assert path_trace.shade_route(scene, rays, rays) == want


@pytest.mark.parametrize("name", ["edge2", "edge0"])
def test_kernel_route_launches_each_kernel_once_a_bounce(port_scenes, monkeypatch, name):
    """The kernel route through trace_paths with the wrappers stubbed by
    their plain versions: one call of each a bounce, and the plain route's
    image."""
    scene = port_scenes[name]
    calls = {"shade": 0, "finish": 0}

    def fake_shade(*a):
        calls["shade"] += 1
        return shade.shade_bounce_plain(*a)

    def fake_finish(*a):
        calls["finish"] += 1
        return shade.finish_bounce_plain(*a)

    r = np.random.default_rng(3)
    o, d = _camera_rays(scene, r, 256)
    ids = torch.arange(256, dtype=torch.int32)
    config = RenderConfig(width=16, height=16, max_bounces=3, ray_chunk=0)
    want = path_trace.trace_paths(scene, _brute(scene), o, d, (1, 2), ids, config)
    monkeypatch.setattr(path_trace, "shade_route", lambda *a: "kernel")
    monkeypatch.setattr(shade, "shade_bounce", fake_shade)
    monkeypatch.setattr(shade, "finish_bounce", fake_finish)
    got = path_trace.trace_paths(scene, _brute(scene), o, d, (1, 2), ids, config)
    assert calls == {"shade": 3, "finish": 3}
    assert torch.equal(_bits(got), _bits(want))


def test_kernel_args_point_at_the_tensors(port_scenes):
    scene = port_scenes["edge2"]
    inp = bounce_inputs(scene, seed=1, n=64)
    reads, pending, s_args, args = shade.kernel_args(
        scene, *(inp[k] for k in ("ray_o", "ray_d", "idx", "hit", "active", "throughput",
                                  "radiance", "inside", "prev_diffuse", "u")))
    assert (args.ray_o, args.u, args.o_window) == (
        inp["ray_o"].data_ptr(), inp["u"].data_ptr(), pending.window.data_ptr())
    assert (args.num_rays, args.u_stride, args.lobe_ratio_grad) == (64, 64, 1)
    assert (s_args.table, s_args.num_lights, s_args.has_lights) == (
        scene.shade_table.data_ptr(), 2, 1)
    assert s_args.normals is None  # read only without a table
    assert len(pending.tensors()) == 13 and pending.light_idx.dtype == torch.int32
    reads, outs, s_args, fargs = shade.finish_args(scene, pending, inp["shadow_idx"],
                                                   inp["shadow_hit"], inp["u"][8], True)
    assert (fargs.idx, fargs.o_active, fargs.roulette) == (
        inp["shadow_idx"].data_ptr(), outs[2].data_ptr(), 1)


@pytest.mark.parametrize("fault", ["dtype", "shape", "device", "contiguity", "requires grad",
                                   "uniform rows", "table dtype"])
def test_kernel_args_refuse(port_scenes, fault):
    scene = port_scenes["edge1"]
    inp = bounce_inputs(scene, seed=2, n=32)
    if fault == "dtype":
        inp["ray_o"] = inp["ray_o"].double()
    elif fault == "shape":
        inp["throughput"] = inp["throughput"][:16]
    elif fault == "device":
        inp["radiance"] = torch.empty((32, 3), device="meta")
    elif fault == "contiguity":
        inp["ray_d"] = torch.zeros((3, 32)).T
    elif fault == "requires grad":
        inp["throughput"] = inp["throughput"].requires_grad_(True)
    elif fault == "uniform rows":
        inp["u"] = inp["u"][:5]
    else:
        scene = scene.replace(shade_table=scene.shade_table.double())
    with pytest.raises((TypeError, ValueError)):
        shade.kernel_args(scene, *(inp[k] for k in (
            "ray_o", "ray_d", "idx", "hit", "active", "throughput", "radiance", "inside",
            "prev_diffuse", "u")))


def test_finish_args_refuse_a_mismatched_light_state(port_scenes):
    scene = port_scenes["edge1"]
    inp = bounce_inputs(scene, seed=4, n=32)
    pending, _ = port_bounce(scene, inp, True, True)
    with pytest.raises(ValueError):  # shadow hits missing for a scene with lights
        shade.finish_args(scene, pending, None, None, inp["u"][8], True)
    with pytest.raises(TypeError):
        shade.finish_args(scene, pending, inp["shadow_idx"].long(), inp["shadow_hit"],
                          inp["u"][8], True)


def test_wrappers_raise_on_cpu_tensors(port_scenes):
    scene = port_scenes["edge1"]
    inp = bounce_inputs(scene, seed=5, n=16)
    args = [inp[k] for k in ("ray_o", "ray_d", "idx", "hit", "active", "throughput",
                             "radiance", "inside", "prev_diffuse", "u")]
    before = ki.COUNTS.snapshot()
    with pytest.raises(ValueError, match="CUDA tensors expected"):
        shade.shade_bounce(scene, *args)
    pending, _ = port_bounce(scene, inp, True, True)
    with pytest.raises(ValueError, match="CUDA tensors expected"):
        shade.finish_bounce(scene, pending, inp["shadow_idx"], inp["shadow_hit"], inp["u"][8],
                            True)
    assert ki.COUNTS.snapshot() == before  # nothing launched, no plain call on CUDA


# --- on the card ----------------------------------------------------------


def _equal_bits(label, got, want) -> None:
    for k, (g, w) in enumerate(zip(got, want)):
        if g is None and w is None:
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, f"{label}: output {k}"
        assert torch.equal(_bits(g), _bits(w)), f"{label}: output {k} differs"


def check_kernels_equal_plain(device, scenes, n: int = 2000) -> int:
    """Both kernels against their plain versions bit for bit on every
    output, over ``scenes`` ({name: prepared scene on ``device``}) in both
    layouts, both ``lobe_ratio_grad``, with and without roulette. Returns
    the cases checked."""
    cases = 0
    for name, scene in scenes.items():
        for table in (True, False):
            s = scene if table else scene.replace(shade_table=None)
            for seed, (lobe, roulette) in enumerate(((True, True), (False, False),
                                                     (True, False))):
                inp = bounce_inputs(s, seed, n, device)
                label = f"{name} {'table' if table else 'arrays'} lobe {lobe} rr {roulette}"
                plain = port_bounce(s, inp, lobe, roulette)
                kernel = port_bounce(s, inp, lobe, roulette, shade.shade_bounce,
                                     shade.finish_bounce)
                torch.cuda.synchronize()
                _equal_bits(label + " shade_bounce", kernel[0].tensors(), plain[0].tensors())
                _equal_bits(label + " finish_bounce", kernel[1], plain[1])
                cases += 1
    return cases


@pytest.mark.cuda
def test_cuda_shade_kernels_equal_plain():
    """Both kernels bit-equal to their plain versions on the edge scenes
    (0, 1 and 2 lights) and the demo, at a ray count that is not a multiple
    of the kernels' block, and on a one-ray call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    scenes = {f"edge{k}": prepare_scene(edge_scene(procedural, ptexture, k), dev)
              for k in (0, 1, 2)}
    scenes["demo"] = prepare_scene(procedural.material_demo_scene(textured=True), dev)
    before = ki.COUNTS.shade_kernel
    cases = check_kernels_equal_plain(dev, scenes, n=2001)
    assert cases == 24 and ki.COUNTS.shade_kernel - before == cases
    check_kernels_equal_plain(dev, {"edge2": scenes["edge2"]}, n=1)
