"""Port parity: a bounce's shading differentiated through its own backward.

``kernels/shade.py``'s ``BounceFunction`` runs a bounce (the two shading
kernels and the NEE intersector call between them) as one autograd node:
on CPU tensors the plain versions forward and ``bounce_backward_plain``
(autograd of the plain versions recomputed on the saved inputs) backward,
on the card the kernels of ``csrc/shade_bounce.cu`` forward and the
``bounce_backward`` kernel of ``csrc/shade_backward.cu`` backward.

Inputs are made with numpy from a seed, on ``tests/test_torch_shade.py``'s
edge scene (textured materials, metal, dielectric, transparent and
unset-ior surfaces, rays inside a medium, Fresnel terms of exactly 0 and 1,
back faces, miss and inactive lanes, 0, 1 and 2 lights, both scene
layouts). Tolerances:

- the Function on CPU tensors against autograd of the plain versions
  composed directly: bit for bit (the same ops in the same order);
- ``trace_paths`` through the Function against the JAX package's
  ``jax.grad`` (run op by op under ``jax.disable_jit``):
  ``tests/test_torch_grad.py``'s rtol 1e-4 plus atol 1e-6;
- the kernel's per-ray arithmetic (``csrc/shade_backward.cu`` built for
  the host with g++, its sums in ray order) and, on the card, the kernel
  against ``bounce_backward_plain``: the per-ray gradients within rtol
  1e-4 plus atol 1e-6 x the field's largest magnitude (the kernel applies
  the same derivative rules in another order of additions); the material
  and texel sums within rtol 1e-4 plus atol 1e-6 (the card's adds them
  with atomics); non-finite values at the same places.

The ``cuda`` test runs on the card (``python3 chip_smoke.py``, phase
shade_grad). This module imports JAX only inside the tests that compare
with it, so that test runs on a machine without JAX.
"""

import ctypes
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu_torch import interop
from isaklm_raytracer_tpu_torch.accel import prepare_scene
from isaklm_raytracer_tpu_torch.camera import Camera
from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.integrator import path_trace
from isaklm_raytracer_tpu_torch.integrator.render import render_sample
from isaklm_raytracer_tpu_torch.kernels import build
from isaklm_raytracer_tpu_torch.kernels import intersect as ki
from isaklm_raytracer_tpu_torch.kernels import shade
from isaklm_raytracer_tpu_torch.scene import procedural
from isaklm_raytracer_tpu_torch.scene import texture as ptexture

# tests/ is no package: chip_smoke.py loads this module by its path
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_shade import bounce_inputs, edge_scene  # noqa: E402

torch.set_num_threads(1)  # the test workers share the host's cores

N = 600
RAY_RTOL, RAY_ATOL_SHARE = 1e-4, 1e-6  # per-ray gradients, atol x max |g|
SUM_RTOL, SUM_ATOL = 1e-4, 1e-6  # material and texel sums (chip_smoke.CARD_VS_CPU_*)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # against jax.grad (tests/test_torch_grad.py)
NAMES = ("ray_o", "ray_d", "throughput", "radiance", *shade.MATERIAL_FIELDS, "texels")
PER_RAY = NAMES[:4]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def saved_bounce(scene, inp, lobe_ratio_grad: bool, roulette: bool) -> shade.BounceSaved:
    lit = scene.has_lights
    return shade.BounceSaved(
        scene, *(inp[k] for k in ("ray_o", "ray_d", "idx", "hit", "active", "throughput",
                                  "radiance", "inside", "prev_diffuse", "u")),
        inp["shadow_idx"] if lit else None, inp["shadow_hit"] if lit else None,
        lobe_ratio_grad, roulette)


def grad_outputs(n: int, seed: int, device="cpu") -> list:
    """Gradients of a bounce's next (ray_o, ray_d, throughput, radiance)."""
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.normal(size=(n, 3)).astype(np.float32)).to(device)
            for _ in range(4)]


# the plain version's rays a call when it is the kernel's reference (see
# plain_in_slices)
PLAIN_SLICE = 4096


def plain_in_slices(saved: shade.BounceSaved, gouts, rays: int = PLAIN_SLICE) -> list:
    """``bounce_backward_plain`` over slices of ``rays`` rays: each slice's
    per-ray gradients, and the material and texel gradients summed over the
    slices in float64. A bounce's backward is a sum over its rays, so this
    is the same function; its float32 sums (index_add) drift where one term
    is added tens of thousands of times into one address (a 512x512
    wavefront's camera rays on the light: up to 7e-4 relative on the H100),
    where a slice's stay within the tolerance."""
    n = saved.ray_o.shape[0]
    if n <= rays:
        return shade.bounce_backward_plain(saved, gouts)
    parts = []
    for a in range(0, n, rays):
        cut = slice(a, min(a + rays, n))
        piece = shade.BounceSaved(**{
            f: (v[:, cut].contiguous() if f == "u" else v[cut])
            if isinstance(v, torch.Tensor) else v for f, v in vars(saved).items()})
        parts.append(shade.bounce_backward_plain(piece, [g[cut] for g in gouts]))
    return ([torch.cat([p[k] for p in parts]) for k in range(4)]
            + [sum(p[k].double() for p in parts).to(torch.float32) for k in range(4, 11)])


# A full-size wavefront's per-ray gradients (chip_smoke.py phase shade_grad)
# hold some rays whose gradient is a difference of much larger terms (the
# Cramer's-rule barycentrics of the 2M-triangle hero's small triangles at
# coordinates far larger than their size): there any float32 order of the
# operations moves the last bits by up to 1e-2 of the value, the plain
# version's as much as the kernel's (both against a float64 recomputation).
# Up to this share of a call's per-ray values may lie beyond the tolerance,
# each within ILL_CONDITIONED_RTOL of its value plus the tolerance's atol.
ILL_CONDITIONED_SHARE, ILL_CONDITIONED_RTOL = 2e-5, 2e-2


def check_backward(label: str, got, want, share: float = 0.0) -> dict:
    """``got`` (a kernel's gradients, in ``NAMES``' order) against ``want``
    (``bounce_backward_plain``'s) at the module's tolerances; up to
    ``share`` of the per-ray values may lie beyond them, each within
    ILL_CONDITIONED_RTOL. Raises on a difference. Returns {name: max |got -
    want|} over the finite values, and under "beyond" the per-ray values
    beyond the tolerances."""
    errs = {"beyond": 0}
    for name, g, w in zip(NAMES, got, want):
        g, w = g.detach().double().cpu(), w.detach().double().cpu()
        assert g.shape == w.shape, f"{label} {name}: shape {tuple(g.shape)} != {tuple(w.shape)}"
        finite = torch.isfinite(w)
        assert torch.equal(finite, torch.isfinite(g)), (
            f"{label} {name}: non-finite at {int((finite != torch.isfinite(g)).sum())} other "
            "places")
        g, w = g[finite], w[finite]
        if name in PER_RAY:
            atol = RAY_ATOL_SHARE * float(w.abs().max()) if w.numel() else 0.0
            rtol = RAY_RTOL
        else:
            atol, rtol = SUM_ATOL, SUM_RTOL
        err = (g - w).abs()
        bad = err > atol + rtol * w.abs()
        allowed = 0
        if name in PER_RAY and share:
            allowed = int(share * bad.numel())
            bad_far = err > atol + ILL_CONDITIONED_RTOL * w.abs()
            errs["beyond"] += int(bad.sum())
            if int(bad.sum()) <= allowed:
                bad = bad_far
        worst = [(float(g[k]), float(w[k])) for k in (err / (atol + rtol * w.abs())).argsort(
            descending=True)[:3].tolist()] if bad.any() else []
        assert not bad.any(), (f"{label} {name}: {int(bad.sum())} of {bad.numel()} values off "
                               f"({allowed} allowed within {ILL_CONDITIONED_RTOL:g}), max |diff| "
                               f"{float(err.max()):.3e}; the worst (kernel, plain) {worst}")
        errs[name] = float(err.max()) if err.numel() else 0.0
    return errs


# --- the Function on CPU tensors --------------------------------------------


@pytest.fixture(scope="module")
def edge_scenes():
    return {k: prepare_scene(edge_scene(procedural, ptexture, k), "cpu") for k in (0, 1, 2)}


def _leaves(scene, inp):
    """Fresh leaves of everything a bounce differentiates, and the scene
    that reads them."""
    m = scene.materials
    xs = [inp[k] for k in PER_RAY] + [getattr(m, f) for f in shade.MATERIAL_FIELDS]
    xs.append(scene.textures.buffer)
    leaves = [x.detach().clone().requires_grad_(True) for x in xs]
    s = scene.replace(materials=m.replace(**dict(zip(shade.MATERIAL_FIELDS, leaves[4:10]))),
                      textures=dataclasses.replace(scene.textures, buffer=leaves[10]))
    return s, leaves


@pytest.mark.parametrize("lights,table,lobe_ratio_grad,roulette", [
    (0, True, True, True), (0, False, False, False), (1, True, True, False),
    (1, False, False, True), (2, True, True, True), (2, False, True, False),
    (2, True, False, True)])
def test_function_equals_autograd_of_the_plain_versions(edge_scenes, lights, table,
                                                        lobe_ratio_grad, roulette):
    scene = edge_scenes[lights]
    if not table:
        scene = scene.replace(shade_table=None)
    inp = bounce_inputs(scene, seed=3 * lights + int(table))
    gouts = grad_outputs(N, seed=lights + 40)
    lit = scene.has_lights

    def shadow_trace(o, d, active=None, t_max=None):
        return None, inp["shadow_idx"], inp["shadow_hit"]

    s, leaves = _leaves(scene, inp)
    got = shade.bounce(s, shadow_trace, leaves[0], leaves[1], inp["idx"], inp["hit"],
                       inp["active"], leaves[2], leaves[3], inp["inside"], inp["prev_diffuse"],
                       inp["u"], lambda: inp["u"], lobe_ratio_grad, roulette)
    g_got = torch.autograd.grad(got[:4], leaves, gouts, allow_unused=True)

    s, leaves = _leaves(scene, inp)
    pending = shade.shade_bounce_plain(s, leaves[0], leaves[1], inp["idx"], inp["hit"],
                                       inp["active"], leaves[2], leaves[3], inp["inside"],
                                       inp["prev_diffuse"], inp["u"], lobe_ratio_grad)
    want = shade.finish_bounce_plain(s, pending, inp["shadow_idx"] if lit else None,
                                     inp["shadow_hit"] if lit else None, inp["u"][8], roulette)
    g_want = torch.autograd.grad(want[:4], leaves, gouts, allow_unused=True)

    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(_bits(a.detach()), _bits(b.detach())), f"output {k}"
    assert got[0].grad_fn is not None and not got[4].requires_grad
    for name, a, b, x in zip(NAMES, g_got, g_want, leaves):
        b = torch.zeros_like(x) if b is None else b  # transparent: only a comparison
        assert a is not None and torch.equal(_bits(a), _bits(b)), name
    assert any(float(g.abs().max()) > 0 for g in g_got[4:])


def test_function_counts_nothing_on_the_cpu(edge_scenes):
    scene = edge_scenes[1]
    inp = bounce_inputs(scene, seed=8, n=64)
    s, leaves = _leaves(scene, inp)
    before = ki.COUNTS.snapshot()
    out = shade.bounce(s, lambda o, d, active=None, t_max=None: (None, inp["shadow_idx"],
                                                                 inp["shadow_hit"]),
                       leaves[0], leaves[1], inp["idx"], inp["hit"], inp["active"], leaves[2],
                       leaves[3], inp["inside"], inp["prev_diffuse"], inp["u"], lambda: inp["u"],
                       True, True)
    torch.autograd.grad(out[3].sum(), leaves[4])
    assert ki.COUNTS.snapshot() == before


# --- trace_paths through the Function against jax.grad -----------------------


# tests/test_torch_grad.py's PARITY cases (material and camera leaves) and a
# texel case: the textured demo's atlas
GRAD_CASES = ("cornell_albedo_roughness_ior", "demo_ior_extinction", "floor_camera_pose",
              "demo_texels_albedo_emittance")


@pytest.mark.parametrize("case", GRAD_CASES)
def test_trace_paths_through_the_function_equals_jax_grad(monkeypatch, case):
    import jax
    import jax.numpy as jnp

    import test_torch_grad as tg
    from isaklm_raytracer_tpu.camera import Camera as JCamera
    from isaklm_raytracer_tpu.config import RenderConfig as JConfig
    from isaklm_raytracer_tpu.integrator.render import render_sample as jrender_sample
    from isaklm_raytracer_tpu.scene import procedural as jproc

    if case in tg.PARITY:
        scene_fn, (pos, yaw, pitch, fov), seed, cfg, leaves = tg.PARITY[case]
    else:
        scene_fn, (pos, yaw, pitch, fov), seed, cfg, leaves = (
            jproc.material_demo_scene, ((0.0, 1.2, -1.8), 0.0, 0.15, np.pi / 2), 5,
            dict(width=8, height=8, max_bounces=3), ("texels", "albedo", "emittance"))
    camera_leaves = ("position", "yaw", "pitch")
    jscene = scene_fn()
    pscene = interop.scene_from_numpy(interop.scene_to_numpy(jscene), device="cpu")
    jcam = JCamera.create(pos, yaw=yaw, pitch=pitch, fov=fov)
    pcam = Camera.create(pos, yaw=yaw, pitch=pitch, fov=fov, device="cpu")

    def value(owner, k):
        if k in camera_leaves:
            return getattr(jcam, k)
        if k == "texels":
            return owner.textures.buffer
        return getattr(owner.materials, k)

    x0 = [np.asarray(value(jscene, k), np.float32) for k in leaves]

    def with_leaves(scene, cam, xs):
        vals = dict(zip(leaves, xs))
        mats = {k: v for k, v in vals.items() if k in shade.MATERIAL_FIELDS}
        scene = scene.replace(materials=scene.materials.replace(**mats))
        if "texels" in vals:
            scene = scene.replace(textures=dataclasses.replace(scene.textures,
                                                               buffer=vals["texels"]))
        return scene, cam.replace(**{k: v for k, v in vals.items() if k in camera_leaves})

    def jloss(*xs):
        s, c = with_leaves(jscene, jcam, xs)
        return jnp.mean(jrender_sample(s, c, jax.random.PRNGKey(seed), JConfig(**cfg)))

    with jax.disable_jit():
        want = jax.grad(jloss, argnums=tuple(range(len(leaves))))(*map(jnp.asarray, x0))

    calls = []
    real_bounce = shade.bounce
    monkeypatch.setattr(path_trace, "shade_route", lambda *a: "kernel")
    monkeypatch.setattr(shade, "bounce", lambda *a: calls.append(1) or real_bounce(*a))
    xs = [torch.from_numpy(x.copy()).requires_grad_(True) for x in x0]
    s, c = with_leaves(pscene, pcam, xs)
    loss = render_sample(s, c, (0, seed), RenderConfig(**cfg)).mean()
    got = torch.autograd.grad(loss, xs)
    assert len(calls) == cfg["max_bounces"]  # one node a bounce
    for name, g, w in zip(leaves, got, want):
        w = np.asarray(w)
        assert torch.isfinite(g).all() and np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


# --- the route rule ---------------------------------------------------------


class _FakeCuda:
    """Stands for a CUDA tensor in shade_route's rule."""

    is_cuda = True

    def __init__(self, requires_grad: bool = False):
        self.requires_grad = requires_grad


def _leaf(t):
    return t.clone().requires_grad_(True)


@pytest.mark.parametrize("leaf,want,records", [
    ("none", "kernel", False), ("rays", "kernel", True), ("albedo", "kernel", True),
    ("emittance", "kernel", True), ("roughness", "kernel", True), ("ior", "kernel", True),
    ("extinction", "kernel", True), ("transparent", "kernel", True), ("texels", "kernel", True),
    ("vertices", "plain", None), ("normals", "plain", None), ("uvs", "plain", None),
    ("shade_table", "plain", None), ("cpu rays", "plain", None)])
def test_shade_route_differentiates_all_but_geometry(edge_scenes, caplog, leaf, want, records):
    scene = edge_scenes[2]
    rays = _FakeCuda(requires_grad=leaf == "rays")
    if leaf == "cpu rays":
        rays = torch.zeros((4, 3), requires_grad=True)
    elif leaf in shade.MATERIAL_FIELDS:
        m = scene.materials
        scene = scene.replace(materials=m.replace(**{leaf: _leaf(getattr(m, leaf))}))
    elif leaf == "texels":
        scene = scene.replace(textures=dataclasses.replace(
            scene.textures, buffer=_leaf(scene.textures.buffer)))
    elif leaf != "rays" and leaf != "none":
        scene = scene.replace(**{leaf: _leaf(getattr(scene, leaf))})
    before = ki.COUNTS.shade_geometry_grad
    path_trace._GEOMETRY_LOGGED = False
    with caplog.at_level("WARNING", logger=path_trace.__name__):
        assert path_trace.shade_route(scene, rays, rays) == want
    geometry = want == "plain" and leaf != "cpu rays"
    assert ki.COUNTS.shade_geometry_grad - before == int(geometry)
    assert ("geometry tensor requires grad" in caplog.text) == geometry
    if records is not None:
        assert path_trace.records_shading(scene, rays, rays) == records
        with torch.no_grad():  # nothing records without grad mode
            assert path_trace.shade_route(scene, rays, rays) == "kernel"
            assert not path_trace.records_shading(scene, rays, rays)


# --- the kernel's arguments -------------------------------------------------


def test_backward_args_point_at_the_tensors(edge_scenes):
    scene = edge_scenes[2]
    inp = bounce_inputs(scene, seed=1, n=64)
    saved = saved_bounce(scene, inp, True, False)
    gouts = grad_outputs(64, seed=2)
    reads, outs, s_args, args = shade.backward_args(saved, gouts)
    o, d, t, sums, tex = outs
    assert (args.ray_o, args.u, args.shadow_idx, args.g_radiance, args.o_throughput) == (
        inp["ray_o"].data_ptr(), inp["u"].data_ptr(), inp["shadow_idx"].data_ptr(),
        gouts[3].data_ptr(), t.data_ptr())
    assert (args.num_rays, args.u_stride, args.roulette, args.lobe_ratio_grad) == (64, 64, 0, 1)
    assert sums.shape == (scene.materials.albedo.shape[0], 9) and not sums.any()
    assert sums.dtype == tex.dtype == torch.float64
    assert tex.shape == scene.textures.buffer.shape and args.o_texels == tex.data_ptr()
    assert s_args.has_lights == 1 and s_args.table == scene.shade_table.data_ptr()
    _, outs, _, args = shade.backward_args(saved, gouts, materials=False, texels=False)
    assert outs[3] is None and outs[4] is None and args.o_material is None and not args.o_texels
    dark = edge_scenes[0]
    inp = bounce_inputs(dark, seed=1, n=16)
    _, _, s_args, args = shade.backward_args(saved_bounce(dark, inp, False, True),
                                             grad_outputs(16, seed=3))
    assert s_args.has_lights == 0 and args.shadow_idx is None and args.shadow_hit is None


@pytest.mark.parametrize("fault", ["dtype", "shape", "device", "contiguity", "uniform rows",
                                   "grad shape", "no shadow hits", "shadow hits without lights",
                                   "grad outputs missing", "requires grad under grad mode"])
def test_backward_args_refuse(edge_scenes, fault):
    scene = edge_scenes[1]
    inp = bounce_inputs(scene, seed=2, n=32)
    gouts = grad_outputs(32, seed=4)
    if fault == "dtype":
        inp["ray_d"] = inp["ray_d"].double()
    elif fault == "shape":
        inp["throughput"] = inp["throughput"][:16]
    elif fault == "device":
        inp["ray_o"] = torch.empty((32, 3), device="meta")
    elif fault == "contiguity":
        inp["ray_d"] = torch.zeros((3, 32)).T
    elif fault == "uniform rows":
        inp["u"] = inp["u"][:8]
    elif fault == "grad shape":
        gouts[1] = gouts[1][:, :2].contiguous()
    elif fault == "shadow hits without lights":
        scene = edge_scenes[0]
        inp = bounce_inputs(scene, seed=2, n=32)
    elif fault == "grad outputs missing":
        gouts = gouts[:3]
    elif fault == "requires grad under grad mode":
        inp["throughput"] = inp["throughput"].requires_grad_(True)
    saved = saved_bounce(scene, inp, True, True)
    if fault == "no shadow hits":
        saved.shadow_idx = saved.shadow_hit = None
    if fault == "shadow hits without lights":
        saved.shadow_idx, saved.shadow_hit = inp["shadow_idx"], inp["shadow_hit"]
    with pytest.raises((TypeError, ValueError)):
        shade.backward_args(saved, gouts)


def test_bounce_backward_raises_on_cpu_tensors(edge_scenes):
    scene = edge_scenes[1]
    inp = bounce_inputs(scene, seed=5, n=16)
    before = ki.COUNTS.snapshot()
    with pytest.raises(ValueError, match="CUDA tensors expected"):
        shade.bounce_backward(saved_bounce(scene, inp, True, True), grad_outputs(16, seed=5))
    assert ki.COUNTS.snapshot() == before


# --- the kernel's arithmetic, built for the host ----------------------------


@pytest.fixture(scope="module")
def host_backward(tmp_path_factory):
    """``csrc/shade_backward.cu``'s per-ray code built with g++ (its host
    entry point, ``bounce_backward_host``: the rays one after another, the
    sums in ray order), and a function that runs it on a ``BounceSaved``
    of CPU tensors as ``bounce_backward`` runs the kernel."""
    lib = tmp_path_factory.mktemp("shade_backward") / "libshade_backward_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                    "-x", "c++", str(build.CSRC / "shade_backward.cu"), "-o", str(lib)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).bounce_backward_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(saved, gouts):
        reads, (o, d, t, sums, tex), s_args, args = shade.backward_args(saved, gouts)
        assert fn(ctypes.addressof(s_args), ctypes.addressof(args)) == 0
        return [o, d, t, gouts[3], *shade.material_grads(sums, saved.scene, [True] * 6),
                tex.to(torch.float32)]

    return run


@pytest.mark.parametrize("lights,table,lobe_ratio_grad,roulette", [
    (0, True, True, True), (1, False, True, True), (1, True, False, False),
    (2, True, True, False), (2, False, False, True), ("demo", True, True, True)])
def test_host_build_of_the_kernel_equals_plain(edge_scenes, host_backward, lights, table,
                                               lobe_ratio_grad, roulette):
    if lights == "demo":
        scene = prepare_scene(procedural.material_demo_scene(textured=True), "cpu")
    else:
        scene = edge_scenes[lights]
    if not table:
        scene = scene.replace(shade_table=None)
    n = 2000 if lights == "demo" else N
    inp = bounce_inputs(scene, seed=21, n=n)
    saved = saved_bounce(scene, inp, lobe_ratio_grad, roulette)
    gouts = grad_outputs(n, seed=22)
    want = shade.bounce_backward_plain(saved, gouts)
    got = host_backward(saved, gouts)
    check_backward(f"host {lights} {table}", got, want)
    assert all(float(g.abs().max()) > 0 for g in got[:3])
    assert float(got[4].abs().max()) > 0 and float(got[10].abs().max()) > 0


def _grazing_miss_scene(device="cpu"):
    """A floor (y = 0) under a light (y = 3), both horizontal, and a miss
    lane whose direction meets their plane at a grazing 2e-20: the plain
    backward's divide by that dot product (t of triangle 0, unselected on a
    miss) carries 0 x inf = NaN into the lane's direction gradient."""
    b = procedural.SceneBuilder()
    floor = b.add_material(albedo=(0.6, 0.5, 0.4), roughness=0.7, ior=1.0)
    light = b.add_material(albedo=(0.0, 0.0, 0.0), emittance=(6.0, 6.0, 6.0), ior=1.0)
    b.add_quad((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4), floor)
    b.add_quad((-1, 3, -1), (1, 3, -1), (1, 3, 1), (-1, 3, 1), light)
    scene = prepare_scene(b.build(), device)
    inp = bounce_inputs(scene, seed=30, n=8, device=device)
    tri = scene.vertices[0].cpu().numpy()
    geo = np.cross(tri[1] - tri[0], tri[2] - tri[0])
    assert geo[0] == 0 and geo[2] == 0  # triangle 0's normal lies along y
    inp["ray_o"][0] = torch.tensor([0.0, 1.0, 0.0])
    inp["ray_d"][0] = torch.tensor([1.0, 2e-20, 0.0])
    inp["hit"][0] = False
    inp["idx"][0] = -1
    return scene, inp


def test_plain_backward_gives_nan_where_the_kernel_does_not(host_backward):
    """ROADMAP.md section C: the plain backward's NaN on an unselected
    branch, logged and not copied; the kernel's arithmetic passes the
    lane's gradients through, as the selected branch does."""
    scene, inp = _grazing_miss_scene()
    saved = saved_bounce(scene, inp, True, True)
    gouts = grad_outputs(8, seed=31)
    want = shade.bounce_backward_plain(saved, gouts)
    got = host_backward(saved, gouts)
    assert torch.isnan(want[1][0]).any()  # the plain version's direction gradient
    assert torch.equal(got[1][0], gouts[1][0]) and torch.equal(got[0][0], gouts[0][0])
    assert torch.isfinite(got[1]).all()
    rest = slice(1, None)
    check_backward("grazing miss, the other lanes",
                   [g[rest] if k < 4 else g for k, g in enumerate(got)],
                   [w[rest] if k < 4 else w for k, w in enumerate(want)])


# --- on the card ------------------------------------------------------------


def check_kernel_against_plain(device, scenes, n: int = 2001) -> int:
    """``bounce_backward`` against ``bounce_backward_plain`` on ``scenes``
    ({name: prepared scene on ``device``}) in both layouts, both
    ``lobe_ratio_grad``, with and without roulette. Returns the cases."""
    cases = 0
    for name, scene in scenes.items():
        for table in (True, False):
            s = scene if table else scene.replace(shade_table=None)
            for seed, (lobe, roulette) in enumerate(((True, True), (False, False),
                                                     (True, False))):
                inp = bounce_inputs(s, seed, n, device)
                saved = saved_bounce(s, inp, lobe, roulette)
                gouts = grad_outputs(n, seed + 50, device)
                got = shade.bounce_backward(saved, gouts)
                want = plain_in_slices(saved, gouts)
                torch.cuda.synchronize()
                check_backward(f"{name} {'table' if table else 'arrays'} lobe {lobe} rr "
                               f"{roulette}", got, want)
                cases += 1
    return cases


@pytest.mark.cuda
def test_cuda_bounce_backward_equals_plain():
    """The backward kernel against its plain version on the edge scenes (0,
    1 and 2 lights) and the demo, at a ray count that is not a multiple of
    the kernel's block, on a one-ray call, and on the grazing miss (its
    direction gradient finite where the plain version's is NaN)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    scenes = {f"edge{k}": prepare_scene(edge_scene(procedural, ptexture, k), dev)
              for k in (0, 1, 2)}
    scenes["demo"] = prepare_scene(procedural.material_demo_scene(textured=True), dev)
    before = ki.COUNTS.shade_backward_kernel
    cases = check_kernel_against_plain(dev, scenes)
    assert cases == 24 and ki.COUNTS.shade_backward_kernel - before == cases
    check_kernel_against_plain(dev, {"edge2": scenes["edge2"]}, n=1)
    scene, inp = _grazing_miss_scene(dev)
    saved = saved_bounce(scene, inp, True, True)
    gouts = grad_outputs(8, seed=31, device=dev)
    got = shade.bounce_backward(saved, gouts)
    want = shade.bounce_backward_plain(saved, gouts)
    torch.cuda.synchronize()
    assert torch.isnan(want[1][0]).any() and torch.isfinite(got[1]).all()
    assert torch.equal(got[1][0], gouts[1][0])
