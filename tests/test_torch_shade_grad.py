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
  the host with g++, its sums in the binning's order) and, on the card,
  the kernel against ``bounce_backward_plain``: the per-ray gradients
  within rtol 1e-4 plus atol 1e-6 x the field's largest magnitude (the
  kernel applies the same derivative rules in another order of
  additions); the material and texel sums within rtol 1e-4 plus atol 1e-6
  (the card's adds them with atomics); non-finite values at the same
  places. The host build's per-ray gradients are also held to SHA-256
  digests of the first kernel's (the one-thread-a-ray kernel in pixel
  order that the binned one replaced), bit for bit;
- the binning (``bounce_bin_host``): every ray once, in the class that
  ``chip_smoke.backward_classes`` derives from the forward and that
  ``shade.bounce_bin_plain`` gives, the dead lanes' gradients passed
  through bit for bit;
- ``float64_recheck`` (phase shade_grad's check of the per-ray values
  beyond the tolerance) on a small triangle far from the origin, where
  float32 cancels.

The ``cuda`` test runs on the card (``python3 chip_smoke.py``, phase
shade_grad). This module imports JAX only inside the tests that compare
with it, so that test runs on a machine without JAX.
"""

import ctypes
import dataclasses
import hashlib
import importlib.util
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


STATE = ("ray_o", "ray_d", "idx", "hit", "active", "throughput", "radiance", "inside",
         "prev_diffuse", "u")


@torch.no_grad()
def forward_record(scene, inp, lobe_ratio_grad: bool) -> tuple:
    """The forward's next (inside, prev_diffuse) and ray classes of a
    bounce's inputs, its shadow hits ``inp``'s: on the card the two
    kernels' (the classes they write where autograd records the bounce),
    on the CPU the plain version's flags and ``ray_classes_plain``."""
    lit = scene.has_lights
    if inp["ray_o"].is_cuda:
        pending = shade.shade_bounce(scene, *(inp[k] for k in STATE), lobe_ratio_grad,
                                     classes=True)
        shade.finish_bounce(scene, pending, inp["shadow_idx"] if lit else None,
                            inp["shadow_hit"] if lit else None, inp["u"][8], True)
        return pending.inside, pending.prev_diffuse, pending.ray_class
    pending = shade.shade_bounce_plain(scene, *(inp[k] for k in STATE), lobe_ratio_grad)
    saved = shade.BounceSaved(
        scene, *(inp[k] for k in STATE), inp["shadow_idx"] if lit else None,
        inp["shadow_hit"] if lit else None, lobe_ratio_grad, True, pending.inside,
        pending.prev_diffuse)
    return pending.inside, pending.prev_diffuse, shade.ray_classes_plain(saved)


def saved_bounce(scene, inp, lobe_ratio_grad: bool, roulette: bool,
                 record=None) -> shade.BounceSaved:
    """The saved inputs of a bounce as ``BounceFunction`` keeps them: the
    forward's next flags and ray classes (``forward_record``), computed
    unless given."""
    lit = scene.has_lights
    if record is None:
        record = forward_record(scene, inp, lobe_ratio_grad)
    return shade.BounceSaved(
        scene, *(inp[k] for k in STATE), inp["shadow_idx"] if lit else None,
        inp["shadow_hit"] if lit else None, lobe_ratio_grad, roulette, *record)


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


# A per-ray value beyond the strict tolerance (phase shade_grad) is recomputed
# in float64 (float64_recheck). Kernel and plain version round the same
# cancelling terms in float32 in another order, so each lands some ulps of
# the largest term away from the float64 value, neither always nearer: over
# a call's rechecked values of a field, the kernel's largest distance may
# be at most this many times the plain version's (plus the strict atol).
RECHECK_FACTOR = 8.0


def beyond_rays(got, want) -> torch.Tensor:
    """The rays with a per-ray gradient beyond the strict tolerance of
    ``check_backward`` (ascending ids)."""
    bad = None
    for g, w in zip(got[:3], want[:3]):
        g, w = g.detach().double().cpu(), w.detach().double().cpu()
        finite = torch.isfinite(w)
        atol = RAY_ATOL_SHARE * float(w[finite].abs().max()) if finite.any() else 0.0
        off = ((g - w).abs() > atol + RAY_RTOL * w.abs()) & finite
        bad = off.any(dim=1) if bad is None else bad | off.any(dim=1)
    return torch.nonzero(bad).flatten()


def float64_bounce(saved: shade.BounceSaved, gouts, rays: torch.Tensor):
    """(the saved inputs, the output gradients) of ``rays`` as float64 CPU
    copies, on a scene of the triangles they read (their hits and the
    lights; a shadow hit elsewhere becomes -2, which no light is) with its
    float tables in float64."""
    scene = saved.scene
    rays = rays.to(saved.ray_o.device)
    idx = saved.idx[rays]
    rows = torch.unique(torch.cat([idx.clamp_min(0), scene.light_indices.to(idx.dtype)]))

    def new_id(ids):
        at = torch.searchsorted(rows, ids).clamp_max(rows.numel() - 1)
        return torch.where(rows[at] == ids, at, torch.full_like(ids, -2)).to(torch.int32).cpu()

    def f64(t):
        return t.detach().cpu().double() if t.is_floating_point() else t.detach().cpu()

    m, tex = scene.materials, scene.textures
    small = scene.replace(
        vertices=f64(scene.vertices[rows]), normals=f64(scene.normals[rows]),
        uvs=f64(scene.uvs[rows]), mat_id=f64(scene.mat_id[rows]),
        light_indices=new_id(scene.light_indices.to(idx.dtype)),
        materials=m.replace(**{f.name: f64(getattr(m, f.name)) for f in dataclasses.fields(m)}),
        textures=dataclasses.replace(tex, **{f.name: f64(getattr(tex, f.name))
                                             for f in dataclasses.fields(tex)}),
        kd=None, wkd=None, cbvh=None,
        shade_table=None if scene.shade_table is None else f64(scene.shade_table[rows]))
    kw = {}
    for f, v in vars(saved).items():
        if f == "scene":
            v = small
        elif f == "idx":
            v = torch.where(idx < 0, idx, new_id(idx.clamp_min(0)).to(idx.device)).cpu()
        elif f == "shadow_idx" and v is not None:
            v = new_id(v[rays])
        elif isinstance(v, torch.Tensor):
            v = f64(v[:, rays] if f == "u" else v[rays])
        kw[f] = v
    return shade.BounceSaved(**kw), [f64(g[rays]) for g in gouts[:4]]


def float64_recheck(label: str, saved: shade.BounceSaved, gouts, got, want, rays) -> dict:
    """The per-ray gradients of ``rays`` recomputed in float64 (the plain
    versions on ``float64_bounce``'s copies) against the kernel's ``got``
    and the float32 plain version's ``want``: raises where, over a field's
    finite values, the kernel's largest distance from the float64 values
    exceeds RECHECK_FACTOR times the plain version's plus the strict atol.
    Returns each side's largest distance over the three per-ray fields, and
    the rays."""
    saved64, gouts64 = float64_bounce(saved, gouts, rays)
    ref = shade.bounce_backward_plain(saved64, gouts64)
    out = {"rays": int(rays.numel()), "kernel": 0.0, "plain": 0.0}
    for name, g, w, r in zip(PER_RAY, got[:3], want[:3], ref[:3]):
        cut = rays.to(g.device)
        finite = torch.isfinite(r)
        if not finite.any():
            continue
        dk = float((g[cut].detach().cpu().double() - r)[finite].abs().max())
        dp = float((w[cut].detach().cpu().double() - r)[finite].abs().max())
        atol = RAY_ATOL_SHARE * float(w.detach().double().abs().max())
        assert dk <= RECHECK_FACTOR * dp + atol, (
            f"{label} {name}: over {out['rays']} rays the kernel lies up to {dk:.3e} from the "
            f"float64 values, farther than {RECHECK_FACTOR:g}x the plain version's {dp:.3e} "
            f"plus atol {atol:.3e}")
        out["kernel"], out["plain"] = max(out["kernel"], dk), max(out["plain"], dp)
    return out


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
    assert (args.ray_o, args.u, args.shadow_idx, args.g_radiance, args.o_throughput,
            args.ray_class, args.inside) == (
        inp["ray_o"].data_ptr(), inp["u"].data_ptr(), inp["shadow_idx"].data_ptr(),
        gouts[3].data_ptr(), outs.throughput.data_ptr(), saved.ray_class.data_ptr(),
        inp["inside"].data_ptr())
    n_mat = scene.materials.albedo.shape[0]
    assert (args.num_rays, args.u_stride, args.roulette, args.lobe_ratio_grad,
            args.num_materials) == (64, 64, 0, 1, n_mat)
    sums, tex = outs.material, outs.texels
    assert sums.shape == (n_mat, 9)
    assert sums.dtype == tex.dtype == torch.float64
    assert tex.shape == scene.textures.buffer.shape and args.o_texels == tex.data_ptr()
    assert args.o_material == sums.data_ptr() == outs.sums.data_ptr()
    assert outs.sums.numel() == sums.numel() + tex.numel()  # one flat table: one conversion
    # the binning zeroes the sums and transparent's zeros (no fill of their own)
    zeroed = (args.zero, args.zero + 16 * args.zero_words)
    assert args.zero == outs.sums.data_ptr() and outs.zeros.numel() == n_mat
    assert zeroed[0] <= outs.zeros.data_ptr() and outs.zeros.data_ptr() + 4 * n_mat <= zeroed[1]
    assert outs.ray_list.shape == (len(shade.RAY_CLASSES), 64)
    assert outs.ray_list.dtype == outs.class_counts.dtype == torch.int32
    assert outs.class_counts.shape == (8,) and not outs.class_counts.any()
    assert args.counters == outs.class_counts.data_ptr()  # new zero counters by default
    counters = torch.zeros(shade.COUNTER_WORDS, dtype=torch.int32)
    _, outs, _, args = shade.backward_args(saved, gouts, counters=counters)
    assert args.counters == counters.data_ptr() == outs.class_counts.data_ptr()
    assert args.ray_list == outs.ray_list.data_ptr()
    assert s_args.has_lights == 1 and s_args.table == scene.shade_table.data_ptr()
    _, outs, _, args = shade.backward_args(saved, gouts, materials=False, texels=False)
    assert outs.material is None and outs.texels is None
    assert args.o_material is None and not args.o_texels
    assert outs.sums is None and args.zero_words == -(-4 * n_mat // 16)
    dark = edge_scenes[0]
    inp = bounce_inputs(dark, seed=1, n=16)
    _, _, s_args, args = shade.backward_args(saved_bounce(dark, inp, False, True),
                                             grad_outputs(16, seed=3))
    assert s_args.has_lights == 0 and args.shadow_idx is None and args.shadow_hit is None


@pytest.mark.parametrize("fault", ["dtype", "shape", "device", "contiguity", "uniform rows",
                                   "grad shape", "no shadow hits", "shadow hits without lights",
                                   "grad outputs missing", "requires grad under grad mode",
                                   "no next flags", "next flags' shape", "no ray classes",
                                   "ray classes' dtype"])
def test_backward_args_refuse(edge_scenes, fault):
    scene = edge_scenes[1]
    inp = bounce_inputs(scene, seed=2, n=32)
    gouts = grad_outputs(32, seed=4)
    record = forward_record(scene, inp, True)
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
    elif fault == "next flags' shape":
        record = (record[0][:16], *record[1:])
    saved = saved_bounce(scene, inp, True, True, record)
    if fault == "no next flags":
        saved.next_inside = None
    if fault == "no ray classes":
        saved.ray_class = None
    if fault == "ray classes' dtype":
        saved.ray_class = saved.ray_class.int()
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


def host_library(tmp_path_factory, source: str, names) -> dict:
    """The entry points ``names`` of ``csrc/<source>`` built for the host
    with g++ (its ``#ifndef __CUDACC__`` part), each taking two pointers."""
    stem = source.split(".")[0]
    lib = tmp_path_factory.mktemp(stem) / f"lib{stem}_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared",
                    "-x", "c++", str(build.CSRC / source), "-o", str(lib)],
                   check=True, capture_output=True)
    fns = {}
    for name in names:
        fns[name] = getattr(ctypes.CDLL(str(lib)), name)
        fns[name].argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fns[name].restype = ctypes.c_int
    return fns


@pytest.fixture(scope="module")
def host_backward(tmp_path_factory):
    """``csrc/shade_backward.cu``'s per-ray code built with g++ (its host
    entry point, ``bounce_backward_host``: the rays one after another, the
    sums in ray order), and a function that runs it on a ``BounceSaved``
    of CPU tensors as ``bounce_backward`` runs the kernel."""
    fns = host_library(tmp_path_factory, "shade_backward.cu",
                       ("bounce_backward_host", "bounce_bin_host", "bounce_counter_layout"))
    fns["bounce_counter_layout"].argtypes = [ctypes.c_void_p]

    def run(saved, gouts, counters=None):
        reads, outs, s_args, args = shade.backward_args(saved, gouts, counters=counters)
        assert fns["bounce_backward_host"](ctypes.addressof(s_args), ctypes.addressof(args)) == 0
        return [outs.ray_o, outs.ray_d, outs.throughput, gouts[3],
                *shade.material_grads(outs.material, saved.scene, [True] * 6),
                outs.texels.to(torch.float32)]

    def binning(saved, gouts, counters=None):
        """The binning alone: its ``BackwardOutputs`` (the live lanes'
        gradients left NaN)."""
        reads, outs, s_args, args = shade.backward_args(saved, gouts, counters=counters)
        for t in outs[:3]:
            t.fill_(float("nan"))
        assert fns["bounce_bin_host"](ctypes.addressof(s_args), ctypes.addressof(args)) == 0
        return outs

    run.binning = binning
    run.fns = fns
    return run


@pytest.fixture(scope="module")
def host_forward(tmp_path_factory):
    """``csrc/shade_bounce.cu``'s two kernels built with g++ (their host
    entry points: the rays one after another), and a function that runs
    them on a bounce's CPU inputs as ``shade_bounce`` and ``finish_bounce``
    run the kernels (their shadow hits ``inp``'s); returns the ``Pending``
    state and the next (throughput, radiance, active)."""
    fns = host_library(tmp_path_factory, "shade_bounce.cu",
                       ("shade_bounce_host", "finish_bounce_host"))

    def run(scene, inp, lobe_ratio_grad: bool, classes: bool):
        reads, pending, s_args, args = shade.kernel_args(
            scene, *(inp[k] for k in STATE), lobe_ratio_grad, classes)
        assert (args.o_ray_class is None) != classes
        assert fns["shade_bounce_host"](ctypes.addressof(s_args), ctypes.addressof(args)) == 0
        lit = scene.has_lights
        reads, outs, s_args, f_args = shade.finish_args(
            scene, pending, inp["shadow_idx"] if lit else None,
            inp["shadow_hit"] if lit else None, inp["u"][8], True)
        assert (f_args.o_ray_class is None) != classes
        assert fns["finish_bounce_host"](ctypes.addressof(s_args), ctypes.addressof(f_args)) == 0
        return pending, outs

    return run


# SHA-256 of the per-ray gradients (ray_o, ray_d, throughput) that the first
# kernel's host build (one thread a ray in pixel order, before the binning)
# gave on test_host_build_of_the_kernel_equals_plain's cases
HOST_DIGESTS = {
    (0, True, True, True): "03671ad914135179", (1, False, True, True): "0d8e20e4b2802753",
    (1, True, False, False): "095cd93c91e68806", (2, True, True, False): "71f2cd75240db82b",
    (2, False, False, True): "c02bf1cb6b02d28f", ("demo", True, True, True): "08dcd698f8d1f588"}


@pytest.fixture(scope="module")
def textured_demo():
    return prepare_scene(procedural.material_demo_scene(textured=True), "cpu")


@pytest.mark.parametrize("lights,table,lobe_ratio_grad,roulette", list(HOST_DIGESTS))
def test_host_build_of_the_kernel_equals_plain(edge_scenes, textured_demo, host_backward, lights,
                                               table, lobe_ratio_grad, roulette):
    """Within the tolerances of the plain version, and the per-ray
    gradients bit for bit the first kernel's."""
    scene = textured_demo if lights == "demo" else edge_scenes[lights]
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
    digest = hashlib.sha256()
    for g in got[:3]:
        digest.update(g.numpy().tobytes())
    assert digest.hexdigest()[:16] == HOST_DIGESTS[(lights, table, lobe_ratio_grad, roulette)]


def _chip_smoke():
    """chip_smoke.py of the repository's root, loaded from its file (its
    ``backward_classes``, the bound's classes)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                   "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("lights,table", [(0, True), (1, False), (2, True), ("demo", True),
                                          ("demo", False)])
def test_binning_lists_every_ray_once_in_the_bounds_class(edge_scenes, textured_demo,
                                                          host_backward, lights, table):
    scene = textured_demo if lights == "demo" else edge_scenes[lights]
    if not table:
        scene = scene.replace(shade_table=None)
    n = 2000 if lights == "demo" else N
    inp = bounce_inputs(scene, seed=23, n=n)
    saved = saved_bounce(scene, inp, True, True)
    gouts = grad_outputs(n, seed=24)
    outs = host_backward.binning(saved, gouts)
    counts = outs.class_counts.tolist()
    lists = [outs.ray_list[c, :counts[c]] for c in range(len(shade.RAY_CLASSES))]
    assert counts[len(shade.RAY_CLASSES):] == [0] * (len(counts) - len(shade.RAY_CLASSES))
    live = inp["active"] & inp["hit"]
    listed = torch.cat(lists).long()
    assert listed.numel() == int(live.sum()) and torch.unique(listed).numel() == listed.numel()
    assert bool(live[listed].all())
    with torch.no_grad():
        pending = shade.shade_bounce_plain(scene, *(inp[k] for k in STATE), True)
    bound = _chip_smoke().backward_classes(saved, pending)
    plain = shade.bounce_bin_plain(saved)
    for c, name in enumerate(shade.RAY_CLASSES):
        want = torch.nonzero(bound[name]).flatten()
        assert torch.equal(lists[c].long(), want) and torch.equal(plain[c], want), name
    dead = ~live
    for g, o in zip(gouts[:3], outs[:3]):
        assert torch.equal(_bits(o[dead]), _bits(g[dead]))
        assert torch.isnan(o[live]).all()
    assert sum(counts) > 0 and sum(c > 0 for c in counts) >= (3 if lights else 2)


def check_binning(label: str, outs, saved: shade.BounceSaved, gouts) -> list:
    """A binning's outputs against ``bounce_bin_plain``: each class's
    segment its rays (as a set: the card's blocks place their parts in the
    order of their atomics); the counts beyond the classes zero; the dead
    lanes' gradients passed through bit for bit. Returns the counts."""
    want = shade.bounce_bin_plain(saved)
    counts = outs.class_counts.tolist()
    for c, (name, w) in enumerate(zip(shade.RAY_CLASSES, want)):
        got = outs.ray_list[c, :counts[c]].long().sort().values
        assert counts[c] == w.numel() and torch.equal(got.cpu(), w.cpu()), f"{label}: {name}"
    assert not any(counts[len(shade.RAY_CLASSES):]), label
    dead = ~(saved.active & saved.hit)
    for o, g in zip(outs[:3], gouts[:3]):
        assert torch.equal(_bits(o[dead]), _bits(g[dead])), f"{label}: a dead lane's gradient"
    return counts[:len(shade.RAY_CLASSES)]


@pytest.mark.parametrize("lights,table", [(0, True), (1, False), (2, True), ("demo", True),
                                          ("demo", False)])
@pytest.mark.parametrize("lobe_ratio_grad", [True, False])
def test_forward_writes_the_ray_classes(edge_scenes, textured_demo, host_forward, lights, table,
                                        lobe_ratio_grad):
    """The forward kernels' class bytes (their host build) equal
    ``ray_classes_plain`` of the saved state their next flags give; without
    a recorded backward their pointer is null and every other output is the
    same, bit for bit."""
    scene = textured_demo if lights == "demo" else edge_scenes[lights]
    if not table:
        scene = scene.replace(shade_table=None)
    n = 2000 if lights == "demo" else N
    inp = bounce_inputs(scene, seed=25, n=n)
    pending, outs = host_forward(scene, inp, lobe_ratio_grad, True)
    lit = scene.has_lights
    saved = shade.BounceSaved(
        scene, *(inp[k] for k in STATE), inp["shadow_idx"] if lit else None,
        inp["shadow_hit"] if lit else None, lobe_ratio_grad, True, pending.inside,
        pending.prev_diffuse)
    want = shade.ray_classes_plain(saved)
    assert pending.ray_class.dtype == torch.uint8
    assert torch.equal(pending.ray_class, want)
    seen = set(torch.unique(want).tolist())
    assert shade.DEAD in seen and len(seen) >= (4 if lit else 3)
    plain_pending, plain_outs = host_forward(scene, inp, lobe_ratio_grad, False)
    assert plain_pending.ray_class is None
    for g, w in zip([*pending.tensors()[:-1], *outs], [*plain_pending.tensors(), *plain_outs]):
        assert torch.equal(_bits(g), _bits(w))


def test_counters_layout_is_the_kernels(host_backward):
    """kernels/shade.py's counter words are csrc/shade_backward.cu's."""
    layout = (ctypes.c_int32 * 3)()
    assert host_backward.fns["bounce_counter_layout"](ctypes.addressof(layout)) == 0
    assert tuple(layout) == (shade.COUNT_STRIDE, shade.DONE_WORD, shade.COUNTER_WORDS)


def test_backward_leaves_its_counters_at_zero(edge_scenes, host_backward):
    """The binning adds each class's count to the counters and the reverse
    leaves them at zero (the host build's emulation of its last block), so
    one counters tensor serves call after call with the same results; the
    binning alone leaves them counting."""
    scene = edge_scenes[2]
    inp = bounce_inputs(scene, seed=27, n=N)
    saved = saved_bounce(scene, inp, True, True)
    gouts = grad_outputs(N, seed=28)
    counters = torch.zeros(shade.COUNTER_WORDS, dtype=torch.int32)
    first = host_backward(saved, gouts, counters)
    assert not counters.any()
    again = host_backward(saved, gouts, counters)
    assert not counters.any()
    for g, w in zip(again, first):
        assert torch.equal(_bits(g), _bits(w))
    outs = host_backward.binning(saved, gouts, counters)
    want = [r.numel() for r in shade.bounce_bin_plain(saved)]
    assert outs.class_counts.tolist()[:len(want)] == want and counters.any()
    assert counters[shade.DONE_WORD] == 0 and counters.sum() == sum(want)


def _far_small_triangle_scene():
    """A 1e-3 wide triangle 1,000 units from the origin and a light above
    it: hit_geometry's barycentrics subtract coordinates near 1e3 that
    differ in their last float32 bits, so the gradients of rays hitting
    it cancel."""
    b = procedural.SceneBuilder()
    glossy = b.add_material(albedo=(0.6, 0.5, 0.4), roughness=0.3, ior=1.5)
    light = b.add_material(albedo=(0.0, 0.0, 0.0), emittance=(5.0, 5.0, 5.0), ior=1.0)
    c = np.array([1000.0, 1000.0, 1000.0])
    b.add_quad(tuple(c + (-5e-4, 0, -5e-4)), tuple(c + (5e-4, 0, -5e-4)),
               tuple(c + (5e-4, 0, 5e-4)), tuple(c + (-5e-4, 0, 5e-4)), glossy)
    b.add_quad(tuple(c + (-1, 2, -1)), tuple(c + (1, 2, -1)), tuple(c + (1, 2, 1)),
               tuple(c + (-1, 2, 1)), light)
    return prepare_scene(b.build(), "cpu")


def test_float64_recheck_on_a_small_triangle_far_from_the_origin(host_backward):
    scene = _far_small_triangle_scene()
    n = 256
    r = np.random.default_rng(41)
    inp = bounce_inputs(scene, seed=42, n=n)
    verts = scene.vertices.numpy()
    small = np.nonzero(np.abs(verts[:, :, 1] - 1000.0).max(axis=1) < 1e-2)[0]
    assert small.size == 2  # the small quad's two triangles
    tri = r.choice(small, n)
    verts = verts[tri]
    point = np.einsum("nk,nkc->nc", r.dirichlet((1.0, 1.0, 1.0), n), verts)
    d = np.stack([r.normal(0, 0.3, n), -np.ones(n), r.normal(0, 0.3, n)], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    inp["ray_o"] = torch.from_numpy((point - 0.5 * d).astype(np.float32))
    inp["ray_d"] = torch.from_numpy(d.astype(np.float32))
    inp["idx"] = torch.from_numpy(tri.astype(np.int32))
    inp["hit"] = inp["active"] = torch.ones(n, dtype=torch.bool)
    saved = saved_bounce(scene, inp, True, True)
    gouts = grad_outputs(n, seed=43)
    got = host_backward(saved, gouts)
    want = shade.bounce_backward_plain(saved, gouts)
    rays = torch.arange(n)
    out = float64_recheck("far small triangle", saved, gouts, got, want, rays)
    assert out["rays"] == n and 0.0 < out["kernel"] and 0.0 < out["plain"]
    # the case is ill-conditioned: float32 lands far from the float64 value
    saved64, gouts64 = float64_bounce(saved, gouts, rays)
    ref = shade.bounce_backward_plain(saved64, gouts64)
    rel = ((want[0].double() - ref[0]).abs() / ref[0].abs().clamp_min(1e-30)).max()
    assert float(rel) > RAY_RTOL
    assert beyond_rays(got, want).numel() <= n
    # a kernel far off the float64 values where the plain version is near them fails
    bad = [g.clone() for g in got]
    bad[0][0] = (ref[0][0] + 100.0 * (out["plain"] + 1.0)).float()
    with pytest.raises(AssertionError, match="farther"):
        float64_recheck("far small triangle, off", saved, gouts, bad, want, rays)


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
                label = f"{name} {'table' if table else 'arrays'} lobe {lobe} rr {roulette}"
                assert torch.equal(saved.ray_class, shade.ray_classes_plain(saved)), label
                check_binning(label, shade.bounce_bin(saved, gouts), saved, gouts)
                got = shade.bounce_backward(saved, gouts)
                want = plain_in_slices(saved, gouts)
                torch.cuda.synchronize()
                check_backward(label, got, want)
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
    before = (ki.COUNTS.shade_backward_kernel, ki.COUNTS.shade_bin_kernel)
    cases = check_kernel_against_plain(dev, scenes)
    assert cases == 24 and ki.COUNTS.shade_backward_kernel - before[0] == cases
    assert ki.COUNTS.shade_bin_kernel - before[1] == 2 * cases  # the binning alone, then both
    check_kernel_against_plain(dev, {"edge2": scenes["edge2"]}, n=1)
    scene, inp = _grazing_miss_scene(dev)
    saved = saved_bounce(scene, inp, True, True)
    gouts = grad_outputs(8, seed=31, device=dev)
    got = shade.bounce_backward(saved, gouts)
    want = shade.bounce_backward_plain(saved, gouts)
    torch.cuda.synchronize()
    assert torch.isnan(want[1][0]).any() and torch.isfinite(got[1]).all()
    assert torch.equal(got[1][0], gouts[1][0])


@pytest.mark.cuda
def test_cuda_forward_writes_the_ray_classes():
    """The forward kernels' class bytes (``shade_bounce`` with ``classes``,
    then ``finish_bounce``) equal ``ray_classes_plain`` of the saved state
    on the edge scenes and the demo, both layouts; without them every other
    output is the same, bit for bit; and the binning of an empty call
    zeroes the sums all the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda", 0)
    scenes = {f"edge{k}": prepare_scene(edge_scene(procedural, ptexture, k), dev)
              for k in (0, 1, 2)}
    scenes["demo"] = prepare_scene(procedural.material_demo_scene(textured=True), dev)
    for name, scene in scenes.items():
        for table in (True, False):
            s = scene if table else scene.replace(shade_table=None)
            lit = s.has_lights
            inp = bounce_inputs(s, 7, 2001, dev)
            outs = []
            for classes in (True, False):
                pending = shade.shade_bounce(s, *(inp[k] for k in STATE), True, classes=classes)
                nxt = shade.finish_bounce(s, pending, inp["shadow_idx"] if lit else None,
                                          inp["shadow_hit"] if lit else None, inp["u"][8], True)
                outs.append((pending, nxt))
            (pending, nxt), (bare, bare_nxt) = outs
            saved = saved_bounce(s, inp, True, True, (pending.inside, pending.prev_diffuse, None))
            assert bare.ray_class is None
            assert torch.equal(pending.ray_class, shade.ray_classes_plain(saved)), name
            for g, w in zip([*pending.tensors()[:-1], *nxt], [*bare.tensors(), *bare_nxt]):
                assert torch.equal(_bits(g), _bits(w)), name
    saved = saved_bounce(scenes["demo"], bounce_inputs(scenes["demo"], 8, 0, dev), True, True)
    got = shade.bounce_backward(saved, grad_outputs(0, 9, dev))
    torch.cuda.synchronize()
    assert got[10].shape == scenes["demo"].textures.buffer.shape
    assert not any(g.any() for g in got[4:11])
    assert not shade.device_counters(dev).any()  # every reverse left them at zero
