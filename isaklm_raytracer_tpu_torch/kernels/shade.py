"""A bounce's shading in two CUDA kernels around the NEE intersector call.

The JAX package runs the body of its bounce loop
(``isaklm_raytracer_tpu/integrator/path_trace.py:61-131``) as a few XLA
fusions; there is no Pallas kernel. The port splits that body at the
shadow rays' intersector call into two pure functions of tensors, the
plain versions, composed of the integrator's own functions with no change
to their arithmetic:

- ``shade_bounce_plain``, after the bounce's intersector call: the hit's
  attributes and texture lookup (``accel.traverse.hit_attributes``), the
  emitted radiance, the BSDF sample (``integrator.bsdf.scatter``), the
  next bounce's ray state and the NEE shadow rays
  (``integrator.nee.shadow_rays``), as a ``Pending`` state;
- ``finish_bounce_plain``, after the shadow rays' call: the direct light
  (``integrator.nee.direct_from_hit``) and Russian roulette, giving the
  next bounce's state.

``shade_bounce`` and ``finish_bounce`` launch the two kernels of
``csrc/shade_bounce.cu`` (one thread a ray), which equal the plain versions
bit for bit on every output.

Gradients: ``bounce`` runs a whole bounce (both halves and the NEE
intersector call between them) as one ``BounceFunction``, a node autograd
records. Its forward is the two kernels (on CPU tensors the plain
versions), which there also write each ray's class (``Pending.ray_class``:
the lobe they chose, a diffuse lobe's shadow hit); its backward is
``bounce_backward``, the kernels of ``csrc/shade_backward.cu`` (a binning
pass that sorts the live rays by that class, then one thread a ray: the
forward recomputed in registers, then its reverse), on CPU tensors
``bounce_backward_plain``
(autograd of the plain versions recomputed on the saved inputs). It
differentiates the rays, the throughput and radiance, the six float
material fields and the texel atlas; the geometry stays a constant.

``integrator.path_trace.trace_paths`` takes, for CUDA rays, the kernels
when autograd records none of the inputs, ``bounce`` when it records only
those ``bounce`` differentiates, and the plain versions when a geometry
tensor requires grad or on CPU tensors (``path_trace.shade_route``).

On CUDA tensors the wrappers launch their kernel or raise, and count in
``kernels.intersect.COUNTS`` (``shade``, ``shade_finish``,
``shade_backward`` and its binning's ``shade_bin``); on CPU tensors they
raise (the render calls the plain versions there). The plain versions
count their calls on CUDA tensors (``shade_plain_cuda``,
``shade_finish_plain_cuda``, ``shade_bin_plain_cuda``,
``shade_backward_plain_cuda``). A launch makes no host sync and no copy
from the host, so a CUDA graph capture records it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import typing
from typing import Optional

import torch

from isaklm_raytracer_tpu_torch.accel.traverse import hit_attributes
from isaklm_raytracer_tpu_torch.integrator.bsdf import scatter
from isaklm_raytracer_tpu_torch.integrator.nee import ShadowRays, direct_from_hit, shadow_rays
from isaklm_raytracer_tpu_torch.kernels import build
from isaklm_raytracer_tpu_torch.kernels.intersect import COUNTS, _launch
from isaklm_raytracer_tpu_torch.scene.types import Scene

# uniforms a bounce reads: u[0:5] the BSDF sample, u[5:8] the light pick and
# the point on the light (shade_bounce), u[8] Russian roulette (finish_bounce)
SHADE_UNIFORMS, BOUNCE_UNIFORMS = 8, 9
# the MaterialTable fields a bounce's backward differentiates (dist/sharding.py
# FLOAT_FIELDS), and the columns of each in the kernel's (M, 9) sums;
# transparent only feeds a comparison, so its gradient is zeros
MATERIAL_FIELDS = ("albedo", "emittance", "roughness", "ior", "extinction", "transparent")
_MATERIAL_COLUMNS = {"albedo": slice(0, 3), "emittance": slice(3, 6), "roughness": 6, "ior": 7,
                     "extinction": 8}


@dataclasses.dataclass
class Pending:
    """A bounce's per-ray state between its two halves.

    The next bounce's ray state (its throughput before Russian roulette);
    ``live`` = active & hit; and, where the scene has lights, the shadow
    rays from ``ray_o`` (``nee_mask`` = live & a diffuse event, the rays
    the NEE call traces) with the surface normal their cosine needs.
    """

    ray_o: torch.Tensor  # (R, 3) float32
    ray_d: torch.Tensor  # (R, 3) float32
    throughput: torch.Tensor  # (R, 3) float32
    radiance: torch.Tensor  # (R, 3) float32, the emitted radiance added
    inside: torch.Tensor  # (R,) bool
    prev_diffuse: torch.Tensor  # (R,) bool
    live: torch.Tensor  # (R,) bool
    nee_mask: Optional[torch.Tensor] = None  # (R,) bool
    shadow_dir: Optional[torch.Tensor] = None  # (R, 3) float32
    window: Optional[torch.Tensor] = None  # (R,) float32
    light_idx: Optional[torch.Tensor] = None  # (R,) int32
    dist_sq: Optional[torch.Tensor] = None  # (R,) float32
    normal: Optional[torch.Tensor] = None  # (R, 3) float32
    # (R,) uint8, each ray's class for the backward's binning (RAY_CLASSES,
    # DEAD), which the kernels write where autograd records the bounce
    ray_class: Optional[torch.Tensor] = None

    def tensors(self) -> list:
        """Every field that is set, in field order (the tensors themselves,
        not copies)."""
        return [t for t in (getattr(self, f.name) for f in dataclasses.fields(self))
                if t is not None]


def shade_bounce_plain(
    scene: Scene,
    ray_o: torch.Tensor,
    ray_d: torch.Tensor,
    idx: torch.Tensor,
    hit: torch.Tensor,
    active: torch.Tensor,
    throughput: torch.Tensor,
    radiance: torch.Tensor,
    inside: torch.Tensor,
    prev_diffuse: torch.Tensor,
    u: torch.Tensor,
    lobe_ratio_grad: bool = True,
) -> Pending:
    """The first half of a bounce, after its intersector call (idx, hit):
    emission, the scatter event, the next ray state and the shadow rays.
    ``u`` holds at least the bounce's first 8 uniform rows."""
    if ray_o.is_cuda:
        COUNTS.shade_plain_cuda += 1
    attrs = hit_attributes(scene, ray_o, ray_d, idx, hit)
    live = active & hit

    emit_mask = live & (~prev_diffuse)
    radiance = radiance + torch.where(emit_mask[:, None], attrs.emittance * throughput, 0.0)

    event = scatter(attrs, ray_d, inside, u[0], u[1], u[2], u[3], u[4],
                    lobe_ratio_grad=lobe_ratio_grad)
    new_throughput = throughput * event.weight

    on = live[:, None]
    pending = Pending(
        ray_o=torch.where(on, attrs.position, ray_o),
        ray_d=torch.where(on, event.direction, ray_d),
        throughput=torch.where(on, new_throughput, throughput),
        radiance=radiance,
        inside=torch.where(live, event.inside_medium, inside),
        prev_diffuse=torch.where(live, event.is_diffuse, prev_diffuse),
        live=live,
    )
    if scene.has_lights:
        shadow = shadow_rays(scene, pending.ray_o, u[5], u[6], u[7])
        pending.nee_mask = live & event.is_diffuse
        pending.shadow_dir = shadow.direction
        pending.window = shadow.window
        pending.light_idx = shadow.light_idx
        pending.dist_sq = shadow.dist_sq
        pending.normal = attrs.normal
    return pending


def finish_bounce_plain(
    scene: Scene,
    pending: Pending,
    idx: Optional[torch.Tensor],
    hit: Optional[torch.Tensor],
    u_rr: torch.Tensor,
    roulette: bool,
):
    """The second half of a bounce, after the shadow rays' intersector call
    (idx, hit; None where the scene has no lights): the direct light and
    Russian roulette. ``roulette`` is bounce >= rr_start_bounce. Returns
    the next (ray_o, ray_d, throughput, radiance, inside, prev_diffuse,
    active)."""
    if pending.live.is_cuda:
        COUNTS.shade_finish_plain_cuda += 1
    new_throughput = pending.throughput
    radiance = pending.radiance
    if pending.nee_mask is not None:
        shadow = ShadowRays(origin=pending.ray_o, direction=pending.shadow_dir,
                            window=pending.window, light_idx=pending.light_idx,
                            dist_sq=pending.dist_sq)
        direct = direct_from_hit(scene, shadow, pending.normal, idx, hit)
        radiance = radiance + torch.where(pending.nee_mask[:, None], direct * new_throughput,
                                          0.0)

    # Russian roulette; the reference divides by the raw max channel even
    # when it exceeds 1. Bounces below rr_start_bounce skip it.
    live = pending.live
    if roulette:
        survival = new_throughput.max(dim=-1).values.detach()
        rr_alive = u_rr <= survival
        rolled = torch.where(rr_alive[:, None],
                             new_throughput / torch.clamp_min(survival, 1e-30)[:, None],
                             new_throughput)
        throughput = torch.where(live[:, None], rolled, new_throughput)
        active = live & rr_alive
    else:
        throughput, active = new_throughput, live
    return (pending.ray_o, pending.ray_d, throughput, radiance, pending.inside,
            pending.prev_diffuse, active)


# --- the kernels' arguments (csrc/shade_bounce.cu: ShadeScene, ShadeArgs,
# FinishArgs; every pointer a device address, every field in C's order) ----

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


class ShadeSceneArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "table", "vertices", "normals", "uvs", "mat_id", "light_indices", "albedo",
        "emittance", "roughness", "ior", "extinction", "transparent", "tex_id", "texels",
        "tex_offset", "tex_width", "tex_height")] + [("num_lights", _I32), ("has_lights", _I32)]


class ShadeArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "ray_o", "ray_d", "idx", "hit", "active", "throughput", "radiance", "inside",
        "prev_diffuse", "u", "o_ray_o", "o_ray_d", "o_throughput", "o_radiance", "o_inside",
        "o_prev_diffuse", "o_live", "o_nee_mask", "o_shadow_dir", "o_window", "o_light_idx",
        "o_dist_sq", "o_normal", "o_ray_class")] + [("u_stride", _I64), ("num_rays", _I32),
                                                    ("lobe_ratio_grad", _I32)]


class FinishArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "ray_o", "throughput", "radiance", "live", "nee", "shadow_dir", "light_idx",
        "dist_sq", "normal", "idx", "hit", "u_rr", "o_throughput", "o_radiance",
        "o_active", "o_ray_class")] + [("num_rays", _I32), ("roulette", _I32)]


def _planes(device, num_rays: int, vecs: int, scalars: int, flags: int):
    """Outputs of a launch, in at most two allocations (each costs host
    time): ``vecs`` (R, 3) and ``scalars`` (R,) float32 planes of one
    buffer, ``flags`` (R,) bool planes of another; each plane contiguous."""
    floats = torch.empty(num_rays * (3 * vecs + scalars), dtype=torch.float32, device=device)
    bools = torch.empty(num_rays * flags, dtype=torch.bool, device=device) if flags else None
    n3 = 3 * num_rays
    return ([floats[k * n3:(k + 1) * n3].view(num_rays, 3) for k in range(vecs)],
            [floats[vecs * n3 + k * num_rays:vecs * n3 + (k + 1) * num_rays]
             for k in range(scalars)],
            [bools[k * num_rays:(k + 1) * num_rays] for k in range(flags)])


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: {dtype} expected, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(shape)} expected, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, the rays on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.requires_grad and torch.is_grad_enabled():
        raise ValueError(f"{name} requires grad: the kernels record no autograd graph "
                         "(shade.bounce differentiates a bounce through them)")


def scene_args(scene: Scene, device) -> tuple:
    """(the scene tensors the kernels read, their ``ShadeSceneArgs``), each
    tensor checked for dtype, shape, device and contiguity."""
    m, tex = scene.materials, scene.textures
    n_tri, n_mat, n_tex = scene.vertices.shape[0], m.albedo.shape[0], tex.offset.shape[0]
    f32, i32 = torch.float32, torch.int32
    named = [
        ("vertices", scene.vertices, f32, (n_tri, 3, 3)),
        ("light_indices", scene.light_indices, i32, (scene.num_lights,)),
        ("albedo", m.albedo, f32, (n_mat, 3)), ("emittance", m.emittance, f32, (n_mat, 3)),
        ("roughness", m.roughness, f32, (n_mat,)), ("ior", m.ior, f32, (n_mat,)),
        ("extinction", m.extinction, f32, (n_mat,)),
        ("transparent", m.transparent, f32, (n_mat,)), ("tex_id", m.tex_id, i32, (n_mat,)),
        ("texels", tex.buffer, f32, (tex.buffer.shape[0], 3)),
        ("tex_offset", tex.offset, i32, (n_tex,)), ("tex_width", tex.width, i32, (n_tex,)),
        ("tex_height", tex.height, i32, (n_tex,)),
    ]
    if scene.shade_table is not None:
        named.append(("table", scene.shade_table, f32, (scene.shade_table.shape[0], 32)))
    else:
        named += [("normals", scene.normals, f32, (n_tri, 3, 3)),
                  ("uvs", scene.uvs, f32, (n_tri, 3, 2)), ("mat_id", scene.mat_id, i32, (n_tri,))]
    if scene.num_lights < 1:
        raise ValueError("the scene needs at least one light index (build_scene gives one)")
    for name, t, dtype, shape in named:
        _check(name, t, dtype, shape, device)
    fields = {name: t.data_ptr() for name, t, _, _ in named}
    args = ShadeSceneArgs(**fields, num_lights=scene.num_lights,
                          has_lights=int(bool(scene.has_lights)))
    return [t for _, t, _, _ in named], args


def _bool_ptr(name: str, t: torch.Tensor, shape, device) -> int:
    _check(name, t, torch.bool, shape, device)
    return t.data_ptr()


def kernel_args(scene: Scene, ray_o, ray_d, idx, hit, active, throughput, radiance, inside,
                prev_diffuse, u, lobe_ratio_grad: bool = True, classes: bool = False):
    """(the tensors a launch reads, the ``Pending`` it writes, its
    ``ShadeSceneArgs`` and ``ShadeArgs``) of ``shade_bounce``: every input
    checked for dtype, shape, device and contiguity (it raises on any
    other), the outputs allocated on the rays' device. ``u`` is the
    bounce's (n >= 8, R) float32 uniforms. With ``classes`` (where autograd
    records the bounce) the kernel also writes ``Pending.ray_class``; else
    its pointer is null and nothing more is written."""
    device = ray_o.device
    num_rays = ray_o.shape[0]
    if num_rays >= 2**31:
        raise ValueError(f"{num_rays} rays exceed the kernel's int32 ray count")
    vec, one = (num_rays, 3), (num_rays,)
    for name, t in (("ray_o", ray_o), ("ray_d", ray_d), ("throughput", throughput),
                    ("radiance", radiance)):
        _check(name, t, torch.float32, vec, device)
    _check("idx", idx, torch.int32, one, device)
    flags = {name: _bool_ptr(name, t, one, device) for name, t in (
        ("hit", hit), ("active", active), ("inside", inside), ("prev_diffuse", prev_diffuse))}
    if u.dim() != 2 or u.shape[0] < SHADE_UNIFORMS:
        raise ValueError(f"u must be (n >= {SHADE_UNIFORMS}, R), got {tuple(u.shape)}")
    _check("u", u, torch.float32, (u.shape[0], num_rays), device)
    tables, s_args = scene_args(scene, device)
    lit = bool(scene.has_lights)
    # the next rays apart from the rest, which finish_bounce consumes: a
    # differentiated bounce's next node keeps them and frees the rest
    (ray_o_next, ray_d_next), _, _ = _planes(device, num_rays, 2, 0, 0)
    vecs, scalars, masks = _planes(device, num_rays, 4 if lit else 2, 3 if lit else 0,
                                   4 if lit else 3)
    pending = Pending(ray_o_next, ray_d_next, *vecs[:2], *masks[:3])
    if classes:
        pending.ray_class = torch.empty(num_rays, dtype=torch.uint8, device=device)
    if lit:
        pending.nee_mask, pending.shadow_dir, pending.normal = masks[3], vecs[2], vecs[3]
        pending.window, pending.dist_sq = scalars[0], scalars[1]
        pending.light_idx = scalars[2].view(torch.int32)
    outputs = {f"o_{f.name}": getattr(pending, f.name) for f in dataclasses.fields(pending)}
    args = ShadeArgs(
        ray_o=ray_o.data_ptr(), ray_d=ray_d.data_ptr(), idx=idx.data_ptr(),
        throughput=throughput.data_ptr(), radiance=radiance.data_ptr(), u=u.data_ptr(),
        **flags, **{k: None if t is None else t.data_ptr() for k, t in outputs.items()},
        u_stride=num_rays, num_rays=num_rays, lobe_ratio_grad=int(bool(lobe_ratio_grad)))
    reads = [ray_o, ray_d, idx, hit, active, throughput, radiance, inside, prev_diffuse, u,
             *tables]
    return reads, pending, s_args, args


def finish_args(scene: Scene, pending: Pending, idx, hit, u_rr, roulette: bool):
    """(the tensors a launch reads, the (throughput, radiance, active) it
    writes, its ``ShadeSceneArgs`` and ``FinishArgs``) of
    ``finish_bounce``, checked as ``kernel_args`` checks."""
    device = pending.ray_o.device
    num_rays = pending.ray_o.shape[0]
    vec, one = (num_rays, 3), (num_rays,)
    for name in ("ray_o", "throughput", "radiance"):
        _check(f"pending.{name}", getattr(pending, name), torch.float32, vec, device)
    _check("pending.live", pending.live, torch.bool, one, device)
    _check("u_rr", u_rr, torch.float32, one, device)
    lights = bool(scene.has_lights)
    if {lights} != {pending.nee_mask is not None, idx is not None, hit is not None}:
        raise ValueError("the shadow rays' (idx, hit) and the pending shadow state go with a "
                         "scene that has lights, and only with one")
    reads = [pending.ray_o, pending.throughput, pending.radiance, pending.live, u_rr]
    ptrs = {}
    if pending.ray_class is not None:  # shade_bounce's classes: a visible shadow hit's marked
        _check("pending.ray_class", pending.ray_class, torch.uint8, one, device)
        ptrs["o_ray_class"] = pending.ray_class.data_ptr()
    if lights:
        for name, t, dtype, shape in (
                ("nee", pending.nee_mask, torch.bool, one),
                ("shadow_dir", pending.shadow_dir, torch.float32, vec),
                ("light_idx", pending.light_idx, torch.int32, one),
                ("dist_sq", pending.dist_sq, torch.float32, one),
                ("normal", pending.normal, torch.float32, vec),
                ("idx", idx, torch.int32, one), ("hit", hit, torch.bool, one)):
            _check(name, t, dtype, shape, device)
            ptrs[name] = t.data_ptr()
            reads.append(t)
    tables, s_args = scene_args(scene, device)
    (throughput, radiance), _, (active,) = _planes(device, num_rays, 2, 0, 1)
    args = FinishArgs(
        ray_o=pending.ray_o.data_ptr(), throughput=pending.throughput.data_ptr(),
        radiance=pending.radiance.data_ptr(), live=pending.live.data_ptr(),
        u_rr=u_rr.data_ptr(), **ptrs, o_throughput=throughput.data_ptr(),
        o_radiance=radiance.data_ptr(), o_active=active.data_ptr(), num_rays=num_rays,
        roulette=int(bool(roulette)))
    return reads + tables, (throughput, radiance, active), s_args, args


def _cuda_only(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} launches a CUDA kernel: CUDA tensors expected "
                         "(trace_paths runs the plain versions on CPU tensors)")


def shade_bounce(scene: Scene, ray_o, ray_d, idx, hit, active, throughput, radiance, inside,
                 prev_diffuse, u, lobe_ratio_grad: bool = True, classes: bool = False) -> Pending:
    """``shade_bounce_plain`` by the ``shade_bounce`` kernel, bit for bit;
    CUDA tensors only. With ``classes`` it also writes
    ``Pending.ray_class`` (each ray's lobe; ``finish_bounce`` marks the
    visible shadow hits), what ``ray_classes_plain`` derives from the
    flags."""
    _cuda_only("shade_bounce", ray_o)
    # reads stay referenced until the launch: the kernel reads them
    reads, pending, s_args, args = kernel_args(
        scene, ray_o, ray_d, idx, hit, active, throughput, radiance, inside, prev_diffuse, u,
        lobe_ratio_grad, classes)
    if ray_o.shape[0]:  # an empty grid is an invalid launch
        _launch("shade_bounce", ray_o, ctypes.addressof(s_args), ctypes.addressof(args))
    return pending


def finish_bounce(scene: Scene, pending: Pending, idx, hit, u_rr, roulette: bool):
    """``finish_bounce_plain`` by the ``finish_bounce`` kernel, bit for
    bit; CUDA tensors only. Returns the next (ray_o, ray_d, throughput,
    radiance, inside, prev_diffuse, active); where ``pending.ray_class`` is
    set, marks its rays whose shadow ray hit the picked light."""
    _cuda_only("finish_bounce", pending.ray_o)
    # reads stay referenced until the launch: the kernel reads them
    reads, (throughput, radiance, active), s_args, args = finish_args(
        scene, pending, idx, hit, u_rr, roulette)
    if pending.ray_o.shape[0]:
        _launch("finish_bounce", pending.ray_o, ctypes.addressof(s_args), ctypes.addressof(args))
    return (pending.ray_o, pending.ray_d, throughput, radiance, pending.inside,
            pending.prev_diffuse, active)


# --- the backward ------------------------------------------------------------


@dataclasses.dataclass
class BounceSaved:
    """What a bounce's backward reads: the scene (its material fields and
    atlas those the forward read), the bounce's inputs, its uniforms and
    the shadow rays' hits (None where the scene has no lights)."""

    scene: Scene
    ray_o: torch.Tensor  # (R, 3) float32
    ray_d: torch.Tensor
    idx: torch.Tensor  # (R,) int32
    hit: torch.Tensor  # (R,) bool
    active: torch.Tensor
    throughput: torch.Tensor  # (R, 3) float32
    radiance: torch.Tensor
    inside: torch.Tensor  # (R,) bool
    prev_diffuse: torch.Tensor
    u: torch.Tensor  # (n >= 9, R) float32
    shadow_idx: Optional[torch.Tensor]  # (R,) int32
    shadow_hit: Optional[torch.Tensor]  # (R,) bool
    lobe_ratio_grad: bool
    roulette: bool
    # the forward's next inside and prev_diffuse (Pending's): the lobe it
    # chose, from which ray_classes_plain derives each ray's class
    next_inside: torch.Tensor  # (R,) bool
    next_diffuse: torch.Tensor
    # (R,) uint8: the classes the forward kernels wrote (Pending.ray_class),
    # by which the kernel's binning sorts the rays; None on CPU tensors
    ray_class: Optional[torch.Tensor] = None


def _differentiable(saved: BounceSaved) -> list:
    """The tensors a bounce's backward differentiates, in its order: the
    ray origin, direction, throughput and radiance, the six material fields
    and the texel atlas."""
    m = saved.scene.materials
    return [saved.ray_o, saved.ray_d, saved.throughput, saved.radiance,
            *(getattr(m, f) for f in MATERIAL_FIELDS), saved.scene.textures.buffer]


def bounce_backward_plain(saved: BounceSaved, grad_outputs, needs=None) -> list:
    """The gradients of ``_differentiable(saved)`` from those of the
    bounce's next (ray_o, ray_d, throughput, radiance): autograd of
    ``shade_bounce_plain`` and ``finish_bounce_plain`` recomputed on the
    saved inputs. ``needs`` (one flag a tensor) leaves out the gradients not
    asked for (None); a field that does not reach the outputs
    (transparent) gets zeros."""
    inputs = _differentiable(saved)
    if needs is None:
        needs = [True] * len(inputs)
    if saved.ray_o.is_cuda:
        COUNTS.shade_backward_plain_cuda += 1
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in inputs]
        ray_o, ray_d, throughput, radiance, *fields, texels = leaves
        scene = saved.scene.replace(
            materials=saved.scene.materials.replace(**dict(zip(MATERIAL_FIELDS, fields))),
            textures=dataclasses.replace(saved.scene.textures, buffer=texels))
        pending = shade_bounce_plain(scene, ray_o, ray_d, saved.idx, saved.hit, saved.active,
                                     throughput, radiance, saved.inside, saved.prev_diffuse,
                                     saved.u, saved.lobe_ratio_grad)
        out = finish_bounce_plain(scene, pending, saved.shadow_idx, saved.shadow_hit, saved.u[8],
                                  saved.roulette)
        wanted = [x for x, need in zip(leaves, needs) if need]
        got = iter(torch.autograd.grad(out[:4], wanted, grad_outputs[:4], allow_unused=True))
    grads = []
    for x, need in zip(inputs, needs):
        g = next(got) if need else None
        grads.append(torch.zeros_like(x) if need and g is None else g)
    return grads


class BackwardArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "ray_o", "ray_d", "idx", "throughput", "inside", "prev_diffuse", "u", "shadow_idx",
        "shadow_hit", "ray_class", "g_ray_o", "g_ray_d", "g_throughput", "g_radiance",
        "o_ray_o", "o_ray_d", "o_throughput", "o_material", "o_texels", "ray_list",
        "counters", "zero")] + [
        ("zero_words", _I64), ("u_stride", _I64), ("num_rays", _I32), ("num_materials", _I32),
        ("roulette", _I32), ("lobe_ratio_grad", _I32)]


# the classes the backward's binning sorts the live rays into, in the order
# of the ray list's segments (csrc/shade_common.cuh RayClass), and the dead
# rays' class
RAY_CLASSES = ("diffuse visible", "transmission", "specular", "metal", "specular inside",
               "diffuse dark")
DEAD = len(RAY_CLASSES)
# the backward's counters (csrc/shade_backward.cu kCountStride, kDoneWord,
# kCounterWords): the count of class c at word COUNT_STRIDE * c (c < 8),
# the reverse's finished blocks at DONE_WORD
COUNT_STRIDE, DONE_WORD, COUNTER_WORDS = 32, 8 * 32, 8 * 32 + 1
# each card's counters (device_counters): a graph that captured a call
# replays with them, so every call on the card shares them
_COUNTERS: dict = {}


def device_counters(device) -> torch.Tensor:
    """The counters ``bounce_backward`` hands its two kernels on ``device``:
    made zero once, by an eager call (a capture refuses to make them), and
    left at zero by every call's reverse; calls on one device run one after
    another on its streams."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    counters = _COUNTERS.get(index)
    if counters is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("bounce_backward: the first call on a card makes its counters "
                               "and runs eagerly, before any CUDA graph capture")
        counters = _COUNTERS[index] = torch.zeros(COUNTER_WORDS, dtype=torch.int32,
                                                  device=torch.device("cuda", index))
    return counters


class BackwardOutputs(typing.NamedTuple):
    """What a backward launch writes: the gradients of the bounce's ray
    origin, direction and throughput; the (M, 9) material and (P, 3) texel
    sums (float64, zeroed by the binning; None where left out), views of
    ``sums``, one flat tensor; the binning's ray list, (len(RAY_CLASSES),
    R) int32, segment c's first ``class_counts[c]`` entries the rays of
    class c; the (8,) int32 class counts, a view of the counters (until a
    reverse sets them to zero); and (M,) float32 zeros (zeroed by the
    binning), transparent's gradient."""

    ray_o: torch.Tensor
    ray_d: torch.Tensor
    throughput: torch.Tensor
    material: Optional[torch.Tensor]
    texels: Optional[torch.Tensor]
    sums: Optional[torch.Tensor]
    ray_list: torch.Tensor
    class_counts: torch.Tensor
    zeros: torch.Tensor


def _scratch(device, material_shape, texel_shape, num_materials: int) -> tuple:
    """From one buffer (one allocation, no fill): the flat float64 sums
    (None if both shapes are), the material and texel sums as views of it
    (each None where its shape is), ``num_materials`` float32 for
    transparent's zero gradient, the buffer, and its 16-byte words that the
    binning zeroes (the sums and transparent's)."""
    sizes = [0 if shape is None else math.prod(shape) for shape in (material_shape, texel_shape)]
    at = 8 * sum(sizes)
    zero_words = -(-(at + 4 * num_materials) // 16)
    buf = torch.empty(16 * zero_words, dtype=torch.uint8, device=device)
    flat = buf[:at].view(torch.float64)
    views = [None if shape is None else flat[start:start + n].view(shape)
             for shape, start, n in zip((material_shape, texel_shape), (0, sizes[0]), sizes)]
    zeros = buf[at:at + 4 * num_materials].view(torch.float32)
    return (flat if sum(sizes) else None), *views, zeros, buf, zero_words


def backward_args(saved: BounceSaved, grad_outputs, materials: bool = True,
                  texels: bool = True, counters: Optional[torch.Tensor] = None):
    """(the tensors a launch reads, the ``BackwardOutputs`` it writes, its
    ``ShadeSceneArgs`` and ``BackwardArgs``) of ``bounce_bin`` and
    ``bounce_backward``, every input checked as ``kernel_args`` checks (the
    forward's next flags, the record ``ray_classes_plain`` reads, and its
    class bytes, which the binning reads). ``grad_outputs`` are the
    gradients of the next (ray_o, ray_d, throughput, radiance), contiguous.
    The sums are float64, zeroed by the binning; ``materials`` and
    ``texels`` False leave them out (null pointers). ``counters`` (int32,
    COUNTER_WORDS, zero) are the binning's and the reverse's; by default
    new zeros."""
    device = saved.ray_o.device
    num_rays = saved.ray_o.shape[0]
    if num_rays >= 2**31:
        raise ValueError(f"{num_rays} rays exceed the kernel's int32 ray count")
    vec, one = (num_rays, 3), (num_rays,)
    for name in ("ray_o", "ray_d", "throughput"):
        _check(name, getattr(saved, name), torch.float32, vec, device)
    _check("idx", saved.idx, torch.int32, one, device)
    if saved.next_inside is None or saved.next_diffuse is None:
        raise ValueError("the forward's next inside and prev_diffuse flags expected "
                         "(BounceSaved.next_inside, next_diffuse)")
    flags = {name: _bool_ptr(name, getattr(saved, name), one, device)
             for name in ("hit", "active", "inside", "prev_diffuse", "next_inside",
                          "next_diffuse")}
    if saved.ray_class is None:
        raise ValueError("the forward's ray classes expected (BounceSaved.ray_class: "
                         "shade_bounce with classes, or ray_classes_plain)")
    _check("ray_class", saved.ray_class, torch.uint8, one, device)
    u = saved.u
    if u.dim() != 2 or u.shape[0] < BOUNCE_UNIFORMS:
        raise ValueError(f"u must be (n >= {BOUNCE_UNIFORMS}, R), got {tuple(u.shape)}")
    _check("u", u, torch.float32, (u.shape[0], num_rays), device)
    scene = saved.scene
    lights = bool(scene.has_lights)
    if {lights} != {saved.shadow_idx is not None, saved.shadow_hit is not None}:
        raise ValueError("the shadow rays' (idx, hit) go with a scene that has lights, and "
                         "only with one")
    reads = [saved.ray_o, saved.ray_d, saved.idx, saved.hit, saved.active, saved.throughput,
             saved.inside, saved.prev_diffuse, saved.next_inside, saved.next_diffuse, u]
    shadow = {"shadow_idx": None, "shadow_hit": None}
    if lights:
        _check("shadow_idx", saved.shadow_idx, torch.int32, one, device)
        shadow = {"shadow_idx": saved.shadow_idx.data_ptr(),
                  "shadow_hit": _bool_ptr("shadow_hit", saved.shadow_hit, one, device)}
        reads += [saved.shadow_idx, saved.shadow_hit]
    names = ("g_ray_o", "g_ray_d", "g_throughput", "g_radiance")
    if len(grad_outputs) < 4:
        raise ValueError("the gradients of the next ray_o, ray_d, throughput and radiance "
                         "expected")
    for name, g in zip(names, grad_outputs):
        _check(name, g, torch.float32, vec, device)
    tables, s_args = scene_args(scene, device)
    (o_ray_o, o_ray_d, o_throughput), _, _ = _planes(device, num_rays, 3, 0, 0)
    n_mat = scene.materials.albedo.shape[0]
    sums, o_material, o_texels, zeros, buf, zero_words = _scratch(
        device, (n_mat, 9) if materials else None,
        tuple(scene.textures.buffer.shape) if texels else None, n_mat)
    if counters is None:
        counters = torch.zeros(COUNTER_WORDS, dtype=torch.int32, device=device)
    _check("counters", counters, torch.int32, (COUNTER_WORDS,), device)
    ray_list = torch.empty((len(RAY_CLASSES), num_rays), dtype=torch.int32, device=device)
    outs = BackwardOutputs(o_ray_o, o_ray_d, o_throughput, o_material, o_texels, sums, ray_list,
                           counters[:DONE_WORD:COUNT_STRIDE], zeros)
    args = BackwardArgs(
        ray_o=saved.ray_o.data_ptr(), ray_d=saved.ray_d.data_ptr(), idx=saved.idx.data_ptr(),
        throughput=saved.throughput.data_ptr(), inside=flags["inside"],
        prev_diffuse=flags["prev_diffuse"], u=u.data_ptr(), **shadow,
        ray_class=saved.ray_class.data_ptr(),
        **{name: g.data_ptr() for name, g in zip(names, grad_outputs)},
        o_ray_o=o_ray_o.data_ptr(), o_ray_d=o_ray_d.data_ptr(),
        o_throughput=o_throughput.data_ptr(),
        o_material=None if o_material is None else o_material.data_ptr(),
        o_texels=None if o_texels is None else o_texels.data_ptr(),
        ray_list=ray_list.data_ptr(), counters=counters.data_ptr(), zero=buf.data_ptr(),
        zero_words=zero_words, u_stride=u.shape[1], num_rays=num_rays, num_materials=n_mat,
        roulette=int(bool(saved.roulette)), lobe_ratio_grad=int(bool(saved.lobe_ratio_grad)))
    return reads + [saved.ray_class, *grad_outputs[:4], *tables], outs, s_args, args


def material_grads(sums: Optional[torch.Tensor], scene: Scene, needs, zeros=None) -> list:
    """The six material fields' float32 gradients from the kernel's (M, 9)
    sums (None where not needed; transparent's zeros, ``zeros`` where
    given)."""
    out = []
    sums = None if sums is None else sums.to(torch.float32)
    for f, need in zip(MATERIAL_FIELDS, needs):
        if not need:
            out.append(None)
        elif f == "transparent":
            out.append(torch.zeros_like(scene.materials.transparent) if zeros is None else zeros)
        else:
            out.append(sums[:, _MATERIAL_COLUMNS[f]])
    return out


def ray_classes_plain(saved: BounceSaved) -> torch.Tensor:
    """Each ray's class (uint8: an index of RAY_CLASSES, or DEAD) in plain
    PyTorch, from the saved flags: a live lane's class is the lobe its
    forward chose (``next_diffuse``: diffuse; ``next_inside`` != ``inside``:
    transmission; a material with extinction: metal; else a specular
    reflection, from inside or not) and, for a diffuse lobe, whether its
    shadow ray hit the light it picked. What the forward kernels write
    (``shade_bounce`` with ``classes``)."""
    scene, live = saved.scene, saved.active & saved.hit
    safe = saved.idx.clamp_min(0).long()
    if scene.shade_table is not None:
        mat = scene.shade_table[safe, 24].to(torch.int32).long()
    else:
        mat = scene.mat_id[safe].long()
    diffuse = live & saved.next_diffuse
    trans = live & ~saved.next_diffuse & (saved.next_inside != saved.inside)
    metal = live & ~saved.next_diffuse & ~trans & (scene.materials.extinction[mat] > 0)
    spec = live & ~saved.next_diffuse & ~trans & ~metal
    if scene.has_lights:
        n = scene.num_lights
        pick = torch.clamp((saved.u[5] * n).to(torch.int32), 0, n - 1)
        visible = saved.shadow_hit & (saved.shadow_idx == scene.light_indices[pick.long()])
    else:
        visible = torch.zeros_like(live)
    masks = (diffuse & visible, trans, spec & ~saved.inside, metal, spec & saved.inside,
             diffuse & ~visible)
    classes = torch.full(live.shape, DEAD, dtype=torch.uint8, device=live.device)
    for c, mask in enumerate(masks):
        classes.masked_fill_(mask, c)
    return classes


def bounce_bin_plain(saved: BounceSaved) -> list:
    """The binning's classes in plain PyTorch: for each of RAY_CLASSES the
    ids of its live rays, ascending (int64), by ``ray_classes_plain``."""
    if saved.ray_o.is_cuda:
        COUNTS.shade_bin_plain_cuda += 1
    classes = ray_classes_plain(saved)
    return [torch.nonzero(classes == c).flatten() for c in range(len(RAY_CLASSES))]


def _backward_launch(names, saved: BounceSaved, grads, materials: bool, texels: bool,
                     counters=None):
    """Launch the entry points ``names`` on one ``backward_args``; returns
    its ``BackwardOutputs``."""
    # reads stay referenced until the launches: the kernels read them
    reads, outs, s_args, args = backward_args(saved, grads, materials, texels, counters)
    try:
        for name in names:  # the binning zeroes the sums even with no ray
            _launch(name, saved.ray_o, ctypes.addressof(s_args), ctypes.addressof(args))
    except RuntimeError:
        if counters is not None:  # a binning without its reverse leaves them counting
            counters.zero_()
        raise
    return outs


def bounce_bin(saved: BounceSaved, grad_outputs) -> BackwardOutputs:
    """The backward's binning alone (its kernel, ``bounce_bin``, on new
    zero counters): the ray list and class counts (each segment's order is
    the atomics' and the blocks'; ``bounce_bin_plain`` gives its rays
    ascending) and the dead lanes' gradients (the live lanes' left
    unwritten), from the classes the forward wrote (``saved.ray_class``);
    CUDA tensors only."""
    _cuda_only("bounce_bin", saved.ray_o)
    return _backward_launch(("bounce_bin",), saved, [g.contiguous() for g in grad_outputs[:4]],
                            False, False)


def bounce_backward(saved: BounceSaved, grad_outputs, needs=None) -> list:
    """``bounce_backward_plain`` by the backward's two kernels, the binning
    and the reverse (within float32 rounding: the per-ray gradients in
    another order of the same derivative rules, the material and texel
    sums by atomics); CUDA tensors only."""
    _cuda_only("bounce_backward", saved.ray_o)
    if needs is None:
        needs = [True] * 11
    grads = [g.contiguous() for g in grad_outputs[:4]]
    outs = _backward_launch(("bounce_bin", "bounce_backward"), saved, grads, any(needs[4:9]),
                            needs[10], device_counters(saved.ray_o.device))
    # both tables rounded to float32 by one conversion
    flat = None if outs.sums is None else outs.sums.to(torch.float32)
    n = 0 if outs.material is None else outs.material.numel()
    material = None if outs.material is None else flat[:n].view(outs.material.shape)
    texels = None if outs.texels is None else flat[n:].view(outs.texels.shape)
    return [outs.ray_o, outs.ray_d, outs.throughput, grads[3],
            *material_grads(material, saved.scene, needs[4:10], outs.zeros), texels]


@functools.cache
def _attributes_fn():
    fn = build.load("shade_backward.cu").bounce_backward_attributes
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def backward_attributes(device) -> dict:
    """The attributes of the backward's kernels on a card, as the card's
    runtime reports them (``bounce_backward_attributes`` of
    ``csrc/shade_backward.cu``): {kernel: {"registers", "local_bytes",
    "resident_warps", "threads"}} for ``bounce_bin_kernel`` and the reverse
    with device sums and with the shared table."""
    fn = _attributes_fn()
    out = (ctypes.c_int32 * 12)()
    err = fn(torch.device(device).index or 0, out)
    if err != 0:
        raise RuntimeError(f"bounce_backward_attributes failed: CUDA error {err}")
    keys = ("registers", "local_bytes", "resident_warps", "threads")
    return {name: dict(zip(keys, out[4 * k:4 * k + 4])) for k, name in enumerate(
        ("bounce_bin_kernel", "bounce_backward_kernel<false>", "bounce_backward_kernel<true>"))}


class BounceFunction(torch.autograd.Function):
    """One bounce as one autograd node (``bounce``): the forward kernels
    (plain versions on CPU tensors) and the NEE intersector call, the
    backward ``bounce_backward`` (``bounce_backward_plain`` on CPU
    tensors)."""

    @staticmethod
    def forward(ctx, static, ray_o, ray_d, throughput, radiance, *fields):
        scene, trace_fn, idx, hit, active, inside, prev_diffuse, u, redraw, lobe, roulette = static
        state = (ray_o, ray_d, idx, hit, active, throughput, radiance, inside, prev_diffuse, u,
                 lobe)
        if ray_o.is_cuda:  # the kernels also write the classes the binning sorts by
            pending, finish_fn = shade_bounce(scene, *state, classes=True), finish_bounce
        else:
            pending, finish_fn = shade_bounce_plain(scene, *state), finish_bounce_plain
        shadow_idx = shadow_hit = None
        if scene.has_lights:
            _, shadow_idx, shadow_hit = trace_fn(pending.ray_o, pending.shadow_dir,
                                                 active=pending.nee_mask, t_max=pending.window)
        out = finish_fn(scene, pending, shadow_idx, shadow_hit, u[BOUNCE_UNIFORMS - 1], roulette)
        # the backward draws u again (redraw) rather than keep it; the next
        # inside and prev_diffuse flags (out[4:6], the next bounce's inputs)
        # record the lobe each ray took, and on the card the kernels' class
        # bytes the class the binning sorts it by
        ctx.save_for_backward(ray_o, ray_d, idx, hit, active, throughput, radiance, inside,
                              prev_diffuse, shadow_idx, shadow_hit, *out[4:6],
                              pending.ray_class)
        ctx.scene, ctx.flags, ctx.redraw = scene, (lobe, roulette), redraw
        ctx.mark_non_differentiable(*out[4:])
        return out

    @staticmethod
    def backward(ctx, g_ray_o, g_ray_d, g_throughput, g_radiance, *_):
        *state, shadow_idx, shadow_hit, next_inside, next_diffuse, classes = ctx.saved_tensors
        saved = BounceSaved(ctx.scene, *state, ctx.redraw(), shadow_idx, shadow_hit, *ctx.flags,
                            next_inside, next_diffuse, classes)
        fn = bounce_backward if g_ray_o.is_cuda else bounce_backward_plain
        grads = fn(saved, (g_ray_o, g_ray_d, g_throughput, g_radiance), ctx.needs_input_grad[1:])
        return (None, *grads)


def bounce(scene: Scene, trace_fn, ray_o, ray_d, idx, hit, active, throughput, radiance, inside,
           prev_diffuse, u, redraw, lobe_ratio_grad: bool, roulette: bool):
    """A whole bounce after its intersector call (idx, hit) as one node
    autograd records (``BounceFunction``): ``shade_bounce``, the shadow
    rays' call ``trace_fn`` and ``finish_bounce``. Returns the next
    (ray_o, ray_d, throughput, radiance, inside, prev_diffuse, active),
    those of ``finish_bounce``; the gradients reach the rays, the
    throughput and radiance, the six float fields of ``scene.materials``
    and ``scene.textures.buffer``. ``redraw()`` returns ``u`` again (the
    sampler's draw) for the backward, so the node keeps no uniforms."""
    m = scene.materials
    static = (scene, trace_fn, idx, hit, active, inside, prev_diffuse, u, redraw,
              lobe_ratio_grad, roulette)
    return BounceFunction.apply(static, ray_o, ray_d, throughput, radiance,
                                *(getattr(m, f) for f in MATERIAL_FIELDS),
                                scene.textures.buffer)
