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
bit for bit on every output. ``integrator.path_trace.trace_paths`` takes
the kernels for CUDA tensors that autograd does not record and the plain
versions otherwise (``path_trace.shade_route``).

On CUDA tensors the wrappers launch their kernel or raise, and count in
``kernels.intersect.COUNTS`` (``shade``, ``shade_finish``); on CPU tensors
they raise (the render calls the plain versions there). The plain versions
count their calls on CUDA tensors (``shade_plain_cuda``,
``shade_finish_plain_cuda``). A launch makes no host sync and no copy from
the host, so a CUDA graph capture records it.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from isaklm_raytracer_tpu_torch.accel.traverse import hit_attributes
from isaklm_raytracer_tpu_torch.integrator.bsdf import scatter
from isaklm_raytracer_tpu_torch.integrator.nee import ShadowRays, direct_from_hit, shadow_rays
from isaklm_raytracer_tpu_torch.kernels.intersect import COUNTS, _launch
from isaklm_raytracer_tpu_torch.scene.types import Scene

# uniforms a bounce reads: u[0:5] the BSDF sample, u[5:8] the light pick and
# the point on the light (shade_bounce), u[8] Russian roulette (finish_bounce)
SHADE_UNIFORMS, BOUNCE_UNIFORMS = 8, 9


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
        "o_dist_sq", "o_normal")] + [("u_stride", _I64), ("num_rays", _I32),
                                     ("lobe_ratio_grad", _I32)]


class FinishArgs(ctypes.Structure):
    _fields_ = [(name, _P) for name in (
        "ray_o", "throughput", "radiance", "live", "nee", "shadow_dir", "light_idx",
        "dist_sq", "normal", "idx", "hit", "u_rr", "o_throughput", "o_radiance",
        "o_active")] + [("num_rays", _I32), ("roulette", _I32)]


def _planes(device, num_rays: int, vecs: int, scalars: int, flags: int):
    """Outputs of a launch, in two allocations (each costs host time): ``vecs``
    (R, 3) and ``scalars`` (R,) float32 planes of one buffer, ``flags`` (R,)
    bool planes of another; each plane contiguous."""
    floats = torch.empty(num_rays * (3 * vecs + scalars), dtype=torch.float32, device=device)
    bools = torch.empty(num_rays * flags, dtype=torch.bool, device=device)
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
        raise ValueError(f"{name} requires grad: the kernels do not differentiate "
                         "(trace_paths takes the plain versions when autograd records)")


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
                prev_diffuse, u, lobe_ratio_grad: bool = True):
    """(the tensors a launch reads, the ``Pending`` it writes, its
    ``ShadeSceneArgs`` and ``ShadeArgs``) of ``shade_bounce``: every input
    checked for dtype, shape, device and contiguity (it raises on any
    other), the outputs allocated on the rays' device. ``u`` is the
    bounce's (n >= 8, R) float32 uniforms."""
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
    vecs, scalars, masks = _planes(device, num_rays, 6 if lit else 4, 3 if lit else 0,
                                   4 if lit else 3)
    pending = Pending(*vecs[:4], *masks[:3])
    if lit:
        pending.nee_mask, pending.shadow_dir, pending.normal = masks[3], vecs[4], vecs[5]
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
                 prev_diffuse, u, lobe_ratio_grad: bool = True) -> Pending:
    """``shade_bounce_plain`` by the ``shade_bounce`` kernel, bit for bit;
    CUDA tensors only."""
    _cuda_only("shade_bounce", ray_o)
    # reads stay referenced until the launch: the kernel reads them
    reads, pending, s_args, args = kernel_args(
        scene, ray_o, ray_d, idx, hit, active, throughput, radiance, inside, prev_diffuse, u,
        lobe_ratio_grad)
    if ray_o.shape[0]:  # an empty grid is an invalid launch
        _launch("shade_bounce", ray_o, ctypes.addressof(s_args), ctypes.addressof(args))
    return pending


def finish_bounce(scene: Scene, pending: Pending, idx, hit, u_rr, roulette: bool):
    """``finish_bounce_plain`` by the ``finish_bounce`` kernel, bit for
    bit; CUDA tensors only. Returns the next (ray_o, ray_d, throughput,
    radiance, inside, prev_diffuse, active)."""
    _cuda_only("finish_bounce", pending.ray_o)
    # reads stay referenced until the launch: the kernel reads them
    reads, (throughput, radiance, active), s_args, args = finish_args(
        scene, pending, idx, hit, u_rr, roulette)
    if pending.ray_o.shape[0]:
        _launch("finish_bounce", pending.ray_o, ctypes.addressof(s_args), ctypes.addressof(args))
    return (pending.ray_o, pending.ray_d, throughput, radiance, pending.inside,
            pending.prev_diffuse, active)
