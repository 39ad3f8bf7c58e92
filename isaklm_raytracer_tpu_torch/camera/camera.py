"""Pinhole + thin-aperture camera.

Port of ``Camera`` and ``generate_rays`` of
``isaklm_raytracer_tpu/camera/camera.py`` (reference camera.cuh:15-26,
path_tracing.cuh:327-336, 379-391). ``camera_movement`` is not ported yet.
Pose leaves that require grad carry gradients through ``generate_rays``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from isaklm_raytracer_tpu_torch.config import resolve_device
from isaklm_raytracer_tpu_torch.math import sampling, transforms


@dataclasses.dataclass
class Camera:
    """Pose + optics (reference camera.cuh:15-26); 0-d or (3,) float32."""

    position: torch.Tensor  # (3,)
    yaw: torch.Tensor
    pitch: torch.Tensor
    fov: torch.Tensor  # radians, full horizontal FOV
    aperture_radius: torch.Tensor

    @staticmethod
    def create(position, yaw=0.0, pitch=0.0, fov=math.pi / 2, aperture_radius=0.0,
               device="cuda") -> "Camera":
        """A camera on ``device``: the card unless the caller passes "cpu";
        without a card the default raises (``config.resolve_device``)."""
        device = resolve_device(device)

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32, device=device)

        return Camera(f32(position), f32(yaw), f32(pitch), f32(fov), f32(aperture_radius))

    def replace(self, **changes) -> "Camera":
        """A copy with some leaves replaced, e.g. by tensors that require
        grad (the JAX package's ``Camera.replace``)."""
        return dataclasses.replace(self, **changes)

    def rotation(self) -> torch.Tensor:
        """3x3 view rotation = rotation_matrix(yaw, pitch) (camera.cuh:22-25)."""
        return transforms.rotation_matrix(self.yaw, self.pitch, device=self.yaw.device)

    def to(self, device) -> "Camera":
        return Camera(*(getattr(self, f.name).to(device) for f in dataclasses.fields(self)))


def generate_rays(
    camera: Camera,
    width: int,
    height: int,
    pixel_x: torch.Tensor,
    pixel_y: torch.Tensor,
    uniforms: torch.Tensor,
):
    """Primary rays for pixel coordinates with jitter + aperture.

    direction = R @ normalize([thf*(x+ux-W/2)/(W/2), thf*(y+uy-H/2)/(W/2), 1])
    with both axes normalised by W/2 and integer W/2, H/2 as in the CUDA
    macros; origin = position + R @ [ox, oy, 0] for a sqrt-warped aperture
    disc sample. uniforms: (R, 4). Returns (origins (R, 3), directions (R, 3)).
    """
    half_w = float(width // 2)
    half_h = float(height // 2)
    thf = torch.tan(camera.fov / 2.0)
    rot = camera.rotation()

    x = pixel_x.to(torch.float32) + uniforms[..., 0]
    y = pixel_y.to(torch.float32) + uniforms[..., 1]
    dirs = torch.stack(
        [thf * (x - half_w) / half_w, thf * (y - half_h) / half_w, torch.ones_like(x)],
        dim=-1,
    )
    dirs = transforms.apply(rot, transforms.normalize(dirs))

    ox, oy = sampling.disc_aperture(
        uniforms[..., 2], uniforms[..., 3], camera.aperture_radius
    )
    offset = transforms.apply(rot, torch.stack([ox, oy, torch.zeros_like(ox)], dim=-1))
    return camera.position + offset, dirs
