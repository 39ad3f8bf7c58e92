"""Checkpoint / resume for progressive rendering state.

Port of ``isaklm_raytracer_tpu/io/checkpoint.py``, with the same ``.npz``
keys and ``FORMAT_VERSION``, so a checkpoint written by either package
loads in the other. The reference has no mid-render persistence (SURVEY.md
section 5): its progressive state dies with the process
(screen.cuh:15-21). Accumulation is a plain sum, so the G-buffer, the
camera pose and the RNG bookkeeping (seed + next sample index) are enough
to continue the exact same sample sequence.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from isaklm_raytracer_tpu_torch.camera.camera import Camera
from isaklm_raytracer_tpu_torch.config import resolve_device
from isaklm_raytracer_tpu_torch.scene.types import GBuffer

FORMAT_VERSION = 1


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_checkpoint(
    path: str,
    gbuffer: GBuffer,
    camera: Camera,
    seed: int,
    next_sample: int,
) -> None:
    """Write render state to an .npz (atomic rename)."""
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp.npz"
    meta = {
        "version": FORMAT_VERSION,
        "seed": int(seed),
        "next_sample": int(next_sample),
    }
    np.savez_compressed(
        tmp,
        frame=_np(gbuffer.frame),
        sq_luminance=_np(gbuffer.sq_luminance),
        count=_np(gbuffer.count),
        camera_position=_np(camera.position),
        camera_scalars=np.asarray(
            [_np(camera.yaw), _np(camera.pitch), _np(camera.fov), _np(camera.aperture_radius)],
            np.float32,
        ),
        meta=np.frombuffer(json.dumps(meta).encode(), np.uint8),
    )
    os.replace(tmp, path)


def load_checkpoint(path: str, device="cuda"):
    """Returns (gbuffer, camera, seed, next_sample), the G-buffer and the
    camera on ``device``: the card unless the caller passes "cpu"; without
    a card the default raises. A missing file raises FileNotFoundError."""
    device = resolve_device(device)
    with np.load(path) as data:
        meta = json.loads(bytes(data["meta"]).decode())
        if meta["version"] != FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        gbuffer = GBuffer(
            frame=torch.from_numpy(data["frame"]).to(device),
            sq_luminance=torch.from_numpy(data["sq_luminance"]).to(device),
            count=torch.from_numpy(data["count"]).to(device),
        )
        yaw, pitch, fov, aperture = (float(v) for v in data["camera_scalars"])
        camera = Camera.create(data["camera_position"], yaw, pitch, fov, aperture, device=device)
    return gbuffer, camera, meta["seed"], meta["next_sample"]
