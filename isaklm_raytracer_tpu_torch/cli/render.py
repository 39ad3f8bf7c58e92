"""Render entry point: the reference's main loop (main.cu:62-160), headless.

Usage:
  python -m isaklm_raytracer_tpu_torch.cli.render --scene demo --width 512 \
      --height 512 --max-bounces 8 --min-samples 4 --max-samples 16 \
      --camera 0 1.2 -1.8 0 0.15 --out renders/demo.png

Port of ``isaklm_raytracer_tpu/cli/render.py`` for one device. Scenes: the
procedural ``cornell``, ``demo`` and ``hero`` presets (``hero`` is the
2M-triangle ``hero_scene()``) or a JSON manifest that replaces the
reference's hardcoded create_models.cuh:17-43:

  [{"obj": "models/room.obj", "mat": "materials/room.mat",
    "offset": [0, 1.5, 0], "yaw": 0.1, "pitch": 0, "roll": 0,
    "scale": 1.0, "smooth_normals": false}, ...]

It renders on the device that ``--device`` names: ``cuda`` (the default)
raises when there is no card, ``cpu`` runs the plain PyTorch versions of
the kernels (the counterpart of the JAX CLI honouring JAX_PLATFORMS).
``--checkpoint`` resumes from its file when it exists, saves after every
``--checkpoint-every`` samples and, when a batch fails, reloads the last
checkpoint and retries (at most twice). ``--preview`` draws the
progressive image in the terminal with the interactive camera. Several
devices, multi-host and running without the cluster tables are not ported:
their flags are rejected with an error that names them. Progress lines go
to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="cornell",
                   help="cornell | demo | hero | path to JSON scene manifest")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="render on the CUDA card (the default; raises without one) "
                        "or on the CPU")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--min-samples", type=int, default=100)
    p.add_argument("--max-samples", type=int, default=5000)
    p.add_argument("--max-tolerance", type=float, default=0.05)
    p.add_argument("--max-bounces", type=int, default=24)
    p.add_argument("--ray-chunk", type=int, default=16384)
    p.add_argument("--no-adaptive", action="store_true")
    p.add_argument("--no-kd", action="store_true")
    p.add_argument("--camera", type=float, nargs=5,
                   metavar=("X", "Y", "Z", "YAW", "PITCH"),
                   default=[-2.1, 1.7, -1.2, 0.975, 0.3],
                   help="initial pose (default: the reference's, main.cu:101-104)")
    p.add_argument("--fov", type=float, default=1.5707963)
    p.add_argument("--aperture", type=float, default=0.002)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="renders/render.png")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint path; resumes if it exists")
    p.add_argument("--checkpoint-every", type=int, default=64)
    p.add_argument("--devices", default="auto",
                   help="'auto' or '1': the port renders on one device")
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--preview", action="store_true",
                   help="progressive terminal preview with interactive camera "
                        "(the reference's GLFW window loop, main.cu:114-155)")
    return p.parse_args(argv)


def _reject_unported(args) -> None:
    unported = []
    if args.devices not in ("auto", "1"):
        unported.append(f"--devices {args.devices}")
    if args.multihost:
        unported.append("--multihost")
    if args.no_kd:
        unported.append("--no-kd (the port always builds its cluster tables)")
    if unported:
        raise SystemExit(
            "isaklm_raytracer_tpu_torch.cli.render: not ported yet: "
            + "; ".join(unported)
        )


def load_scene(args, device):
    """The prepared scene ``--scene`` names, on ``device``: a preset, or the
    meshes of a JSON manifest (a missing file raises FileNotFoundError)."""
    import numpy as np

    from isaklm_raytracer_tpu_torch.accel import prepare_scene
    from isaklm_raytracer_tpu_torch.scene import procedural
    from isaklm_raytracer_tpu_torch.scene.obj import Transformation, create_scene_from_files

    presets = {
        "cornell": lambda: procedural.cornell_box(glossy=True),
        "demo": procedural.material_demo_scene,
        "hero": procedural.hero_scene,
    }
    if args.scene in presets:
        return prepare_scene(presets[args.scene](), device)

    from isaklm_raytracer_tpu_torch.math import transforms

    with open(args.scene) as f:
        manifest = json.load(f)
    meshes = []
    for entry in manifest:
        rot = transforms.rotation_matrix(
            entry.get("yaw", 0.0), entry.get("pitch", 0.0), entry.get("roll", 0.0),
            device="cpu",
        ).numpy() * entry.get("scale", 1.0)
        meshes.append((
            entry["obj"],
            entry.get("mat", ""),
            Transformation(np.asarray(entry.get("offset", [0, 0, 0]), np.float32), rot),
            entry.get("smooth_normals", False),
        ))
    return create_scene_from_files(meshes, device=device)


def main(argv=None) -> int:
    args = parse_args(argv)
    _reject_unported(args)

    import numpy as np
    import torch

    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.config import RenderConfig, resolve_device
    from isaklm_raytracer_tpu_torch.integrator.adaptive import needs_sample
    from isaklm_raytracer_tpu_torch.integrator.render import (
        intersector_name,
        render,
        resolve_image,
    )
    from isaklm_raytracer_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from isaklm_raytracer_tpu_torch.io.png import save_png
    from isaklm_raytracer_tpu_torch.scene.types import GBuffer

    device = resolve_device(args.device)
    # every rate line names what it was measured on
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    config = RenderConfig(
        width=args.width,
        height=args.height,
        min_samples=args.min_samples,
        max_samples=args.max_samples,
        max_tolerance=args.max_tolerance,
        max_bounces=args.max_bounces,
        ray_chunk=args.ray_chunk,
    )

    t0 = time.time()
    scene = load_scene(args, device)
    print(
        f"triangle count: {scene.num_triangles}\n"
        f"light count: {scene.num_lights if scene.has_lights else 0}\n"
        f"scene build: {time.time() - t0:.1f}s\n"
        f"device: {device} ({device_name})\n"
        f"intersector: {intersector_name(scene.cbvh)}",
        file=sys.stderr,
    )

    x, y, z, yaw, pitch = args.camera
    camera = Camera.create((x, y, z), yaw, pitch, args.fov, args.aperture, device=device)
    adaptive = not args.no_adaptive

    if args.preview:
        from isaklm_raytracer_tpu_torch.cli.preview import run_preview
        from isaklm_raytracer_tpu_torch.viewer import InteractiveSession

        session = InteractiveSession(scene, camera, config, seed=args.seed, adaptive=adaptive)
        image = run_preview(session, max_samples=args.max_samples)
        save_png(args.out, image)
        print(f"wrote {args.out}", file=sys.stderr)
        return 0

    gbuffer = None
    start_sample = 0
    if args.checkpoint:
        try:
            gbuffer, camera, _, start_sample = load_checkpoint(args.checkpoint, device)
            print(f"resumed at sample {start_sample}", file=sys.stderr)
        except FileNotFoundError:
            pass
    if gbuffer is None:
        gbuffer = GBuffer.create(config.num_pixels, device)

    rays_per_sample = config.num_pixels * config.max_bounces * 2
    sample = start_sample
    retries_left = 2
    while sample < args.max_samples:
        batch = min(args.checkpoint_every, args.max_samples - sample)
        t0 = time.time()
        try:
            gbuffer = render(
                scene, camera, config, num_samples=batch, seed=args.seed,
                adaptive=adaptive, gbuffer=gbuffer, sample_offset=sample,
            )
            counts = gbuffer.count.cpu().numpy()  # waits for the device
        except Exception as e:  # noqa: BLE001 -- failure recovery:
            # a fault mid-batch loses at most one batch; reload the last
            # atomic checkpoint and retry (the reference loses the whole
            # render, SURVEY.md section 5).
            if not args.checkpoint or retries_left == 0:
                raise
            retries_left -= 1
            print(f"batch failed ({type(e).__name__}: {e}); resuming from "
                  f"checkpoint ({retries_left} retries left)", file=sys.stderr)
            try:
                gbuffer, camera, _, sample = load_checkpoint(args.checkpoint, device)
            except FileNotFoundError:
                gbuffer = GBuffer.create(config.num_pixels, device)
                sample = 0
            continue
        dt = time.time() - t0
        sample += batch
        min_spp = int(counts.min())
        print(
            f"sample {sample}/{args.max_samples}: {dt / batch * 1e3:.0f} ms/sample, "
            f"{rays_per_sample * batch / dt / 1e6:.1f} Mrays/s on {device_name}, "
            f"min spp {min_spp}, converged "
            f"{float((counts >= config.min_samples).mean()):.0%}",
            file=sys.stderr,
        )
        if args.checkpoint:
            save_checkpoint(args.checkpoint, gbuffer, camera, args.seed, sample)
        if adaptive and min_spp >= config.min_samples:
            if int(needs_sample(gbuffer, config).sum()) == 0:
                print("all pixels converged", file=sys.stderr)
                break

    image = resolve_image(gbuffer, config)
    save_png(args.out, np.asarray(image.cpu()))
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
