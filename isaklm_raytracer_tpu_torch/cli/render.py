"""Render entry point: the reference's main loop (main.cu:62-160), headless.

Usage:
  python -m isaklm_raytracer_tpu_torch.cli.render --scene demo --width 512 \
      --height 512 --max-bounces 8 --min-samples 4 --max-samples 16 \
      --camera 0 1.2 -1.8 0 0.15 --out renders/demo.png

Port of ``isaklm_raytracer_tpu/cli/render.py`` for one device. Scenes: the
procedural ``cornell``, ``demo`` and ``hero`` presets (``hero`` is the
2M-triangle ``hero_scene()``). It renders on the device that ``--device``
names: ``cuda`` (the default) raises when there is no card, ``cpu`` runs
the plain PyTorch versions of the kernels (the counterpart of the JAX CLI
honouring JAX_PLATFORMS). The flags of features not ported yet (JSON
manifests, checkpoints, several devices, multi-host, the interactive
preview, running without the cluster tables) are rejected with an error
that names them. Progress lines go to stderr.
"""

from __future__ import annotations

import argparse
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scene", default="cornell", help="cornell | demo | hero")
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
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=64)
    p.add_argument("--devices", default="auto",
                   help="'auto' or '1': the port renders on one device")
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--preview", action="store_true")
    return p.parse_args(argv)


def _reject_unported(args) -> None:
    unported = []
    if args.scene not in ("cornell", "demo", "hero"):
        unported.append(f"--scene {args.scene} (only cornell, demo and hero are ported)")
    if args.checkpoint:
        unported.append("--checkpoint")
    if args.devices not in ("auto", "1"):
        unported.append(f"--devices {args.devices}")
    if args.multihost:
        unported.append("--multihost")
    if args.preview:
        unported.append("--preview")
    if args.no_kd:
        unported.append("--no-kd (the port always builds its cluster tables)")
    if unported:
        raise SystemExit(
            "isaklm_raytracer_tpu_torch.cli.render: not ported yet: "
            + "; ".join(unported)
        )


def main(argv=None) -> int:
    args = parse_args(argv)
    _reject_unported(args)

    import numpy as np
    import torch

    from isaklm_raytracer_tpu_torch.accel import prepare_scene
    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.config import RenderConfig, resolve_device
    from isaklm_raytracer_tpu_torch.integrator.adaptive import needs_sample
    from isaklm_raytracer_tpu_torch.integrator.render import (
        intersector_name,
        render,
        resolve_image,
    )
    from isaklm_raytracer_tpu_torch.io.png import save_png
    from isaklm_raytracer_tpu_torch.scene import procedural
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
    if args.scene == "cornell":
        scene = procedural.cornell_box(glossy=True)
    elif args.scene == "demo":
        scene = procedural.material_demo_scene()
    else:
        scene = procedural.hero_scene()
    scene = prepare_scene(scene, device)
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
    gbuffer = GBuffer.create(config.num_pixels, device)

    adaptive = not args.no_adaptive
    rays_per_sample = config.num_pixels * config.max_bounces * 2
    sample = 0
    while sample < args.max_samples:
        batch = min(args.checkpoint_every, args.max_samples - sample)
        t0 = time.time()
        gbuffer = render(
            scene, camera, config, num_samples=batch, seed=args.seed,
            adaptive=adaptive, gbuffer=gbuffer, sample_offset=sample,
        )
        counts = gbuffer.count.cpu().numpy()  # waits for the device
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
