"""Render entry point: the reference's main loop (main.cu:62-160), headless.

Usage:
  python -m isaklm_raytracer_tpu_torch.cli.render --scene demo --width 512 \
      --height 512 --max-bounces 8 --min-samples 4 --max-samples 16 \
      --camera 0 1.2 -1.8 0 0.15 --out renders/demo.png

Port of ``isaklm_raytracer_tpu/cli/render.py``. Scenes: the
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
progressive image in the terminal with the interactive camera. Progress
lines go to stderr.

Several cards: one process (rank) per card, the image's pixels split over
the ranks (``dist.sharding.render_sharded``, bit-equal to one device).

- When a process group is already up (the caller's, or ``--multihost``'s,
  which starts one from torchrun's ``env://`` variables: NCCL on the card,
  gloo under ``--device cpu``), the mesh is its world: ``--devices auto``,
  or ``--devices N`` equal to the world size.
- With no group up, ``--devices N`` (N > 1) spawns N local ranks through
  ``dist.launch``; ``auto`` is every card (1 under ``--device cpu``).
  Asking for more cards than there are raises.
- ``--devices 1``, or an ``auto`` of 1, is the single-device loop.

Under a mesh rank 0 reads the checkpoint and broadcasts it, and writes
it after gathering the G-buffer from every rank; a failed batch is
retried when any rank failed (a MAX all_reduce of a flag). Every process
writes ``--out``, except ranks the CLI spawned itself, of which rank 0
does.

``--no-kd`` skips ``prepare_scene``, as in the JAX CLI: the scene is only
moved to the device and every ray goes through the brute force (the
brute-force kernel on the card). ``--kd-depth`` and ``--kd-leaf`` are
accepted so that the JAX CLI's command lines run, and reach
``RenderConfig`` as there, but build no KD tree and change no output: the
port's renders take the cluster tables on every device, as the JAX CLI's
do on a TPU (``accel.prepare_scene`` builds no tree by default).

  torchrun --nproc-per-node 4 -m isaklm_raytracer_tpu_torch.cli.render \\
      --multihost --scene hero --width 640 --height 360 --out hero.png
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
    p.add_argument("--kd-depth", type=int, default=19, help="accepted; builds no tree")
    p.add_argument("--kd-leaf", type=int, default=7, help="accepted; builds no tree")
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
    p.add_argument("--devices", type=_devices, default="auto",
                   help="'auto' = every card (the group's world when one is up; 1 "
                        "under --device cpu); N = N ranks, one a card, the pixels "
                        "split over them; '1' = single-device loop")
    p.add_argument("--multihost", action="store_true",
                   help="start the process group from torchrun's env:// variables "
                        "first (NCCL; gloo under --device cpu)")
    p.add_argument("--preview", action="store_true",
                   help="progressive terminal preview with interactive camera "
                        "(the reference's GLFW window loop, main.cu:114-155)")
    return p.parse_args(argv)


def _devices(text: str):
    if text == "auto":
        return text
    if not text.isdigit() or int(text) < 1:
        raise argparse.ArgumentTypeError(f"expected 'auto' or a count >= 1, got {text!r}")
    return int(text)


def load_scene(args, device):
    """The scene ``--scene`` names, on ``device``: a preset, or the meshes of
    a JSON manifest (a missing file raises FileNotFoundError); prepared,
    or only moved under ``--no-kd``."""
    import numpy as np

    from isaklm_raytracer_tpu_torch.accel import move_scene, prepare_scene
    from isaklm_raytracer_tpu_torch.scene import procedural
    from isaklm_raytracer_tpu_torch.scene.obj import Transformation, create_scene_from_files

    presets = {
        "cornell": lambda: procedural.cornell_box(glossy=True),
        "demo": procedural.material_demo_scene,
        "hero": procedural.hero_scene,
    }
    if args.scene in presets:
        scene = presets[args.scene]()
        return move_scene(scene, device) if args.no_kd else prepare_scene(scene, device)

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
    scene = create_scene_from_files(meshes, prepare=not args.no_kd, device=device)
    return move_scene(scene, device) if args.no_kd else scene


def _cards_asked(args) -> int:
    """The rank count ``--devices`` asks for when no process group is up."""
    import torch

    if args.device == "cpu":
        return 1 if args.devices == "auto" else args.devices
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if args.devices == "auto":
        return max(have, 1)  # no card: the single-device path names it
    if args.devices > 1 and args.devices > have:
        raise RuntimeError(
            f"--devices {args.devices}: asks for {args.devices} CUDA cards, {have} found "
            "(torch.cuda.device_count()); ask for fewer, or for the CPU (--device cpu)"
        )
    return args.devices


def _init_multihost(args) -> None:
    """``init_process_group`` from torchrun's env:// variables."""
    import os

    import torch
    import torch.distributed as dist

    from isaklm_raytracer_tpu_torch.config import resolve_device

    missing = [v for v in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
               if v not in os.environ]
    if missing:
        raise RuntimeError(
            f"--multihost: {', '.join(missing)} not set; start the ranks with torchrun, "
            "which sets them"
        )
    if resolve_device(args.device).type == "cpu":
        dist.init_process_group("gloo", init_method="env://")
        return
    card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    torch.cuda.set_device(card)
    dist.init_process_group("nccl", init_method="env://", device_id=card)


def main(argv=None) -> int:
    args = parse_args(argv)

    import torch.distributed as dist

    if args.preview:
        return _render(args)
    if args.multihost and not dist.is_initialized():
        _init_multihost(args)
        try:
            return _render(args)
        finally:
            dist.destroy_process_group()
    if dist.is_initialized():
        return _render(args)
    n = _cards_asked(args)
    if n > 1:
        from isaklm_raytracer_tpu_torch.dist.launch import launch

        launch(_spawned_rank, n, sys.argv[1:] if argv is None else list(argv),
               device=args.device)
        return 0
    return _render(args)


def _spawned_rank(rank: int, world: int, argv) -> int:
    return _render(parse_args(argv), spawned=True)


def _load(path, config, device, mesh):
    """(gbuffer, camera, next sample) of the checkpoint at ``path``, or None
    when there is none. Under a mesh rank 0 reads the file and broadcasts
    it, so the ranks need no shared filesystem (the JAX CLI reads it on
    every process: ROADMAP C.4)."""
    import torch
    import torch.distributed as dist

    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.io.checkpoint import load_checkpoint
    from isaklm_raytracer_tpu_torch.scene.types import GBuffer

    state, error = None, None
    if mesh is None or mesh.rank == 0:
        try:
            gb, camera, _, next_sample = load_checkpoint(path, device)
            if gb.count.shape[0] != config.num_pixels:
                raise ValueError(f"{path} holds {gb.count.shape[0]} pixels, the render "
                                 f"{config.num_pixels}")
            state = gb, camera, next_sample
        except FileNotFoundError:
            pass
        except Exception as e:  # noqa: BLE001 -- the other ranks wait in the
            # broadcast below: tell them, then raise
            if mesh is None:
                raise
            error = e
    if mesh is None:
        return state
    head = torch.tensor([0 if state is None else 1, 0 if state is None else state[2]],
                        dtype=torch.int64, device=device)
    if error is not None:
        head[0] = 2
    dist.broadcast(head, src=0)
    status, next_sample = head.tolist()
    if status == 2:
        raise error or RuntimeError(f"rank 0 could not load the checkpoint {path}")
    if status == 0:
        return None
    if mesh.rank == 0:
        gb, camera, _ = state
        pose = torch.cat([camera.position.reshape(3), torch.stack(
            [camera.yaw, camera.pitch, camera.fov, camera.aperture_radius])])
    else:
        gb = GBuffer.create(config.num_pixels, device)
        pose = torch.empty(7, dtype=torch.float32, device=device)
    for t in (gb.frame, gb.sq_luminance, gb.count, pose):
        dist.broadcast(t, src=0)
    return gb, Camera(pose[:3], pose[3], pose[4], pose[5], pose[6]), next_sample


def _render(args, spawned: bool = False) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    from isaklm_raytracer_tpu_torch.camera import Camera
    from isaklm_raytracer_tpu_torch.config import RenderConfig, resolve_device
    from isaklm_raytracer_tpu_torch.dist import sharding
    from isaklm_raytracer_tpu_torch.integrator.adaptive import needs_sample
    from isaklm_raytracer_tpu_torch.integrator.render import (
        render,
        resolve_image,
        trace_name,
    )
    from isaklm_raytracer_tpu_torch.io.checkpoint import save_checkpoint
    from isaklm_raytracer_tpu_torch.io.png import save_png
    from isaklm_raytracer_tpu_torch.scene.types import GBuffer

    device = resolve_device(args.device)
    mesh = None
    if dist.is_initialized() and not args.preview:
        world = dist.get_world_size()
        if args.devices not in ("auto", world):
            raise ValueError(f"--devices {args.devices}: the process group that is up has "
                             f"{world} ranks")
        if world > 1:
            mesh = sharding.make_render_mesh(num_tile=world, num_sample=1, device=device)
            device = mesh.device
    # rank 0 of a mesh prints the progress lines; every rank names its device
    lead = mesh is None or mesh.rank == 0
    # every rate line names what it was measured on
    device_name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    config = RenderConfig(
        width=args.width,
        height=args.height,
        min_samples=args.min_samples,
        max_samples=args.max_samples,
        max_tolerance=args.max_tolerance,
        max_bounces=args.max_bounces,
        kd_tree_depth=args.kd_depth,
        kd_leaf_size=args.kd_leaf,
        ray_chunk=args.ray_chunk,
    )

    t0 = time.time()
    scene = load_scene(args, device)
    rank = "" if mesh is None else f" (rank {mesh.rank} of {mesh.num_tile} on 'tile')"
    print(
        f"triangle count: {scene.num_triangles}\n"
        f"light count: {scene.num_lights if scene.has_lights else 0}\n"
        f"scene build: {time.time() - t0:.1f}s\n"
        f"device: {device} ({device_name}){rank}\n"
        f"intersector: {trace_name(scene)}",
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

    def fresh():
        gb = GBuffer.create(config.num_pixels, device)
        return gb if mesh is None else sharding.shard_gbuffer(gb, config, mesh)

    def plain(gb):
        """The (num_pixels,) G-buffer; collective under a mesh, so every
        rank calls it outside the rank-0 guards."""
        return gb if mesh is None else sharding.unshard_gbuffer(gb, config, mesh)

    gbuffer = fresh()
    start_sample = 0
    if args.checkpoint:
        state = _load(args.checkpoint, config, device, mesh)
        if state is not None:
            gbuffer, camera, start_sample = state
            if mesh is not None:
                gbuffer = sharding.shard_gbuffer(gbuffer, config, mesh)
            if lead:
                print(f"resumed at sample {start_sample}", file=sys.stderr)

    rays_per_sample = config.num_pixels * config.max_bounces * 2
    sample = start_sample
    retries_left = 2
    while sample < args.max_samples:
        batch = min(args.checkpoint_every, args.max_samples - sample)
        t0 = time.time()
        failure = None
        try:
            if mesh is None:
                gbuffer = render(
                    scene, camera, config, num_samples=batch, seed=args.seed,
                    adaptive=adaptive, gbuffer=gbuffer, sample_offset=sample,
                )
                counts = gbuffer.count.cpu().numpy()  # waits for the device
            else:
                gbuffer = sharding.render_sharded(
                    scene, camera, config, num_samples=batch, mesh=mesh, seed=args.seed,
                    adaptive=adaptive, gbuffer=gbuffer, sample_offset=sample,
                )
        except Exception as e:  # noqa: BLE001 -- failure recovery:
            # a fault mid-batch loses at most one batch; reload the last
            # atomic checkpoint and retry (the reference loses the whole
            # render, SURVEY.md section 5).
            failure = e
        failed = failure is not None
        if mesh is not None:  # the ranks retry together or not at all
            flag = torch.tensor([int(failed)], dtype=torch.int64, device=device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            failed = bool(flag.item())
        if failed:
            if not args.checkpoint or retries_left == 0:
                if failure is not None:
                    raise failure
                raise RuntimeError(f"a batch failed on another rank than {mesh.rank}")
            retries_left -= 1
            why = "on another rank" if failure is None else f"{type(failure).__name__}: {failure}"
            print(f"batch failed ({why}); resuming from checkpoint ({retries_left} retries "
                  "left)", file=sys.stderr)
            state = _load(args.checkpoint, config, device, mesh)
            if state is None:
                gbuffer, sample = fresh(), 0
            else:
                gbuffer, camera, sample = state
                if mesh is not None:
                    gbuffer = sharding.shard_gbuffer(gbuffer, config, mesh)
            continue
        dt = time.time() - t0
        sample += batch
        if mesh is None:
            min_spp = int(counts.min())
            converged = float((counts >= config.min_samples).mean())
            n_unconverged = None  # counted below, when needed
        else:
            min_spp, converged, n_unconverged = sharding.gbuffer_progress(gbuffer, config, mesh)
        if lead:
            print(
                f"sample {sample}/{args.max_samples}: {dt / batch * 1e3:.0f} ms/sample, "
                f"{rays_per_sample * batch / dt / 1e6:.1f} Mrays/s on {device_name}, "
                f"min spp {min_spp}, converged {converged:.0%}",
                file=sys.stderr,
            )
        if args.checkpoint:
            gb_plain = plain(gbuffer)
            if lead:
                save_checkpoint(args.checkpoint, gb_plain, camera, args.seed, sample)
        if adaptive and min_spp >= config.min_samples:
            if n_unconverged is None:
                n_unconverged = int(needs_sample(gbuffer, config).sum())
            if n_unconverged == 0:
                if lead:
                    print("all pixels converged", file=sys.stderr)
                break

    gb_plain = plain(gbuffer)
    if spawned and not lead:
        return 0
    image = resolve_image(gb_plain, config)
    save_png(args.out, np.asarray(image.cpu()))
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
