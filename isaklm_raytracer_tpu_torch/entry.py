"""The port's entry points: one forward render to run or capture, and a dry
run over several ranks.

Counterpart of ``__graft_entry__.py`` (which stays the JAX package's):

- ``entry(device)`` -> (fn, args): ``fn(camera, key_words)`` is one forward
  ``render_sample`` of the Cornell box at 32x32 with 4 bounces, and
  ``args`` its camera and key words. The key words are a (2,) int64 tensor
  on the card (``rng.key_tensor``), so a caller can capture ``fn`` in a
  CUDA graph and replay it with other keys: the port's counterpart of
  ``jax.jit(fn)(*args)``.
- ``dryrun_multichip(n, device)``: n ranks (``dist.launch``) on an n-rank
  ("tile", "sample") mesh at 16x16 with 3 bounces run one
  ``sharded_render_fn``, one ``sharded_train_step_fn`` with a finite loss,
  and one adaptive ``render_sharded`` on a tile mesh, gathered by
  ``unshard_gbuffer`` into a finite frame.

Both run on the card unless the caller asks for the CPU, and raise without
one (``config.resolve_device``).
"""

from __future__ import annotations

import math

import torch

from isaklm_raytracer_tpu_torch.accel import prepare_scene
from isaklm_raytracer_tpu_torch.camera import Camera
from isaklm_raytracer_tpu_torch.config import RenderConfig, resolve_device
from isaklm_raytracer_tpu_torch.dist import sharding
from isaklm_raytracer_tpu_torch.dist.launch import launch
from isaklm_raytracer_tpu_torch.integrator.render import render_sample
from isaklm_raytracer_tpu_torch.math import rng
from isaklm_raytracer_tpu_torch.scene.procedural import cornell_box

FOV = 3.14159 / 2  # the JAX entry's field of view, as written there


def _small_scene_and_config(device, width: int = 32, height: int = 32, bounces: int = 4):
    """The JAX entry's Cornell box, camera and configuration on ``device``.
    ``max_depth=8, leaf_size=4`` are the JAX entry's KD arguments; the port's
    ``prepare_scene`` builds no KD tree by default, so they build nothing."""
    config = RenderConfig(width=width, height=height, max_bounces=bounces, min_samples=1,
                          max_samples=8)
    scene = prepare_scene(cornell_box(), device, max_depth=8, leaf_size=4)
    camera = Camera.create(position=(0.0, 0.0, -0.9), fov=FOV, device=device)
    return scene, camera, config


def entry(device="cuda"):
    """(fn, args): ``fn(camera, key_words)`` -> (1024, 3) radiance, one
    forward ``render_sample`` of the Cornell box at 32x32x4; ``args`` =
    (the camera at (0, 0, -0.9), the key words of ``PRNGKey(0)`` as a (2,)
    int64 tensor on ``device``).

    The JAX entry renders through the KD walk (the JAX package takes the
    tree off the TPU). The port's ``prepare_scene`` builds no tree by
    default, so ``fn`` renders through the flat intersector, the port's main
    path for a scene of a few clusters: its kernel on the card, its plain
    version on the CPU. The two part only on knife-edge rays."""
    device = resolve_device(device)
    scene, camera, config = _small_scene_and_config(device)

    def forward(camera: Camera, key_words) -> torch.Tensor:
        return render_sample(scene, camera, key_words, config)

    return forward, (camera, rng.key_tensor((0, 0), device))


def _dryrun_rank(rank: int, world: int, device: str) -> dict:
    """One rank of ``dryrun_multichip``: what ``__graft_entry__.dryrun_multichip``
    runs on its mesh, on this rank's device."""
    mesh_device = torch.device(device).type  # "cuda": this rank's card
    num_sample = 2 if world % 2 == 0 and world >= 2 else 1
    mesh = sharding.make_render_mesh(world // num_sample, num_sample, mesh_device)
    scene, camera, config = _small_scene_and_config(mesh.device, width=16, height=16,
                                                    bounces=3)
    key = (0, 0)  # PRNGKey(0)'s words

    # forward render sharded over tiles and sample streams
    run, _ = sharding.sharded_render_fn(scene, config, mesh)
    target = run(camera, key)

    # one training step: forward, backward, the grads' all_reduce over the mesh
    train_step = sharding.sharded_train_step_fn(scene, config, mesh, learning_rate=0.01)
    _, loss = train_step(scene.materials, camera, target, rng.fold_in(key, 1))
    if not torch.isfinite(loss):
        raise AssertionError("non-finite training loss in dry run")

    # the CLI's multi-rank path: progressive sharded G-buffer with each
    # rank's adaptive compaction
    tile_mesh = sharding.make_render_mesh(world, 1, mesh_device)
    gb = sharding.render_sharded(scene, camera, config, num_samples=2, mesh=tile_mesh,
                                 adaptive=True)
    gb = sharding.unshard_gbuffer(gb, config, tile_mesh)
    if not torch.isfinite(gb.frame).all():
        raise AssertionError("non-finite frame in dry run")
    return {"mesh": (mesh.num_tile, mesh.num_sample), "loss": float(loss),
            "frame": gb.frame.cpu().numpy(), "count": gb.count.cpu().numpy()}


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run the dry run on ``n_devices`` ranks (``dist.launch``): "cuda" puts
    rank i on card i over NCCL, "cuda:k" every rank on card k over gloo
    (NCCL refuses two ranks on one card), "cpu" gloo ranks on the CPU.
    Prints the JAX entry's line and returns rank 0's results: the mesh
    shape, the loss and the gathered G-buffer's frame and counts (numpy)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None and n_devices > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n_devices}) on {torch.cuda.device_count()} cards: "
                         "one card a rank over NCCL (or name one card for gloo ranks)")
    results = launch(_dryrun_rank, n_devices, str(device), device=device)
    out = results[0]
    if not all(math.isfinite(r["loss"]) for r in results):
        raise AssertionError("non-finite training loss on a rank")
    print(f"dryrun_multichip ok: mesh={{'tile': {out['mesh'][0]}, 'sample': {out['mesh'][1]}}} "
          f"loss={out['loss']:.6f}")
    return out
