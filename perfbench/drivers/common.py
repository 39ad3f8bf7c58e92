"""What the drivers share: the program's scene, configuration and camera
built from a configuration file, the reference's scene beside it, seeds
drawn from ``--seed``, and the comparisons of rendered pixels."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.core import Check
from perfbench.reference import plain
from perfbench.reference.intersect import Culled, brute
from perfbench.scenes import procedural

# scenes up to this many triangles are checked by the brute force
BRUTE_LIMIT = 20_000


def rng(seed: int, *tags: int) -> np.random.Generator:
    """A generator of its own for each use of the run's seed."""
    return np.random.default_rng([seed & ((1 << 63) - 1), *tags])


def word(seed: int, *tags: int) -> int:
    """A 32-bit render seed drawn from the run's seed."""
    return int(rng(seed, *tags).integers(0, 1 << 32))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def scene_arrays(config: dict) -> procedural.SceneArrays:
    return procedural.GENERATORS[config["scene"]](**config.get("scene_args", {}))


def program_scene(arrays: procedural.SceneArrays, device):
    """The port's prepared scene of the benchmark's arrays, through its
    public constructors."""
    from isaklm_raytracer_tpu_torch.accel import prepare_scene
    from isaklm_raytracer_tpu_torch.scene.types import MaterialTable, TextureAtlas, build_scene

    scene = build_scene(arrays.vertices, arrays.normals, arrays.uvs, arrays.mat_id,
                        MaterialTable(**arrays.materials), TextureAtlas(**arrays.textures))
    return prepare_scene(scene, device)


def render_config(config: dict, **changes):
    from isaklm_raytracer_tpu_torch.config import RenderConfig

    keys = ("width", "height", "min_samples", "max_samples", "max_tolerance", "max_bounces",
            "ray_chunk")
    return RenderConfig(**{**{k: config[k] for k in keys}, **changes})


def program_camera(config: dict, device):
    from isaklm_raytracer_tpu_torch.camera.camera import Camera

    c = config["camera"]
    return Camera.create(c["position"], c["yaw"], c["pitch"], c["fov"], c["aperture_radius"],
                         device=device)


def settings(config: dict) -> dict:
    return {"width": config["width"], "height": config["height"],
            "max_bounces": config["max_bounces"], "rr_start_bounce": 0}


def reference_camera(config: dict, device, dtype=torch.float32) -> dict:
    c = config["camera"]
    return {k: torch.as_tensor(c[k], dtype=dtype, device=device)
            for k in ("position", "yaw", "pitch", "fov", "aperture_radius")}


# WASD in the view frame (camera.cuh:38-63)
_MOVES = {"w": (0.0, 0.0, 1.0), "a": (-1.0, 0.0, 0.0), "s": (0.0, 0.0, -1.0),
          "d": (1.0, 0.0, 0.0)}


def moved_camera(camera: dict, key: str, time_step: float) -> dict:
    """The camera after one WASD key held for ``time_step`` seconds at the
    reference's 0.5 units a second."""
    rot = plain.rotation_matrix(camera["yaw"], camera["pitch"])
    local = torch.tensor(_MOVES[key], dtype=camera["position"].dtype,
                         device=camera["position"].device)
    return {**camera, "position": camera["position"] + plain.apply(rot, local) * (0.5 * time_step)}


def light_order(arrays: procedural.SceneArrays, program_scene) -> np.ndarray:
    """The reference's light list in the order the program lists its lights.

    The light the estimator picks is the list's entry at a uniform index,
    so any order of the same triangles is the same estimator; the program
    renumbers its triangles and lists its lights in its own order. This
    matches the program's light triangles to the reference's own by their
    vertices, and raises unless they are the same set."""
    own = arrays.light_indices
    theirs = program_scene.vertices[program_scene.light_indices.long()].cpu().numpy()
    mine = arrays.vertices[own]
    order = []
    for tri in theirs:
        same = np.nonzero((mine == tri[None]).all(axis=(1, 2)))[0]
        if same.size != 1:
            raise RuntimeError("the program's light list is not the scene's light triangles")
        order.append(own[same[0]])
    if sorted(order) != sorted(own.tolist()):
        raise RuntimeError("the program's light list is not the scene's light triangles")
    return np.asarray(order, np.int32)


def reference_scene(arrays, lights: np.ndarray, device, dtype=torch.float32):
    """(reference scene, its nearest-hit function)."""
    scene = plain.Scene.from_arrays(arrays, device, dtype)
    scene.light_indices = torch.as_tensor(lights, device=device)
    if arrays.vertices.shape[0] <= BRUTE_LIMIT:
        def trace(o, d, active, t_max):
            return brute(scene.vertices, o, d, active, t_max)
    else:
        trace = Culled(scene.vertices)
    return scene, trace


def sample_keys(seed: int, samples, device) -> torch.Tensor:
    """(S, 2) int64 key words of the given sample indices of a render
    seeded ``seed``."""
    return torch.tensor([plain.sample_key_words(seed, int(i)) for i in samples],
                        dtype=torch.int64, device=device)


def path_radiance(scene, trace, camera, sets, keys, pixel_ids, batch: int):
    """Radiance of every path (key row, pixel id), in batches of paths."""
    out = []
    for start in range(0, pixel_ids.shape[0], batch):
        out.append(plain.radiance(scene, trace, camera, sets, keys[start:start + batch],
                                  pixel_ids[start:start + batch]))
    return torch.cat(out) if out else torch.zeros((0, 3), dtype=scene.dtype,
                                                  device=scene.vertices.device)


def sample_sums(arrays, lights, config: dict, seed: int, samples: int, pixels, batch: int,
                camera=None, dtype=torch.float32, device="cuda"):
    """(frame, count) of ``pixels`` after samples 0 .. ``samples`` - 1 of a
    render seeded ``seed``, traced by the reference in ``dtype`` from
    ``camera`` (default: the configuration's), summed in the G-buffer's
    order of additions."""
    scene, trace = reference_scene(arrays, lights, device, dtype)
    camera = camera or reference_camera(config, device, dtype)
    pixels = torch.as_tensor(pixels, device=device)
    keys = sample_keys(seed, range(samples), device)
    # paths in sample-major order: sample i of every pixel, then i + 1
    rad = path_radiance(scene, trace, camera, settings(config),
                        keys.repeat_interleave(pixels.shape[0], dim=0), pixels.repeat(samples),
                        batch).reshape(samples, pixels.shape[0], 3)
    frame = torch.zeros((pixels.shape[0], 3), dtype=dtype, device=device)
    for i in range(samples):
        frame = frame + rad[i]
    return frame, torch.full((pixels.shape[0],), samples, dtype=torch.int32, device=device)


def display(frame, count):
    """The displayed colours of summed radiance (``resolve_image``)."""
    return plain.correct_color(frame / torch.clamp_min(count, 1).to(frame.dtype)[:, None])


def pixel_checks(limits: dict, frame, count, image, ref_frame, ref_count) -> list:
    """The shares of the checked pixels whose count differs from the
    reference's, whose summed radiance differs by more than
    ``radiance_rtol`` of its size (a path that took another turn), and
    whose displayed colour (``image``; None: the display of ``frame``)
    differs by more than ``image_atol`` from the reference's."""
    frame, count, ref_frame, ref_count = (x.cpu() for x in (frame, count, ref_frame, ref_count))
    image = display(frame.float(), count) if image is None else image.cpu()
    ref_image = display(ref_frame, ref_count)
    frame, ref_frame = frame.double(), ref_frame.double()
    scale = ref_frame.abs().amax(dim=-1) + limits["radiance_floor"] * ref_count.double()
    err = (frame - ref_frame).abs().amax(dim=-1) / torch.clamp_min(scale, 1e-30)
    ierr = (image.double() - ref_image.double()).abs().amax(dim=-1)

    def share(bad):
        return bad.double().mean().item()

    return [Check("count_off", share(count != ref_count), limits["count_off"]),
            Check("radiance_off", share((err > limits["radiance_rtol"]) | ~torch.isfinite(err)),
                  limits["radiance_off"]),
            Check("image_off", share((ierr > limits["image_atol"]) | ~torch.isfinite(ierr)),
                  limits["image_off"])]


def draw_pixels(seed: int, num_pixels: int, count: int, tag: int) -> np.ndarray:
    return np.sort(rng(seed, tag).choice(num_pixels, size=min(count, num_pixels),
                                         replace=False))

