"""The frozen scenes, the plain reference and its nearest hits, against
the port on the CPU at tiny sizes, and the count behind ``rays_per_s``."""

import numpy as np
import pytest
import torch

import tiny
from perfbench.drivers import common
from perfbench.reference import plain
from perfbench.reference.intersect import Culled, _tests, brute
from perfbench.scenes import procedural


@pytest.mark.parametrize("make", [
    lambda m: m.material_demo_scene(),
    lambda m: m.material_demo_scene(textured=False),
    lambda m: m.hero_scene(20_000),
    lambda m: m.hero_scene(9_000, seed=3),
], ids=["demo", "demo-plain", "hero20k", "hero9k"])
def test_frozen_scenes_equal_the_ports(make):
    from isaklm_raytracer_tpu_torch.scene import procedural as port

    mine, theirs = make(procedural), make(port)
    for key in ("vertices", "normals", "uvs", "mat_id", "light_indices"):
        a, b = getattr(mine, key), np.asarray(getattr(theirs, key))
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    for key in procedural.MATERIAL_KEYS:
        assert np.array_equal(mine.materials[key], np.asarray(getattr(theirs.materials, key)))
    for key in ("buffer", "offset", "width", "height"):
        assert np.array_equal(mine.textures[key], np.asarray(getattr(theirs.textures, key)))


def _rays(n, seed, lo, hi):
    g = torch.Generator().manual_seed(seed)
    o = torch.rand((n, 3), generator=g) * (torch.tensor(hi) - torch.tensor(lo)) + \
        torch.tensor(lo)
    d = torch.randn((n, 3), generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    d[: n // 10, 1] = 0.0  # axis-parallel rays: slabs of 0 * inf
    d[n // 10: n // 5, 0] = 0.0
    return o, d


def test_culled_equals_the_brute_force():
    v = torch.as_tensor(procedural.hero_scene(30_000).vertices)
    o, d = _rays(1500, 0, [-7.0, -0.5, -7.0], [7.0, 3.5, 7.0])
    culled = Culled(v, rays_per_pass=512)
    bi, bh = brute(v, o, d)
    ci, ch = culled(o, d)
    assert torch.equal(ch, bh) and torch.equal(ci, bi) and 0.3 < bh.float().mean() < 1.0
    active = torch.arange(1500) % 3 != 0
    ai, ah = culled(o, d, active)
    assert torch.equal(ah, bh & active) and torch.equal(ai[active], bi[active])
    # within a search window, the nearest hit is the brute force's
    t_max = torch.rand(1500, generator=torch.Generator().manual_seed(1)) * 6.0
    wi, _ = culled(o, d, None, t_max)
    tri = v[bi.clamp_min(0).long()]
    t = _tests(o, d, tri[:, 0], tri[:, 1], tri[:, 2], 1e-5)
    near = bh & (t < t_max * 0.99)
    assert near.sum() > 50 and torch.equal(wi[near], bi[near])


def test_reference_radiance_equals_the_ports_plain_render():
    """The reference's paths and the port's plain versions, on the CPU, of
    the same pixels and samples: the same radiance."""
    from isaklm_raytracer_tpu_torch.integrator.render import render_sample
    from isaklm_raytracer_tpu_torch.math import rng

    config = {"width": 16, "height": 12, "max_bounces": 4, "min_samples": 1,
              "max_samples": 4, "max_tolerance": 0.05, "ray_chunk": 0,
              "camera": {"position": [0.0, 1.2, -1.8], "yaw": 0.0, "pitch": 0.15,
                         "fov": 1.5707963267948966, "aperture_radius": 0.002}}
    arrays = procedural.material_demo_scene()
    program = common.program_scene(arrays, torch.device("cpu"))
    lights = common.light_order(arrays, program)
    scene, trace = common.reference_scene(arrays, lights, "cpu")
    camera = common.reference_camera(config, "cpu")
    ids = torch.arange(16 * 12, dtype=torch.int32)
    for sample in range(3):
        words = rng.sample_key_words(77, sample)
        want = render_sample(program, common.program_camera(config, "cpu"), words,
                             common.render_config(config))
        keys = torch.tensor([plain.sample_key_words(77, sample)]).expand(ids.shape[0], 2)
        got = plain.radiance(scene, trace, camera, common.settings(config), keys, ids)
        assert torch.equal(got, want)
        assert (want.abs().sum(dim=1) > 0).float().mean() > 0.3


def test_gate_equals_the_ports():
    from isaklm_raytracer_tpu_torch.config import RenderConfig
    from isaklm_raytracer_tpu_torch.integrator.adaptive import needs_sample
    from isaklm_raytracer_tpu_torch.scene.types import GBuffer

    g = torch.Generator().manual_seed(5)
    frame = torch.rand((4000, 3), generator=g) * 50
    count = torch.randint(0, 300, (4000,), generator=g, dtype=torch.int32)
    sq = plain.luminance(frame) ** 2 / count.clamp_min(1) * (1 + torch.rand(4000, generator=g))
    want = needs_sample(GBuffer(frame, sq, count), RenderConfig(min_samples=100,
                                                                max_samples=250))
    assert torch.equal(plain.needs_sample(frame, sq, count, 100, 250, 0.05), want)
    assert 0 < want.float().mean() < 1


def test_rays_per_s_counts_the_samples_taken():
    """The offline window's rays are the pixel-samples its images'
    G-buffers counted (the one it ended in too), x bounces x 2: fewer than
    pixels x steps once pixels converge."""
    from perfbench import core

    bench = core.load_benchmark()
    ctx = tiny.context("demo-adaptive", bench=bench)
    cell = __import__("perfbench.drivers.offline", fromlist=["Cell"]).Cell(ctx)
    finished, done = [], cell._done

    def record(gb, offset):
        if done(gb, offset):
            finished.append((gb, offset))
            return True
        return False

    cell._done = record
    window = cell.window(4.0, 0.0)
    images = finished + ([] if "image" in cell.last else
                         [(cell.last["gbuffer"], cell.last["samples"])])
    taken = sum(int(gb.count.sum()) for gb, _ in images)
    pixels = ctx.config["width"] * ctx.config["height"]
    assert finished and window.units >= len(images)
    assert window.rays == taken * ctx.config["max_bounces"] * 2
    assert taken < pixels * sum(samples for _, samples in images)
    assert window.measures["rays_per_s.adaptive"] == pytest.approx(window.rays / window.seconds)
