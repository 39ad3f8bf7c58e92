"""Port parity: gradients of the rendered image.

Three parts.

1. The estimator tests of tests/test_estimator.py, on the port, with the
   same scenes, key words, tolerances and step sizes: the furnace
   equilibrium twice, material gradients (albedo, emittance, roughness,
   extinction, IOR) and camera pose gradients against central finite
   differences with common random numbers (``diff.check_grad_vs_fd``), and
   the detached-ratio lobe estimator. The JAX package's key
   ``PRNGKey(s)`` carries the key words (0, s).
2. The port's gradients against ``jax.grad`` of the JAX package on the
   same numpy scene and camera at 8x8, with the JAX package's brute-force
   intersector on both sides: rtol 1e-4 plus atol 1e-6. The JAX side runs
   op by op (``jax.disable_jit``), as tests/test_torch_integrator.py does:
   under jit, XLA on the CPU contracts multiply-adds into FMAs and
   approximates rsqrt, which moved one IOR gradient of the demo by 1.4e-3
   of its value (a glancing Fresnel term amplifies the last bit); op by op
   the two agree to 4e-7.
3. Gradients through a prepared scene: every intersector's plain version
   (flat, queue, blk) in every ordering gives the same gradient as the
   brute-force oracle on the same scene, bit for bit. The kernels'
   outputs are detached; the gradient flows through ``hit_attributes``'
   re-derivation of the hit, so only the hit ids reach it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu.camera import Camera as JCamera
from isaklm_raytracer_tpu.config import RenderConfig as JConfig
from isaklm_raytracer_tpu.integrator.render import render_sample as jrender_sample
from isaklm_raytracer_tpu.scene import procedural as jproc
from isaklm_raytracer_tpu_torch import interop
from isaklm_raytracer_tpu_torch.accel import move_scene, prepare_scene, with_blocks
from isaklm_raytracer_tpu_torch.accel.traverse import HitAttributes, nearest_hit_brute
from isaklm_raytracer_tpu_torch.camera import Camera
from isaklm_raytracer_tpu_torch.config import RenderConfig
from isaklm_raytracer_tpu_torch.diff import check_grad_vs_fd
from isaklm_raytracer_tpu_torch.integrator.bsdf import scatter
from isaklm_raytracer_tpu_torch.integrator.render import render_sample
from isaklm_raytracer_tpu_torch.kernels import intersect as ki
from isaklm_raytracer_tpu_torch.scene.procedural import (
    SceneBuilder,
    cornell_box,
    material_demo_scene,
)

torch.set_num_threads(1)  # the test workers share the host's cores

PI = float(np.pi)


def key(s):
    """The key words of the JAX package's PRNGKey(s)."""
    return (0, s)


def cpu_camera(*args, **kwargs):
    return Camera.create(*args, **kwargs, device="cpu")


def replace_config(config, **changes):
    return config.__class__(**{**config.__dict__, **changes})


# --- 1. the estimator tests ----------------------------------------------


def furnace_box(emit=1.0, albedo=0.5):
    b = SceneBuilder()
    m = b.add_material(
        albedo=(albedo,) * 3, emittance=(emit,) * 3, roughness=0.5, ior=1.0001
    )
    lo, hi = -1.0, 1.0
    b.add_quad((lo, lo, lo), (hi, lo, lo), (hi, lo, hi), (lo, lo, hi), m)
    b.add_quad((lo, hi, hi), (hi, hi, hi), (hi, hi, lo), (lo, hi, lo), m)
    b.add_quad((lo, lo, hi), (hi, lo, hi), (hi, hi, hi), (lo, hi, hi), m)
    b.add_quad((lo, lo, lo), (lo, lo, hi), (lo, hi, hi), (lo, hi, lo), m)
    b.add_quad((hi, lo, hi), (hi, lo, lo), (hi, hi, lo), (hi, hi, hi), m)
    b.add_quad((hi, lo, lo), (lo, lo, lo), (lo, hi, lo), (hi, hi, lo), m)  # front
    return move_scene(b.build(), "cpu")


def test_furnace_equilibrium():
    emit, albedo = 1.0, 0.5
    expected = emit / (1.0 - albedo)  # = 2
    scene = furnace_box(emit, albedo)
    config = RenderConfig(width=16, height=16, max_bounces=32)
    camera = cpu_camera((0.0, 0.0, 0.0), fov=PI / 2)
    vals = [float(render_sample(scene, camera, key(s), config).mean()) for s in range(24)]
    mean = np.mean(vals)
    sem = np.std(vals) / np.sqrt(len(vals))
    assert abs(mean - expected) < max(4 * sem, 0.05 * expected), (mean, sem)


def test_furnace_unbiased_vs_albedo():
    emit, albedo = 0.7, 0.3
    scene = furnace_box(emit, albedo)
    config = RenderConfig(width=16, height=16, max_bounces=32)
    camera = cpu_camera((0.0, 0.0, 0.0), fov=PI / 2)
    vals = [float(render_sample(scene, camera, key(100 + s), config).mean())
            for s in range(16)]
    expected = emit / (1 - albedo)
    assert abs(np.mean(vals) - expected) < 0.06 * expected


def _with_materials(scene, **leaves):
    return scene.replace(materials=scene.materials.replace(**leaves))


class TestGradVsFD:
    """Cornell box: image + material-gradient check vs FD."""

    @pytest.fixture(scope="class")
    def setup(self):
        scene = move_scene(cornell_box(include_blockers=False), "cpu")
        config = RenderConfig(width=16, height=16, max_bounces=4)
        camera = cpu_camera((0.0, 0.0, -0.9), fov=PI / 2)
        return scene, config, camera, key(11)

    def test_albedo_grad(self, setup):
        # Russian roulette off inside the bounce cap: its threshold moves
        # with albedo, so FD across it would measure path-length flips.
        scene, config, camera, kw = setup
        no_rr = replace_config(config, rr_start_bounce=config.max_bounces)

        def loss(albedo):
            return render_sample(_with_materials(scene, albedo=albedo), camera, kw, no_rr).mean()

        check_grad_vs_fd(loss, scene.materials.albedo, h=2e-3, rtol=0.05, atol=2e-4)

    def test_emittance_grad_is_exact(self, setup):
        # radiance is LINEAR in emittance -> FD agrees to fp precision
        scene, config, camera, kw = setup

        def loss(emittance):
            return render_sample(
                _with_materials(scene, emittance=emittance), camera, kw, config).mean()

        check_grad_vs_fd(loss, scene.materials.emittance, h=5e-2, rtol=0.02, atol=1e-5)

    def test_roughness_grad(self, setup):
        scene, config, camera, kw = setup
        no_rr = replace_config(config, rr_start_bounce=config.max_bounces,
                               lobe_ratio_grad=False)

        def loss(roughness):
            return render_sample(
                _with_materials(scene, roughness=roughness), camera, kw, no_rr).mean()

        check_grad_vs_fd(loss, scene.materials.roughness, h=1e-3, rtol=0.08, atol=5e-4)

    def test_camera_grad_finite_nonzero_in_cornell(self, setup):
        # Silhouette flips dominate camera FD in a box; the interior term's
        # FD agreement is checked silhouette-free in TestGradVsFDCamera.
        scene, config, camera, kw = setup
        pos = camera.position.clone().requires_grad_(True)
        yp = torch.zeros((2,), dtype=torch.float32, requires_grad=True)
        cam = camera.replace(position=pos, yaw=yp[0], pitch=yp[1])
        g_pos, g_yp = torch.autograd.grad(
            render_sample(scene, cam, kw, config).mean(), (pos, yp))
        for g in (g_pos, g_yp):
            assert torch.isfinite(g).all()
            assert g.abs().max() > 0


def floor_view(builder=SceneBuilder):
    """TestGradVsFDCamera's scene, with either package's SceneBuilder: one
    large diffuse floor lit by a panel outside every camera ray's frustum."""
    b = builder()
    light = b.add_material(albedo=(0.0, 0.0, 0.0), emittance=(6.0, 6.0, 6.0), ior=1.0)
    floor = b.add_material(albedo=(0.6, 0.5, 0.4), roughness=0.7, ior=1.0)
    s = 60.0
    b.add_quad((-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s), floor)
    b.add_quad((-2, 6, -9), (2, 6, -9), (2, 6, -5), (-2, 6, -5), light)
    return b.build()


class TestGradVsFDCamera:
    """Camera pose FD on a silhouette-free view: the estimator is C^1 in
    position/yaw/pitch, so CRN FD must match autodiff tightly."""

    @pytest.fixture(scope="class")
    def setup(self):
        scene = move_scene(floor_view(), "cpu")
        config = RenderConfig(width=12, height=12, max_bounces=1, rr_start_bounce=1,
                              lobe_ratio_grad=False)
        camera = cpu_camera((0.0, 3.0, 0.0), yaw=0.0, pitch=0.9, fov=0.9)
        kw = key(23)
        r = render_sample(scene, camera, kw, config)
        assert (r.sum(-1) > 0).all(), "every camera ray must land on lit floor"
        return scene, config, camera, kw

    def test_camera_position_grad_vs_fd(self, setup):
        scene, config, camera, kw = setup

        def loss(pos):
            return render_sample(scene, camera.replace(position=pos), kw, config).mean()

        auto, _ = check_grad_vs_fd(loss, camera.position, h=1e-3, rtol=0.05, atol=5e-4)
        assert np.abs(auto).max() > 0

    def test_camera_yaw_pitch_grad_vs_fd(self, setup):
        scene, config, camera, kw = setup

        def loss(yp):
            return render_sample(
                scene, camera.replace(yaw=yp[0], pitch=yp[1]), kw, config).mean()

        auto, _ = check_grad_vs_fd(
            loss, torch.stack([camera.yaw, camera.pitch]), h=1e-3, rtol=0.05, atol=5e-4)
        assert np.abs(auto).max() > 0


class TestLobeRatioEstimator:
    """The detached-ratio lobe estimator (bsdf.scatter): against the
    EXPECTED radiance over a stratified lobe uniform, its autodiff gradient
    equals the true derivative, selection-probability term included."""

    K = 32768

    def _expected_value(self, ior, ratio: bool):
        k = self.K
        ones = torch.ones((k,), dtype=torch.float32)

        def rows(v):
            return torch.tensor([v], dtype=torch.float32).expand(k, 3)

        hit = HitAttributes(
            albedo=torch.full((k, 3), 0.7), emittance=torch.zeros((k, 3)),
            roughness=0.3 * ones, ior=ior * ones, extinction=0.0 * ones,
            transparent=0.0 * ones, triangle_index=torch.zeros((k,), dtype=torch.int32),
            position=torch.zeros((k, 3)), normal=rows([0.0, 1.0, 0.0]),
            tangent=rows([1.0, 0.0, 0.0]), bitangent=rows([0.0, 0.0, 1.0]), t=ones,
        )
        wi = rows([0.5, -0.8, 0.1])
        ray_d = wi / torch.linalg.norm(wi, dim=-1, keepdim=True)
        u_lobe = (torch.arange(k, dtype=torch.float32) + 0.5) / k  # stratified
        ev = scatter(hit, ray_d, torch.zeros((k,), dtype=torch.bool), 0.37 * ones,
                     0.61 * ones, u_lobe, 0.23 * ones, 0.84 * ones, lobe_ratio_grad=ratio)
        probe = torch.tensor([0.2, 1.0, 0.4])
        g = 1.0 + torch.clamp_min(ev.direction @ probe, 0.0)
        return (ev.weight.sum(dim=-1) * g).mean()

    def _grad(self, ior0, ratio):
        ior = torch.tensor(ior0, dtype=torch.float32, requires_grad=True)
        (g,) = torch.autograd.grad(self._expected_value(ior, ratio), ior)
        return float(g)

    def test_ratio_grad_matches_expected_derivative(self):
        ior0, h = 1.5, 1e-2
        auto = self._grad(ior0, True)
        with torch.no_grad():
            fd = (float(self._expected_value(torch.tensor(ior0 + h), True))
                  - float(self._expected_value(torch.tensor(ior0 - h), True))) / (2 * h)
        reparam = self._grad(ior0, False)
        # the reparameterized-only gradient must NOT agree ...
        assert abs(reparam - fd) > 5 * abs(auto - fd), (reparam, auto, fd)
        # ... while the ratio estimator's must
        np.testing.assert_allclose(auto, fd, rtol=0.05, atol=1e-3)

    def test_ratio_is_forward_identity(self):
        with torch.no_grad():
            a = self._expected_value(torch.tensor(1.5), True)
            b = self._expected_value(torch.tensor(1.5), False)
        assert float(a) == float(b)


class TestGradVsFDMixedMaterials:
    """Conductor extinction k and dielectric/conductor IOR on the demo."""

    @pytest.fixture(scope="class")
    def setup(self):
        scene = move_scene(material_demo_scene(), "cpu")
        config = RenderConfig(width=12, height=12, max_bounces=4, rr_start_bounce=4,
                              lobe_ratio_grad=False)
        camera = cpu_camera((0.0, 1.2, -1.8), pitch=0.15, fov=PI / 2)
        return scene, config, camera, key(17)

    def test_extinction_grad(self, setup):
        # only the conductor's k: FD across extinction = 0 would flip the
        # metal/dielectric branch
        scene, config, camera, kw = setup
        gold = int(torch.argmax(scene.materials.extinction))
        base = scene.materials.extinction[gold]

        def loss(k_gold):
            ext = scene.materials.extinction.clone()
            ext[gold] = k_gold.reshape(())
            return render_sample(_with_materials(scene, extinction=ext), camera, kw,
                                 config).mean()

        auto, _ = check_grad_vs_fd(loss, base.reshape(1), h=2e-3, rtol=0.08, atol=5e-4)
        assert np.abs(auto).max() > 0  # the gold sphere is visible

    def test_ior_grad(self, setup):
        scene, config, camera, kw = setup

        def loss(ior):
            return render_sample(_with_materials(scene, ior=ior), camera, kw, config).mean()

        auto, _ = check_grad_vs_fd(loss, scene.materials.ior, h=1e-3, rtol=0.08, atol=1e-3)
        assert np.abs(auto).max() > 0


# --- 2. against jax.grad ----------------------------------------------------

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARITY = {
    # scene, camera (position, yaw, pitch, fov), key, config, leaves
    "cornell_albedo_roughness_ior": (
        lambda: jproc.cornell_box(include_blockers=False), ((0.0, 0.0, -0.9), 0.0, 0.0, PI / 2),
        11, dict(width=8, height=8, max_bounces=4), ("albedo", "roughness", "ior")),
    "demo_ior_extinction": (
        jproc.material_demo_scene, ((0.0, 1.2, -1.8), 0.0, 0.15, PI / 2),
        17, dict(width=8, height=8, max_bounces=4), ("ior", "extinction")),
    "floor_camera_pose": (
        lambda: floor_view(jproc.SceneBuilder), ((0.0, 3.0, 0.0), 0.1, 0.9, 0.9),
        23, dict(width=8, height=8, max_bounces=2), ("position", "yaw", "pitch")),
}
_CAMERA_LEAVES = ("position", "yaw", "pitch")


@pytest.mark.parametrize("case", sorted(PARITY))
def test_grad_equals_jax_grad(case):
    scene_fn, (pos, yaw, pitch, fov), seed, cfg, leaves = PARITY[case]
    jscene = scene_fn()
    pscene = interop.scene_from_numpy(interop.scene_to_numpy(jscene), device="cpu")
    jcam = JCamera.create(pos, yaw=yaw, pitch=pitch, fov=fov)
    pcam = cpu_camera(pos, yaw=yaw, pitch=pitch, fov=fov)
    x0 = [np.asarray(getattr(jcam if k in _CAMERA_LEAVES else jscene.materials, k), np.float32)
          for k in leaves]

    def split(xs):
        vals = dict(zip(leaves, xs))
        return ({k: v for k, v in vals.items() if k in _CAMERA_LEAVES},
                {k: v for k, v in vals.items() if k not in _CAMERA_LEAVES})

    def jloss(*xs):
        cam, mats = split(xs)
        s = jscene.replace(materials=jscene.materials.replace(**mats))
        return jnp.mean(jrender_sample(s, jcam.replace(**cam), jax.random.PRNGKey(seed),
                                       JConfig(**cfg)))

    with jax.disable_jit():
        want = jax.grad(jloss, argnums=tuple(range(len(leaves))))(*map(jnp.asarray, x0))

    xs = [torch.from_numpy(x.copy()).requires_grad_(True) for x in x0]
    cam, mats = split(xs)
    loss = render_sample(_with_materials(pscene, **mats), pcam.replace(**cam), key(seed),
                         RenderConfig(**cfg)).mean()
    got = torch.autograd.grad(loss, xs)
    for name, g, w in zip(leaves, got, want):
        w = np.asarray(w)
        assert torch.isfinite(g).all() and np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=name)


# --- 3. through a prepared scene ------------------------------------------

PREPARED = [("flat", False), ("flat", True), ("queue", False), ("queue", True),
            ("blk", False), ("blk", True), ("blk", "block")]


@pytest.fixture(scope="module")
def prepared_cornell():
    """The Cornell box prepared for every intersector (16-cluster blocks),
    at 20x20: 400 rays a call, more than one packet of each ordering."""
    scene = prepare_scene(cornell_box(include_blockers=False), "cpu")
    scene = scene.replace(cbvh=with_blocks(scene.cbvh, 16))
    config = RenderConfig(width=20, height=20, max_bounces=3, ray_chunk=0)
    camera = cpu_camera((0.0, 0.0, -0.9), yaw=0.05, pitch=-0.05, fov=PI / 2)

    def grads(trace_fn):
        albedo = scene.materials.albedo.clone().requires_grad_(True)
        rough = scene.materials.roughness.clone().requires_grad_(True)
        pos = camera.position.clone().requires_grad_(True)
        loss = render_sample(_with_materials(scene, albedo=albedo, roughness=rough),
                             camera.replace(position=pos), key(3), config,
                             trace_fn=trace_fn).mean()
        return torch.autograd.grad(loss, (albedo, rough, pos))

    brute = functools.partial(nearest_hit_brute, vertices=scene.vertices,
                              t_eps=config.t_epsilon)
    return scene, config, grads, grads(brute)


@pytest.mark.parametrize("kernel,sort_rays", PREPARED)
def test_prepared_scene_grad_equals_brute(prepared_cornell, kernel, sort_rays):
    scene, config, grads, want = prepared_cornell
    fn = {"flat": ki.nearest_hit_flat, "queue": ki.nearest_hit_queue,
          "blk": ki.nearest_hit_blk}[kernel]
    got = grads(functools.partial(fn, scene.cbvh, t_eps=config.t_epsilon,
                                  sort_rays=sort_rays))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all() and g.abs().max() > 0
        assert torch.equal(g, w), (kernel, sort_rays, float((g - w).abs().max()))


def test_entry_points_default_to_the_card(monkeypatch):
    """prepare_scene and Camera.create run on the card unless asked for the
    CPU: without a card the default raises, "cpu" works."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        prepare_scene(cornell_box())
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Camera.create((0.0, 0.0, 0.0))
    assert prepare_scene(cornell_box(), "cpu").device.type == "cpu"
    assert Camera.create((0.0, 0.0, 0.0), device="cpu").position.device.type == "cpu"
