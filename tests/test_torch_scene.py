"""Port parity: procedural scenes, textures, prepare_scene and interop.

Host-side builders are numpy in both packages, so everything here is held
to EXACT equality: renumbering order, cluster tiles, shading rows, light
indices, the texture atlas. ``sample_texture`` (floored mod, truncating
casts) is also exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu.accel import prepare_scene as jprepare
from isaklm_raytracer_tpu.camera import Camera as JCamera
from isaklm_raytracer_tpu.scene import procedural as jproc
from isaklm_raytracer_tpu.scene.types import GBuffer as JGBuffer
from isaklm_raytracer_tpu.scene.types import sample_texture as jsample_texture
from isaklm_raytracer_tpu_torch import interop
from isaklm_raytracer_tpu_torch.accel import prepare_scene
from isaklm_raytracer_tpu_torch.accel.cluster import build_cluster_bvh, cluster_order
from isaklm_raytracer_tpu_torch.scene import procedural
from isaklm_raytracer_tpu_torch.scene.types import sample_texture

torch.set_num_threads(1)  # the test workers share the host's cores

SCENES = {
    "cornell": (lambda: jproc.cornell_box(glossy=True),
                lambda: procedural.cornell_box(glossy=True)),
    "demo": (jproc.material_demo_scene, procedural.material_demo_scene),
}


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}.{k}")
    elif want is None:
        assert got is None, path
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_procedural_scene_identical(name):
    jax_fn, port_fn = SCENES[name]
    want = interop.scene_to_numpy(jax_fn())
    got = interop.scene_to_numpy(port_fn())
    _assert_tree_equal(got, want)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_prepare_scene_identical(name):
    """Renumbering order, tri_const, clu_bbox, shade_table, light_indices
    and, under the JAX package's default build_kd=None, the KD tree and its
    chunk rows: bit for bit."""
    jax_fn, port_fn = SCENES[name]
    want = interop.scene_to_numpy(jprepare(jax_fn()))
    got = interop.scene_to_numpy(prepare_scene(port_fn(), "cpu", build_kd=None))
    _assert_tree_equal(got, want)
    assert got["cbvh"]["num_triangles"] == want["cbvh"]["num_triangles"]


def test_cluster_tables_random_soup():
    from isaklm_raytracer_tpu.accel.cluster import build_cluster_bvh as jbuild
    from isaklm_raytracer_tpu.accel.cluster import cluster_order as jorder

    r = np.random.default_rng(3)
    verts = (r.uniform(-2, 2, (777, 1, 3)) + r.uniform(-0.4, 0.4, (777, 3, 3))).astype(np.float32)
    order = cluster_order(verts)
    np.testing.assert_array_equal(order, jorder(verts))
    got, want = build_cluster_bvh(verts[order]), jbuild(verts[order])
    np.testing.assert_array_equal(got.tri_const, np.asarray(want.tri_const))
    np.testing.assert_array_equal(got.clu_bbox, np.asarray(want.clu_bbox))
    assert got.real_clusters == 7 and got.num_clusters == 64


def test_morton_order_matches():
    from isaklm_raytracer_tpu.accel.cluster import morton_order as jmorton

    from isaklm_raytracer_tpu_torch.accel import morton_order

    r = np.random.default_rng(8)
    verts = (r.uniform(-2, 2, (1001, 1, 3)) + r.uniform(-0.4, 0.4, (1001, 3, 3))).astype(np.float32)
    verts[500:520] = verts[0]  # equal centroids: the stable order keeps their indices
    order = morton_order(verts)
    assert order.dtype == np.int64
    np.testing.assert_array_equal(order, np.asarray(jmorton(verts)))
    np.testing.assert_array_equal(np.sort(order), np.arange(1001))


def test_sample_texture_matches():
    r = np.random.default_rng(4)
    leaves = interop.scene_to_numpy(procedural.material_demo_scene())
    tex = leaves["textures"]
    n = 4096
    tex_id = r.integers(-1, 1, n).astype(np.int32)
    color = r.random((n, 3)).astype(np.float32)
    uv = r.uniform(-3.0, 3.0, (n, 2)).astype(np.float32)
    uv[:16] = np.float32(-0.0)  # the floored mod's edge cases
    uv[16:32] = np.float32(1.0)
    from isaklm_raytracer_tpu.scene.types import TextureAtlas as JAtlas

    want = jsample_texture(
        JAtlas(**{k: jnp.asarray(v) for k, v in tex.items()}),
        jnp.asarray(tex_id), jnp.asarray(color), jnp.asarray(uv),
    )
    port = interop.scene_from_numpy(leaves, device="cpu")
    got = sample_texture(port.textures, torch.from_numpy(tex_id),
                         torch.from_numpy(color), torch.from_numpy(uv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_interop_round_trip():
    """JAX leaves -> port dataclasses -> numpy leaves gives back the same
    arrays, for scene, camera and G-buffer."""
    jscene = jprepare(jproc.material_demo_scene())
    leaves = interop.scene_to_numpy(jscene)
    _assert_tree_equal(interop.scene_to_numpy(interop.scene_from_numpy(leaves, device="cpu")), leaves)

    jcam = JCamera.create((0.1, 1.2, -1.8), yaw=0.3, pitch=0.15, fov=1.2, aperture_radius=0.01)
    cam_leaves = interop.camera_to_numpy(jcam)
    cam = interop.camera_from_numpy(**cam_leaves, device="cpu")
    _assert_tree_equal(interop.camera_to_numpy(cam), cam_leaves)

    r = np.random.default_rng(5)
    jgb = JGBuffer(
        frame=jnp.asarray(r.random((64, 3)).astype(np.float32)),
        sq_luminance=jnp.asarray(r.random(64).astype(np.float32)),
        count=jnp.asarray(r.integers(0, 9, 64).astype(np.int32)),
    )
    gb_leaves = interop.gbuffer_to_numpy(jgb)
    gb = interop.gbuffer_from_numpy(**gb_leaves, device="cpu")
    assert gb.count.dtype == torch.int32 and gb.frame.dtype == torch.float32
    _assert_tree_equal(interop.gbuffer_to_numpy(gb), gb_leaves)
