from isaklm_raytracer_tpu_torch.scene.types import (
    GBuffer,
    MaterialTable,
    Scene,
    TextureAtlas,
    build_scene,
    sample_texture,
)

__all__ = [
    "GBuffer",
    "MaterialTable",
    "Scene",
    "TextureAtlas",
    "build_scene",
    "sample_texture",
]
