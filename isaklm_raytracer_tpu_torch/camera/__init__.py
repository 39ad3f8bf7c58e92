from isaklm_raytracer_tpu_torch.camera.camera import Camera, generate_rays

__all__ = ["Camera", "generate_rays"]
