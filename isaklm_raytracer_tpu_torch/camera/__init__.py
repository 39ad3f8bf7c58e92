from isaklm_raytracer_tpu_torch.camera.camera import Camera, camera_movement, generate_rays

__all__ = ["Camera", "camera_movement", "generate_rays"]
