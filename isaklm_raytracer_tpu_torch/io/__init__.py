from isaklm_raytracer_tpu_torch.io.png import save_png

__all__ = ["save_png"]
