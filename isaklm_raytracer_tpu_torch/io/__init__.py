from isaklm_raytracer_tpu_torch.io.png import load_image, save_png

__all__ = ["load_image", "save_png"]
