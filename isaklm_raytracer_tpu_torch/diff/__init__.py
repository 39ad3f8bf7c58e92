from isaklm_raytracer_tpu_torch.diff.fd import central_difference, check_grad_vs_fd

__all__ = ["central_difference", "check_grad_vs_fd"]
