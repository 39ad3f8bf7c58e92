from isaklm_raytracer_tpu_torch.integrator.bsdf import scatter
from isaklm_raytracer_tpu_torch.integrator.nee import sample_direct_light
from isaklm_raytracer_tpu_torch.integrator.path_trace import trace_paths

__all__ = ["scatter", "sample_direct_light", "trace_paths"]
