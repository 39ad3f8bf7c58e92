"""PyTorch + CUDA port of the wavefront path tracer in ``isaklm_raytracer_tpu``.

The JAX package stays the reference. This package mirrors its layout module
for module, uses plain functions on tensors with an explicit ``device``, and
replaces each Pallas kernel on its path with a CUDA C++ kernel for Hopper
(``csrc/``, built with nvcc at first use). On a CPU tensor a kernel wrapper
runs the kernel's plain PyTorch version; on a CUDA tensor it launches the
kernel or raises -- there is no fallback.

This package imports torch and numpy, never jax or flax.
"""

__version__ = "0.1.0"

import torch as _torch

# Rendering is cancellation-sensitive (plane offsets minus origin dots,
# barycentric denominators). The JAX package forces full-f32 contractions
# ("highest" matmul precision); the CUDA equivalent is to keep TF32 off for
# matmuls and cuDNN.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from isaklm_raytracer_tpu_torch.config import RenderConfig  # noqa: E402

__all__ = ["RenderConfig", "__version__"]
