"""The counter-mode Threefry-2x32 sampler's CUDA kernel and its wrapper.

``threefry_uniforms`` (``csrc/threefry_uniforms.cu``) computes
``math.rng.uniforms`` in one launch: n uniform variates a ray from the
sample's key words, the ray's global pixel id and the stream. The JAX
package computes that function in jnp (``isaklm_raytracer_tpu/math/rng.py``
``uniforms``, one XLA fusion a call; no Pallas kernel); its plain PyTorch
version, one tensor op at a time, is ``math.rng.uniforms_plain``, and the
kernel equals it bit for bit.

``math.rng.uniforms`` calls this wrapper for CUDA ids and the plain
version for CPU ids; it imports this module only for CUDA ids, so nothing
on the CPU loads a library. The kernel launches on the ids' card through
``kernels.intersect``'s route and counts in its ``COUNTS`` (``sampler``).

Key words: Python ints go to the kernel by value; a ``rng.key_tensor``
(2,) tensor on the ids' card is read by the kernel when it runs, so a
captured CUDA graph draws each replay's own sample and the call makes no
host sync and no copy from the host.
"""

from __future__ import annotations

import torch

from isaklm_raytracer_tpu_torch.kernels.intersect import _launch
from isaklm_raytracer_tpu_torch.math import rng

_ID_DTYPES = (torch.int32, torch.int64)


def threefry_uniforms(key_words, pixel_ids: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    """The sampler kernel on CUDA ids (``rng.uniforms`` calls it for them):
    (n, *pixel_ids.shape) float32 uniforms in [0, 1), with the arguments
    and errors of ``rng.uniforms``. Ids of another dtype than int32 or
    int64 are converted to int64, as the plain version does; a key tensor
    must hold two words and lie on the ids' device. CPU ids raise."""
    rng.check_counter(stream, n)
    if not pixel_ids.is_cuda:
        raise ValueError("threefry_uniforms launches a CUDA kernel: CUDA ids expected "
                         "(rng.uniforms runs rng.uniforms_plain on CPU ids)")
    # ids and key stay referenced until the launch: the kernel reads them
    ids, key, out, args = kernel_args(key_words, pixel_ids, stream, n)
    if ids.numel():  # an empty grid is an invalid launch
        _launch("threefry_uniforms", ids, *args)
    return out.reshape(n, *pixel_ids.shape)


def kernel_args(key_words, pixel_ids: torch.Tensor, stream: int, n: int):
    """(ids, key, out, the C entry point's arguments between the device and
    the stream) of a launch on ``pixel_ids``' device: the ids flat and
    contiguous in int32 or int64, the key words' (2,) int64 tensor or None,
    the (n, R) float32 output, and ``ids, id_bytes, num_rays, key (a
    device pointer or None), k0, k1, w1_base, n, out``
    (csrc/threefry_uniforms.cu)."""
    ids = pixel_ids.reshape(-1)
    if ids.dtype not in _ID_DTYPES:
        ids = ids.to(torch.int64)
    ids = ids.contiguous()
    num_rays = ids.shape[0]
    if num_rays >= 2**31:
        raise ValueError(f"{num_rays} ids exceed the kernel's int32 ray count")
    if isinstance(key_words, torch.Tensor):
        if key_words.device != pixel_ids.device:
            raise ValueError(f"key words on {key_words.device}, ids on {pixel_ids.device}")
        if key_words.numel() != 2:
            raise ValueError(f"key words must be two, got shape {tuple(key_words.shape)}")
        key = key_words.reshape(2).to(torch.int64).contiguous()
        key_ptr, k0, k1 = key.data_ptr(), 0, 0
    else:
        key, key_ptr = None, None
        k0, k1 = rng.key_pair(key_words)
    out = torch.empty((n, num_rays), dtype=torch.float32, device=ids.device)
    return ids, key, out, (ids.data_ptr(), ids.element_size(), num_rays, key_ptr, k0, k1,
                           int(rng.counter_base(stream)), int(n), out.data_ptr())
