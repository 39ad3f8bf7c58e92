"""Counter-mode Threefry-2x32 sampler, bit-exact with the JAX package.

Port of ``isaklm_raytracer_tpu/math/rng.py``. Every variate is a pure
function of (sample key words, global pixel id, stream, dimension), so
images do not depend on chunking, compaction or ray order.

Torch on the CPU cannot add or shift ``uint32`` tensors, so the 32-bit words
live in ``int64`` tensors (or Python ints) and every add and shift is masked
with ``& 0xFFFFFFFF``. The same code therefore runs on Python ints (the
per-sample key words, computed on the host) and on tensors (per-ray words).

The per-sample key words may also be a (2,) int64 tensor on the rays'
device (``key_tensor``). Python ints would be baked into a captured CUDA
graph as constants, so every replay would draw the same sample; the tensor
is a graph input, as the JAX package passes its key into a jitted step.
Both forms give the same bits.

``uniforms`` launches the sampler's CUDA kernel (``kernels/sampler.py``,
``csrc/threefry_uniforms.cu``) on CUDA ids and runs ``uniforms_plain``,
the same function one tensor op at a time, on CPU ids; the two give the
same bits. The kernel's module is imported only for CUDA ids.
"""

from __future__ import annotations

import torch

CAMERA_STREAM = 255
_DIMS_PER_STREAM = 64  # max variate PAIRS per stream
_MASK = 0xFFFFFFFF


def _rotl(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds (Random123).

    Arguments are 32-bit words held in Python ints or int64 tensors with
    values in [0, 2**32); the key words ``k0``, ``k1`` may be the 0-dim
    elements of a ``key_tensor``. Returns two words of the same kind.
    """
    ks0 = k0
    ks1 = k1
    ks2 = 0x1BD11BDA ^ k0 ^ k1
    x0 = (x0 + ks0) & _MASK
    x1 = (x1 + ks1) & _MASK

    def four(x0, x1, rots):
        for r in rots:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        return x0, x1

    ra = (13, 15, 26, 6)
    rb = (17, 29, 16, 24)
    x0, x1 = four(x0, x1, ra)
    x0, x1 = (x0 + ks1) & _MASK, (x1 + ks2 + 1) & _MASK
    x0, x1 = four(x0, x1, rb)
    x0, x1 = (x0 + ks2) & _MASK, (x1 + ks0 + 2) & _MASK
    x0, x1 = four(x0, x1, ra)
    x0, x1 = (x0 + ks0) & _MASK, (x1 + ks1 + 3) & _MASK
    x0, x1 = four(x0, x1, rb)
    x0, x1 = (x0 + ks1) & _MASK, (x1 + ks2 + 4) & _MASK
    x0, x1 = four(x0, x1, ra)
    x0, x1 = (x0 + ks2) & _MASK, (x1 + ks0 + 5) & _MASK
    return x0, x1


def fold_in(key_words, data: int) -> tuple[int, int]:
    """The key words of ``jax.random.fold_in(key, data)`` for a key with
    words ``key_words``: with the default threefry implementation and
    32-bit mode, fold_in hashes the counter ``[0, data mod 2**32]`` under
    the key."""
    k0, k1 = (int(k) & _MASK for k in key_words)
    return threefry2x32(k0, k1, 0, int(data) & _MASK)


def sample_key_words(seed: int, index: int) -> tuple[int, int]:
    """Key words of sample ``index`` of a render seeded with ``seed``: the
    JAX package's ``key_data(fold_in(PRNGKey(seed), index))``, where
    ``PRNGKey(seed)`` has the words ``(0, seed mod 2**32)``."""
    return fold_in((0, seed), index)


def key_tensor(key_words, device=None) -> torch.Tensor:
    """The (2,) int64 tensor form of per-sample key words on ``device``
    (default: the CPU), each word masked to 32 bits."""
    if isinstance(key_words, torch.Tensor):
        return (key_words.to(device=device, dtype=torch.int64) & _MASK).reshape(2)
    k0, k1 = (int(k) & _MASK for k in key_words)
    return torch.tensor([k0, k1], dtype=torch.int64, device=device)


def key_pair(key_words):
    """(k0, k1): Python ints of a pair of ints, 0-dim int64 tensors of a
    (2,) tensor (no host read: the words stay where they are)."""
    if isinstance(key_words, torch.Tensor):
        words = key_words.to(torch.int64) & _MASK
        return words[0], words[1]
    return tuple(int(k) & _MASK for k in key_words)


def _to_unit(bits: torch.Tensor) -> torch.Tensor:
    # 24 high bits -> [0, 1): exact in float32, never returns 1.0.
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def check_counter(stream: int, n: int) -> None:
    """Raise unless ``n`` variates of ``stream`` fit the stream's counter
    words (the JAX package's checks; n < 1 fails there when the empty
    list of rows is stacked)."""
    if n < 1:
        raise ValueError(f"uniforms(n={n}): at least one variate")
    if n > 2 * _DIMS_PER_STREAM:
        raise ValueError(
            f"uniforms(n={n}) exceeds the stream's {2 * _DIMS_PER_STREAM} "
            "variates; counter words would collide with the next stream"
        )
    if not 0 <= stream <= CAMERA_STREAM:
        raise ValueError(f"stream {stream} outside [0, {CAMERA_STREAM}]")


def counter_base(stream: int) -> int:
    """The second counter word of the stream's first pair of variates."""
    return stream * _DIMS_PER_STREAM


def uniforms_plain(key_words, pixel_ids: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    """``uniforms`` one tensor op at a time, on any device: the sampler
    kernel's plain version, bit-exact with the JAX package's ``uniforms``.
    Counts its calls on CUDA ids (``kernels.intersect.COUNTS``)."""
    check_counter(stream, n)
    if pixel_ids.is_cuda:
        from isaklm_raytracer_tpu_torch.kernels.intersect import COUNTS

        COUNTS.sampler_plain_cuda += 1
    k0, k1 = key_pair(key_words)
    w0 = pixel_ids.to(torch.int64) & _MASK
    base = counter_base(stream)
    rows = []
    for p in range(-(-n // 2)):
        w1 = torch.full_like(w0, base + p)
        a, b = threefry2x32(k0, k1, w0, w1)
        rows.append(_to_unit(a))
        rows.append(_to_unit(b))
    return torch.stack(rows[:n])


def uniforms(key_words, pixel_ids: torch.Tensor, stream: int, n: int) -> torch.Tensor:
    """n uniform [0,1) variates per ray: (n, R) float32.

    key_words: the (k0, k1) per-sample key words (``sample_key_words``), or
      their (2,) int64 tensor on ``pixel_ids``' device (``key_tensor``).
    pixel_ids: (R,) GLOBAL pixel/ray ids, the counter word.
    stream: bounce index or CAMERA_STREAM.

    On CUDA ids the sampler kernel (``kernels.sampler.threefry_uniforms``),
    on CPU ids ``uniforms_plain``; both check the stream and n.
    """
    if pixel_ids.is_cuda:
        from isaklm_raytracer_tpu_torch.kernels.sampler import threefry_uniforms

        return threefry_uniforms(key_words, pixel_ids, stream, n)
    return uniforms_plain(key_words, pixel_ids, stream, n)
