"""Port parity: the counter-mode Threefry sampler, bit for bit.

Inputs are made with numpy from a seed and go through both packages.
Tolerance: none -- uniforms and key words must be bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isaklm_raytracer_tpu.integrator.render import sample_key_data
from isaklm_raytracer_tpu.math import rng as jrng
from isaklm_raytracer_tpu_torch.math import rng as prng

torch.set_num_threads(1)  # the test workers share the host's cores


def test_threefry_words_bit_exact():
    r = np.random.default_rng(0)
    k0, k1 = (int(x) for x in r.integers(0, 2**32, 2))
    x0, x1 = (r.integers(0, 2**32, 4096).astype(np.uint32) for _ in range(2))
    ja, jb = jrng.threefry2x32(
        jnp.uint32(k0), jnp.uint32(k1), jnp.asarray(x0), jnp.asarray(x1)
    )
    pa, pb = prng.threefry2x32(
        k0, k1, torch.from_numpy(x0.astype(np.int64)), torch.from_numpy(x1.astype(np.int64))
    )
    np.testing.assert_array_equal(np.asarray(ja).astype(np.int64), pa.numpy())
    np.testing.assert_array_equal(np.asarray(jb).astype(np.int64), pb.numpy())


@pytest.mark.parametrize("stream,n", [(0, 9), (3, 9), (prng.CAMERA_STREAM, 4), (7, 5)])
def test_uniforms_bit_exact(stream, n):
    r = np.random.default_rng(stream)
    key = tuple(int(x) for x in r.integers(0, 2**32, 2))
    ids = r.integers(0, 1920 * 1080, 3000).astype(np.int32)
    want = np.asarray(
        jrng.uniforms(jnp.asarray(key, jnp.uint32), jnp.asarray(ids), stream, n)
    )
    got = prng.uniforms(key, torch.from_numpy(ids), stream, n).numpy()
    assert got.dtype == np.float32 and got.shape == (n, ids.size)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 11, 2**31 + 7, 2**32 - 1])
def test_sample_key_words_match_fold_in(seed):
    base = jax.random.PRNGKey(seed)
    for i in (0, 1, 3, 1000, 2**31 + 5):
        want = tuple(int(x) for x in np.asarray(sample_key_data(jax.random.fold_in(base, i))))
        assert prng.sample_key_words(seed, i) == want


def test_uniforms_rejects_overflowing_streams():
    ids = torch.arange(4)
    with pytest.raises(ValueError):
        prng.uniforms((1, 2), ids, 0, 129)
    with pytest.raises(ValueError):
        prng.uniforms((1, 2), ids, 256, 2)
