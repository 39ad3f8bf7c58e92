"""Port parity: the counter-mode Threefry sampler, bit for bit.

Inputs are made with numpy from a seed and go through both packages.
Tolerance: none -- uniforms and key words must be bit-identical.

``rng.uniforms`` launches the sampler kernel (``csrc/threefry_uniforms.cu``,
``kernels/sampler.py``) on CUDA ids and runs ``rng.uniforms_plain`` on CPU
ids. Here, on the CPU: both against the JAX package's ``uniforms``; the
kernel wrapper's arguments driving a numpy emulation of the CUDA source's
arithmetic; no library built or loaded. The kernel itself needs the card
(the ``cuda`` test; ``python3 chip_smoke.py`` runs it on the card and holds
the kernel to the plain version at the render's shapes).

This module imports JAX only inside the tests that compare with it, so
``chip_smoke.card_test`` can run its cuda test on a machine without JAX.
"""

import ctypes
import subprocess
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from isaklm_raytracer_tpu_torch.kernels import build, sampler
from isaklm_raytracer_tpu_torch.kernels import intersect as ki
from isaklm_raytracer_tpu_torch.math import rng as prng

torch.set_num_threads(1)  # the test workers share the host's cores

NS = (1, 2, 4, 5, 9, 128)
STREAMS = (0, 7, prng.CAMERA_STREAM)
# ids around the counter word's wrap: -1 and 2**31 - 1 in int32; in int64
# also ids of 2**32 and above and below -2**31, which wrap mod 2**32
EDGE_IDS = {
    torch.int32: [0, 1, -1, 2**31 - 1, -(2**31), 262_143],
    torch.int64: [0, -1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 5, 2**40 + 3, -(2**33) - 7],
}


def _jrng():
    from isaklm_raytracer_tpu.math import rng as jrng

    return jrng


def _want(key, ids: np.ndarray, stream: int, n: int) -> np.ndarray:
    """The JAX package's ``uniforms``. JAX runs in 32-bit mode, where the
    counter word is the id's uint32 cast: int32 ids go in as they are,
    int64 ids as their low 32 bits (which is what the port takes)."""
    import jax.numpy as jnp

    if ids.dtype == np.int64:
        ids = (ids & 0xFFFFFFFF).astype(np.uint32)
    out = _jrng().uniforms(jnp.asarray(key, jnp.uint32), jnp.asarray(ids), stream, n)
    return np.asarray(out)


def _ids(r, dtype, size=3000):
    hi = 1920 * 1080 if dtype == torch.int32 else 2**45
    body = r.integers(-hi // 8, hi, size - len(EDGE_IDS[dtype]))
    return np.concatenate([np.asarray(EDGE_IDS[dtype]), body]).astype(
        np.int32 if dtype == torch.int32 else np.int64)


def test_threefry_words_bit_exact():
    import jax.numpy as jnp

    r = np.random.default_rng(0)
    k0, k1 = (int(x) for x in r.integers(0, 2**32, 2))
    x0, x1 = (r.integers(0, 2**32, 4096).astype(np.uint32) for _ in range(2))
    ja, jb = _jrng().threefry2x32(
        jnp.uint32(k0), jnp.uint32(k1), jnp.asarray(x0), jnp.asarray(x1)
    )
    pa, pb = prng.threefry2x32(
        k0, k1, torch.from_numpy(x0.astype(np.int64)), torch.from_numpy(x1.astype(np.int64))
    )
    np.testing.assert_array_equal(np.asarray(ja).astype(np.int64), pa.numpy())
    np.testing.assert_array_equal(np.asarray(jb).astype(np.int64), pb.numpy())


@pytest.mark.parametrize("stream,n", [(0, 9), (3, 9), (prng.CAMERA_STREAM, 4), (7, 5)])
def test_uniforms_bit_exact(stream, n):
    import jax.numpy as jnp

    r = np.random.default_rng(stream)
    key = tuple(int(x) for x in r.integers(0, 2**32, 2))
    ids = r.integers(0, 1920 * 1080, 3000).astype(np.int32)
    want = np.asarray(
        _jrng().uniforms(jnp.asarray(key, jnp.uint32), jnp.asarray(ids), stream, n)
    )
    got = prng.uniforms(key, torch.from_numpy(ids), stream, n).numpy()
    assert got.dtype == np.float32 and got.shape == (n, ids.size)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 11, 2**31 + 7, 2**32 - 1])
def test_sample_key_words_match_fold_in(seed):
    import jax

    from isaklm_raytracer_tpu.integrator.render import sample_key_data

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


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
def test_uniforms_and_plain_bit_exact_with_jax(dtype, n, stream):
    """uniforms and uniforms_plain against the JAX package, key words as
    ints and as a key tensor, ids at the counter word's edges."""
    r = np.random.default_rng([n, stream, dtype.itemsize])
    key = tuple(int(x) for x in r.integers(0, 2**32, 2))
    ids = _ids(r, dtype)
    want = _want(key, ids, stream, n)
    assert want.shape == (n, ids.size)
    t = torch.from_numpy(ids)
    for fn in (prng.uniforms, prng.uniforms_plain):
        for key_words in (key, prng.key_tensor(key)):
            got = fn(key_words, t, stream, n)
            assert got.dtype == torch.float32 and got.shape == (n, ids.size)
            np.testing.assert_array_equal(got.numpy(), want)


@settings(max_examples=25, deadline=None)
@given(
    key=st.tuples(st.integers(0, 2**32 - 1), st.integers(0, 2**32 - 1)),
    ids=st.lists(st.integers(-(2**31), 2**31 - 1), min_size=1, max_size=64),
    stream=st.integers(0, prng.CAMERA_STREAM),
    n=st.integers(1, 2 * 64),
)
def test_uniforms_hypothesis(key, ids, stream, n):
    ids = np.asarray(ids, np.int32)
    want = _want(key, ids, stream, n)
    got = prng.uniforms(prng.key_tensor(key), torch.from_numpy(ids), stream, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fn", [prng.uniforms, prng.uniforms_plain, sampler.threefry_uniforms],
                         ids=["uniforms", "uniforms_plain", "threefry_uniforms"])
@pytest.mark.parametrize("stream,n", [(0, 129), (0, 0), (256, 2), (-1, 2)])
def test_uniforms_value_errors(fn, stream, n):
    with pytest.raises(ValueError):
        fn((1, 2), torch.arange(4, dtype=torch.int32), stream, n)


def test_cpu_ids_run_the_plain_version_and_load_no_library(monkeypatch):
    """On CPU ids uniforms runs uniforms_plain: nothing is built, no
    library is loaded, no kernel counted."""
    def refuse(*args, **kwargs):
        raise AssertionError("a library was built or loaded on the CPU")

    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(ctypes, "CDLL", refuse)
    plain_calls = []
    real_plain = prng.uniforms_plain

    def counting_plain(*args):
        plain_calls.append(args)
        return real_plain(*args)

    monkeypatch.setattr(prng, "uniforms_plain", counting_plain)
    ki.COUNTS.reset()
    ids = torch.arange(257, dtype=torch.int32)
    assert torch.equal(prng.uniforms((3, 4), ids, 1, 9), real_plain((3, 4), ids, 1, 9))
    assert len(plain_calls) == 1
    assert ki.COUNTS.sampler_kernel == ki.COUNTS.sampler_plain_cuda == 0


def test_rng_imports_the_kernel_module_only_for_cuda_ids():
    code = (
        "import sys, torch\n"
        "from isaklm_raytracer_tpu_torch.math import rng\n"
        "rng.uniforms((1, 2), torch.arange(8), 0, 9)\n"
        "print('isaklm_raytracer_tpu_torch.kernels.sampler' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300)
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("n", [1, 4, 9])
def test_no_rays_give_an_empty_draw(n):
    ids = torch.zeros((0,), dtype=torch.int32)
    for fn in (prng.uniforms, prng.uniforms_plain):
        for key_words in ((5, 6), prng.key_tensor((5, 6))):
            out = fn(key_words, ids, 3, n)
            assert out.shape == (n, 0) and out.dtype == torch.float32
    _, _, out, args = sampler.kernel_args((5, 6), ids, 3, n)
    assert out.shape == (n, 0) and args[2] == 0


def _emulated_kernel(ids_ptr, id_bytes, num_rays, key_ptr, k0, k1, w1_base, n, out_ptr):
    """csrc/threefry_uniforms.cu's kernel in numpy uint32, reading and
    writing the memory its arguments point to (CPU tensors here)."""
    c_id = ctypes.c_int64 if id_bytes == 8 else ctypes.c_int32
    ids = np.ctypeslib.as_array((c_id * num_rays).from_address(ids_ptr))
    if key_ptr is not None:
        k0, k1 = np.ctypeslib.as_array((ctypes.c_int64 * 2).from_address(key_ptr))
    out = np.ctypeslib.as_array((ctypes.c_float * (n * num_rays)).from_address(out_ptr))
    k0, k1 = np.uint32(k0 & 0xFFFFFFFF), np.uint32(k1 & 0xFFFFFFFF)
    k2 = np.uint32(0x1BD11BDA) ^ k0 ^ k1
    w0 = ids.astype(np.uint32)  # the id's low 32 bits

    def rotl(x, r):
        return (x << np.uint32(r)) | (x >> np.uint32(32 - r))

    def mix4(x0, x1, rots):
        for r in rots:
            x0 = x0 + x1
            x1 = rotl(x1, r) ^ x0
        return x0, x1

    ra, rb = (13, 15, 26, 6), (17, 29, 16, 24)
    rows = out.reshape(n, num_rays)
    with np.errstate(over="ignore"):
        for p in range(-(-n // 2)):
            x0 = w0 + k0
            x1 = np.full_like(w0, w1_base + p) + k1
            x0, x1 = mix4(x0, x1, ra)
            x0, x1 = x0 + k1, x1 + k2 + np.uint32(1)
            x0, x1 = mix4(x0, x1, rb)
            x0, x1 = x0 + k2, x1 + k0 + np.uint32(2)
            x0, x1 = mix4(x0, x1, ra)
            x0, x1 = x0 + k0, x1 + k1 + np.uint32(3)
            x0, x1 = mix4(x0, x1, rb)
            x0, x1 = x0 + k1, x1 + k2 + np.uint32(4)
            x0, x1 = mix4(x0, x1, ra)
            x0, x1 = x0 + k2, x1 + k0 + np.uint32(5)
            for row, bits in ((2 * p, x0), (2 * p + 1, x1)):
                if row < n:
                    rows[row] = (bits >> np.uint32(8)).astype(np.float32) * np.float32(2.0**-24)


@pytest.mark.parametrize("ids_kind", ["int32", "int64", "int16", "strided int64", "(2, R) int32"])
@pytest.mark.parametrize("key_kind", ["ints", "key_tensor", "int32 tensor"])
def test_kernel_args_drive_the_kernel_arithmetic(ids_kind, key_kind):
    """The wrapper's launch arguments (``kernel_args``), handed to a numpy
    emulation of the CUDA kernel, give uniforms_plain's bits: ids of every
    dtype and layout, keys as ints and tensors (the card is not needed to
    check what the wrapper passes)."""
    r = np.random.default_rng(len(ids_kind) * 7 + len(key_kind))
    key = (int(r.integers(0, 2**32)), int(r.integers(0, 2**32)))
    base = torch.from_numpy(r.integers(-(2**40), 2**40, 2 * 515))
    ids = {"int32": base[:515].to(torch.int32), "int64": base[:515],
           "int16": base[:515].to(torch.int16), "strided int64": base[::2],
           "(2, R) int32": base[:514].to(torch.int32).reshape(2, 257)}[ids_kind]
    key_words = {"ints": key, "key_tensor": prng.key_tensor(key),
                 "int32 tensor": prng.key_tensor(key).to(torch.int32)}[key_kind]
    for stream, n in ((0, 9), (prng.CAMERA_STREAM, 4), (200, 7)):
        flat, key_t, out, args = sampler.kernel_args(key_words, ids, stream, n)
        assert flat.is_contiguous() and flat.dtype in (torch.int32, torch.int64)
        assert (key_t is None) == (key_kind == "ints")
        _emulated_kernel(*args)
        want = prng.uniforms_plain(key_words, ids, stream, n)
        np.testing.assert_array_equal(out.reshape(n, *ids.shape).numpy(), want.numpy())


def test_kernel_wrapper_refuses_cpu_ids_a_key_elsewhere_or_not_two_words():
    ids = torch.arange(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        sampler.threefry_uniforms((1, 2), ids, 0, 2)
    with pytest.raises(ValueError):
        sampler.kernel_args(torch.zeros(2, dtype=torch.int64, device="meta"), ids, 0, 2)
    with pytest.raises(ValueError):
        sampler.kernel_args(torch.zeros(3, dtype=torch.int64), ids, 0, 2)


@pytest.mark.cuda
def test_cuda_sampler_kernel_equals_plain():
    """On the card: the kernel (``uniforms``) equals ``uniforms_plain`` bit
    for bit for int32 and int64 ids at the counter word's edges, every n of
    NS, streams 0, 7 and 255, keys as ints and as a key tensor, ray counts
    around the kernel's block, an empty and a strided draw; a key on
    another device raises; a CUDA graph captured with a key tensor draws
    each replay's key."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    r = np.random.default_rng(12)
    for dtype in (torch.int32, torch.int64):
        for size in (1, 257, 65_537):
            ids = torch.from_numpy(_ids(r, dtype, max(size, len(EDGE_IDS[dtype])))[:size]).to(dev)
            key = tuple(int(x) for x in r.integers(0, 2**32, 2))
            for stream in STREAMS:
                for n in NS:
                    for key_words in (key, prng.key_tensor(key, dev)):
                        ki.COUNTS.reset()
                        got = prng.uniforms(key_words, ids, stream, n)
                        assert ki.COUNTS.sampler_kernel == 1
                        assert ki.COUNTS.sampler_plain_cuda == 0
                        want = prng.uniforms_plain(key_words, ids, stream, n)
                        assert got.shape == (n, size) and got.dtype == torch.float32
                        assert torch.equal(got, want), (dtype, size, stream, n)
    ids = torch.arange(0, 1000, dtype=torch.int64, device=dev)[::3]
    assert torch.equal(prng.uniforms((1, 2), ids, 5, 9), prng.uniforms_plain((1, 2), ids, 5, 9))
    ki.COUNTS.reset()
    assert prng.uniforms((1, 2), ids[:0], 5, 9).shape == (9, 0)
    assert ki.COUNTS.sampler_kernel == 0
    with pytest.raises(ValueError):
        prng.uniforms(prng.key_tensor((1, 2)), ids, 5, 9)
    # a captured draw reads the key tensor at every replay
    ids = torch.arange(262_144, dtype=torch.int32, device=dev)
    key_t = prng.key_tensor((7, 8), dev)
    prng.uniforms(key_t, ids, 3, 9)  # warm: the library is loaded
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        drawn = prng.uniforms(key_t, ids, 3, 9)
    for key in ((7, 8), (2**32 - 1, 12345), (0, 0)):
        key_t.copy_(prng.key_tensor(key, dev))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(drawn, prng.uniforms_plain(key, ids, 3, 9)), key
