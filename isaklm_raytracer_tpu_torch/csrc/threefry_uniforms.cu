// Counter-mode Threefry-2x32 sampler for Hopper (sm_90a): n uniform
// variates a ray in one pass.
//
// Replaces no Pallas kernel. It computes `uniforms`
// (isaklm_raytracer_tpu/math/rng.py:72), which XLA fuses into one loop a
// call, with that function's contract: row 2p and 2p + 1 of the (n, R)
// float32 output are the two words of the 20-round Threefry-2x32 of the
// counter (w0, w1) = (pixel id mod 2^32, stream * 64 + p) under the key
// (k0, k1), each word's 24 high bits times 2^-24; an odd n drops the last
// pair's second word. It equals the plain version (math/rng.py
// uniforms_plain) bit for bit: every step is an exact 32-bit integer
// operation, a 24-bit integer converts to float32 exactly, and the product
// by a power of two is exact.
//
// What bounds it on the H100: at the main path's 262,144 rays and n = 9 it
// writes 9.4 MB and reads 1 MB of ids, 3.1 us at the HBM rate. Each
// counter pair takes 20 funnel-shift rotations and 20 xors, which only the
// SMs' ALU pipe issues (64 lanes a clock), and each word a shift before
// its conversion: about 3.2 us of ALU issue at n = 9. The adds may go to
// the ALU or, as IMAD, to the FMA pipe. So it is bound by the ALU pipe and
// the bytes about equally. The design: one thread a ray, the rounds in
// registers (each rotation one funnel shift), the ray's id read once, and
// the rows written so that the threads of a warp store neighbouring words
// of one row. The main path's two draws (n = 9 a bounce, n = 4 the camera)
// are instantiations with n fixed, so the pair loop unrolls and a ray's
// pairs, independent chains of 20 rounds, overlap; other n take the loop.
//
// The key words come by value (Python ints, eager calls) or from a (2,)
// int64 device tensor read when the kernel runs (a CUDA graph replays with
// the key of its inputs, not one baked in at capture).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSamplerThreads = 256;  // rays a block
constexpr uint32_t kParity = 0x1BD11BDAu;  // Threefry's key schedule constant

__device__ __forceinline__ void mix4(uint32_t& x0, uint32_t& x1, int r0, int r1, int r2,
                                     int r3) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, r0) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r1) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r2) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, r3) ^ x0;
}

__device__ __forceinline__ float to_unit(uint32_t bits) {
  return static_cast<float>(bits >> 8) * 0x1p-24f;
}

// The pair p of a ray: rows 2p and 2p + 1 (the second only if `second`).
__device__ __forceinline__ void draw_pair(uint32_t x0, uint32_t x1, uint32_t k0, uint32_t k1,
                                          uint32_t k2, float* row, int64_t stride, int p,
                                          bool second) {
  mix4(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  mix4(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  mix4(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  mix4(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  mix4(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
  row[(2 * p) * stride] = to_unit(x0);
  if (second) row[(2 * p + 1) * stride] = to_unit(x1);
}

// ids: int32 (id_bytes 4) or int64 (id_bytes 8); the counter word is the
// id's low 32 bits, as the plain version's int64 & 0xFFFFFFFF. kN > 0: n
// is kN (the pair loop unrolls); kN == 0: n is `n`.
template <int kN>
__global__ void __launch_bounds__(kSamplerThreads)
threefry_uniforms_kernel(const void* __restrict__ ids, int id_bytes, int num_rays,
                         const int64_t* __restrict__ key, uint32_t k0, uint32_t k1,
                         uint32_t w1_base, int n, float* __restrict__ out) {
  const int r = blockIdx.x * kSamplerThreads + threadIdx.x;
  if (r >= num_rays) return;
  if (key != nullptr) {
    k0 = static_cast<uint32_t>(__ldg(key));
    k1 = static_cast<uint32_t>(__ldg(key + 1));
  }
  const uint32_t w0 = id_bytes == 8
      ? static_cast<uint32_t>(__ldg(static_cast<const int64_t*>(ids) + r))
      : static_cast<uint32_t>(__ldg(static_cast<const int32_t*>(ids) + r));
  const uint32_t k2 = kParity ^ k0 ^ k1;
  const uint32_t x0 = w0 + k0, x1 = w1_base + k1;
  const int64_t stride = num_rays;
  float* row = out + r;
  if constexpr (kN > 0) {
#pragma unroll
    for (int p = 0; 2 * p < kN; ++p)
      draw_pair(x0, x1 + static_cast<uint32_t>(p), k0, k1, k2, row, stride, p, 2 * p + 1 < kN);
  } else {
    for (int p = 0; 2 * p < n; ++p)
      draw_pair(x0, x1 + static_cast<uint32_t>(p), k0, k1, k2, row, stride, p, 2 * p + 1 < n);
  }
}

template <int kN>
void launch(const dim3& grid, cudaStream_t stream, const void* ids, int id_bytes, int num_rays,
            const int64_t* key, uint32_t k0, uint32_t k1, uint32_t w1_base, int n, float* out) {
  threefry_uniforms_kernel<kN><<<grid, kSamplerThreads, 0, stream>>>(
      ids, id_bytes, num_rays, key, k0, k1, w1_base, n, out);
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError()
// (0 = launched). `key` is a (2,) int64 device tensor's data or null, in
// which case k0 and k1 are the key words. Allocates nothing and does not
// synchronise.
extern "C" int threefry_uniforms(int device, const void* ids, int id_bytes, int num_rays,
                                 const int64_t* key, unsigned int k0, unsigned int k1,
                                 unsigned int w1_base, int n, float* out, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (num_rays > 0 && n > 0) {
    const dim3 grid((num_rays + kSamplerThreads - 1) / kSamplerThreads);
    const auto stream_ = static_cast<cudaStream_t>(stream);
    if (n == 9) {  // a bounce's draw
      launch<9>(grid, stream_, ids, id_bytes, num_rays, key, k0, k1, w1_base, n, out);
    } else if (n == 4) {  // the camera's
      launch<4>(grid, stream_, ids, id_bytes, num_rays, key, k0, k1, w1_base, n, out);
    } else {
      launch<0>(grid, stream_, ids, id_bytes, num_rays, key, k0, k1, w1_base, n, out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
