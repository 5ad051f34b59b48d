// Per-row symmetric int8 quantizer of the int8 MLP's activations:
//
//   hscale[m] = max(max_k |h[m, k]| / 127, 1e-12)
//   hq[m, k]  = clamp(round_half_even(h[m, k] / hscale[m]), -127, 127)
//
// No TPU kernel: it replaces the reference's jnp quantizer
// (src/repro/quant.py:52 `absmax_scale`, :60 `quantize`, called at
// src/repro/kernels/ops.py:543-544), which XLA fuses into one pass under
// jit. Eager PyTorch runs it as ten ops a layer (full, abs, amax, div,
// clamp_min, to, div, round, clamp_, to), each a dispatch and a launch;
// this is that fusion, one launch a layer.
//
//   h      (M, K) f32   activations, contiguous
//   hq     (M, K) int8  codes (the operand of dense_matmul_q8.cu)
//   hscale (M, 1) f32   per-row scales
//
// Bound on an H100: bytes. It reads 4 M K and writes M K + 4 M bytes:
// 1.91 us at M = 1024, K = 1248 over 3.35 TB/s, 0.48 us at M = 256.
//
// Design: one 128-thread block per row (256 blocks at b = 256, so every
// SM holds several). Rows of up to 2048 floats with K % 4 == 0 and an
// aligned base (the MLP's) are held in registers: each thread issues all
// of its 16-byte loads (4, predicated) before it uses one, so the row costs
// one memory round trip; max|x| is reduced in registers, across each warp
// with shuffles and across the four warps through shared memory, and each
// thread writes four codes as one 32-bit store from the values it holds.
// Any other row streams through a loop that reads it twice (the second
// time from L1).
//
// Why not in the previous op's epilogue: a row's max|x| spans every
// N-tile of the GEMM that produced it, and those tiles are computed by
// different blocks, so the scale would need a grid-wide reduction before
// any code could be written. A separate launch reads the row once more
// from L2 instead.
//
// Numerics: bitwise the plain version (quant.absmax_scale + quant.quantize)
// on finite inputs. The scale is an IEEE division (__fdiv_rn), not a
// multiply by a rounded reciprocal. A code needs only the rounding of
// fl(x / scale), so it is taken from qa = x * rn(1 / scale): for
// |x / scale| <= 127.5 the two differ by less than 3e-5, so wherever qa is
// farther than 0.001 from a half-integer both round to the same integer,
// and everywhere else the code comes from the true division, rounded half
// to even (rintf) as torch.round does. The multiply also keeps zeros --
// half of a ReLU output -- off IEEE division's slow path. The maximum is
// exact in any order. An all-zero row gets the 1e-12 floor and codes of 0.
// Every maximum, the floor included, is PTX max.NaN.f32: a row holding a
// NaN gets a NaN scale and codes of 0, as the plain version's amax and
// clamp_min give (fmaxf would drop the NaN and give the row a finite
// scale). On NaN-free operands it is fmaxf, so finite rows are unchanged.

#include <cstdint>
#include <cuda_runtime.h>

namespace {
constexpr int kThreads = 128;          // one block per row
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                // float4s a thread holds: rows <= 2048
constexpr float kQmax = 127.0f;
constexpr float kScaleEps = 1e-12f;    // quant.SCALE_EPS as fp32
constexpr float kNearHalf = 0.499f;    // |qa - rint(qa)| past this: divide

__device__ __forceinline__ int code(float x, float scale, float rcp) {
  const float qa = __fmul_rn(x, rcp);
  float k = rintf(qa);
  if (fabsf(qa - k) > kNearHalf) k = rintf(__fdiv_rn(x, scale));
  return min(max(static_cast<int>(k), -127), 127);
}

// four codes, little-endian, as one 32-bit word
__device__ __forceinline__ uint32_t codes4(float4 v, float scale, float rcp) {
  const float x[4] = {v.x, v.y, v.z, v.w};
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    word |= static_cast<uint32_t>(static_cast<uint8_t>(code(x[i], scale, rcp)))
            << (8 * i);
  }
  return word;
}

// max(a, b), NaN if either is NaN (fmaxf returns the other operand)
__device__ __forceinline__ float max_nan(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

__device__ __forceinline__ float abs_max4(float4 v) {
  return max_nan(max_nan(fabsf(v.x), fabsf(v.y)),
                 max_nan(fabsf(v.z), fabsf(v.w)));
}

// the row's scale from each thread's partial max|x|; every thread gets it
__device__ __forceinline__ float row_scale(float amax) {
  __shared__ float part[kWarps];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = max_nan(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) amax = max_nan(amax, part[w]);
  return max_nan(__fdiv_rn(amax, kQmax), kScaleEps);
}

// rows of at most kThreads * 4 * kVec floats, K % 4 == 0, 16-byte-aligned
__global__ void __launch_bounds__(kThreads)
quantize_rows_q8_regs(const float* __restrict__ h, int8_t* __restrict__ hq,
                      float* __restrict__ hscale, int64_t K) {
  const int64_t m = blockIdx.x;
  const int t = threadIdx.x;
  const int n4 = static_cast<int>(K / 4);
  const float4* x4 = reinterpret_cast<const float4*>(h + m * K);
  float4 v[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int i = t + kThreads * j;
    v[j] = i < n4 ? x4[i] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) amax = max_nan(amax, abs_max4(v[j]));
  const float scale = row_scale(amax);
  const float rcp = __frcp_rn(scale);
  if (t == 0) hscale[m] = scale;
  uint32_t* q4 = reinterpret_cast<uint32_t*>(hq + m * K);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int i = t + kThreads * j;
    if (i < n4) q4[i] = codes4(v[j], scale, rcp);
  }
}

// any row: two passes over it
__global__ void __launch_bounds__(kThreads)
quantize_rows_q8_kernel(const float* __restrict__ h, int8_t* __restrict__ hq,
                        float* __restrict__ hscale, int64_t K, bool vec) {
  const int64_t m = blockIdx.x;
  const int t = threadIdx.x;
  const float* x = h + m * K;
  int8_t* q = hq + m * K;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float amax = 0.0f;
  if (vec) {
    for (int64_t i = t; i < K / 4; i += kThreads)
      amax = max_nan(amax, abs_max4(x4[i]));
  } else {
    for (int64_t i = t; i < K; i += kThreads)
      amax = max_nan(amax, fabsf(x[i]));
  }
  const float scale = row_scale(amax);
  const float rcp = __frcp_rn(scale);
  if (t == 0) hscale[m] = scale;
  if (vec) {
    uint32_t* q4 = reinterpret_cast<uint32_t*>(q);
    for (int64_t i = t; i < K / 4; i += kThreads)
      q4[i] = codes4(x4[i], scale, rcp);
  } else {
    for (int64_t i = t; i < K; i += kThreads)
      q[i] = static_cast<int8_t>(code(x[i], scale, rcp));
  }
}
}  // namespace

extern "C" int quantize_rows_q8(const void* h, void* hq, void* hscale,
                                int64_t M, int64_t K, void* stream) {
  if (M == 0) return 0;
  if (M > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  // 16-byte loads and 4-byte stores need K % 4 == 0 and aligned bases
  // (the allocator's are)
  const bool vec = (K % 4) == 0 &&
                   (reinterpret_cast<uintptr_t>(h) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(hq) % 4) == 0;
  const auto* x = static_cast<const float*>(h);
  auto* q = static_cast<int8_t*>(hq);
  auto* sc = static_cast<float*>(hscale);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(M);
  if (vec && K <= kThreads * 4 * kVec) {
    quantize_rows_q8_regs<<<grid, kThreads, 0, s>>>(x, q, sc, K);
  } else {
    quantize_rows_q8_kernel<<<grid, kThreads, 0, s>>>(x, q, sc, K, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
