// Quantized dense layer (int8 MLP compute):
//
//   out = relu?( (hq . wq) * hscale * wscale + bias )
//
// Replaces src/repro/kernels/dense_matmul.py:42 `dmm_q8`, the Pallas kernel
// that accumulates int8 x int8 -> int32 on the MXU over one batch block per
// grid step, with the whole weight in VMEM, and dequantizes in the same pass.
//
//   hq     (M, K) int8    per-row quantized activations
//   hscale (M, 1) f32     per-row activation scales
//   wt     (N, K) int8    per-output-channel quantized weights, transposed
//                         once when the graph is built (row n = channel n)
//   wscale (1, N) f32     per-channel weight scales
//   bias   (1, N) f32
//   out    (M, N) f32
//
// Bound on an H100: bytes at the MLP's shapes. At M = 1024, K = 1248,
// N = 1024 the layer moves ~6.8 MB (two int8 operands read once, the fp32
// output written once: ~2.0 us at 3.35 TB/s) against 2.6 G int8 operations
// (~1.3 us at the 1,979 TOP/s dense int8 tensor rate). This first kernel
// runs on the CUDA cores (__dp4a), not the tensor cores, so its own ceiling
// is the dp4a issue rate, far above the bound; wgmma is later work.
//
// Design: a shared-memory tiled GEMM. Each 256-thread block owns a 64 x 64
// output tile and walks K in 64-byte steps; both operands are K-contiguous
// (hence the transposed weight), so one 32-bit word holds 4 consecutive k
// of a row and one __dp4a adds 4 products into an int32 accumulator. Each
// thread keeps 4 x 4 accumulators for rows ty + 16i and columns tx + 16j,
// which with a row stride of 17 words makes every shared-memory read of a
// warp conflict-free. Tiles load 16 bytes a thread when K % 16 == 0 (the
// MLP's widths), else byte by byte; bytes past M, N or K load as zero and
// add nothing, so any shape works, (1, 1, 1) and (33, 7, 5) included.
//
// Numerics: the int32 sum of int8 products is exact in any order (|acc| <=
// 127^2 K < 2^31 for K < 133,000), so the kernel is bitwise its plain
// version. The epilogue is written out with intrinsics as
// fma(round(fp32(acc) * hs), ws, bias) -- the form the reference's jitted
// epilogue compiles to -- so nvcc's --fmad contraction cannot pick another.

#include <cstdint>
#include <cuda_runtime.h>

namespace {
constexpr int kBM = 64;            // output rows per block
constexpr int kBN = 64;            // output columns per block
constexpr int kBK = 64;            // k bytes per tile step
constexpr int kKW = kBK / 4;       // 32-bit words of k per tile row
constexpr int kLD = kKW + 1;       // padded row stride, in words
constexpr int kThreads = 256;      // 16 x 16 threads, 4 x 4 outputs each

// Tile row `r` (of `rows`), bytes [k, k + 16) of a K-contiguous int8
// matrix, as four little-endian words; out-of-range bytes read as zero.
__device__ __forceinline__ void load16(const int8_t* __restrict__ base,
                                       int64_t r, int64_t rows, int64_t k,
                                       int64_t K, bool vec, int32_t* w) {
  if (r < rows && vec && k + 16 <= K) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(base + r * K + k));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t kk = k + 4 * q + j;
      if (r < rows && kk < K) {
        word |= static_cast<uint32_t>(static_cast<uint8_t>(
                    __ldg(base + r * K + kk))) << (8 * j);
      }
    }
    w[q] = static_cast<int32_t>(word);
  }
}

__global__ void __launch_bounds__(kThreads)
dmm_q8_kernel(const int8_t* __restrict__ hq, const float* __restrict__ hscale,
              const int8_t* __restrict__ wt, const float* __restrict__ wscale,
              const float* __restrict__ bias, float* __restrict__ out,
              int64_t M, int64_t N, int64_t K, bool relu, bool vec) {
  __shared__ int32_t As[kBM * kLD];
  __shared__ int32_t Bs[kBN * kLD];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * kBM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * kBN;
  // loader: thread t fills tile row t / 4, words 4 (t % 4) .. 4 (t % 4) + 3
  const int lr = tid / 4;
  const int lw = (tid % 4) * 4;

  int32_t acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int64_t k0 = 0; k0 < K; k0 += kBK) {
    int32_t w[4];
    load16(hq, m0 + lr, M, k0 + 4 * lw, K, vec, w);
#pragma unroll
    for (int q = 0; q < 4; ++q) As[lr * kLD + lw + q] = w[q];
    load16(wt, n0 + lr, N, k0 + 4 * lw, K, vec, w);
#pragma unroll
    for (int q = 0; q < 4; ++q) Bs[lr * kLD + lw + q] = w[q];
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kKW; ++kw) {
      int32_t a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * kLD + kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * kLD + kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float hs = __ldg(hscale + m);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = __fmaf_rn(__fmul_rn(__int2float_rn(acc[i][j]), hs),
                          __ldg(wscale + n), __ldg(bias + n));
      if (relu) v = fmaxf(v, 0.0f);
      out[m * N + n] = v;
    }
  }
}
}  // namespace

extern "C" int dmm_q8(const void* hq, const void* hscale, const void* wt,
                      const void* wscale, const void* bias, void* out,
                      int64_t M, int64_t N, int64_t K, int relu,
                      void* stream) {
  if (M == 0 || N == 0) return 0;
  const int64_t gx = (N + kBN - 1) / kBN;
  const int64_t gy = (M + kBM - 1) / kBM;
  if (gx > 0x7fffffff || gy > 65535) return static_cast<int>(
      cudaErrorInvalidConfiguration);
  // 16-byte tile loads need 16-byte rows (the bases are allocator-aligned)
  const bool vec = (K % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(hq) % 16) == 0 &&
                   (reinterpret_cast<uintptr_t>(wt) % 16) == 0;
  dmm_q8_kernel<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
                  kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(hq), static_cast<const float*>(hscale),
      static_cast<const int8_t*>(wt), static_cast<const float*>(wscale),
      static_cast<const float*>(bias), static_cast<float*>(out), M, N, K,
      relu != 0, vec);
  return static_cast<int>(cudaGetLastError());
}
