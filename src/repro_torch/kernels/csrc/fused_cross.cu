// Fused elementwise tails of the DCN / DCNv2 cross layers (C5).
//
// Replaces src/repro/kernels/fused_cross.py:26 `fused_cross_v2` and
// src/repro/kernels/fused_cross.py:48 `fused_cross_v1`, the Pallas kernels
// that run the post-GEMM chain of a cross layer in one VMEM pass.
//
//   cross_v2:  out = x0 * xw_plus + x                    (all (b, D))
//   cross_v1:  out = x0 * xlw + bias + x    (xlw (b, 1), bias (D,))
//
// Bound on an H100: bytes. Each output element costs two or three fp32
// operations against 16 bytes moved, far below the card's ratio of
// operations to bytes, so the least time is (inputs + output) / memory rate.
//
// Design: one pass, one thread per element, consecutive threads on
// consecutive addresses, each input read once and the output written once —
// the unfused chain would write and re-read an intermediate per operation.
// The arithmetic uses __fmul_rn / __fadd_rn in the order the plain PyTorch
// ops round ((x0*xw)+x and ((x0*xlw)+bias)+x), which keeps nvcc from
// contracting them into an FMA, so the kernel is bitwise equal to the plain
// version and to the unfused graph.

#include <cstdint>
#include <cuda_runtime.h>

template <typename Index>
__global__ void cross_v2_kernel(const float* __restrict__ x0,
                                const float* __restrict__ xw,
                                const float* __restrict__ x,
                                float* __restrict__ out, Index n) {
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index i = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = __fadd_rn(__fmul_rn(x0[i], xw[i]), x[i]);
  }
}

template <typename Index>
__global__ void cross_v1_kernel(const float* __restrict__ x0,
                                const float* __restrict__ xlw,
                                const float* __restrict__ bias,
                                const float* __restrict__ x,
                                float* __restrict__ out, Index b, Index dim) {
  const Index n = b * dim;
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index i = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const Index row = i / dim;
    const Index col = i - row * dim;
    out[i] = __fadd_rn(__fadd_rn(__fmul_rn(x0[i], __ldg(xlw + row)),
                                 __ldg(bias + col)),
                       x[i]);
  }
}

namespace {
constexpr int kThreads = 256;

int64_t grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return blocks > (int64_t{1} << 20) ? (int64_t{1} << 20) : blocks;
}

bool fits_int32(int64_t n, int64_t blocks) {
  return n < (int64_t{1} << 31) - int64_t{kThreads} * blocks;
}
}  // namespace

extern "C" int fused_cross_v2(const void* x0, const void* xw, const void* x,
                              void* out, int64_t b, int64_t dim,
                              void* stream) {
  const int64_t n = b * dim;
  if (n == 0) return 0;
  const int64_t blocks = grid_for(n);
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(x0);
  auto w = static_cast<const float*>(xw);
  auto r = static_cast<const float*>(x);
  auto y = static_cast<float*>(out);
  if (fits_int32(n, blocks)) {
    cross_v2_kernel<int32_t><<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(a, w, r, y, static_cast<int32_t>(n));
  } else {
    cross_v2_kernel<int64_t><<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(a, w, r, y, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_cross_v1(const void* x0, const void* xlw,
                              const void* bias, const void* x, void* out,
                              int64_t b, int64_t dim, void* stream) {
  const int64_t n = b * dim;
  if (n == 0) return 0;
  const int64_t blocks = grid_for(n);
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(x0);
  auto l = static_cast<const float*>(xlw);
  auto c = static_cast<const float*>(bias);
  auto r = static_cast<const float*>(x);
  auto y = static_cast<float*>(out);
  if (fits_int32(n, blocks)) {
    cross_v1_kernel<int32_t><<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(a, l, c, r, y, static_cast<int32_t>(b),
                                    static_cast<int32_t>(dim));
  } else {
    cross_v1_kernel<int64_t><<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(a, l, c, r, y, b, dim);
  }
  return static_cast<int>(cudaGetLastError());
}
