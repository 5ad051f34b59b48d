// Fused factorization-machine second-order term (DeepFM, C5).
//
// Replaces src/repro/kernels/fused_fm.py:31 `fused_fm_second_order`, the
// Pallas kernel that keeps a (bm, k, d) tile in VMEM and emits (bm, 1).
//
//   out[b] = 0.5 * sum_d [ (sum_k v[b,k,d])^2 - sum_k v[b,k,d]^2 ]
//
// Bound on an H100: bytes. It reads b*k*d floats once and writes b floats,
// with about four fp32 operations per float read.
//
// Design: one warp per batch row, eight rows per block. Lane e walks the k
// fields of embedding column e (and e+32, ... when d > 32), so at each field
// a warp reads one contiguous row of d floats; sum_k v and sum_k v^2 stay in
// registers, v is read exactly once and no (b, d) intermediate is written.
// A shuffle reduction over the warp sums the d columns. The summation order
// differs from torch.sum's, so the result is held against the plain version
// at a tolerance, not bitwise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {
constexpr int kRowsPerBlock = 8;
}

__global__ void fm_second_order_kernel(const float* __restrict__ v,
                                       float* __restrict__ out, int64_t b,
                                       int64_t k, int64_t d) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  if (row >= b) return;  // whole warp leaves together
  const float* vr = v + row * k * d;
  float acc = 0.0f;
  for (int64_t e = lane; e < d; e += 32) {
    float s = 0.0f;
    float sq = 0.0f;
    for (int64_t i = 0; i < k; ++i) {
      const float x = __ldg(vr + i * d + e);
      s += x;
      sq = fmaf(x, x, sq);
    }
    acc += s * s - sq;
  }
  for (int offset = 16; offset > 0; offset >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, offset);
  }
  if (lane == 0) out[row] = 0.5f * acc;
}

extern "C" int fused_fm_second_order(const void* v, void* out, int64_t b,
                                     int64_t k, int64_t d, void* stream) {
  if (b == 0) return 0;
  const int64_t blocks = (b + kRowsPerBlock - 1) / kRowsPerBlock;
  fm_second_order_kernel<<<static_cast<unsigned>(blocks), kRowsPerBlock * 32,
                           0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<float*>(out), b, k, d);
  return static_cast<int>(cudaGetLastError());
}
