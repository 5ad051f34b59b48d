// Fused factorization-machine second-order term (DeepFM, C5).
//
// Replaces src/repro/kernels/fused_fm.py:31 `fused_fm_second_order` (its
// pallas_call at :44), the Pallas kernel that keeps a (bm, k, d) tile in
// VMEM and emits (bm, 1).
//
//   out[b] = 0.5 * sum_d [ (sum_k v[b,k,d])^2 - sum_k v[b,k,d]^2 ]
//
// Bound on an H100: bytes. It reads b*k*d floats once and writes b floats,
// with about four fp32 operations per float read: 5.11 MB, 1.53 us at
// b = 1024, k = 39, d = 32 (0.38 us at b = 256). At those sizes the launch
// and the round trips to device memory take longer than the bytes, so the
// design spends one round trip a row.
//
// Design: a warp a batch row. A group of `lanes` lanes (the power of two
// up to 32 that covers the pieces of a field's row) covers one field's row
// of d floats, a lane a piece of 4 floats copied as one 16-byte word where
// d % 4 == 0 and v is 16-byte aligned, else a piece of one float. The
// warp's 32 / lanes groups take fields g, g + groups, ...: at d = 32 that
// is 8 lanes a field and 4 fields at a time, so 10 pieces a lane cover a
// row of k = 39 fields. A lane issues the copies of up to kChunk fields
// (which covers such a row) before it sums any of them: cp.async into its
// own slots of the block's shared memory, one wait, then the sums from
// there. Loading into registers instead, ptxas interleaved each load with
// the sums of the one before, so at most two loads of a lane were in
// flight and a row took five round trips to device memory (5.31 us at
// b = 256 on an H100, 3.60 with cp.async). Sum v and sum v^2 of the
// piece's columns stay in registers. Shuffles across the groups (xor over the group bits) give
// every lane its columns' totals; the lane forms sum_e (s_e^2 - sq_e) over
// its piece, shuffles across the group's lanes give the row's sum, and
// lane 0 writes 0.5 * acc. Past 128 floats a row (32 one-float pieces) the
// group is the whole warp and a lane takes several pieces. A lane past the
// row's last piece, or a group past the last field, copies nothing (its
// slot is zero-filled) and adds exactly 0. The lanes and the block size
// come from the wrapper (fused_fm.py, `fm_launch`), and the entry checks
// them before it launches. The design it replaced (a lane a column walking
// the k fields as a chain of dependent loads, 8 rows a block) took 8.15 us
// at b = 1024 and 7.55 at b = 256 on an H100: latency, not bytes.
//
// Numerics: the sums run in another order than torch.sum's, so the kernel
// is held against the plain version at a tolerance (rtol = atol = 1e-5),
// not bitwise. A NaN or inf in a row makes that row's result NaN (an inf
// column gives inf - inf), as in the plain version; no other row reads it.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;   // fields a lane copies before it sums them

// Bytes of shared memory a block of `threads` stages: a 16-byte slot per
// lane and field of a chunk (a one-float piece uses the slot's first float).
constexpr int64_t stage_bytes(int64_t threads) {
  return threads * kChunk * 16;
}

// Copy V floats (4: one 16-byte word; 1) from global p to shared dst, or
// zero-fill them where !ok (nothing is read).
template <int V>
__device__ __forceinline__ void copy_async(float4* dst, const float* p,
                                           bool ok) {
  const auto s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (V == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(p), "r"(ok ? 16 : 0) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(p), "r"(ok ? 4 : 0) : "memory");
  }
}

// V floats a piece (4: one 16-byte word; 1); 2^lane_bits lanes a field.
template <int V>
__global__ void __launch_bounds__(256)
fm_second_order_kernel(const float* __restrict__ v, float* __restrict__ out,
                       int64_t b, int64_t k, int64_t d, int lane_bits) {
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ float4 stage[];   // [warp of the block][kChunk][lane]
  const int lanes = 1 << lane_bits;
  const int lane = threadIdx.x & 31;
  const int l = lane & (lanes - 1);
  const int64_t g = lane >> lane_bits;
  const int64_t groups = 32 >> lane_bits;
  const int64_t pieces = d / V;
  float4* const slots = stage + (threadIdx.x >> 5) * kChunk * 32 + lane;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps =
      (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t row = warp; row < b; row += warps) {       // warp-uniform
    const float* vr = v + row * k * d;
    float acc = 0.0f;
    for (int64_t w0 = 0; w0 < pieces; w0 += lanes) {      // warp-uniform
      const int64_t w = w0 + l;
      const bool in = w < pieces;
      float s[V] = {};
      float sq[V] = {};
      for (int64_t f0 = g; f0 < k; f0 += kChunk * groups) {
        // every copy of the chunk first, then one wait
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int64_t f = f0 + c * groups;
          const bool ok = in && f < k;
          copy_async<V>(slots + c * 32, ok ? vr + f * d + w * V : vr, ok);
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const float4 q = slots[c * 32];
          const float x[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
          for (int e = 0; e < V; ++e) {
            s[e] += x[e];
            sq[e] = fmaf(x[e], x[e], sq[e]);
          }
        }
      }
      // the columns' totals over the groups, in every group
      for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          s[e] += __shfl_xor_sync(kAll, s[e], off);
          sq[e] += __shfl_xor_sync(kAll, sq[e], off);
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) acc += s[e] * s[e] - sq[e];
    }
    // the row's sum over the group's lanes
    for (int off = 1; off < lanes; off <<= 1) {
      acc += __shfl_xor_sync(kAll, acc, off);
    }
    if (lane == 0) out[row] = 0.5f * acc;
  }
}

// cudaFuncSetAttribute sets the limit on the current device only, so it is
// set once on each device a launch lands on (a mesh's batch shards launch
// on several cards from one process).
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes,
                       std::atomic<int> (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && done[dev].load(std::memory_order_acquire)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && known) done[dev].store(1, std::memory_order_release);
  return e;
}

template <int V>
int launch(const float* v, float* out, int64_t b, int64_t k, int64_t d,
           int lane_bits, int64_t threads, int64_t blocks,
           cudaStream_t stream) {
  static std::atomic<int> smem_set[kMaxDevices];
  const cudaError_t attr =
      allow_smem(fm_second_order_kernel<V>, stage_bytes(256), smem_set);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  fm_second_order_kernel<V><<<static_cast<unsigned>(blocks),
                              static_cast<unsigned>(threads),
                              stage_bytes(threads), stream>>>(
      v, out, b, k, d, lane_bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// v (b, k, d) float32, out (b, 1) float32, both on the device. vec: 4 floats
// a lane as one 16-byte copy (needs d % 4 == 0 and v 16-byte aligned), else
// one float; lane_bits: log2 of the lanes a field (0..5); threads: a
// multiple of 32 up to 256; blocks: 1..2^31-1 (the warps stride over the
// rows past the grid).
extern "C" int fused_fm_second_order(const void* v, void* out, int64_t b,
                                     int64_t k, int64_t d, int64_t vec,
                                     int64_t lane_bits, int64_t threads,
                                     int64_t blocks, void* stream) {
  if (b == 0) return 0;
  if ((vec != 0 && vec != 1) || (vec && d % 4 != 0) || k < 0 || d < 0
      || lane_bits < 0 || lane_bits > 5 || threads < 32 || threads > 256
      || threads % 32 != 0 || blocks < 1 || blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (vec && reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto x = static_cast<const float*>(v);
  auto y = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int lb = static_cast<int>(lane_bits);
  return vec ? launch<4>(x, y, b, k, d, lb, threads, blocks, s)
             : launch<1>(x, y, b, k, d, lb, threads, blocks, s);
}
