// Output-first fused multi-table gather (DPIFrame Alg. 1, C2 + C3).
//
// Replaces src/repro/kernels/multi_table_lookup.py:60 `mtl_gather`, the
// Pallas kernel that copies one (1, d) row per grid step, its row picked by
// a scalar-prefetch index map over precomputed global rows.
//
// Bound on an H100: bytes. The gather reads b*k ids, k offsets and b*k rows
// of d floats, and writes b*k*d floats; it does no arithmetic beyond index
// math, so its least time is those bytes over the card's memory rate.
//
// Design: one thread per output element, consecutive threads on consecutive
// output addresses (output-first), so every warp's stores are one coalesced
// segment, and with d >= 32 a warp's loads are one contiguous table row.
// Each thread finds its field, reads ids[row, f] and adds offsets[f] itself
// (Alg. 1 lines 6-8) instead of a separate pass over the ids. Table offsets
// are 64-bit products, so tables of more than 2^31 floats index exactly; the
// element decomposition runs in 32-bit when the output fits, to keep the
// integer divisions cheap. Nothing assumes a vector per row: d = 1 (the
// wide/FM tables) works like d = 32.
//
// Out-of-range ids: the global row id + offset is clamped into [0, n_rows),
// so a bad id reads some row of the table and never past it. The plain
// PyTorch version clamps the same way, so the two stay bitwise equal.

#include <cstdint>
#include <cuda_runtime.h>

template <typename Index>
__global__ void mtl_gather_kernel(const int32_t* __restrict__ ids,
                                  const int32_t* __restrict__ offsets,
                                  const float* __restrict__ table,
                                  float* __restrict__ out, Index b, Index k,
                                  Index d, int64_t n_rows) {
  const Index total = b * k * d;
  const Index row_width = k * d;
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index idx = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const Index row = idx / row_width;
    const Index col = idx - row * row_width;
    const Index f = col / d;
    const Index e = col - f * d;
    int64_t r = static_cast<int64_t>(__ldg(ids + row * k + f)) +
                static_cast<int64_t>(__ldg(offsets + f));
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    out[idx] = __ldg(table + r * static_cast<int64_t>(d) + e);
  }
}

extern "C" int mtl_gather(const void* ids, const void* offsets,
                          const void* table, void* out, int64_t b, int64_t k,
                          int64_t d, int64_t n_rows, void* stream) {
  const int64_t total = b * k * d;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;  // grid-stride
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int32_t*>(ids);
  auto o = static_cast<const int32_t*>(offsets);
  auto t = static_cast<const float*>(table);
  auto y = static_cast<float*>(out);
  if (total < (int64_t{1} << 31) - int64_t{threads} * blocks) {
    mtl_gather_kernel<int32_t><<<static_cast<unsigned>(blocks), threads, 0,
                                 s>>>(i, o, t, y, static_cast<int32_t>(b),
                                      static_cast<int32_t>(k),
                                      static_cast<int32_t>(d), n_rows);
  } else {
    mtl_gather_kernel<int64_t><<<static_cast<unsigned>(blocks), threads, 0,
                                 s>>>(i, o, t, y, b, k, d, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
