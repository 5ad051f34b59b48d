// One-hot lookup over small, padded per-field tables.
//
// Replaces src/repro/kernels/multi_table_lookup.py:472 `mtl_onehot`, the
// Pallas kernel that, per (batch block, field), builds one_hot(ids) against
// an iota of the field's padded height and multiplies it into the field's
// (n_pad, d) table on the MXU with an fp32 accumulator.
//
//   ids     (b, k)        int32 local ids
//   tables  (k, n_pad, d) float32 or bfloat16, fields padded to one height
//   out     (b, k, d)     the tables' dtype
//
// What the product computes is a gather with one twist: an id outside
// [0, n_pad) matches no iota column and yields a zero row. A one-hot row
// has one nonzero term, so the fp32 sum is that table value exactly (a
// bf16 value widens and narrows back unchanged).
//
// Bound on an H100: bytes -- b*k ids, the stacked tables (a few hundred KB,
// read once) and the b*k*d output. A matmul would spend n_pad multiply-adds
// per output value on zeros; on a card with no MXU to keep busy that is
// pure waste.
//
// Design: the gather, not the matmul. One thread per output element,
// consecutive threads on consecutive output addresses (as K1), a predicated
// zero for an out-of-range id (not a clamp, unlike K1-K6). The stacked
// tables are small enough to stay in L2 across the batch, so every block
// reads them from there. Values are copied as raw 32- or 16-bit words, so
// the kernel is bitwise its plain version. On finite tables that is also
// bitwise a one-hot product, up to the sign of a zero: the product turns a
// table's -0.0 into +0.0, which compares equal.

#include <cstdint>
#include <cuda_runtime.h>

template <typename T, typename Index>
__global__ void mtl_onehot_kernel(const int32_t* __restrict__ ids,
                                  const T* __restrict__ tables,
                                  T* __restrict__ out, Index b, Index k,
                                  Index n_pad, Index d) {
  const Index total = b * k * d;
  const Index row_width = k * d;
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index idx = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const Index row = idx / row_width;
    const Index col = idx - row * row_width;
    const Index f = col / d;
    const Index e = col - f * d;
    const int32_t id = __ldg(ids + row * k + f);
    T v = T(0);
    if (id >= 0 && static_cast<Index>(id) < n_pad) {
      v = __ldg(tables + (static_cast<int64_t>(f) * n_pad + id) *
                             static_cast<int64_t>(d) + e);
    }
    out[idx] = v;
  }
}

template <typename T>
int launch(const void* ids, const void* tables, void* out, int64_t b,
           int64_t k, int64_t n_pad, int64_t d, cudaStream_t s) {
  const int64_t total = b * k * d;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;  // grid-stride
  auto i = static_cast<const int32_t*>(ids);
  auto t = static_cast<const T*>(tables);
  auto y = static_cast<T*>(out);
  if (total < (int64_t{1} << 31) - int64_t{threads} * blocks) {
    mtl_onehot_kernel<T, int32_t><<<static_cast<unsigned>(blocks), threads, 0,
                                    s>>>(i, t, y, static_cast<int32_t>(b),
                                         static_cast<int32_t>(k),
                                         static_cast<int32_t>(n_pad),
                                         static_cast<int32_t>(d));
  } else {
    mtl_onehot_kernel<T, int64_t><<<static_cast<unsigned>(blocks), threads, 0,
                                    s>>>(i, t, y, b, k, n_pad, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// elem_bytes: 4 for float32 tables, 2 for bfloat16 (copied as raw bits)
extern "C" int mtl_onehot(const void* ids, const void* tables, void* out,
                          int64_t b, int64_t k, int64_t n_pad, int64_t d,
                          int64_t elem_bytes, void* stream) {
  if (b * k * d == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) return launch<uint32_t>(ids, tables, out, b, k, n_pad,
                                               d, s);
  if (elem_bytes == 2) return launch<uint16_t>(ids, tables, out, b, k, n_pad,
                                               d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
