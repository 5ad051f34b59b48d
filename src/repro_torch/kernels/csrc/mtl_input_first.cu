// Input-first multi-table gather: the paper's Fig.-11 strawman.
//
// Replaces src/repro/kernels/multi_table_lookup.py:510 `mtl_input_first`,
// the Pallas kernel whose grid walks (sample, field) in input-sample-major
// order and writes each looked-up row into a field-major (k, b, d) output,
// after which a transpose restores (b, k*d).
//
// Bound on an H100: bytes, as for the output-first gather (K1): b*k ids,
// k offsets and the distinct rows read once, the (k, b, d) output written
// once. The strawman does not come near it on purpose: its work is laid out
// by input, not by output.
//
// Design: what the paper's input-first allocation does on a GPU -- one
// thread per input id, threads in input-sample-major order (thread p serves
// sample p / k, field p % k). Each thread adds its field's offset, clamps
// the row into [0, n_rows) like K1, and copies the row's d floats one by
// one into out[f, s, :]. A warp's 32 threads thus read 32 different table
// rows and write 32 rows that lie b*d floats apart, so no load or store of
// a warp is one coalesced segment -- the cost Fig. 11 measures against the
// output-first K1, where a warp's stores are one contiguous run. The
// (k, b, d) -> (b, k*d) transpose is a separate PyTorch copy, as it is a
// separate XLA op in the reference. Every output float is a copy of a table
// float, so the result is bitwise K1's.

#include <cstdint>
#include <cuda_runtime.h>

template <typename Index>
__global__ void mtl_input_first_kernel(const int32_t* __restrict__ ids,
                                       const int32_t* __restrict__ offsets,
                                       const float* __restrict__ table,
                                       float* __restrict__ out, Index b,
                                       Index k, Index d, int64_t n_rows) {
  const Index pairs = b * k;
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index p = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < pairs; p += stride) {
    const Index s = p / k;
    const Index f = p - s * k;
    int64_t r = static_cast<int64_t>(__ldg(ids + p)) +
                static_cast<int64_t>(__ldg(offsets + f));
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    const float* src = table + r * static_cast<int64_t>(d);
    float* dst = out + (static_cast<int64_t>(f) * b + s) * d;
    for (Index e = 0; e < d; ++e) dst[e] = __ldg(src + e);
  }
}

extern "C" int mtl_input_first(const void* ids, const void* offsets,
                               const void* table, void* out, int64_t b,
                               int64_t k, int64_t d, int64_t n_rows,
                               void* stream) {
  const int64_t pairs = b * k;
  if (pairs == 0 || d == 0) return 0;
  const int threads = 256;
  int64_t blocks = (pairs + threads - 1) / threads;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;  // grid-stride
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int32_t*>(ids);
  auto o = static_cast<const int32_t*>(offsets);
  auto t = static_cast<const float*>(table);
  auto y = static_cast<float*>(out);
  if (pairs < (int64_t{1} << 31) - int64_t{threads} * blocks) {
    mtl_input_first_kernel<int32_t><<<static_cast<unsigned>(blocks), threads,
                                      0, s>>>(i, o, t, y,
                                              static_cast<int32_t>(b),
                                              static_cast<int32_t>(k),
                                              static_cast<int32_t>(d), n_rows);
  } else {
    mtl_input_first_kernel<int64_t><<<static_cast<unsigned>(blocks), threads,
                                      0, s>>>(i, o, t, y, b, k, d, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
