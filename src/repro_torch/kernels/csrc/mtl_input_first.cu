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
// the row into [0, n_rows) like K1, and copies the whole row into
// out[f, s, :]. A warp's 32 threads thus read 32 different table rows and
// write 32 rows that lie b*d floats apart, so no load or store of a warp is
// one coalesced segment -- the cost Fig. 11 measures against the
// output-first K1, where a warp's stores are one contiguous run. The
// (k, b, d) -> (b, k*d) transpose is a separate PyTorch copy, as it is a
// separate XLA op in the reference. Every output float is a copy of a table
// float, so the result is bitwise K1's.
//
// What is the port's cost and not the allocation's is removed: a thread
// copies its row in chunks of kChunk words, all of a chunk's loads issued
// before its stores, so a row of d = 32 is 8 16-byte loads in flight and
// d = 60 is 15. A word is a float4 when d % 4 == 0 and the table and the
// output are 16-byte aligned, else a float (d = 1, odd d, or a table view at
// a 4-byte offset: 16 loads in flight a chunk). Blocks are 64 threads (the
// wrapper's `input_first_launch`, multi_table_lookup.py): b = 256 at
// Criteo's k = 39 (9,984 threads) gives 156 blocks, so every one of the 132
// SMs copies rows, where 256-thread blocks left 39 of them at work. On the
// H100 (chip_smoke.py's launch sweep) 64 threads time within 8% of the best
// block size of 32-256 at every shape swept, Fig. 11's and Criteo's; 256
// threads take 29% longer than 64 at b = 256.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;   // words of a row in flight per thread

template <typename Word, typename Index>
__global__ void __launch_bounds__(256)
mtl_input_first_kernel(const int32_t* __restrict__ ids,
                       const int32_t* __restrict__ offsets,
                       const Word* __restrict__ table, Word* __restrict__ out,
                       Index b, Index k, Index words, int64_t n_rows) {
  const Index pairs = b * k;
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index p = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x;
       p < pairs; p += stride) {
    const Index s = p / k;
    const Index f = p - s * k;
    int64_t r = static_cast<int64_t>(__ldg(ids + p)) +
                static_cast<int64_t>(__ldg(offsets + f));
    r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
    const Word* src = table + r * static_cast<int64_t>(words);
    Word* dst = out + (static_cast<int64_t>(f) * b + s) * words;
    for (Index c = 0; c < words; c += kChunk) {
      Word v[kChunk];
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        if (c + e < words) v[e] = __ldg(src + c + e);
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        if (c + e < words) dst[c + e] = v[e];
    }
  }
}

template <typename Word>
void launch(const int32_t* ids, const int32_t* offsets, const void* table,
            void* out, int64_t b, int64_t k, int64_t words, int threads,
            int64_t blocks, int64_t n_rows, cudaStream_t s) {
  const auto* t = static_cast<const Word*>(table);
  auto* y = static_cast<Word*>(out);
  const auto g = static_cast<unsigned>(blocks);
  // 32-bit indices when the pairs and the grid stay below 2^31 (table and
  // output offsets are 64-bit either way)
  if (b * k + blocks * threads < (int64_t{1} << 31)) {
    mtl_input_first_kernel<Word, int32_t><<<g, threads, 0, s>>>(
        ids, offsets, t, y, static_cast<int32_t>(b), static_cast<int32_t>(k),
        static_cast<int32_t>(words), n_rows);
  } else {
    mtl_input_first_kernel<Word, int64_t><<<g, threads, 0, s>>>(
        ids, offsets, t, y, b, k, words, n_rows);
  }
}

}  // namespace

// vec: copy float4 words (needs d % 4 == 0 and 16-byte-aligned table and
// out); threads: a multiple of 32 up to 256; blocks: 1..2^31-1.
extern "C" int mtl_input_first(const void* ids, const void* offsets,
                               const void* table, void* out, int64_t b,
                               int64_t k, int64_t d, int64_t n_rows, int vec,
                               int threads, int64_t blocks, void* stream) {
  if (b * k == 0 || d == 0) return 0;
  if (threads < 32 || threads > 256 || threads % 32 != 0 || blocks < 1 ||
      blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (vec && (d % 4 != 0 || reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int32_t*>(ids);
  auto o = static_cast<const int32_t*>(offsets);
  if (vec) {
    launch<float4>(i, o, table, out, b, k, d / 4, threads, blocks, n_rows, s);
  } else {
    launch<float>(i, o, table, out, b, k, d, threads, blocks, n_rows, s);
  }
  return static_cast<int>(cudaGetLastError());
}
