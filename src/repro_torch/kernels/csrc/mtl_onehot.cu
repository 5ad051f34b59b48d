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
// Bound on an H100: bytes -- b*k ids, the distinct rows of the stacked
// tables (a few hundred KB, read once) and the b*k*d output. A matmul
// would spend n_pad multiply-adds per output value on zeros; on a card
// with no MXU to keep busy that is pure waste.
//
// Design: the gather, in K1's layout (mtl_gather.cu). A group of `lanes`
// consecutive threads (a power of two, at most 32, so a group never spans
// two warps) copies one (sample, field) row, and consecutive groups take
// consecutive rows of the (b, k) ids, so a warp's stores are one
// contiguous run of the output. The group loads its row's id once and
// finds the field once (p % k); each lane then copies the row's words
// lane, lane + lanes, ... as raw bits. A word is 16, 4 or the element's
// own 2 or 4 bytes: the largest that divides the row's bytes and both base
// addresses (the wrapper's `onehot_word`; at d = 32, 8 words of fp32 or 4
// of bf16 a row). A thread copies R rows at once, its rows a grid of
// groups apart, all R loads issued before any store. The word type and R
// are template arguments: read at run time they put a predicated branch
// around each load (as they did in K9/K10).
//
// Zero rows: an id outside [0, n_pad) -- one unsigned compare, which no
// id overflows (n_pad < 2^31) -- stores zero words and loads nothing (a
// predicate, not the clamp of K1-K6). The stacked tables stay in L2
// across the batch and are read through the read-only path. Values are
// copied as raw bits, so the kernel is bitwise its plain version; on
// finite tables that is also bitwise a one-hot product, up to the sign of
// a zero: the product turns a table's -0.0 into +0.0, which compares
// equal.
//
// Index math runs in 32-bit when the output's words and the grid fit; the
// source offset (f * n_pad + id) * words is always 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename Word, typename Index, int R>
__global__ void __launch_bounds__(256)
mtl_onehot_kernel(const int32_t* __restrict__ ids,
                  const Word* __restrict__ tables, Word* __restrict__ out,
                  Index pairs, Index k, uint32_t n_pad, Index words,
                  int lane_bits) {
  const int lanes = 1 << lane_bits;
  const int lane = threadIdx.x & (lanes - 1);
  const Index group =
      (static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x) >> lane_bits;
  const Index groups =
      (static_cast<Index>(gridDim.x) * blockDim.x) >> lane_bits;
  for (Index first = group; first < pairs; first += groups * R) {
    int64_t src[R];
    Index dst[R];
    bool live[R], hit[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const Index p = first + i * groups;
      live[i] = p < pairs;
      hit[i] = false;
      src[i] = 0;
      dst[i] = 0;
      if (live[i]) {
        const int32_t id = __ldg(ids + p);
        const Index f = p % k;
        hit[i] = static_cast<uint32_t>(id) < n_pad;
        src[i] = (static_cast<int64_t>(f) * n_pad + id) *
                 static_cast<int64_t>(words);
        dst[i] = p * words;
      }
    }
    for (Index j = lane; j < words; j += lanes) {
      Word v[R];
#pragma unroll
      for (int i = 0; i < R; ++i) v[i] = hit[i] ? __ldg(tables + src[i] + j)
                                                : Word{};
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (live[i]) out[dst[i] + j] = v[i];
    }
  }
}

template <typename Word, typename Index>
void launch(const int32_t* ids, const void* tables, void* out, int64_t pairs,
            int64_t k, uint32_t n_pad, int64_t words, int lane_bits,
            int rows, int threads, int64_t blocks, cudaStream_t s) {
  const auto* t = static_cast<const Word*>(tables);
  auto* y = static_cast<Word*>(out);
  const auto g = static_cast<unsigned>(blocks);
  const auto P = static_cast<Index>(pairs);
  const auto K = static_cast<Index>(k);
  const auto W = static_cast<Index>(words);
  if (rows == 2) {
    mtl_onehot_kernel<Word, Index, 2><<<g, threads, 0, s>>>(
        ids, t, y, P, K, n_pad, W, lane_bits);
  } else {
    mtl_onehot_kernel<Word, Index, 1><<<g, threads, 0, s>>>(
        ids, t, y, P, K, n_pad, W, lane_bits);
  }
}

template <typename Word>
void launch_word(const int32_t* ids, const void* tables, void* out,
                 int64_t pairs, int64_t k, uint32_t n_pad, int64_t words,
                 int lane_bits, int rows, int threads, int64_t blocks,
                 cudaStream_t s) {
  // every 32-bit index stays below 2^31: the output's words, and a group's
  // next first row (first + groups * R, at most pairs + grid_threads * 2)
  const bool narrow = pairs * words < (int64_t{1} << 31) &&
                      pairs + blocks * threads * 2 < (int64_t{1} << 31);
  if (narrow) {
    launch<Word, int32_t>(ids, tables, out, pairs, k, n_pad, words,
                          lane_bits, rows, threads, blocks, s);
  } else {
    launch<Word, int64_t>(ids, tables, out, pairs, k, n_pad, words,
                          lane_bits, rows, threads, blocks, s);
  }
}

bool aligned(const void* ptr, int64_t word) {
  return reinterpret_cast<uintptr_t>(ptr) % word == 0;
}

}  // namespace

// itemsize: 4 for float32 tables, 2 for bfloat16 (copied as raw bits);
// n_pad: 1..2^31-1; word: the bytes a load takes, 16, 4 or itemsize,
// dividing d * itemsize and both the tables' and the output's addresses;
// lanes: threads a row, a power of two up to 32; rows: rows a thread (1
// or 2); threads: a multiple of 32 up to 256; blocks: 1..2^31-1. A call
// that breaks any of these returns cudaErrorInvalidValue before anything
// runs.
extern "C" int mtl_onehot(const void* ids, const void* tables, void* out,
                          int64_t b, int64_t k, int64_t n_pad, int64_t d,
                          int64_t itemsize, int64_t word, int lanes,
                          int rows, int threads, int64_t blocks,
                          void* stream) {
  const int64_t pairs = b * k;
  if (pairs == 0 || d == 0) return 0;
  const int64_t row_bytes = d * itemsize;
  if ((itemsize != 4 && itemsize != 2) || n_pad < 1 || n_pad > INT32_MAX ||
      (word != 16 && word != 4 && word != itemsize) ||
      row_bytes % word != 0 || !aligned(tables, word) ||
      !aligned(out, word) || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0 || (rows != 1 && rows != 2) ||
      threads < 32 || threads > 256 || threads % 32 != 0 || blocks < 1 ||
      blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  int lane_bits = 0;
  while ((1 << lane_bits) < lanes) ++lane_bits;
  const int64_t words = row_bytes / word;
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int32_t*>(ids);
  const auto n = static_cast<uint32_t>(n_pad);
  if (word == 16) {
    launch_word<uint4>(i, tables, out, pairs, k, n, words,
                       lane_bits, rows, threads, blocks, s);
  } else if (word == 4) {
    launch_word<uint32_t>(i, tables, out, pairs, k, n, words,
                          lane_bits, rows, threads, blocks, s);
  } else {
    launch_word<uint16_t>(i, tables, out, pairs, k, n, words,
                          lane_bits, rows, threads, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}
