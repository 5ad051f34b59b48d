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
// Design: a group of `lanes` consecutive threads (a power of two, at most
// 32, so a group never spans two warps) copies one (sample, field) row,
// and consecutive groups take consecutive rows of the (b, k) id matrix
// (output-first: a warp's stores are one contiguous run of the output).
// Each group computes its row's global index once -- one ids load, one
// offsets load, added and clamped, no division per element -- and then
// each lane copies the row's words lane, lane + lanes, ... A word is a
// float4 when d % 4 == 0 and both the table and the output are 16-byte
// aligned (at d = 32: 8 lanes, so a warp moves 4 whole rows per 16-byte
// load and one 512-byte store run), else a float (d = 1, odd d, or a table
// view at a 4-byte offset). A thread copies R rows at once, all R loads
// issued before any store; its rows lie one grid of groups apart, so a
// warp's ids loads stay one contiguous segment. On the H100 (chip_smoke.py's
// launch sweep) R = 2 pays only where a word is a float and a row fills a
// warp: 6.44 against 8.43 us at b = 1024 on a misaligned d = 32 view; on
// 16-byte words it costs up to 8% (9.41 against 8.73 us at Fig. 11's
// b = 2048), and 32-thread blocks lose wherever a row is more than one
// word. The wrapper
// (multi_table_lookup.py, `gather_launch`) picks the word, lanes, R and the
// grid, and this entry checks them before it launches.
//
// Table offsets are 64-bit products, so tables of more than 2^31 floats
// index exactly; the rest of the index math runs in 32-bit when the output
// and the grid fit.
//
// Out-of-range ids: the global row id + offset is clamped into [0, n_rows),
// so a bad id reads some row of the table and never past it. The plain
// PyTorch version clamps the same way, so the two stay bitwise equal.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename Word, typename Index, int R>
__global__ void __launch_bounds__(256)
mtl_gather_kernel(const int32_t* __restrict__ ids,
                  const int32_t* __restrict__ offsets,
                  const Word* __restrict__ table, Word* __restrict__ out,
                  Index pairs, Index k, Index words, int lane_bits,
                  int64_t n_rows) {
  const int lanes = 1 << lane_bits;
  const int lane = threadIdx.x & (lanes - 1);
  const Index group =
      (static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x) >> lane_bits;
  const Index groups =
      (static_cast<Index>(gridDim.x) * blockDim.x) >> lane_bits;
  for (Index first = group; first < pairs; first += groups * R) {
    int64_t src[R];
    Index dst[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const Index p = first + i * groups;
      src[i] = -1;
      dst[i] = 0;
      if (p < pairs) {
        int64_t r = static_cast<int64_t>(__ldg(ids + p)) +
                    static_cast<int64_t>(__ldg(offsets + p % k));
        r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
        src[i] = r * static_cast<int64_t>(words);
        dst[i] = p * words;
      }
    }
    for (Index j = lane; j < words; j += lanes) {
      Word v[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (src[i] >= 0) v[i] = __ldg(table + src[i] + j);
#pragma unroll
      for (int i = 0; i < R; ++i)
        if (src[i] >= 0) out[dst[i] + j] = v[i];
    }
  }
}

template <typename Word, typename Index>
void launch(const int32_t* ids, const int32_t* offsets, const void* table,
            void* out, int64_t pairs, int64_t k, int64_t words,
            int lane_bits, int rows, int threads, int64_t blocks,
            int64_t n_rows, cudaStream_t s) {
  const auto* t = static_cast<const Word*>(table);
  auto* y = static_cast<Word*>(out);
  const auto g = static_cast<unsigned>(blocks);
  const auto P = static_cast<Index>(pairs);
  const auto K = static_cast<Index>(k);
  const auto W = static_cast<Index>(words);
  if (rows == 2) {
    mtl_gather_kernel<Word, Index, 2><<<g, threads, 0, s>>>(
        ids, offsets, t, y, P, K, W, lane_bits, n_rows);
  } else {
    mtl_gather_kernel<Word, Index, 1><<<g, threads, 0, s>>>(
        ids, offsets, t, y, P, K, W, lane_bits, n_rows);
  }
}

}  // namespace

// vec: copy float4 words (needs d % 4 == 0 and 16-byte-aligned table and
// out); lane_bits: log2 of the lanes per row (0..5); rows: rows per thread
// (1 or 2); threads: a multiple of 32 up to 256; blocks: 1..2^31-1.
extern "C" int mtl_gather(const void* ids, const void* offsets,
                          const void* table, void* out, int64_t b, int64_t k,
                          int64_t d, int64_t n_rows, int vec, int lane_bits,
                          int rows, int threads, int64_t blocks,
                          void* stream) {
  const int64_t pairs = b * k;
  if (pairs == 0 || d == 0) return 0;
  if (lane_bits < 0 || lane_bits > 5 || (rows != 1 && rows != 2)
      || threads < 32 || threads > 256 || threads % 32 != 0 || blocks < 1
      || blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (vec && (d % 4 != 0 || reinterpret_cast<uintptr_t>(table) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(out) % 16 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int64_t words = vec ? d / 4 : d;
  const int64_t grid_threads = blocks * threads;
  // every 32-bit index stays below 2^31: the output's words, and a group's
  // next first row (first + groups * R, at most pairs + grid_threads * 2)
  const bool narrow = pairs * words < (int64_t{1} << 31) &&
                      pairs + grid_threads * 2 < (int64_t{1} << 31);
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int32_t*>(ids);
  auto o = static_cast<const int32_t*>(offsets);
  if (vec && narrow) {
    launch<float4, int32_t>(i, o, table, out, pairs, k, words, lane_bits,
                            rows, threads, blocks, n_rows, s);
  } else if (vec) {
    launch<float4, int64_t>(i, o, table, out, pairs, k, words, lane_bits,
                            rows, threads, blocks, n_rows, s);
  } else if (narrow) {
    launch<float, int32_t>(i, o, table, out, pairs, k, words, lane_bits,
                           rows, threads, blocks, n_rows, s);
  } else {
    launch<float, int64_t>(i, o, table, out, pairs, k, words, lane_bits,
                           rows, threads, blocks, n_rows, s);
  }
  return static_cast<int>(cudaGetLastError());
}
