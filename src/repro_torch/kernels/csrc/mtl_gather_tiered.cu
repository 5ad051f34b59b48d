// Pooled and tiered fused multi-table gathers: the multi-hot lookup, the
// cached tier's two-level lookup and the host tier's three-level lookup, in
// fp32 and int8 -- five Pallas kernels, one CUDA kernel (`tiered_kernel`).
//
// Replaces five Pallas kernels of src/repro/kernels/multi_table_lookup.py:
//   K2 `mtl_gather_multihot`       (:106) sum of `hot` rows per output row;
//   K3 `mtl_gather_two_level`      (:164) hit -> cache[slot], miss ->
//                                         backing[row], pooled over `hot`;
//   K4 `mtl_gather_two_level_q8`   (:241/:284) K3 on int8 rows with one fp32
//                                         scale per row, dequantized
//                                         before the pool;
//   K5 `mtl_gather_three_level`    (:323) hit -> cache[slot], else staged ->
//                                         staging[slot], else 0 (the guard);
//                                         there is no backing operand: the
//                                         backing lives in host memory;
//   K6 `mtl_gather_three_level_q8` (:403/:446) K5 on int8 rows, the scale
//                                         from the winning tier; a row in
//                                         neither tier gives exactly 0.0.
// Each of those copies one (1, d) row per grid step; the tier is picked by
// scalar-prefetch index maps over slot vectors gathered in a separate pass,
// and every tier's block is fetched before the body selects one.
//
// Bound on an H100: bytes. Per call they read the b*k*h ids (and the mask),
// one slot per distinct row touched (none for K2, two for K5/K6 on a cache
// miss), each distinct row once (4*d bytes fp32, d + 4 bytes int8), and
// write b*k*d floats; the arithmetic (one add per slot, one multiply more
// for int8) is far below the card's rate. For K4 and K6 at b = 1024,
// h = 1, d = 32 the output write is 5.11 MB of the ~5.8 MB.
//
// Design (`tiered_kernel`, one template over a tier policy -- K2's one
// table, K3/K4's cache and backing, K5/K6's cache and staging -- and the
// row's element type): the fp32 output is most of the bytes, so the write
// has to be coalesced and the reads issued as early as their dependences
// allow. A group of `lanes` consecutive threads (a power of two, at most
// 32) builds one (sample, field) output row, and consecutive groups take
// consecutive rows of the (b, k) id matrix, so a warp's stores are one
// contiguous run. Each lane of the group does the row's index work once
// per slot, not once per element: one id load, the field's offset, the
// clamp, the masked-slot redirect, the map load(s) and, for int8 rows, one
// scale load; no division per element. The group's lanes repeat that work
// on the same addresses, so each of its loads is a broadcast. K2 has no
// map: its policy's `Maps` is an empty struct and `maps()` loads nothing,
// so the compiler drops the map stage and a slot's row load waits only on
// its id. In the SASS for sm_90a, K2's instantiations load the id and the
// mask of a slot and no map: a pooled chunk of 8 slots issues 8 fewer
// 4-byte loads than K3's (17 against 25 with 16-byte words).
// K5 and K6 issue their two map loads together (both depend only on the
// row), then pick cache, else staging, else exactly +0.0 (no load), so a
// staged row waits for no third round trip. Each lane then takes a piece
// of 4 elements of the winning tier's row, loaded as one word where
// d % 4 == 0 and every tier is aligned to it -- 4 floats as one 16-byte
// load (K2, K3, K5), 4 int8 codes as one 4-byte load (K4, K6) -- else
// element by element where a tier lies off that alignment (a tier view 4
// bytes, or 1 byte, into its storage): this path keeps the pieces, the
// lanes and the float4 stores, since a lane per element redoes the row's
// index chain 4 times as often (one float a lane took K3 at h = 5, b =
// 1024 from 11.5 to 28.5 us on an H100). One element a piece for
// d % 4 != 0. An fp32 value is summed as loaded, so K2 and K3 at h = 1 are
// copies, bitwise K1; an int8 code is dequantized with
// __fmul_rn((float)q, s), so nvcc cannot contract it into the sum's FMA. A
// lane takes one piece up to 128 elements a row (32 for a one-element
// piece) and repeats the index work for each further piece: keeping a
// chunk's tier pointers live across the pieces instead took the pooled
// kernels up to 91 registers (74 without) and K4 at h = 5, b = 1024 from
// 13.6 to 19.1 us on an H100. Pooling (h > 1) issues the loads of up to CH
// slots (ids and masks, then maps, then rows and scales) before it sums
// them in slot order from slot 0's value with __fadd_rn -- the order of the
// reference's output-block revisiting -- so the result is bitwise the
// plain versions'. The piece width, load width, lanes and block size come
// from the wrapper (multi_table_lookup.py, `tiered_launch`), and the
// entries check them before they launch.
//
// Out-of-range input: the global row is clamped into [0, n_rows) as in K1,
// a masked slot reads row n_rows - 1 (the zero row), and a slot outside
// [0, n_cache) (or [0, n_staging)) counts as a miss, so no id and no map
// can make a thread read past the table, the backing, the cache or the
// staging buffer. The plain versions clamp and select the same way.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// K2-K6: tiered rows (fp32 or int8), a group of lanes a row
// ---------------------------------------------------------------------------

constexpr int kChunk = 8;   // slots of a pooled row whose loads go together

// The tier row one slot reads and, for int8 rows, its scale; no row: K5's
// and K6's zero guard.
template <typename T>
struct Pick {
  const T* row;
  const float* scale;
};

// Entry i of a tier's scales: int8 tiers hold one per row, fp32 tiers none.
template <typename T>
__device__ __forceinline__ const float* scale_at(const float* scale,
                                                 int64_t i) {
  if constexpr (std::is_same_v<T, int8_t>) {
    return scale + i;
  } else {
    return nullptr;
  }
}

// K2: one table, no map.
template <typename T>
struct OneLevel {
  using Elem = T;
  const T* table;
  struct Maps {};
  __device__ __forceinline__ Maps maps(int64_t) const { return {}; }
  __device__ __forceinline__ Pick<T> pick(int64_t r, Maps,
                                          int64_t d) const {
    return {table + r * d, nullptr};
  }
};

// K3/K4: a slot inside [0, n_cache) reads the cache, anything else the
// backing.
template <typename T>
struct TwoLevel {
  using Elem = T;
  const int32_t* slot_of_row;
  const T* cache;
  const float* cache_scale;        // int8 rows only
  const T* backing;
  const float* backing_scale;      // int8 rows only
  int64_t n_cache;
  using Maps = int32_t;
  __device__ __forceinline__ Maps maps(int64_t r) const {
    return __ldg(slot_of_row + r);
  }
  __device__ __forceinline__ Pick<T> pick(int64_t r, Maps s,
                                          int64_t d) const {
    if (s >= 0 && s < n_cache)
      return {cache + s * d, scale_at<T>(cache_scale, s)};
    return {backing + r * d, scale_at<T>(backing_scale, r)};
  }
};

// K5/K6: cache, else staging, else nothing; both maps load at once.
template <typename T>
struct ThreeLevel {
  using Elem = T;
  const int32_t* slot_of_row;
  const int32_t* staging_slot_of_row;
  const T* cache;
  const float* cache_scale;        // int8 rows only
  const T* staging;
  const float* staging_scale;      // int8 rows only
  int64_t n_cache;
  int64_t n_staging;
  using Maps = int2;
  __device__ __forceinline__ Maps maps(int64_t r) const {
    return make_int2(__ldg(slot_of_row + r), __ldg(staging_slot_of_row + r));
  }
  __device__ __forceinline__ Pick<T> pick(int64_t, Maps m, int64_t d) const {
    if (m.x >= 0 && m.x < n_cache)
      return {cache + m.x * d, scale_at<T>(cache_scale, m.x)};
    if (m.y >= 0 && m.y < n_staging)
      return {staging + m.y * d, scale_at<T>(staging_scale, m.y)};
    return {nullptr, nullptr};
  }
};

// A lane's piece of a tier row: V elements (4, or 1 for d % 4 != 0) of
// type T, loaded as one word of all V (WORD) or element by element.
template <typename T, int V, bool WORD>
struct Piece;

// fp32 rows: a value is summed as loaded.
template <int V, bool WORD>
struct Piece<float, V, WORD> {
  static constexpr int kWidth = V;
  float x[V];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = 0.0f;
  }
  __device__ __forceinline__ void load(const float* p, const float*) {
    if constexpr (WORD) {
      static_assert(V == 4, "a word is 4 floats");
      const float4 w = __ldg(reinterpret_cast<const float4*>(p));
      x[0] = w.x;
      x[1] = w.y;
      x[2] = w.z;
      x[3] = w.w;
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = __ldg(p + e);
    }
  }
  __device__ __forceinline__ float value(int e) const { return x[e]; }
};

// int8 rows and the row's scale: a code is dequantized as it is summed.
template <int V, bool WORD>
struct Piece<int8_t, V, WORD> {
  static constexpr int kWidth = V;
  int8_t c[V];
  float s;
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int e = 0; e < V; ++e) c[e] = 0;
    s = 0.0f;
  }
  __device__ __forceinline__ void load(const int8_t* p, const float* scale) {
    s = __ldg(scale);
    if constexpr (WORD) {
      static_assert(V == 4, "a word is 4 codes");
      const int x = __ldg(reinterpret_cast<const int*>(p));
#pragma unroll
      for (int e = 0; e < V; ++e) c[e] = static_cast<int8_t>(x >> (8 * e));
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) c[e] = __ldg(p + e);
    }
  }
  __device__ __forceinline__ float value(int e) const {
    return __fmul_rn(static_cast<float>(c[e]), s);
  }
};

// A group of 2^lane_bits lanes builds output row p = (sample, field); lane
// l takes the row's pieces l, l + lanes, ... (one piece when the lanes
// cover the row). A pooled row takes its slots CH at a time, every load of
// a chunk issued before the sum.
template <typename Tiers, typename P, int CH>
__global__ void __launch_bounds__(256)
tiered_kernel(const int32_t* __restrict__ ids,
              const float* __restrict__ mask,
              const int32_t* __restrict__ offsets, Tiers tiers,
              float* __restrict__ out, int64_t pairs, int64_t k, int64_t h,
              int64_t d, int lane_bits, int64_t n_rows) {
  constexpr int V = P::kWidth;
  const int lanes = 1 << lane_bits;
  const int lane = threadIdx.x & (lanes - 1);
  const int64_t pieces = d / V;
  const int64_t group =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x)
      >> lane_bits;
  const int64_t groups =
      (static_cast<int64_t>(gridDim.x) * blockDim.x) >> lane_bits;
  const bool narrow = pairs < (int64_t{1} << 32);
  for (int64_t p = group; p < pairs; p += groups) {
    const int64_t f = narrow ? static_cast<int64_t>(
        static_cast<uint32_t>(p) % static_cast<uint32_t>(k)) : p % k;
    const int64_t offset = __ldg(offsets + f);
    for (int64_t w = lane; w < pieces; w += lanes) {
      float acc[V] = {};
      for (int64_t j0 = 0; j0 < h; j0 += CH) {
        // ids and masks -> the slots' global rows (-1: no such slot)
        int64_t r[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          r[c] = -1;
          if (j0 + c < h) {
            const int64_t slot = p * h + j0 + c;
            int64_t row = n_rows - 1;                 // masked: the zero row
            if (mask == nullptr || __ldg(mask + slot) != 0.0f) {
              row = static_cast<int64_t>(__ldg(ids + slot)) + offset;
              row = row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
            }
            r[c] = row;
          }
        }
        // rows -> maps
        typename Tiers::Maps m[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c)
          m[c] = r[c] >= 0 ? tiers.maps(r[c]) : typename Tiers::Maps{};
        // maps -> the winning tier's piece (and scale); none: +0.0
        P v[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          v[c].zero();
          if (r[c] >= 0) {
            const auto t = tiers.pick(r[c], m[c], d);
            if (t.row != nullptr) v[c].load(t.row + w * V, t.scale);
          }
        }
        // sum in slot order from slot 0's value
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          if (r[c] < 0) continue;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float x = v[c].value(e);
            acc[e] = j0 + c == 0 ? x : __fadd_rn(acc[e], x);
          }
        }
      }
      float* const dst = out + p * d + w * V;
      if constexpr (V == 4) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
        *dst = acc[0];
      }
    }
  }
}

struct Call {
  const int32_t* ids;
  const float* mask;
  const int32_t* offsets;
  float* out;
  int64_t pairs, k, h, d, n_rows;
  int lane_bits, threads;
  unsigned blocks;
  cudaStream_t stream;
};

template <typename Tiers, typename P>
void run(const Call& c, const Tiers& t) {
  if (c.h == 1) {
    tiered_kernel<Tiers, P, 1><<<c.blocks, c.threads, 0, c.stream>>>(
        c.ids, c.mask, c.offsets, t, c.out, c.pairs, c.k, c.h, c.d,
        c.lane_bits, c.n_rows);
  } else {
    tiered_kernel<Tiers, P, kChunk><<<c.blocks, c.threads, 0, c.stream>>>(
        c.ids, c.mask, c.offsets, t, c.out, c.pairs, c.k, c.h, c.d,
        c.lane_bits, c.n_rows);
  }
}

// vec: a piece of 4 elements a lane and one float4 store (needs d % 4 == 0
// and out 16-byte aligned), else 1 element; word: the bytes one load takes
// from a tier, 4 elements (needs vec and both tiers aligned to it: 16
// bytes of fp32, 4 of int8) or one element; lane_bits: log2 of the lanes
// a row (0..5); threads: a multiple of 32 up to 256; blocks: 1..2^31-1.
template <typename Tiers>
int launch_tiered(const void* ids, const void* mask, const void* offsets,
                  const Tiers& tiers, const void* rows_a, const void* rows_b,
                  void* out, int64_t b, int64_t k, int64_t h, int64_t d,
                  int64_t n_rows, int64_t vec, int64_t word,
                  int64_t lane_bits, int64_t threads, int64_t blocks,
                  void* stream) {
  using T = typename Tiers::Elem;
  constexpr int64_t kElem = sizeof(T), kWord = 4 * kElem;
  const int64_t pairs = b * k;
  if (pairs == 0 || d == 0) return 0;
  if ((vec != 0 && vec != 1) || (word != kElem && word != kWord)
      || (word == kWord && !vec) || (vec && d % 4 != 0)
      || lane_bits < 0 || lane_bits > 5 || threads < 32 || threads > 256
      || threads % 32 != 0 || blocks < 1 || blocks > 0x7fffffff || h < 1
      || n_rows < 1)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if ((vec && reinterpret_cast<uintptr_t>(out) % 16 != 0)
      || reinterpret_cast<uintptr_t>(rows_a) % word != 0
      || reinterpret_cast<uintptr_t>(rows_b) % word != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Call c{static_cast<const int32_t*>(ids),
               static_cast<const float*>(mask),
               static_cast<const int32_t*>(offsets), static_cast<float*>(out),
               pairs, k, h, d, n_rows, static_cast<int>(lane_bits),
               static_cast<int>(threads), static_cast<unsigned>(blocks),
               static_cast<cudaStream_t>(stream)};
  if (word == kWord) {
    run<Tiers, Piece<T, 4, true>>(c, tiers);
  } else if (vec) {
    run<Tiers, Piece<T, 4, false>>(c, tiers);
  } else {
    run<Tiers, Piece<T, 1, false>>(c, tiers);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ids (b, k, h) int32, mask (b, k, h) float32 or null (all slots valid),
// offsets (k,) int32, out (b, k*d) float32; every pointer on the device.
// K2-K6 take their launch from the wrapper: vec, word, lane_bits, threads
// and blocks (see launch_tiered).

extern "C" int mtl_gather_multihot(const void* ids, const void* mask,
                                   const void* offsets, const void* table,
                                   void* out, int64_t b, int64_t k, int64_t h,
                                   int64_t d, int64_t n_rows, int64_t vec,
                                   int64_t word, int64_t lane_bits,
                                   int64_t threads, int64_t blocks,
                                   void* stream) {
  return launch_tiered(ids, mask, offsets,
                       OneLevel<float>{static_cast<const float*>(table)},
                       table, table, out, b, k, h, d, n_rows, vec, word,
                       lane_bits, threads, blocks, stream);
}

extern "C" int mtl_gather_two_level(
    const void* ids, const void* mask, const void* offsets,
    const void* slot_of_row, const void* cache, const void* backing,
    void* out, int64_t b, int64_t k, int64_t h, int64_t d, int64_t n_cache,
    int64_t n_rows, int64_t vec, int64_t word, int64_t lane_bits,
    int64_t threads, int64_t blocks, void* stream) {
  return launch_tiered(ids, mask, offsets,
                       TwoLevel<float>{static_cast<const int32_t*>(
                                           slot_of_row),
                                       static_cast<const float*>(cache),
                                       nullptr,
                                       static_cast<const float*>(backing),
                                       nullptr, n_cache},
                       cache, backing, out, b, k, h, d, n_rows, vec, word,
                       lane_bits, threads, blocks, stream);
}

extern "C" int mtl_gather_two_level_q8(
    const void* ids, const void* mask, const void* offsets,
    const void* slot_of_row, const void* cache, const void* cache_scale,
    const void* backing, const void* backing_scale, void* out, int64_t b,
    int64_t k, int64_t h, int64_t d, int64_t n_cache, int64_t n_rows,
    int64_t vec, int64_t word, int64_t lane_bits, int64_t threads,
    int64_t blocks, void* stream) {
  return launch_tiered(ids, mask, offsets,
                       TwoLevel<int8_t>{static_cast<const int32_t*>(
                                            slot_of_row),
                                        static_cast<const int8_t*>(cache),
                                        static_cast<const float*>(
                                            cache_scale),
                                        static_cast<const int8_t*>(backing),
                                        static_cast<const float*>(
                                            backing_scale),
                                        n_cache},
                       cache, backing, out, b, k, h, d, n_rows, vec, word,
                       lane_bits, threads, blocks, stream);
}

// K5/K6: n_rows is the length of both maps (the host backing's height).

extern "C" int mtl_gather_three_level(
    const void* ids, const void* mask, const void* offsets,
    const void* slot_of_row, const void* staging_slot_of_row,
    const void* cache, const void* staging, void* out, int64_t b, int64_t k,
    int64_t h, int64_t d, int64_t n_cache, int64_t n_staging, int64_t n_rows,
    int64_t vec, int64_t word, int64_t lane_bits, int64_t threads,
    int64_t blocks, void* stream) {
  return launch_tiered(ids, mask, offsets,
                       ThreeLevel<float>{static_cast<const int32_t*>(
                                             slot_of_row),
                                         static_cast<const int32_t*>(
                                             staging_slot_of_row),
                                         static_cast<const float*>(cache),
                                         nullptr,
                                         static_cast<const float*>(staging),
                                         nullptr, n_cache, n_staging},
                       cache, staging, out, b, k, h, d, n_rows, vec, word,
                       lane_bits, threads, blocks, stream);
}

extern "C" int mtl_gather_three_level_q8(
    const void* ids, const void* mask, const void* offsets,
    const void* slot_of_row, const void* staging_slot_of_row,
    const void* cache, const void* cache_scale, const void* staging,
    const void* staging_scale, void* out, int64_t b, int64_t k, int64_t h,
    int64_t d, int64_t n_cache, int64_t n_staging, int64_t n_rows,
    int64_t vec, int64_t word, int64_t lane_bits, int64_t threads,
    int64_t blocks, void* stream) {
  return launch_tiered(ids, mask, offsets,
                       ThreeLevel<int8_t>{static_cast<const int32_t*>(
                                              slot_of_row),
                                          static_cast<const int32_t*>(
                                              staging_slot_of_row),
                                          static_cast<const int8_t*>(cache),
                                          static_cast<const float*>(
                                              cache_scale),
                                          static_cast<const int8_t*>(staging),
                                          static_cast<const float*>(
                                              staging_scale),
                                          n_cache, n_staging},
                       cache, staging, out, b, k, h, d, n_rows, vec, word,
                       lane_bits, threads, blocks, stream);
}
