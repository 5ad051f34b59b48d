// Pooled and tiered fused multi-table gathers: the multi-hot lookup, the
// cached tier's two-level lookup and the host tier's three-level lookup, in
// fp32 and int8.
//
// Replaces five Pallas kernels of src/repro/kernels/multi_table_lookup.py:
//   K2 `mtl_gather_multihot`       (:106) sum of `hot` rows per output row;
//   K3 `mtl_gather_two_level`      (:164) hit -> cache[slot], miss ->
//                                         backing[row], pooled over `hot`;
//   K4 `mtl_gather_two_level_q8`   (:241) K3 on int8 rows with one fp32
//                                         scale per row, dequantized before
//                                         the pool;
//   K5 `mtl_gather_three_level`    (:323) hit -> cache[slot], else staged ->
//                                         staging[slot], else 0 (the guard);
//                                         there is no backing operand: the
//                                         backing lives in host memory;
//   K6 `mtl_gather_three_level_q8` (:403) K5 on int8 rows, the scale from the
//                                         winning tier; a row in neither tier
//                                         gives exactly 0.0.
// Each of those copies one (1, d) row per grid step; the tier is picked by
// scalar-prefetch index maps over slot vectors gathered in a separate pass,
// and every tier's block is fetched before the body selects one.
//
// Bound on an H100: bytes. Per call they read the b*k*h ids (and the mask),
// one slot per distinct row touched (two for K5/K6 on a cache miss), each
// distinct row once (4*d bytes fp32, d + 4 bytes int8), and write b*k*d
// floats; the arithmetic (one add per slot, one multiply more for int8) is
// far below the card's rate.
//
// Design: K1's (mtl_gather.cu) output-first layout, one thread per output
// element, so every warp's stores are one coalesced segment and with d = 32
// a warp's loads are one contiguous row. Each thread adds its field's offset
// to the id (Alg. 1 lines 6-8), redirects a masked slot to row n_rows - 1
// (the zero row), reads slot_of_row[row] itself, and loads only the winning
// tier's element: no separate slot pass, no load of the losing tier. The h
// slots are summed in slot order starting from slot 0's value, the order of
// the reference's output-block revisiting and of the plain versions, with
// __fadd_rn; K4 rounds q * s with __fmul_rn before the add, so nvcc cannot
// contract the two into one FMA. Hence bitwise equality with the plain
// PyTorch versions, and K3 at h = 1 with K1 (a cache row is a verbatim copy
// of its backing row).
//
// K5/K6 read the staging map only on a cache miss, so a hit costs what K3's
// does; a staged row costs one more dependent load.
//
// Out-of-range input: the global row is clamped into [0, n_rows) as in K1,
// and a slot outside [0, n_cache) (or [0, n_staging)) counts as a miss, so no
// id and no map can make a thread read past the backing table, the cache or
// the staging buffer. The plain versions clamp and select the same way.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// K2: every slot reads the one table.
struct DenseRows {
  const float* table;
  __device__ __forceinline__ float operator()(int64_t r, int64_t e,
                                              int64_t d) const {
    return __ldg(table + r * d + e);
  }
};

// K3: the row's slot picks the tier; only that tier's element is loaded.
struct TwoLevelRows {
  const int32_t* slot_of_row;
  const float* cache;
  const float* backing;
  int64_t n_cache;
  __device__ __forceinline__ float operator()(int64_t r, int64_t e,
                                              int64_t d) const {
    const int64_t s = __ldg(slot_of_row + r);
    if (s >= 0 && s < n_cache) return __ldg(cache + s * d + e);
    return __ldg(backing + r * d + e);
  }
};

// K4: as K3 on int8 payloads; the scale comes from the same tier.
struct TwoLevelRowsQ8 {
  const int32_t* slot_of_row;
  const int8_t* cache;
  const float* cache_scale;
  const int8_t* backing;
  const float* backing_scale;
  int64_t n_cache;
  __device__ __forceinline__ float operator()(int64_t r, int64_t e,
                                              int64_t d) const {
    const int64_t s = __ldg(slot_of_row + r);
    int8_t q;
    float scale;
    if (s >= 0 && s < n_cache) {
      q = __ldg(cache + s * d + e);
      scale = __ldg(cache_scale + s);
    } else {
      q = __ldg(backing + r * d + e);
      scale = __ldg(backing_scale + r);
    }
    return __fmul_rn(static_cast<float>(q), scale);
  }
};

// K5: cache, else staging, else the zero guard; only the winning tier's
// element is loaded, and the staging map only on a cache miss.
struct ThreeLevelRows {
  const int32_t* slot_of_row;
  const int32_t* staging_slot_of_row;
  const float* cache;
  const float* staging;
  int64_t n_cache;
  int64_t n_staging;
  __device__ __forceinline__ float operator()(int64_t r, int64_t e,
                                              int64_t d) const {
    const int64_t s = __ldg(slot_of_row + r);
    if (s >= 0 && s < n_cache) return __ldg(cache + s * d + e);
    const int64_t t = __ldg(staging_slot_of_row + r);
    if (t >= 0 && t < n_staging) return __ldg(staging + t * d + e);
    return 0.0f;
  }
};

// K6: as K5 on int8 payloads; the scale comes from the winning tier.
struct ThreeLevelRowsQ8 {
  const int32_t* slot_of_row;
  const int32_t* staging_slot_of_row;
  const int8_t* cache;
  const float* cache_scale;
  const int8_t* staging;
  const float* staging_scale;
  int64_t n_cache;
  int64_t n_staging;
  __device__ __forceinline__ float operator()(int64_t r, int64_t e,
                                              int64_t d) const {
    const int64_t s = __ldg(slot_of_row + r);
    if (s >= 0 && s < n_cache) {
      return __fmul_rn(static_cast<float>(__ldg(cache + s * d + e)),
                       __ldg(cache_scale + s));
    }
    const int64_t t = __ldg(staging_slot_of_row + r);
    if (t >= 0 && t < n_staging) {
      return __fmul_rn(static_cast<float>(__ldg(staging + t * d + e)),
                       __ldg(staging_scale + t));
    }
    return 0.0f;
  }
};

template <typename Index, typename Rows>
__global__ void pooled_gather_kernel(const int32_t* __restrict__ ids,
                                     const float* __restrict__ mask,
                                     const int32_t* __restrict__ offsets,
                                     Rows rows, float* __restrict__ out,
                                     Index b, Index k, Index h, Index d,
                                     int64_t n_rows) {
  const Index total = b * k * d;
  const Index row_width = k * d;
  const Index stride = static_cast<Index>(gridDim.x) * blockDim.x;
  for (Index idx = static_cast<Index>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const Index row = idx / row_width;
    const Index col = idx - row * row_width;
    const Index f = col / d;
    const Index e = col - f * d;
    const int64_t offset = __ldg(offsets + f);
    const Index slot0 = (row * k + f) * h;
    float acc = 0.0f;
    for (Index j = 0; j < h; ++j) {
      int64_t r = n_rows - 1;                       // masked: the zero row
      if (mask == nullptr || __ldg(mask + slot0 + j) != 0.0f) {
        r = static_cast<int64_t>(__ldg(ids + slot0 + j)) + offset;
        r = r < 0 ? 0 : (r >= n_rows ? n_rows - 1 : r);
      }
      const float v = rows(r, static_cast<int64_t>(e),
                           static_cast<int64_t>(d));
      acc = j == 0 ? v : __fadd_rn(acc, v);
    }
    out[idx] = acc;
  }
}

template <typename Rows>
int launch(const void* ids, const void* mask, const void* offsets, Rows rows,
           void* out, int64_t b, int64_t k, int64_t h, int64_t d,
           int64_t n_rows, void* stream) {
  const int64_t total = b * k * d;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (int64_t{1} << 20)) blocks = int64_t{1} << 20;  // grid-stride
  auto s = static_cast<cudaStream_t>(stream);
  auto i = static_cast<const int32_t*>(ids);
  auto m = static_cast<const float*>(mask);
  auto o = static_cast<const int32_t*>(offsets);
  auto y = static_cast<float*>(out);
  // 32-bit element math when every index (output and id slots) fits
  const int64_t limit = (int64_t{1} << 31) - int64_t{threads} * blocks;
  if (total < limit && b * k * h < limit) {
    pooled_gather_kernel<int32_t, Rows><<<static_cast<unsigned>(blocks),
                                          threads, 0, s>>>(
        i, m, o, rows, y, static_cast<int32_t>(b), static_cast<int32_t>(k),
        static_cast<int32_t>(h), static_cast<int32_t>(d), n_rows);
  } else {
    pooled_gather_kernel<int64_t, Rows><<<static_cast<unsigned>(blocks),
                                          threads, 0, s>>>(
        i, m, o, rows, y, b, k, h, d, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ids (b, k, h) int32, mask (b, k, h) float32 or null (all slots valid),
// offsets (k,) int32, out (b, k*d) float32; every pointer on the device.

extern "C" int mtl_gather_multihot(const void* ids, const void* mask,
                                   const void* offsets, const void* table,
                                   void* out, int64_t b, int64_t k, int64_t h,
                                   int64_t d, int64_t n_rows, void* stream) {
  return launch(ids, mask, offsets,
                DenseRows{static_cast<const float*>(table)}, out, b, k, h, d,
                n_rows, stream);
}

extern "C" int mtl_gather_two_level(const void* ids, const void* mask,
                                    const void* offsets,
                                    const void* slot_of_row,
                                    const void* cache, const void* backing,
                                    void* out, int64_t b, int64_t k,
                                    int64_t h, int64_t d, int64_t n_cache,
                                    int64_t n_rows, void* stream) {
  return launch(ids, mask, offsets,
                TwoLevelRows{static_cast<const int32_t*>(slot_of_row),
                             static_cast<const float*>(cache),
                             static_cast<const float*>(backing), n_cache},
                out, b, k, h, d, n_rows, stream);
}

extern "C" int mtl_gather_two_level_q8(
    const void* ids, const void* mask, const void* offsets,
    const void* slot_of_row, const void* cache, const void* cache_scale,
    const void* backing, const void* backing_scale, void* out, int64_t b,
    int64_t k, int64_t h, int64_t d, int64_t n_cache, int64_t n_rows,
    void* stream) {
  return launch(ids, mask, offsets,
                TwoLevelRowsQ8{static_cast<const int32_t*>(slot_of_row),
                               static_cast<const int8_t*>(cache),
                               static_cast<const float*>(cache_scale),
                               static_cast<const int8_t*>(backing),
                               static_cast<const float*>(backing_scale),
                               n_cache},
                out, b, k, h, d, n_rows, stream);
}

// K5/K6: n_rows is the length of both maps (the host backing's height).

extern "C" int mtl_gather_three_level(
    const void* ids, const void* mask, const void* offsets,
    const void* slot_of_row, const void* staging_slot_of_row,
    const void* cache, const void* staging, void* out, int64_t b, int64_t k,
    int64_t h, int64_t d, int64_t n_cache, int64_t n_staging, int64_t n_rows,
    void* stream) {
  return launch(ids, mask, offsets,
                ThreeLevelRows{static_cast<const int32_t*>(slot_of_row),
                               static_cast<const int32_t*>(
                                   staging_slot_of_row),
                               static_cast<const float*>(cache),
                               static_cast<const float*>(staging), n_cache,
                               n_staging},
                out, b, k, h, d, n_rows, stream);
}

extern "C" int mtl_gather_three_level_q8(
    const void* ids, const void* mask, const void* offsets,
    const void* slot_of_row, const void* staging_slot_of_row,
    const void* cache, const void* cache_scale, const void* staging,
    const void* staging_scale, void* out, int64_t b, int64_t k, int64_t h,
    int64_t d, int64_t n_cache, int64_t n_staging, int64_t n_rows,
    void* stream) {
  return launch(ids, mask, offsets,
                ThreeLevelRowsQ8{static_cast<const int32_t*>(slot_of_row),
                                 static_cast<const int32_t*>(
                                     staging_slot_of_row),
                                 static_cast<const int8_t*>(cache),
                                 static_cast<const float*>(cache_scale),
                                 static_cast<const int8_t*>(staging),
                                 static_cast<const float*>(staging_scale),
                                 n_cache, n_staging},
                out, b, k, h, d, n_rows, stream);
}
