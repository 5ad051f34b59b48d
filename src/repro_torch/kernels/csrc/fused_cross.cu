// Fused elementwise tails of the DCN / DCNv2 cross layers (C5).
//
// Replaces src/repro/kernels/fused_cross.py:26 `fused_cross_v2` and
// src/repro/kernels/fused_cross.py:48 `fused_cross_v1`, the Pallas kernels
// that run the post-GEMM chain of a cross layer in one VMEM pass.
//
//   cross_v2:  out = x0 * xw_plus + x                    (all (b, D))
//   cross_v1:  out = x0 * xlw + bias + x    (xlw (b, 1), bias (D,))
//
// Bound on an H100: bytes. Each output element costs two or three fp32
// operations against 12-16 bytes moved, far below the card's ratio of
// operations to bytes, so the least time is (inputs + output) / memory rate:
// 6.10 us for cross_v2 at b = 1024, D = 1248 (20.4 MB), 4.58 us in layer 0,
// where x is x0 and one load stream goes (15.3 MB). At b = 256 the bound
// (1.53 us) is under the launch and one round trip to device memory. With
// its inputs cold in device memory the kernel takes what the per-element
// kernel it replaced took (8.6 us at b = 1024: the read stream plus a
// ~2 us floor a launch); in the model's step, where its inputs sit in L2,
// a launch takes 2.5 us at b = 256 and ~7 at b = 1024 (3.0 and 8.8 before).
//
// Design: one pass over pieces of 4 floats (D % 4 == 0) or of one float,
// each input read once and the output written once. A thread takes `words`
// pieces (1, 2 or 4; the wrapper gives 2) a block-width apart, so a warp's
// j-th load covers 512 consecutive bytes, and issues every load of all its
// pieces before any arithmetic (the SASS holds them all ahead of the first
// FMUL). The pieces a thread and the layer-0 form are template arguments:
// a first version read them at run time and took 5.3 us at b = 256 with
// four pieces a thread, against 4.2 us for this one. A piece of 4 floats
// loads as one 16-byte word where every operand is 16-byte aligned, else
// as four 4-byte words (a view 4 bytes into its storage) into one float4;
// the output, allocated by the wrapper, is stored as one float4
// with a plain store (the next GEMM reads it from L2). The grid covers the
// pieces once (no grid-stride loop), sized by the wrapper (fused_cross.py,
// `cross_launch`) to about one wave of the card at b = 256 and 1024. In
// layer 0 the wrapper passes `same` (x is x0) and the kernel skips x's
// loads. cross_v1 finds a piece's row with one division a piece and reads
// xlw[row] and the bias's piece through the read-only path (the bias's
// 5 KB are shared by every row). The arithmetic uses __fmul_rn / __fadd_rn
// in the order the plain PyTorch ops round ((x0*xw)+x and
// ((x0*xlw)+bias)+x), which keeps nvcc from contracting them into an FMA,
// so the kernel is bitwise equal to the plain version and to the unfused
// graph. The C entries check the launch and the alignment they are given
// and return a CUDA error code on what they cannot take.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

// How a piece of E floats is read: one 16-byte word, four 4-byte words
// into one float4, or one float; all through the read-only path.
struct Word16 {
  static constexpr int E = 4;
  using T = float4;
  template <typename I>
  __device__ static T load(const float* p, I i) {
    return __ldg(reinterpret_cast<const float4*>(p) + i);
  }
};

struct Word4x4 {
  static constexpr int E = 4;
  using T = float4;
  template <typename I>
  __device__ static T load(const float* p, I i) {
    const float* q = p + i * 4;
    return make_float4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
  }
};

struct Float {
  static constexpr int E = 1;
  using T = float;
  template <typename I>
  __device__ static T load(const float* p, I i) {
    return __ldg(p + i);
  }
};

__device__ __forceinline__ float tail_v2(float a, float w, float r) {
  return __fadd_rn(__fmul_rn(a, w), r);
}

__device__ __forceinline__ float4 tail_v2(float4 a, float4 w, float4 r) {
  return make_float4(tail_v2(a.x, w.x, r.x), tail_v2(a.y, w.y, r.y),
                     tail_v2(a.z, w.z, r.z), tail_v2(a.w, w.w, r.w));
}

__device__ __forceinline__ float tail_v1(float a, float l, float c,
                                         float r) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, l), c), r);
}

__device__ __forceinline__ float4 tail_v1(float4 a, float l, float4 c,
                                          float4 r) {
  return make_float4(tail_v1(a.x, l, c.x, r.x), tail_v1(a.y, l, c.y, r.y),
                     tail_v1(a.z, l, c.z, r.z), tail_v1(a.w, l, c.w, r.w));
}

// The j-th piece of this thread: blockDim.x apart, `words` a thread.
template <typename I>
__device__ __forceinline__ I piece(int words, int j) {
  return (static_cast<I>(blockIdx.x) * words + j)
             * static_cast<I>(blockDim.x) + static_cast<I>(threadIdx.x);
}

template <class L, typename I, int W, bool Same>
__global__ void __launch_bounds__(256)
cross_v2_kernel(const float* __restrict__ x0, const float* __restrict__ xw,
                const float* __restrict__ x, float* __restrict__ out,
                I pieces) {
  using T = typename L::T;
  T a[W], w[W], r[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const I i = piece<I>(W, j);
    if (i < pieces) {
      a[j] = L::load(x0, i);
      w[j] = L::load(xw, i);
      r[j] = Same ? a[j] : L::load(x, i);
    }
  }
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const I i = piece<I>(W, j);
    if (i < pieces) {
      reinterpret_cast<T*>(out)[i] = tail_v2(a[j], w[j], r[j]);
    }
  }
}

template <class L, typename I, int W, bool Same>
__global__ void __launch_bounds__(256)
cross_v1_kernel(const float* __restrict__ x0, const float* __restrict__ xlw,
                const float* __restrict__ bias, const float* __restrict__ x,
                float* __restrict__ out, I pieces, I row_pieces) {
  using T = typename L::T;
  T a[W], c[W], r[W];
  float l[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const I i = piece<I>(W, j);
    if (i < pieces) {
      const I row = i / row_pieces;
      a[j] = L::load(x0, i);
      l[j] = __ldg(xlw + row);
      c[j] = L::load(bias, i - row * row_pieces);
      r[j] = Same ? a[j] : L::load(x, i);
    }
  }
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const I i = piece<I>(W, j);
    if (i < pieces) {
      reinterpret_cast<T*>(out)[i] = tail_v1(a[j], l[j], c[j], r[j]);
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// 0 if the launch covers b x dim and the operands suit its words, else the
// CUDA error code to return. `ins` are the (b, D) inputs and, for cross_v1,
// the bias (a piece of it is read the way the (b, D) pieces are).
int check(const void* const* ins, int n_ins, const void* out, int64_t b,
          int64_t dim, int64_t vec, int64_t word, int64_t words,
          int64_t threads, int64_t blocks) {
  if (b < 0 || dim < 0 || (vec != 0 && vec != 1) || (word != 4 && word != 16)
      || (word == 16 && !vec) || (vec && dim % 4 != 0)
      || (words != 1 && words != 2 && words != 4) || threads < 32
      || threads > 256 || threads % 32 != 0 || blocks < 1
      || blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (blocks * threads * words < b * dim / (vec ? 4 : 1))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  for (int k = 0; k < n_ins; ++k) {
    if (!aligned(ins[k], static_cast<uintptr_t>(word)))
      return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (!aligned(out, vec ? 16 : 4))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return 0;
}

template <int N>
using Int = std::integral_constant<int, N>;
template <bool B>
using Bool = std::integral_constant<bool, B>;

// Calls f(L{}, I{}, Int<W>{}, Bool<Same>{}) with the piece's loader, the
// index type (32-bit where every element index of the launch fits), the
// pieces a thread and whether x is x0.
template <class F>
int dispatch(int64_t vec, int64_t word, int64_t words, int64_t threads,
             int64_t blocks, int64_t same, F&& f) {
  const bool wide = blocks * threads * words * (vec ? 4 : 1) > 0x7fffffff;
  auto with_same = [&](auto load, auto idx, auto w) {
    return same ? f(load, idx, w, Bool<true>{}) : f(load, idx, w, Bool<false>{});
  };
  auto with_words = [&](auto load, auto idx) {
    if (words == 1) return with_same(load, idx, Int<1>{});
    if (words == 2) return with_same(load, idx, Int<2>{});
    return with_same(load, idx, Int<4>{});
  };
  auto with_index = [&](auto load) {
    return wide ? with_words(load, int64_t{}) : with_words(load, int32_t{});
  };
  if (word == 16) return with_index(Word16{});
  if (vec) return with_index(Word4x4{});
  return with_index(Float{});
}

}  // namespace

// x0, xw, x, out (b, dim) float32 on the device; same: x is x0 (layer 0,
// x is not read); vec: pieces of 4 floats (needs dim % 4 == 0 and out
// 16-byte aligned), else one float; word: bytes a load takes, 16 (every
// operand 16-byte aligned) or 4; words: pieces a thread, 1, 2 or 4;
// threads: a multiple of 32 up to 256; blocks * threads * words must cover
// the pieces.
extern "C" int fused_cross_v2(const void* x0, const void* xw, const void* x,
                              void* out, int64_t b, int64_t dim, int64_t same,
                              int64_t vec, int64_t word, int64_t words,
                              int64_t threads, int64_t blocks, void* stream) {
  if ((same != 0 && same != 1) || (same && x != x0))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ins[] = {x0, xw, x};
  if (const int code = check(ins, 3, out, b, dim, vec, word, words, threads,
                             blocks))
    return code;
  if (b * dim == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(x0);
  auto w = static_cast<const float*>(xw);
  auto r = static_cast<const float*>(x);
  auto y = static_cast<float*>(out);
  return dispatch(vec, word, words, threads, blocks, same,
                  [&](auto load, auto idx, auto nw, auto sm) {
    using L = decltype(load);
    using I = decltype(idx);
    constexpr int W = decltype(nw)::value;
    constexpr bool S = decltype(sm)::value;
    cross_v2_kernel<L, I, W, S><<<static_cast<unsigned>(blocks),
                                  static_cast<unsigned>(threads), 0, s>>>(
        a, w, r, y, static_cast<I>(b * dim / L::E));
    return static_cast<int>(cudaGetLastError());
  });
}

// As fused_cross_v2, with xlw (b, 1) and bias (dim,): word 16 also needs
// the bias 16-byte aligned.
extern "C" int fused_cross_v1(const void* x0, const void* xlw,
                              const void* bias, const void* x, void* out,
                              int64_t b, int64_t dim, int64_t same,
                              int64_t vec, int64_t word, int64_t words,
                              int64_t threads, int64_t blocks, void* stream) {
  if ((same != 0 && same != 1) || (same && x != x0))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ins[] = {x0, bias, x};
  if (const int code = check(ins, 3, out, b, dim, vec, word, words, threads,
                             blocks))
    return code;
  if (b * dim == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto a = static_cast<const float*>(x0);
  auto l = static_cast<const float*>(xlw);
  auto c = static_cast<const float*>(bias);
  auto r = static_cast<const float*>(x);
  auto y = static_cast<float*>(out);
  return dispatch(vec, word, words, threads, blocks, same,
                  [&](auto load, auto idx, auto nw, auto sm) {
    using L = decltype(load);
    using I = decltype(idx);
    constexpr int W = decltype(nw)::value;
    constexpr bool S = decltype(sm)::value;
    cross_v1_kernel<L, I, W, S><<<static_cast<unsigned>(blocks),
                                  static_cast<unsigned>(threads), 0, s>>>(
        a, l, c, r, y, static_cast<I>(b * dim / L::E),
        static_cast<I>(dim / L::E));
    return static_cast<int>(cudaGetLastError());
  });
}
