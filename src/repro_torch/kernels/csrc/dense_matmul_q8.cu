// Quantized dense layer (int8 MLP compute) on Hopper's int8 tensor cores:
//
//   out = relu?( (hq . wq) * hscale * wscale + bias )
//
// Replaces src/repro/kernels/dense_matmul.py:42 `dmm_q8`, the Pallas kernel
// that accumulates int8 x int8 -> int32 on the MXU over one batch block per
// grid step, with the whole weight in VMEM, and dequantizes in the same pass.
//
//   hq     (M, K) int8    per-row quantized activations (quantize_rows_q8.cu)
//   hscale (M, 1) f32     per-row activation scales
//   wt     (N, K) int8    per-output-channel quantized weights, transposed
//                         once when the graph is built (row n = channel n)
//   wscale (1, N) f32     per-channel weight scales
//   bias   (1, N) f32
//   out    (M, N) f32
//
// Bound on an H100: bytes at the MLP's shapes. At M = 1024, K = 1248,
// N = 1024 the layer moves ~6.8 MB (two int8 operands read once, the fp32
// output written once: ~2.0 us at 3.35 TB/s) against 2.6 G int8 operations
// (~1.3 us at the 1,979 TOP/s dense int8 tensor rate).
//
// Design. Each 128-thread block (one warpgroup) owns a 64 x BN output tile
// and walks K in 128-byte k-tiles. Both operands are K-major -- what 8-bit
// wgmma requires, and why the weight is stored transposed -- so a k-tile of
// either is a (rows, 128 B) box that one TMA copy brings into shared memory
// with the 128-byte swizzle wgmma's descriptors read. A ring of stages,
// each with an mbarrier that the copy completes, holds as many k-tiles as
// fit in shared memory (9 at BN = 128, 12 at BN = 32), so at the MLP's widths
// (8 or 10 k-tiles) nearly every copy is issued at the start and the
// block pays one memory round trip, not one per few tiles. The warpgroup
// runs four wgmma.mma_async.m64nBNk32.s32.s8.s8 on each k-tile as it
// lands (32 bytes of k each; the descriptor advances 32 bytes inside the
// swizzle row) and leaves them in flight; a stage is refilled only when
// K outruns the ring, after its wgmmas retire (wait_group 1, then a
// block barrier), by the one thread that issues the copies. While the
// first copies fly, the block stages its columns' wscale and bias in
// shared memory and each thread its two rows' hscale in registers: read
// from global memory inside the epilogue, one round trip per output
// pair, they made the epilogue the longest phase of the kernel.
// BN is picked per call: 128 when that grid still gives ~3/4 of the SMs a
// block, else 32. b = 1024 gets 16 x 8 blocks of 64 x 128, b = 256 4 x 32
// blocks of 64 x 32 (the SIMT kernel this replaced had 64 blocks there).
// A block's ring takes most of an SM's shared memory, so a grid of more
// than one block per SM runs in waves; wider tiles also read each operand
// from L2 fewer times.
//
// The tensor maps are encoded on the host at every call (the activation is
// a new tensor each step) through cuTensorMapEncodeTiled, fetched with
// cudaGetDriverEntryPoint so the library links no libcuda, and passed as
// __grid_constant__ parameters. TMA needs a 16-byte-aligned base and a row
// pitch that is a multiple of 16 bytes; the wrapper (dense_matmul.py)
// copies any other operand once into a zero-padded buffer. Rows past M or
// N and bytes past K (the last k-tile of 1248 = 9 x 128 + 96) are
// zero-filled by the copy and add nothing to the sum.
//
// Numerics: the int32 sum of int8 products is exact in any order (|acc| <=
// 127^2 K < 2^31 for K < 133,000), so the kernel is bitwise its plain
// version at every shape. The epilogue maps wgmma's accumulator fragment
// to (m, n) and is written out with intrinsics as
// fma(round(fp32(acc) * hs), ws, bias) -- the form the reference's jitted
// epilogue compiles to -- so nvcc's --fmad contraction cannot pick another.
// The ReLU is PTX max.NaN.f32, so a row whose scale is NaN (a NaN in the
// activation) stays NaN through it, as the plain version's clamp_min and
// the reference's jnp.maximum keep it; fmaxf would turn it into 0.

#include <cstdint>
#include <cuda.h>            // CUtensorMap and its enums: types only
#include <cuda_runtime.h>

namespace {
constexpr int kBM = 64;            // output rows per block: wgmma's M
constexpr int kBK = 128;           // k bytes per stage: one swizzle row
constexpr int kThreads = 128;      // one warpgroup
constexpr int kRingBudget = 220 * 1024;   // of the 227 KB a block may use
constexpr int kMaxStages = 12;
constexpr uint32_t kTileA = kBM * kBK;

// max(a, b), NaN if either is NaN (fmaxf returns the other operand)
__device__ __forceinline__ float max_nan(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

template <int BN>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return kTileA + BN * kBK;
}

// as many stages as fit: 9 for BN = 128, 12 for BN = 32 -- every k-tile
// of K = 1248 (10) or 1024 (8) is in flight from the start at BN = 32
template <int BN>
__host__ __device__ constexpr int stages() {
  return kRingBudget / stage_bytes<BN>() < kMaxStages
             ? kRingBudget / stage_bytes<BN>() : kMaxStages;
}

template <int BN>
constexpr int smem_bytes() {       // + 1 KB to align the ring to 1024 B
  return stages<BN>() * stage_bytes<BN>() + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// wait for phase `parity` of the barrier to complete; a copy that never
// lands (a bad tensor map) traps after ~2^34 cycles (~10 s) instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// one (box rows, 128 B) tile at (k byte, row) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int k, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k),
         "r"(row)
      : "memory");
}

// k-tile kt of both operands into one stage: A's (64, 128 B) box at
// `dst`, B's (BN, 128 B) box after it, completing barrier `bar`
__device__ __forceinline__ void load_stage(const CUtensorMap* map_a,
                                           const CUtensorMap* map_b,
                                           uint32_t bar, uint32_t dst,
                                           uint32_t tile_a, uint32_t bytes,
                                           int kt, int m0, int n0) {
  mbar_expect_tx(bar, bytes);
  tma_load(dst, map_a, bar, kt * kBK, m0);
  tma_load(dst + tile_a, map_b, bar, kt * kBK, n0);
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte
// swizzle: rows of 128 B, 8-row groups 1024 B apart (stride byte offset);
// the leading byte offset is unused for this layout
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma (CUTLASS's warpgroup_fence_operand)
template <int R>
__device__ __forceinline__ void fence_acc(int32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// D (64 x N, s32, in registers) += A (64 x 32 B) . B (N x 32 B)^T, both
// from shared memory through descriptors
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void mma(int32_t (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(int32_t (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
  }
};

template <int BN>
__global__ void __launch_bounds__(kThreads)
dmm_q8_kernel(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b,
              const float* __restrict__ hscale,
              const float* __restrict__ wscale,
              const float* __restrict__ bias, float* __restrict__ out,
              int M, int N, int K, bool relu) {
  constexpr uint32_t kStage = stage_bytes<BN>();
  constexpr int kStages = stages<BN>();
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ float tile_ws[BN];
  __shared__ float tile_bias[BN];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * BN;
  const int nk = (K + kBK - 1) / kBK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages && s < nk; ++s) {
      load_stage(&map_a, &map_b, smem_u32(&full[s]), ring + s * kStage,
                 kTileA, kStage, s, m0, n0);
    }
  }
  // the epilogue's operands, fetched while the first k-tiles are in
  // flight: a global load per output there would be a round trip each
  for (int i = tid; i < BN; i += kThreads) {
    const bool in = n0 + i < N;
    tile_ws[i] = in ? __ldg(wscale + n0 + i) : 0.0f;
    tile_bias[i] = in ? __ldg(bias + n0 + i) : 0.0f;
  }
  const int w = tid / 32;
  const int l = tid % 32;
  float row_hs[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + 16 * w + l / 4 + 8 * half;
    row_hs[half] = m < M ? __ldg(hscale + m) : 0.0f;
  }
  __syncthreads();             // barriers initialised, operands staged

  int32_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kStages;
    mbar_wait(smem_u32(&full[s]), (kt / kStages) & 1);
    const uint32_t a = ring + s * kStage;
    const uint32_t b = a + kTileA;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)
      Wgmma<BN>::mma(acc, smem_desc(a + 32 * kk), smem_desc(b + 32 * kk));
    wgmma_commit();
    // refill the stage of k-tile kt - 1 once its wgmmas have retired
    // (k-tile kt's stay in flight) and every warp has passed them
    const int refill = kt - 1 + kStages;
    if (kt >= 1 && refill < nk) {
      wgmma_wait<1>();
      __syncthreads();
      if (tid == 0) {
        const int r = (kt - 1) % kStages;
        load_stage(&map_a, &map_b, smem_u32(&full[r]), ring + r * kStage,
                   kTileA, kStage, refill, m0, n0);
      }
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // accumulator fragment: warp w, lane l holds, for each 8-column group j,
  // rows 16 w + l / 4 (regs 4j, 4j+1) and that + 8 (regs 4j+2, 4j+3) at
  // columns 8 j + 2 (l % 4) + {0, 1}
  const bool pairs = (N % 2) == 0;       // 8-byte stores stay aligned
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + 16 * w + l / 4 + 8 * half;
    if (m >= M) continue;
    float* orow = out + static_cast<int64_t>(m) * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + 2 * (l % 4);
      const int n = n0 + c;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[e] = __fmaf_rn(
            __fmul_rn(__int2float_rn(acc[4 * j + 2 * half + e]),
                      row_hs[half]),
            tile_ws[c + e], tile_bias[c + e]);
        if (relu) v[e] = max_nan(v[e], 0.0f);
      }
      if (pairs && n + 1 < N) {
        *reinterpret_cast<float2*>(orow + n) = make_float2(v[0], v[1]);
      } else {
        if (n < N) orow[n] = v[0];
        if (n + 1 < N) orow[n + 1] = v[1];
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiled>(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// (rows, K) int8, row pitch K bytes, in (box_rows, 128 B) boxes
bool encode(CUtensorMap* map, const void* base, int64_t rows, int64_t K,
            uint32_t box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t pitch[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK), box_rows};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, pitch, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN>
int launch(const void* hq, const void* hscale, const void* wt,
           const void* wscale, const void* bias, void* out, int64_t M,
           int64_t N, int64_t K, bool relu, cudaStream_t stream) {
  CUtensorMap map_a, map_b;
  if (!encode(&map_a, hq, M, K, kBM) || !encode(&map_b, wt, N, K, BN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      dmm_q8_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<BN>());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((N + BN - 1) / BN),
                  static_cast<unsigned>((M + kBM - 1) / kBM));
  dmm_q8_kernel<BN><<<grid, kThreads, smem_bytes<BN>(), stream>>>(
      map_a, map_b, static_cast<const float*>(hscale),
      static_cast<const float*>(wscale), static_cast<const float*>(bias),
      static_cast<float*>(out), static_cast<int>(M), static_cast<int>(N),
      static_cast<int>(K), relu);
  return static_cast<int>(cudaGetLastError());
}

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms > 0 ? sms : 132;
  }();
  return n;
}
}  // namespace

// hq and wt: 16-byte-aligned bases, K % 16 == 0 (dense_matmul.py pads)
extern "C" int dmm_q8(const void* hq, const void* hscale, const void* wt,
                      const void* wscale, const void* bias, void* out,
                      int64_t M, int64_t N, int64_t K, int relu,
                      void* stream) {
  if (M == 0 || N == 0) return 0;
  if (K <= 0 || K % 16 != 0 || M > 0x7fffffff || N > 0x7fffffff ||
      (M + kBM - 1) / kBM > 65535 ||
      (reinterpret_cast<uintptr_t>(hq) % 16) != 0 ||
      (reinterpret_cast<uintptr_t>(wt) % 16) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the wide tile while its grid still gives ~3/4 of the SMs a block
  const int64_t m_tiles = (M + kBM - 1) / kBM;
  const int64_t want = (3 * static_cast<int64_t>(sm_count())) / 4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m_tiles * ((N + 127) / 128) >= want) {
    return launch<128>(hq, hscale, wt, wscale, bias, out, M, N, K, relu != 0,
                       s);
  }
  return launch<32>(hq, hscale, wt, wscale, bias, out, M, N, K, relu != 0, s);
}
