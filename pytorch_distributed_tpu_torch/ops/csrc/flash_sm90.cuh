// Hopper (sm_90a) building blocks for the flash attention kernels of the
// causal (B1-B3) and the position-masked (B4-B6) sources: TMA tensor maps
// of [B, T, H, D] views, the CTA and shared-memory layout, the mbarrier
// ring, wgmma descriptors of 128B-swizzled 16-bit tiles, m64n64k16 wgmma
// with A from shared memory or from registers, the product of a score
// tile in registers with a K or V tile (O += P V, dQ += dS K), and the
// forward's online-softmax step.
//
// A tile here is 64 rows of one (batch, head) by 64 columns of D, 16-bit:
// one TMA box, 64 rows of 128 bytes, 8 KB, stored with the 128B swizzle
// (16-byte chunk c of row r lands at chunk c ^ (r % 8)), so every tile
// starts on a 1024-byte boundary. A head of D = 128 is two such tiles,
// one per 64 columns. Columns at or past D and rows at or past T arrive
// as zeros (TMA's out-of-bounds fill).
//
// Products (fp32 accumulators, m64n64k16, 16-bit inputs):
//   K-major operand (the contraction runs along D, e.g. S = Q K^T):
//     rows are the M (or N) index, each k16 step is 32 bytes further
//     along the row; desc_kmajor(tile, kk).
//   MN-major operand (the contraction runs along the tile's rows, e.g.
//     O += P V): rows are the K index, a k16 step is 16 rows further;
//     desc_mnmajor(tile, kk) with imm-trans-b = 1.
// The fp32 accumulator of an m64n64k16 product, thread t of the
// warpgroup (warp w = t / 32, lane l), register i < 32:
//   row 16 w + l / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (l % 4) + i % 2.
// Registers 8 kk .. 8 kk + 7, rounded to 16 bits in pairs, are exactly the
// A fragment of a k16 step over columns 16 kk .. 16 kk + 15
// (FlashAttention-3's layout identity), so a score tile feeds the next
// product without leaving registers.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no driver symbol is linked)
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

constexpr int kBoxCols = 64;                   // 128 bytes of a 16-bit row
constexpr int kBoxRows = 64;
constexpr int kTileBytes = kBoxRows * 128;     // one swizzled 64 x 64 tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (so
// the library needs no -lcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The layout TMA needs of a [B, T, H, D] view with strides s (batch, time,
// head, in elements; D contiguous): D a multiple of 8, a 16-byte aligned
// base, and every stride of a dimension longer than 1 a multiple of 16
// bytes. The Python wrapper checks the same rule and names it.
inline bool tma_layout_ok(const void* p, const long long* s, int B, int T, int H, int D,
                          int elt) {
  const long long sizes[3] = {B, T, H};
  if (D % 8 != 0 || reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (sizes[i] > 1 && (s[i] * elt) % 16 != 0) return false;
  return true;
}

// The tensor map of a [B, T, H, D] view: 4-D, dims (D, H, T, B), the
// view's own byte strides, a (64, 1, 64, 1) box, 128B swizzle, zeros out
// of bounds. A dimension of size 1 is never stepped, so its stride is
// replaced by a valid one.
inline cudaError_t make_map(CUtensorMap* map, const void* p, const long long* s, int B,
                            int T, int H, int D, CUtensorMapDataType type) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t elt = 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const long long view_strides[3] = {s[2], s[1], s[0]};  // head, time, batch
  cuuint64_t strides[3];
  cuuint64_t extent = ((D * elt + 15) / 16) * 16;  // bytes spanned by the inner dims
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] > 1 ? static_cast<cuuint64_t>(view_strides[i]) * elt : extent;
    extent = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {kBoxCols, 1, kBoxRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, 4, const_cast<void*>(p), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// TMA maps of the first `count` [B, T, H, D] operands of p (strides s,
// three per operand), operand i with Ts[i] rows (a rectangular hop has
// Tq != Tk). Fails where an operand's layout breaks TMA's rule.
template <typename T>
cudaError_t make_maps(CUtensorMap* maps, int count, const void* const* p, const long long* s,
                      int B, const int* Ts, int H, int D) {
  for (int i = 0; i < count; ++i) {
    if (!tma_layout_ok(p[i], s + 3 * i, B, Ts[i], H, D, sizeof(T)))
      return cudaErrorInvalidValue;
    const cudaError_t e = make_map(&maps[i], p[i], s + 3 * i, B, Ts[i], H, D, map_type<T>());
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// ------------------------------------------------------------ CTA layout
// A CTA of the Hopper kernels is two consumer warpgroups (warps 0-7, 64
// rows each) and one producer warp (warp 8) that starts the TMA loads.
constexpr int kSm90Threads = 288;
constexpr int kProducerWarp = 8;

template <int kD>
struct Sm90Layout {
  static constexpr int kBoxes = kD / 64;                // tiles across D
  static constexpr int kStages = kD == 64 ? 3 : 2;
  static constexpr int kRows64 = kBoxes * kTileBytes;   // 64 rows, all of D
  // B3 at D = 128 adds warps 9-11, which only give their registers to the
  // consumers (setmaxnreg moves registers within a CTA, one warpgroup to
  // another); at D = 64 the registers do not bind, and the split is slower
  static constexpr int kDkvThreads = kD == 128 ? 384 : kSm90Threads;
  // dynamic shared memory: 1024 bytes of alignment slack, `resident`
  // 64-row tiles that stay for the whole CTA (two per operand, one per
  // warpgroup), and the ring's stages of two tiles each
  static constexpr size_t smem_bytes(int resident) {
    return 1024 + static_cast<size_t>(resident + 2 * kStages) * kRows64;
  }
};

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The first 1024-byte boundary of dynamic shared memory (128B swizzle).
__device__ __forceinline__ char* align_1024(char* raw) {
  const uint32_t off = smem_addr(raw);
  return raw + ((1024 - off % 1024) % 1024);
}

// mbarrier ring. A stage's "full" barrier completes when its TMA bytes
// (and any thread arrivals it counts) are in; its "empty" barrier when
// every consumer warpgroup has released it. Round n of a stage waits on
// parity n & 1 (full) or (n & 1) ^ 1 (empty: the first round passes).
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a [B, T, H, D] map: columns d0 .. d0+63 of rows t0 .. t0+63
// of (b, h), into a 1024-byte aligned tile, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int d0, int h, int t0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(d0), "r"(h), "r"(t0),
      "r"(b)
      : "memory");
}

// Rows t0 .. t0+63 of (b, h) of K and of V, all kBoxes boxes of D, into a
// ring stage (the K tile, then the V tile), completing on `bar`.
template <int kBoxes>
__device__ __forceinline__ void tma_load_kv(char* stage, const CUtensorMap* mk,
                                            const CUtensorMap* mv, uint64_t* bar, int h,
                                            int t0, int b) {
  for (int e = 0; e < kBoxes; ++e) {
    tma_load(stage + e * kTileBytes, mk, bar, 64 * e, h, t0, b);
    tma_load(stage + (kBoxes + e) * kTileBytes, mv, bar, 64 * e, h, t0, b);
  }
}

// wgmma matrix descriptor of a 128B-swizzled tile: start address, leading
// and stride byte offsets (16-byte units), layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major: 8-row groups 1024 bytes apart; k16 step kk is 32 bytes along.
__device__ __forceinline__ uint64_t desc_kmajor(const char* tile, int kk) {
  return make_desc(tile + 32 * kk, 16, 1024);
}

// MN-major (imm-trans-b = 1): k16 step kk is rows 16 kk .. 16 kk + 15, two
// swizzle atoms of 8 rows 1024 bytes apart. The N extent is one 64-column
// atom, so the leading offset is never stepped.
__device__ __forceinline__ uint64_t desc_mnmajor(const char* tile, int kk) {
  return make_desc(tile + 2048 * kk, 1024, 1024);
}

// 2^x on the special-function unit (denormal results flush to zero).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Producer/consumer register split of a warp-specialised CTA: all warps
// of a warpgroup execute it together.
template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous product.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SM90_D32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define SM90_D32_ARGS                                                                  \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),      \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),   \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),   \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),   \
      "+f"(d[31])
#define SM90_WGMMA_SS(TY)                                                    \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " SM90_D32   \
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"                                    \
      : SM90_D32_ARGS                                                        \
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB))
#define SM90_WGMMA_RS(TY)                                                    \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " SM90_D32   \
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                      \
      : SM90_D32_ARGS                                                        \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), \
        "n"(kTransB))

// d (+)= A B over one k16 step, A and B from shared memory (descriptors);
// d is overwritten when accumulate is 0.
template <typename T, int kTransB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (std::is_same<T, __half>::value) {
    SM90_WGMMA_SS("f16");
  } else {
    SM90_WGMMA_SS("bf16");
  }
}

// d (+)= A B over one k16 step, A from registers (a 16-bit A fragment,
// see pack2), B from shared memory.
template <typename T, int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int accumulate) {
  if constexpr (std::is_same<T, __half>::value) {
    SM90_WGMMA_RS("f16");
  } else {
    SM90_WGMMA_RS("bf16");
  }
}

#undef SM90_WGMMA_RS
#undef SM90_WGMMA_SS
#undef SM90_D32_ARGS
#undef SM90_D32

// d = A B^T over all of D for two 64-row tiles of kD / 64 boxes each, both
// read K-major (S = Q K^T, dP = dO V^T and their transposes); started, not
// committed.
template <typename T, int kD>
__device__ __forceinline__ void wgmma_abt(float (&d)[32], const char* a, const char* b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int box = (kk / 4) * kTileBytes;
    wgmma_ss<T, 0>(d, desc_kmajor(a + box, kk % 4), desc_kmajor(b + box, kk % 4), kk > 0);
  }
}

// Two fp32 values rounded to T and packed, lo in the low half.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// The A fragments of an accumulator's four k16 steps (columns 16 kk ..
// 16 kk + 15), rounded to T.
template <typename T>
__device__ __forceinline__ void to_fragments(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack2<T>(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1]);
}

// acc += A B over the 64 columns of a score tile: A is `a` (an fp32
// accumulator of the tile) rounded to T, the register A operand; B is a
// 64-row tile of kBoxes boxes of D (V in O += P V, K in dQ += dS K) read
// through MN-major descriptors. Started, committed and waited for.
template <typename T, int kBoxes>
__device__ __forceinline__ void mma_rs(float (&acc)[kBoxes][32], const float (&a)[32],
                                       const char* b) {
  uint32_t fa[4][4];
  to_fragments<T>(a, fa);
#pragma unroll
  for (int e = 0; e < kBoxes; ++e) fence_acc(acc[e]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < kBoxes; ++e)
      wgmma_rs<T, 1>(acc[e], fa[kk], desc_mnmajor(b + e * kTileBytes, kk), 1);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int e = 0; e < kBoxes; ++e) fence_acc(acc[e]);
}

// Writes a consumer thread's part of an fp32 accumulator over kBoxes
// boxes of D, rounded to T in pairs: rows r0 and r0 + 8 (those at or past
// T_ are skipped), the columns below D, to base with a row stride of st
// elements (dQ, dK, dV).
template <typename T, int kBoxes>
__device__ __forceinline__ void store_rows(T* base, int64_t st, int r0, int T_, int D,
                                           const float (&acc)[kBoxes][32]) {
  const int c0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + 8 * hh;
    if (r >= T_) continue;
#pragma unroll
    for (int e = 0; e < kBoxes; ++e)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int d = 64 * e + 8 * jj + c0;
        if (d < D)
          *reinterpret_cast<uint32_t*>(base + r * st + d) =
              pack2<T>(acc[e][4 * jj + 2 * hh], acc[e][4 * jj + 2 * hh + 1]);
      }
  }
}

// One K/V tile of the forward (B1, B4) for a consumer thread's two rows:
// the online softmax in the log2 domain on the raw scores `sc` (masked
// ones -inf, so their p is exactly 0; m starts at -1e30, so alpha is never
// NaN), then o += P V with P rounded to T (the TPU kernels'
// p.astype(v.dtype)) as the register A operand and the tile's V (64 keys,
// kBoxes boxes of D) read through MN-major descriptors. m is the row max
// of scale * s in log2 units, l this thread's part of the row sum; the
// scale folds into the exponent's FFMA.
template <typename T, int kBoxes>
__device__ __forceinline__ void softmax_pv(float (&sc)[32], float (&m)[2], float (&l)[2],
                                           float (&o)[kBoxes][32], const char* Vs,
                                           float scale_log2) {
  float mx[2] = {-1e30f, -1e30f};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
  float alpha[2], neg_m[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // a row's max over the 4 threads that hold it
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    const float m_new = fmaxf(m[hh], mx[hh] * scale_log2);
    alpha[hh] = exp2_ftz(m[hh] - m_new);
    m[hh] = m_new;
    neg_m[hh] = -m_new;
    l[hh] *= alpha[hh];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = (i / 2) % 2;
    const float p = exp2_ftz(fmaf(sc[i], scale_log2, neg_m[hh]));
    l[hh] += p;
    sc[i] = p;
  }
#pragma unroll
  for (int e = 0; e < kBoxes; ++e)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[e][i] *= alpha[(i / 2) % 2];
  mma_rs<T, kBoxes>(o, sc, Vs);
}

}  // namespace sm90
