// Tile pieces shared by the flash attention kernels for Hopper (sm_90a):
// the static-causal B1-B3 (flash_attention_causal.cu) and the
// position-masked B4-B6 (flash_attention_masked.cu).
//
// A tile is 64 rows of one (batch, head) of a [B, T, H, D] tensor, staged
// in shared memory as fp32 with rows padded to D + 4 floats (16-byte reads
// without bank conflicts). A CTA is 256 threads in a 16 x 16 grid; thread
// (ty, tx) owns rows ty + 16 i and columns tx + 16 j (i, j < 4) of each
// 64 x 64 score tile, so a row's max and sum reduce over the 16 lanes of
// one half-warp with shuffles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kTile = 64;        // rows of a Q tile and of a K/V tile
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 cells each
constexpr int kLP = kTile + 4;   // row stride (floats) of a 64 x 64 smem tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }

// x rounded to T and back (p.astype(v.dtype) in the TPU kernels)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// A [B, T, H, D] tensor: base pointer and batch, time, head strides in
// elements (D is contiguous).
struct View {
  void* ptr;
  int64_t sb, st, sh;
};

inline View view(const void* p, const long long* s) {
  View w;
  w.ptr = const_cast<void*>(p);
  w.sb = s[0];
  w.st = s[1];
  w.sh = s[2];
  return w;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows t0 .. t0+63 of (b, h) into dst [64][kD + 4] as fp32; zero at rows
// >= T and columns >= D.
template <typename T, int kD>
__device__ __forceinline__ void load_tile(float* dst, const View& src, int b,
                                          int h, int t0, int T_, int D) {
  const T* base = static_cast<const T*>(src.ptr) + b * src.sb + h * src.sh;
  for (int idx = threadIdx.x; idx < kTile * kD; idx += kThreads) {
    const int r = idx / kD;
    const int d = idx % kD;
    const int t = t0 + r;
    float x = 0.f;
    if (t < T_ && d < D) x = to_f32(base[t * src.st + d]);
    dst[r * (kD + 4) + d] = x;
  }
}

// acc[i][j] = sum_d A[ra + 16 i][d] * Bm[rb + 16 j][d]   (A, Bm: [64][kD+4])
template <int kD>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* A,
                                         const float* Bm, int ra, int rb) {
  constexpr int LD = kD + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; d += 4) {
    float4 a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ra + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bb[j] = *reinterpret_cast<const float4*>(Bm + (rb + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, bb[j].x, s);
        s = fmaf(a[i].y, bb[j].y, s);
        s = fmaf(a[i].z, bb[j].z, s);
        s = fmaf(a[i].w, bb[j].w, s);
        acc[i][j] = s;
      }
  }
}

// acc[i][j] += sum_c P[rp + 16 i][c] * M[c][tx + 16 j]
// (P: [64][kLP] score tile, M: [64][kD+4] operand tile)
template <int kD>
__device__ __forceinline__ void pv_tile(float (&acc)[4][kD / 16], const float* P,
                                        const float* M, int rp, int tx) {
  constexpr int LD = kD + 4;
  constexpr int kJ = kD / 16;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = *reinterpret_cast<const float4*>(P + (rp + 16 * i) * kLP + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      float m[kJ];
#pragma unroll
      for (int j = 0; j < kJ; ++j) m[j] = M[(c + cc) * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pi = cc == 0 ? p[i].x : cc == 1 ? p[i].y : cc == 2 ? p[i].z : p[i].w;
#pragma unroll
        for (int j = 0; j < kJ; ++j) acc[i][j] = fmaf(pi, m[j], acc[i][j]);
      }
    }
  }
}

// Rows ty + 16 i of a [64, kD] fp32 accumulator tile, scaled by 1/div[i],
// into rows t0 + ty + 16 i of (b, h) of dst; rows >= T and columns >= D
// are not written.
template <typename T, int kD>
__device__ __forceinline__ void store_tile(const View& dst, int b, int h, int t0,
                                           const float (&acc)[4][kD / 16],
                                           const float (&div)[4], int T_, int D) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  T* base = static_cast<T*>(dst.ptr) + b * dst.sb + h * dst.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= T_) continue;
#pragma unroll
    for (int j = 0; j < kD / 16; ++j) {
      const int d = tx + 16 * j;
      if (d < D) base[t * dst.st + d] = from_f32<T>(acc[i][j] / div[i]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace flash
