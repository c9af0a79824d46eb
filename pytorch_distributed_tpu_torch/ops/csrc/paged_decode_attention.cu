// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel pytorch_distributed_tpu/ops/paged_attention.py
// ::_decode_kernel. One new query token per sequence attends every cached
// position <= lengths[b] of its chain, reading K and V through the
// sequence's block table straight from the page pools in their native
// [n_pages, page_size, H, D] layout (strides are passed in, so no call ever
// copies or transposes a pool).
//
// What bounds it on the card: bytes. Each visible K/V element is read once
// and takes part in two multiply-adds, far below the ~20 fp32 operations per
// byte where the H100's CUDA cores would become the limit. At decode sizes
// (a few hundred visible positions per sequence) it is also bound by
// latency: a CTA walks its chain serially.
//
// Design: one CTA per (head, sequence). Each of its warps walks a strided
// share of the visible positions with its own online softmax (fp32 running
// max, sum and accumulator, as in the TPU kernel's VMEM scratch); the lanes
// split D, so one K or V row is one coalesced read. Positions past
// lengths[b] are never visited, so no masking is needed, and pages past the
// query are never read. The warps' partial states merge through shared
// memory at the end. Inactive slots (all-zero table row, length 0) read
// position 0 of the trash page 0, so the sum is >= 1 and nothing divides by
// zero.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxDPerLane = 8;  // head size up to 256
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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* tables;
  const int32_t* lengths;
  void* out;
  int H, D, page_size, max_pages;
  int64_t q_sb, q_sh;        // q [B, 1, H, D]: batch and head strides
  int64_t k_sp, k_so, k_sh;  // pool [P, page, H, D]: page, offset, head strides
  int64_t v_sp, v_so, v_sh;
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) paged_decode_kernel(Args a) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + h * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + h * a.v_sh;
  const int32_t* tbl = a.tables + static_cast<int64_t>(b) * a.max_pages;

  float qr[kMaxDPerLane];
  float acc[kMaxDPerLane];
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i) {
    const int d = lane + 32 * i;
    qr[i] = d < a.D ? to_f32(q[d]) : 0.f;
    acc[i] = 0.f;
  }

  // the query sits at position lengths[b]; the table covers
  // max_pages * page_size positions, as the TPU grid does
  const int last = min(a.lengths[b], a.max_pages * a.page_size - 1);
  float m = kNegInf;
  float l = 0.f;
  for (int pos = warp; pos <= last; pos += kWarps) {
    const int64_t page = tbl[pos / a.page_size];
    const int off = pos % a.page_size;
    const T* kr = kp + page * a.k_sp + off * a.k_so;
    const T* vr = vp + page * a.v_sp + off * a.v_so;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < a.D) s += qr[i] * to_f32(kr[d]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    s *= a.scale;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int i = 0; i < kMaxDPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < a.D) acc[i] = acc[i] * alpha + p * to_f32(vr[d]);
    }
    m = m_new;
  }

  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][kMaxDPerLane * 32];
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < kMaxDPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < a.D) sm_acc[warp][d] = acc[i];
  }
  __syncthreads();

  // merge the warps' partial softmax states; a warp that saw no position
  // holds m = -1e30 and weighs exp(-1e30 - M) = 0
  float M = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w]);
  float L = 0.f;
  float wt[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    wt[w] = expf(sm_m[w] - M);
    L += sm_l[w] * wt[w];
  }
  T* out = static_cast<T*>(a.out) + (static_cast<int64_t>(b) * a.H + h) * a.D;
  for (int d = threadIdx.x; d < a.D; d += blockDim.x) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += sm_acc[w][d] * wt[w];
    out[d] = from_f32<T>(o / L);
  }
}

template <typename T>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const dim3 grid(a.H, B);
  paged_decode_kernel<T><<<grid, kWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 float32, 1 bfloat16,
// 2 float16 (q, pools and out share it). Launches on `stream`, does not
// synchronise, and returns the launch's cudaError_t.
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* tables,
    const void* lengths, void* out, int B, int H, int D, int page_size,
    int max_pages, long long q_sb, long long q_sh, long long k_sp,
    long long k_so, long long k_sh, long long v_sp, long long v_so,
    long long v_sh, float scale, int dtype, void* stream) {
  if (B < 0 || B > 65535 || H < 1 || H > 65535 || D < 1 ||
      D > kMaxDPerLane * 32 || page_size < 1 || max_pages < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.tables = static_cast<const int32_t*>(tables);
  a.lengths = static_cast<const int32_t*>(lengths);
  a.out = out;
  a.H = H;
  a.D = D;
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.k_sp = k_sp;
  a.k_so = k_so;
  a.k_sh = k_sh;
  a.v_sp = v_sp;
  a.v_so = v_so;
  a.v_sh = v_sh;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(a, B, s));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(a, B, s));
    case 2:
      return static_cast<int>(launch<__half>(a, B, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
