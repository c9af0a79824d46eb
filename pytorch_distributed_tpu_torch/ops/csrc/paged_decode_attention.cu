// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel pytorch_distributed_tpu/ops/paged_attention.py
// ::_decode_kernel. One new query token per sequence attends every cached
// position <= lengths[b] of its chain, reading K and V through the
// sequence's block table straight from the page pools in their native
// [n_pages, page_size, H, D] layout (strides are passed in, so no call ever
// copies or transposes a pool).
//
// What bounds it on the card: bytes, and at decode lengths latency. Each
// visible K/V element is read once and takes part in two multiply-adds, far
// below the ~20 fp32 operations per byte where the H100's CUDA cores would
// become the limit, so the tensor cores have nothing to do. A few hundred
// visible positions per sequence are too few bytes to fill the card's
// memory system from one CTA per (head, sequence): the chain has to be
// spread over many CTAs, each with its loads in flight together.
//
// Design (flash-decoding), two kernels:
//   paged_decode_split_kernel, grid (splits, H, B): split s of a chain owns
//     positions [s L, (s + 1) L), L = pages_per_split * page_size. The grid
//     comes from shapes alone (splits = ceil(max_pages / pages_per_split)),
//     so the host never reads lengths; a CTA whose split starts past
//     lengths[b] exits at once and writes nothing. A row of D is read by
//     D / 8 lanes, 8 elements a lane (one 16-byte load for bf16/fp16, two
//     for fp32), so at D = 64 a warp reads 4 rows at once and a score
//     reduces over its row's lanes in 3 shuffles. The CTA's 128
//     threads take 4 passes of 16 rows (at D = 64): every K and V load of
//     the 64 rows is issued before the first score uses one. Then one
//     softmax pass over the rows: the CTA's max once (warp shuffles, then 4
//     warps through shared memory), one exp a score, p V summed in fp32 and
//     reduced over the rows. The partial (m, l, acc[D]) goes, in fp32, to a
//     workspace the wrapper allocates.
//   paged_decode_merge_kernel, grid (H, B): merges a chain's live partials
//     (the splits that start at or before the query; no other is written)
//     by lse, weighting partial i by exp(m_i - M), and writes out in q's
//     dtype. Reading only those keeps a short chain's merge short: the
//     serve phase's chains of 48-64 positions have 1 live split of 16.
// Inactive slots (all-zero table row, length 0) read position 0 of the
// trash page 0, so the sum is >= 1 and nothing divides by zero.
//
// Numerics as the TPU kernel's: scores, m, l and the accumulators are
// fp32, scale = 1/sqrt(D); only the order of the sums differs.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // split kernel: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;        // elements of a row one lane reads
constexpr int kPasses = 4;     // row passes whose loads are in flight together
constexpr int kMaxD = 32 * kVec;  // head size up to 256
constexpr int kMergeThreads = 64;
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

// Two 16-bit values of one 32-bit word, widened.
__device__ __forceinline__ float2 unpack2(uint32_t w, __nv_bfloat16*) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}
__device__ __forceinline__ float2 unpack2(uint32_t w, __half*) {
  return __half22float2(*reinterpret_cast<__half2*>(&w));
}

// Elements d0 .. d0 + 7 of a row, widened to fp32; kWide: 16-byte loads
// (the row's base and d0 16-byte aligned, d0 + 8 <= D), else one element
// at a time with 0 past D.
template <typename T, bool kWide>
__device__ __forceinline__ void load8(const T* row, int d0, int D, float (&f)[kVec]) {
  if constexpr (kWide) {
    if constexpr (sizeof(T) == 4) {
      const float4* src = reinterpret_cast<const float4*>(row + d0);
      const float4 a = __ldg(src);
      const float4 b = __ldg(src + 1);
      f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
      f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
    } else {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(row + d0));
      const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = unpack2(words[i], static_cast<T*>(nullptr));
        f[2 * i] = x.x;
        f[2 * i + 1] = x.y;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) f[j] = d0 + j < D ? to_f32(row[d0 + j]) : 0.f;
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* tables;
  const int32_t* lengths;
  void* out;
  float* part;  // [B, H, splits, D + 2]: acc[D], then m and l
  int H, D, page_size, max_pages, pages_per_split, splits;
  int lanes;    // lanes of a row: the power of two >= D / kVec
  int64_t q_sb, q_sh;        // q [B, 1, H, D]: batch and head strides
  int64_t k_sp, k_so, k_sh;  // pool [P, page, H, D]: page, offset, head strides
  int64_t v_sp, v_so, v_sh;
  float scale;
};

// The page ids of rows pos0 + p * stride (p < kPasses): table entries
// clamped into the table (a row past it is never read).
__device__ __forceinline__ void table_entries(int64_t (&pages)[kPasses], const int32_t* tbl,
                                              int pos0, int stride, const Args& a) {
#pragma unroll
  for (int p = 0; p < kPasses; ++p)
    pages[p] = tbl[min((pos0 + p * stride) / a.page_size, a.max_pages - 1)];
}

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads) paged_decode_split_kernel(Args a) {
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunk = lane % a.lanes;          // the thread's 8 elements of a row
  const int d0 = chunk * kVec;
  const bool active = d0 < a.D;
  const int row_in_pass = threadIdx.x / a.lanes;
  const int rows_per_pass = kThreads / a.lanes;
  const int L = a.pages_per_split * a.page_size;  // positions of a split
  const int s0 = split * L;
  float* part = a.part + ((static_cast<int64_t>(b) * a.H + h) * a.splits + split) * (a.D + 2);

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + h * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + h * a.v_sh;
  const int32_t* tbl = a.tables + static_cast<int64_t>(b) * a.max_pages;
  const int group = kPasses * rows_per_pass;

  // the page ids of the first group's rows and the query, loaded beside
  // the length: the K/V loads then wait for one load, not two in a row
  int64_t pages[kPasses];
  table_entries(pages, tbl, s0 + row_in_pass, rows_per_pass, a);
  float qf[kVec];
  load8<T, false>(q, d0, active ? a.D : 0, qf);  // zeros on an idle chunk
  // the query sits at position lengths[b]; the table covers
  // max_pages * page_size positions, as the TPU grid does
  const int last = min(a.lengths[b], a.max_pages * a.page_size - 1);
  if (s0 > last) return;  // an empty split: the merge reads only live ones

  __shared__ float red[kWarps];
  __shared__ float acc_s[kWarps][kMaxD + 1];  // [warp][D], then l
  float m = kNegInf;  // uniform over the CTA
  float l = 0.f;      // this thread's rows
  float acc[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[j] = 0.f;

  // groups of kPasses passes; one group covers the split at D = 64
  const int end = min(L, last - s0 + 1);
  for (int base = 0; base < end; base += group) {
    float kf[kPasses][kVec], vf[kPasses][kVec];
    bool valid[kPasses];
    // every load of the group first ...
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = base + p * rows_per_pass + row_in_pass;
      valid[p] = r < end;
      if (valid[p] && active) {
        const int off = (s0 + r) % a.page_size;
        load8<T, kWide>(kp + pages[p] * a.k_sp + off * a.k_so, d0, a.D, kf[p]);
        load8<T, kWide>(vp + pages[p] * a.v_sp + off * a.v_so, d0, a.D, vf[p]);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) kf[p][j] = vf[p][j] = 0.f;
      }
    }
    // ... then the scores: a dot over the row's lanes
    float s[kPasses];
    float mx = -INFINITY;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      float x = 0.f;
#pragma unroll
      for (int j = 0; j < kVec; ++j) x = fmaf(qf[j], kf[p][j], x);
      for (int o = a.lanes / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      s[p] = valid[p] ? x * a.scale : -INFINITY;
      mx = fmaxf(mx, s[p]);
    }
    // the group's max over the CTA, once
    for (int o = 16; o >= a.lanes; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) red[warp] = mx;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red[w]);
    __syncthreads();  // red is read before the next group writes it
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);  // 0 on the first group
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] *= alpha;
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const float e = expf(s[p] - m);  // exactly 0 past the split's end
      l += e;
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc[j] = fmaf(e, vf[p][j], acc[j]);
    }
    if (base + group < end)
      table_entries(pages, tbl, s0 + base + group + row_in_pass, rows_per_pass, a);
  }

  // sum over the rows: the lanes of a warp that hold the same chunk, then
  // the warps through shared memory
  for (int o = 16; o >= a.lanes; o >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
  }
  if (lane < a.lanes && active) {
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (d0 + j < a.D) acc_s[warp][d0 + j] = acc[j];
    if (chunk == 0) acc_s[warp][kMaxD] = l;
  }
  __syncthreads();
  for (int d = threadIdx.x; d <= a.D; d += kThreads) {
    const int src = d < a.D ? d : kMaxD;
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) x += acc_s[w][src];
    part[d < a.D ? d : a.D + 1] = x;
  }
  if (threadIdx.x == 0) part[a.D] = m;
}

// The max (kMax) or the sum of x over the CTA of the merge kernel.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  __syncthreads();  // red's previous readers are done
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < kMergeThreads / 32; ++w) x = kMax ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// out[b, 0, h, :] from the chain's live partials (the splits that start at
// or before the query; split 0 always does): M = max m_i, weights
// exp(m_i - M), staged once in shared memory for the first kMaxStaged
// splits.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads) paged_decode_merge_kernel(Args a) {
  constexpr int kMaxStaged = 256;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int stride = a.D + 2;
  const float* part = a.part + (static_cast<int64_t>(b) * a.H + h) * a.splits * stride;
  const int last = min(a.lengths[b], a.max_pages * a.page_size - 1);
  const int live = min(a.splits, last / (a.pages_per_split * a.page_size) + 1);
  __shared__ float w_s[kMaxStaged];
  __shared__ float red[kMergeThreads / 32];

  float M = kNegInf;
  for (int i = threadIdx.x; i < live; i += kMergeThreads) M = fmaxf(M, part[i * stride + a.D]);
  M = block_reduce<true>(M, red);
  float L = 0.f;
  for (int i = threadIdx.x; i < live; i += kMergeThreads) {
    const float w = expf(part[i * stride + a.D] - M);
    if (i < kMaxStaged) w_s[i] = w;
    L += part[i * stride + a.D + 1] * w;
  }
  L = block_reduce<false>(L, red);  // its barrier also publishes w_s

  T* out = static_cast<T*>(a.out) + (static_cast<int64_t>(b) * a.H + h) * a.D;
  for (int d = threadIdx.x; d < a.D; d += kMergeThreads) {
    float o = 0.f;
    for (int i = 0; i < live; ++i) {
      const float w = i < kMaxStaged ? w_s[i] : expf(part[i * stride + a.D] - M);
      o = fmaf(part[i * stride + d], w, o);
    }
    out[d] = from_f32<T>(o / L);
  }
}

template <typename T>
cudaError_t launch(const Args& a, int B, bool wide, cudaStream_t stream) {
  const dim3 grid(a.splits, a.H, B);
  if (wide)
    paged_decode_split_kernel<T, true><<<grid, kThreads, 0, stream>>>(a);
  else
    paged_decode_split_kernel<T, false><<<grid, kThreads, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_decode_merge_kernel<T><<<dim3(a.H, B), kMergeThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p, long long stride, int elt) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (stride * elt) % 16 == 0;
}

}  // namespace

// Plain C entry point, loaded with ctypes. dtype: 0 float32, 1 bfloat16,
// 2 float16 (q, pools and out share it). workspace: fp32, B * H * splits *
// (D + 2) elements with splits = ceil(max_pages / pages_per_split). Launches
// the two kernels on `stream`, does not synchronise, and returns the first
// launch error (cudaError_t).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* k, const void* v, const void* tables,
    const void* lengths, void* out, void* workspace, int B, int H, int D,
    int page_size, int max_pages, int pages_per_split, long long q_sb,
    long long q_sh, long long k_sp, long long k_so, long long k_sh,
    long long v_sp, long long v_so, long long v_sh, float scale, int dtype,
    void* stream) {
  const int splits = pages_per_split < 1 ? 0 : (max_pages + pages_per_split - 1) / pages_per_split;
  if (B < 0 || B > 65535 || H < 1 || H > 65535 || D < 1 || D > kMaxD || page_size < 1 ||
      max_pages < 1 || pages_per_split < 1 || splits > 65535 ||
      static_cast<long long>(pages_per_split) * page_size > (1 << 30)) {
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
  a.part = static_cast<float*>(workspace);
  a.H = H;
  a.D = D;
  a.page_size = page_size;
  a.max_pages = max_pages;
  a.pages_per_split = pages_per_split;
  a.splits = splits;
  a.lanes = 1;
  while (a.lanes * kVec < D) a.lanes *= 2;
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
  const int elt = dtype == 0 ? 4 : 2;
  // 16-byte loads where every row start and every chunk of 8 is aligned
  bool wide = D % kVec == 0;
  const long long strides[6] = {k_sp, k_so, k_sh, v_sp, v_so, v_sh};
  for (int i = 0; i < 6; ++i) wide = wide && aligned16(i < 3 ? k : v, strides[i], elt);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(a, B, wide, s));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(a, B, wide, s));
    case 2:
      return static_cast<int>(launch<__half>(a, B, wide, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
