// Static-causal flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces three TPU kernels of pytorch_distributed_tpu/ops/flash_attention.py:
//   B1 _fwd_kernel_pruned  -> flash_causal_fwd_kernel   (out, lse)
//   B2 _dq_kernel_pruned   -> flash_causal_dq_kernel    (dq)
//   B3 _dkv_kernel_pruned  -> flash_causal_dkv_kernel   (dk, dv)
// Causal self-attention with Tq == Tk: query row r sees key rows c <= r.
// q, k, v, do are read by stride in the model's [B, T, H, D] layout (the
// non-contiguous q/k/v views of GPT-2's c_attn split included), so no call
// copies or transposes an operand; D must be contiguous. lse and delta are
// [B, H, T] fp32, the outputs [B, T, H, D] with the strides given.
//
// What bounds them on this card: operations. At GPT-2's shapes (T = 1024,
// D = 64) each K/V element is reused by up to 16 Q tiles, far above the
// card's bytes-per-operation ratio. This first version computes in fp32 on
// the CUDA cores (tensor cores, TMA and warp specialisation are later
// work), so its ceiling is the fp32 rate, not the bf16 tensor rate.
//
// Design. Tiles are 64 query rows by 64 key rows. Blocks run in no order,
// so where the TPU grid carried the online softmax (or dq, or dk/dv) in
// VMEM scratch from one grid step to the next, one CTA here owns one
// output tile and loops over its partners itself:
//   B1, B2: one CTA per (Q tile, head, batch), looping over K/V tiles
//           0 .. qi (the pruning: tiles above the diagonal are never
//           loaded); the longest rows are scheduled first.
//   B3:     one CTA per (K/V tile, head, batch), looping over Q tiles
//           qi_first = ki .. nq-1 with dk/dv accumulated in fp32 registers,
//           no atomics (the JAX two-pass split: dq and dk/dv apart).
// Operand tiles are staged in shared memory as fp32 (rows padded to
// D+4 floats for 16-byte reads without bank conflicts). 256 threads form a
// 16 x 16 grid; thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
// (i, j < 4) of each 64 x 64 score tile, so a row's max and sum reduce
// over the 16 lanes of one half-warp with shuffles (the tile pieces are in
// flash_tiles.cuh, shared with the masked kernels). Masking applies only
// on tiles that cross the diagonal or the ragged tail (T need not be a
// multiple of 64). As in the TPU kernels: scores, m, l and every
// accumulator are fp32, scale = 1/sqrt(D) in fp32, p is rounded to the
// input dtype before the PV product in the forward, and rows whose lse is
// <= -1e30/2 get p = 0 in the backward.
#include "flash_tiles.cuh"

namespace {

using namespace flash;

struct Dims {
  int T, H, D;
  float scale;
};

// ---------------------------------------------------------------- B1
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_causal_fwd_kernel(View q, View k, View v, View out, float* lse, Dims n) {
  constexpr int LD = kD + 4;
  constexpr int kJ = kD / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;

  const int nq = (n.T + kTile - 1) / kTile;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qi * kTile;

  load_tile<T, kD>(Qs, q, b, h, q0, n.T, n.D);
  float m[4], l[4], acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;
  }

  // pruned: K/V tiles 0 .. qi (last_ki = (q0 + 63) / 64 = qi)
  for (int ki = 0; ki <= qi; ++ki) {
    const int k0 = ki * kTile;
    __syncthreads();  // the previous tile's Ks/Vs/Ps are consumed
    load_tile<T, kD>(Ks, k, b, h, k0, n.T, n.D);
    load_tile<T, kD>(Vs, v, b, h, k0, n.T, n.D);
    __syncthreads();

    float s[4][4];
    dot_tile<kD>(s, Qs, Ks, ty, tx);
    const bool edge = (k0 + kTile - 1 > q0) || (k0 + kTile > n.T);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      bool keep[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        keep[j] = !edge || (c <= r && c < n.T);
        s[i][j] = keep[j] ? s[i][j] * n.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        Ps[(ty + 16 * i) * kLP + tx + 16 * j] = round_to<T>(p);
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    pv_tile<kD>(acc, Ps, Vs, ty, tx);
  }

  float safe[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) safe[i] = fmaxf(l[i], 1e-30f);
  store_tile<T, kD>(out, b, h, q0, acc, safe, n.T, n.D);
  if (tx == 0) {
    float* lse_bh = lse + (static_cast<int64_t>(b) * n.H + h) * n.T;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      if (r < n.T) lse_bh[r] = l[i] > 0.f ? m[i] + logf(safe[i]) : kNegInf;
    }
  }
}

// ---------------------------------------------------------------- B2
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_causal_dq_kernel(View q, View k, View v, View dout, const float* lse,
                       const float* delta, View dq, Dims n) {
  constexpr int LD = kD + 4;
  constexpr int kJ = kD / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* dSs = Vs + kTile * LD;

  const int nq = (n.T + kTile - 1) / kTile;
  const int qi = nq - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = qi * kTile;
  const int64_t bh = (static_cast<int64_t>(b) * n.H + h) * n.T;

  load_tile<T, kD>(Qs, q, b, h, q0, n.T, n.D);
  load_tile<T, kD>(dOs, dout, b, h, q0, n.T, n.D);
  float lse_r[4], delta_r[4], acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < n.T ? lse[bh + r] : 0.f;
    delta_r[i] = r < n.T ? delta[bh + r] : 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;
  }

  for (int ki = 0; ki <= qi; ++ki) {
    const int k0 = ki * kTile;
    __syncthreads();
    load_tile<T, kD>(Ks, k, b, h, k0, n.T, n.D);
    load_tile<T, kD>(Vs, v, b, h, k0, n.T, n.D);
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_tile<kD>(s, Qs, Ks, ty, tx);
    dot_tile<kD>(dp, dOs, Vs, ty, tx);
    const bool edge = (k0 + kTile - 1 > q0) || (k0 + kTile > n.T);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      const bool dead = lse_r[i] <= kNegInf / 2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool keep = !edge || (c <= r && c < n.T);
        const float p = (keep && !dead) ? expf(s[i][j] * n.scale - lse_r[i]) : 0.f;
        dSs[(ty + 16 * i) * kLP + tx + 16 * j] = p * (dp[i][j] - delta_r[i]) * n.scale;
      }
    }
    __syncthreads();
    pv_tile<kD>(acc, dSs, Ks, ty, tx);
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_tile<T, kD>(dq, b, h, q0, acc, one, n.T, n.D);
}

// ---------------------------------------------------------------- B3
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_causal_dkv_kernel(View q, View k, View v, View dout, const float* lse,
                        const float* delta, View dk, View dv, Dims n) {
  constexpr int LD = kD + 4;
  constexpr int kJ = kD / 16;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* dOs = Qs + kTile * LD;
  float* Pt = dOs + kTile * LD;  // [key row][query row]
  float* dSt = Pt + kTile * kLP;
  float* lse_s = dSt + kTile * kLP;
  float* delta_s = lse_s + kTile;

  const int nq = (n.T + kTile - 1) / kTile;
  const int ki = blockIdx.x;  // the first tiles have the most Q tiles
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = ki * kTile;
  const int64_t bh = (static_cast<int64_t>(b) * n.H + h) * n.T;

  load_tile<T, kD>(Ks, k, b, h, k0, n.T, n.D);
  load_tile<T, kD>(Vs, v, b, h, k0, n.T, n.D);
  float dk_acc[4][kJ], dv_acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // qi_first = k0 / 64 = ki: the first Q tile that reaches this K tile
  for (int qi = ki; qi < nq; ++qi) {
    const int q0 = qi * kTile;
    __syncthreads();
    load_tile<T, kD>(Qs, q, b, h, q0, n.T, n.D);
    load_tile<T, kD>(dOs, dout, b, h, q0, n.T, n.D);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < n.T ? lse[bh + r] : 0.f;
      delta_s[threadIdx.x] = r < n.T ? delta[bh + r] : 0.f;
    }
    __syncthreads();

    // cell (i, j): key row c = k0 + ty + 16 i, query row r = q0 + tx + 16 j
    float s[4][4], dp[4][4];
    dot_tile<kD>(s, Ks, Qs, ty, tx);
    dot_tile<kD>(dp, Vs, dOs, ty, tx);
    const bool edge = (k0 + kTile - 1 > q0) || (q0 + kTile > n.T);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = q0 + tx + 16 * j;
      const float lse_v = lse_s[tx + 16 * j];
      const float delta_v = delta_s[tx + 16 * j];
      const bool dead = lse_v <= kNegInf / 2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = k0 + ty + 16 * i;
        const bool keep = !edge || (c <= r && r < n.T);
        const float p = (keep && !dead) ? expf(s[i][j] * n.scale - lse_v) : 0.f;
        Pt[(ty + 16 * i) * kLP + tx + 16 * j] = p;
        dSt[(ty + 16 * i) * kLP + tx + 16 * j] = p * (dp[i][j] - delta_v) * n.scale;
      }
    }
    __syncthreads();
    pv_tile<kD>(dv_acc, Pt, dOs, ty, tx);
    pv_tile<kD>(dk_acc, dSt, Qs, ty, tx);
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_tile<T, kD>(dk, b, h, k0, dk_acc, one, n.T, n.D);
  store_tile<T, kD>(dv, b, h, k0, dv_acc, one, n.T, n.D);
}

// ---------------------------------------------------------------- launch
template <int kD>
constexpr size_t fwd_smem() { return (3 * kTile * (kD + 4) + kTile * kLP) * sizeof(float); }
template <int kD>
constexpr size_t dq_smem() { return (4 * kTile * (kD + 4) + kTile * kLP) * sizeof(float); }
template <int kD>
constexpr size_t dkv_smem() {
  return (4 * kTile * (kD + 4) + 2 * kTile * kLP + 2 * kTile) * sizeof(float);
}

template <typename T, int kD>
cudaError_t fwd(const void* const* p, const long long* s, int B, const Dims& n,
                cudaStream_t stream) {
  const size_t smem = fwd_smem<kD>();
  cudaError_t e = allow_smem(flash_causal_fwd_kernel<T, kD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n.T + kTile - 1) / kTile, n.H, B);
  flash_causal_fwd_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      view(p[0], s), view(p[1], s + 3), view(p[2], s + 6), view(p[3], s + 9),
      static_cast<float*>(const_cast<void*>(p[4])), n);
  return cudaGetLastError();
}

template <typename T, int kD>
cudaError_t dq(const void* const* p, const long long* s, int B, const Dims& n,
               cudaStream_t stream) {
  const size_t smem = dq_smem<kD>();
  cudaError_t e = allow_smem(flash_causal_dq_kernel<T, kD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n.T + kTile - 1) / kTile, n.H, B);
  flash_causal_dq_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      view(p[0], s), view(p[1], s + 3), view(p[2], s + 6), view(p[3], s + 9),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      view(p[6], s + 12), n);
  return cudaGetLastError();
}

template <typename T, int kD>
cudaError_t dkv(const void* const* p, const long long* s, int B, const Dims& n,
                cudaStream_t stream) {
  const size_t smem = dkv_smem<kD>();
  cudaError_t e = allow_smem(flash_causal_dkv_kernel<T, kD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n.T + kTile - 1) / kTile, n.H, B);
  flash_causal_dkv_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      view(p[0], s), view(p[1], s + 3), view(p[2], s + 6), view(p[3], s + 9),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      view(p[6], s + 12), view(p[7], s + 15), n);
  return cudaGetLastError();
}

enum Pass { kFwd, kDq, kDkv };

template <typename T, int kD>
cudaError_t run(Pass pass, const void* const* p, const long long* s, int B,
                const Dims& n, cudaStream_t stream) {
  switch (pass) {
    case kFwd: return fwd<T, kD>(p, s, B, n, stream);
    case kDq: return dq<T, kD>(p, s, B, n, stream);
    default: return dkv<T, kD>(p, s, B, n, stream);
  }
}

template <typename T>
cudaError_t run_d(Pass pass, const void* const* p, const long long* s, int B,
                  const Dims& n, cudaStream_t stream) {
  if (n.D <= 64) return run<T, 64>(pass, p, s, B, n, stream);
  return run<T, 128>(pass, p, s, B, n, stream);
}

int dispatch(Pass pass, const void* const* p, const long long* s, int B, int T,
             int H, int D, float scale, int dtype, void* stream) {
  if (B < 0 || B > 65535 || T < 0 || H < 1 || H > 65535 || D < 1 || D > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || T == 0) return 0;
  Dims n;
  n.T = T;
  n.H = H;
  n.D = D;
  n.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return static_cast<int>(run_d<float>(pass, p, s, B, n, st));
    case 1: return static_cast<int>(run_d<__nv_bfloat16>(pass, p, s, B, n, st));
    case 2: return static_cast<int>(run_d<__half>(pass, p, s, B, n, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype: 0 float32, 1 bfloat16,
// 2 float16 (q, k, v, do and the outputs share it; lse and delta are fp32
// [B, H, T] contiguous). `strides` holds, for each [B, T, H, D] tensor in
// argument order, its batch, time and head strides in elements. Each call
// launches on `stream`, does not synchronise, and returns the launch's
// cudaError_t.

// B1: out [B, T, H, D] and lse [B, H, T]. strides: q, k, v, out.
extern "C" int flash_causal_fwd_launch(const void* q, const void* k, const void* v,
                                       void* out, void* lse, const long long* strides,
                                       int B, int T, int H, int D, float scale,
                                       int dtype, void* stream) {
  const void* p[5] = {q, k, v, out, lse};
  return dispatch(kFwd, p, strides, B, T, H, D, scale, dtype, stream);
}

// B2: dq. strides: q, k, v, do, dq.
extern "C" int flash_causal_dq_launch(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dq,
                                      const long long* strides, int B, int T, int H,
                                      int D, float scale, int dtype, void* stream) {
  const void* p[7] = {q, k, v, dout, lse, delta, dq};
  return dispatch(kDq, p, strides, B, T, H, D, scale, dtype, stream);
}

// B3: dk and dv. strides: q, k, v, do, dk, dv.
extern "C" int flash_causal_dkv_launch(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv,
                                       const long long* strides, int B, int T, int H,
                                       int D, float scale, int dtype, void* stream) {
  const void* p[8] = {q, k, v, dout, lse, delta, dk, dv};
  return dispatch(kDkv, p, strides, B, T, H, D, scale, dtype, stream);
}
