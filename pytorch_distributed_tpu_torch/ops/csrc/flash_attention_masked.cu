// Position-masked flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces three TPU kernels of pytorch_distributed_tpu/ops/flash_attention.py:
//   B4 _fwd_kernel  -> flash_masked_fwd_kernel   (out, lse)
//   B5 _dq_kernel   -> flash_masked_dq_kernel    (dq)
//   B6 _dkv_kernel  -> flash_masked_dkv_kernel   (dk, dv)
// Query row r sees key row c iff q_pos[r] >= kv_pos[c], with int32 global
// positions shared by the batch (q_pos [Tq], kv_pos [Tk]); without
// positions every key row is seen (unmasked). Tq and Tk may differ. These
// are the kernels of a context-parallel ring hop: the hop's K/V chunk
// belongs to another rank, so its positions are not contiguous with Q's
// (the zigzag layout puts two runs in one chunk). q, k, v, do are read by
// stride in [B, T, H, D] (GPT-2's c_attn views and T-slices of them
// included); D must be contiguous. lse and delta are [B, H, Tq] fp32, the
// outputs [B, T, H, D] with the strides given. The forward writes out in
// the input dtype or in fp32 (a ring merges fp32 partials).
//
// What bounds them on this card: operations, as for B1-B3 (GPT-2's
// T = 1024, D = 64 reuse each K/V element up to 16 times). This first
// version computes in fp32 on the CUDA cores, so its ceiling is the fp32
// rate; tensor cores, TMA and warp specialisation are later work.
//
// Design. The same 64 x 64 tiles and thread layout as B1-B3
// (flash_tiles.cuh); one CTA owns one output tile and loops over its
// partners, since blocks run in no order:
//   B4, B5: one CTA per (Q tile, head, batch), looping over every K/V tile;
//   B6:     one CTA per (K/V tile, head, batch), looping over every Q tile
//           with dk/dv in fp32 registers, no atomics (the JAX two-pass
//           split).
// With positions the work per CTA is known only at run time, so the CTAs
// run in plain blockIdx order. A tile pair is skipped whole (no loads, no
// products) when max(q_pos of the Q tile) < min(kv_pos of the K tile), as
// the TPU kernels skip a block. Positions are not sorted (a zigzag chunk
// is two increasing runs, and a tile can straddle the jump), so the max
// and the min are reductions over the tile's valid rows, taken by one warp
// with shuffles; rows past Tq or Tk take no part. Each position tile is
// staged in shared memory beside the operand tiles. Ragged tails: loads
// give 0 past T, columns past Tk are masked, stores skip rows past T. A
// row that sees no key at all gets out = 0 and lse = -1e30, and the
// backward's guard (p = 0 where lse <= -1e30/2) gives it exact zero
// gradients, as a ring hop that holds only future keys needs. As in the
// TPU kernels: scores, m, l and every accumulator are fp32, scale =
// 1/sqrt(D) in fp32, p is rounded to the input dtype before the PV
// product in the forward.
#include <limits.h>

#include "flash_tiles.cuh"

namespace {

using namespace flash;

struct Dims {
  int Tq, Tk, H, D;
  float scale;
};

// Global positions; both null means unmasked.
struct Pos {
  const int* q;
  const int* kv;
};

// Warp 0 stages the positions of rows t0 .. t0+63 in dst (rows >= T get
// `fill`, which no valid position beats) and writes their max (kMax) or
// min to *red. The caller synchronises before reading either.
template <bool kMax>
__device__ __forceinline__ void stage_positions(int* dst, int* red, const int* pos,
                                                int t0, int T_) {
  if (threadIdx.x >= 32) return;
  const int fill = kMax ? INT_MIN : INT_MAX;
  const int a = t0 + threadIdx.x;
  const int x = a < T_ ? pos[a] : fill;
  const int y = a + 32 < T_ ? pos[a + 32] : fill;
  dst[threadIdx.x] = x;
  dst[threadIdx.x + 32] = y;
  int r = kMax ? max(x, y) : min(x, y);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int other = __shfl_xor_sync(0xffffffffu, r, o);
    r = kMax ? max(r, other) : min(r, other);
  }
  if (threadIdx.x == 0) *red = r;
}

// ---------------------------------------------------------------- B4
template <typename T, typename OutT, int kD>
__global__ void __launch_bounds__(kThreads)
flash_masked_fwd_kernel(View q, View k, View v, View out, float* lse, Pos pos,
                        Dims n) {
  constexpr int LD = kD + 4;
  constexpr int kJ = kD / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;
  int* qpos_s = reinterpret_cast<int*>(Ps + kTile * kLP);
  int* kpos_s = qpos_s + kTile;
  int* red_s = kpos_s + kTile;  // [0] max q_pos of the Q tile, [1] min kv_pos

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kTile;
  const int nk = (n.Tk + kTile - 1) / kTile;
  const bool masked = pos.q != nullptr;

  load_tile<T, kD>(Qs, q, b, h, q0, n.Tq, n.D);
  if (masked) stage_positions<true>(qpos_s, red_s, pos.q, q0, n.Tq);
  float m[4], l[4], acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;
  }

  for (int ki = 0; ki < nk; ++ki) {
    const int k0 = ki * kTile;
    __syncthreads();  // the previous tile's Ks/Vs/Ps/kpos_s are consumed
    if (masked) {
      stage_positions<false>(kpos_s, red_s + 1, pos.kv, k0, n.Tk);
      __syncthreads();
      if (red_s[0] < red_s[1]) continue;  // every pair masked (block-uniform)
    }
    load_tile<T, kD>(Ks, k, b, h, k0, n.Tk, n.D);
    load_tile<T, kD>(Vs, v, b, h, k0, n.Tk, n.D);
    __syncthreads();

    float s[4][4];
    dot_tile<kD>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = masked ? qpos_s[ty + 16 * i] : 0;
      bool keep[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        keep[j] = k0 + cl < n.Tk && (!masked || qp >= kpos_s[cl]);
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
  store_tile<OutT, kD>(out, b, h, q0, acc, safe, n.Tq, n.D);
  if (tx == 0) {
    float* lse_bh = lse + (static_cast<int64_t>(b) * n.H + h) * n.Tq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      if (r < n.Tq) lse_bh[r] = l[i] > 0.f ? m[i] + logf(safe[i]) : kNegInf;
    }
  }
}

// ---------------------------------------------------------------- B5
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_masked_dq_kernel(View q, View k, View v, View dout, const float* lse,
                       const float* delta, View dq, Pos pos, Dims n) {
  constexpr int LD = kD + 4;
  constexpr int kJ = kD / 16;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kTile * LD;
  float* Ks = dOs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* dSs = Vs + kTile * LD;
  int* qpos_s = reinterpret_cast<int*>(dSs + kTile * kLP);
  int* kpos_s = qpos_s + kTile;
  int* red_s = kpos_s + kTile;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kTile;
  const int nk = (n.Tk + kTile - 1) / kTile;
  const bool masked = pos.q != nullptr;
  const int64_t bh = (static_cast<int64_t>(b) * n.H + h) * n.Tq;

  load_tile<T, kD>(Qs, q, b, h, q0, n.Tq, n.D);
  load_tile<T, kD>(dOs, dout, b, h, q0, n.Tq, n.D);
  if (masked) stage_positions<true>(qpos_s, red_s, pos.q, q0, n.Tq);
  float lse_r[4], delta_r[4], acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < n.Tq ? lse[bh + r] : kNegInf;  // rows past Tq are dead
    delta_r[i] = r < n.Tq ? delta[bh + r] : 0.f;
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.f;
  }

  for (int ki = 0; ki < nk; ++ki) {
    const int k0 = ki * kTile;
    __syncthreads();
    if (masked) {
      stage_positions<false>(kpos_s, red_s + 1, pos.kv, k0, n.Tk);
      __syncthreads();
      if (red_s[0] < red_s[1]) continue;
    }
    load_tile<T, kD>(Ks, k, b, h, k0, n.Tk, n.D);
    load_tile<T, kD>(Vs, v, b, h, k0, n.Tk, n.D);
    __syncthreads();

    float s[4][4], dp[4][4];
    dot_tile<kD>(s, Qs, Ks, ty, tx);
    dot_tile<kD>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = masked ? qpos_s[ty + 16 * i] : 0;
      const bool dead = lse_r[i] <= kNegInf / 2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx + 16 * j;
        const bool keep = k0 + cl < n.Tk && (!masked || qp >= kpos_s[cl]);
        const float p = (keep && !dead) ? expf(s[i][j] * n.scale - lse_r[i]) : 0.f;
        dSs[(ty + 16 * i) * kLP + cl] = p * (dp[i][j] - delta_r[i]) * n.scale;
      }
    }
    __syncthreads();
    pv_tile<kD>(acc, dSs, Ks, ty, tx);
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_tile<T, kD>(dq, b, h, q0, acc, one, n.Tq, n.D);
}

// ---------------------------------------------------------------- B6
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
flash_masked_dkv_kernel(View q, View k, View v, View dout, const float* lse,
                        const float* delta, View dk, View dv, Pos pos, Dims n) {
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
  int* qpos_s = reinterpret_cast<int*>(delta_s + kTile);
  int* kpos_s = qpos_s + kTile;
  int* red_s = kpos_s + kTile;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kTile;
  const int nq = (n.Tq + kTile - 1) / kTile;
  const bool masked = pos.q != nullptr;
  const int64_t bh = (static_cast<int64_t>(b) * n.H + h) * n.Tq;

  load_tile<T, kD>(Ks, k, b, h, k0, n.Tk, n.D);
  load_tile<T, kD>(Vs, v, b, h, k0, n.Tk, n.D);
  if (masked) stage_positions<false>(kpos_s, red_s + 1, pos.kv, k0, n.Tk);
  float dk_acc[4][kJ], dv_acc[4][kJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int qi = 0; qi < nq; ++qi) {
    const int q0 = qi * kTile;
    __syncthreads();  // the previous tile is consumed (and Ks/Vs/kpos_s ready)
    if (masked) {
      stage_positions<true>(qpos_s, red_s, pos.q, q0, n.Tq);
      __syncthreads();
      if (red_s[0] < red_s[1]) continue;
    }
    load_tile<T, kD>(Qs, q, b, h, q0, n.Tq, n.D);
    load_tile<T, kD>(dOs, dout, b, h, q0, n.Tq, n.D);
    if (threadIdx.x < kTile) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < n.Tq ? lse[bh + r] : kNegInf;
      delta_s[threadIdx.x] = r < n.Tq ? delta[bh + r] : 0.f;
    }
    __syncthreads();

    // cell (i, j): key row k0 + ty + 16 i, query row q0 + tx + 16 j
    float s[4][4], dp[4][4];
    dot_tile<kD>(s, Ks, Qs, ty, tx);
    dot_tile<kD>(dp, Vs, dOs, ty, tx);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int rl = tx + 16 * j;
      const float lse_v = lse_s[rl];
      const float delta_v = delta_s[rl];
      const bool dead = lse_v <= kNegInf / 2;
      const int qp = masked ? qpos_s[rl] : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kl = ty + 16 * i;
        const bool keep = q0 + rl < n.Tq && (!masked || qp >= kpos_s[kl]);
        const float p = (keep && !dead) ? expf(s[i][j] * n.scale - lse_v) : 0.f;
        Pt[kl * kLP + rl] = p;
        dSt[kl * kLP + rl] = p * (dp[i][j] - delta_v) * n.scale;
      }
    }
    __syncthreads();
    pv_tile<kD>(dv_acc, Pt, dOs, ty, tx);
    pv_tile<kD>(dk_acc, dSt, Qs, ty, tx);
  }

  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_tile<T, kD>(dk, b, h, k0, dk_acc, one, n.Tk, n.D);
  store_tile<T, kD>(dv, b, h, k0, dv_acc, one, n.Tk, n.D);
}

// ---------------------------------------------------------------- launch
constexpr size_t kPosBytes = (2 * kTile + 2) * sizeof(int);
template <int kD>
constexpr size_t fwd_smem() {
  return (3 * kTile * (kD + 4) + kTile * kLP) * sizeof(float) + kPosBytes;
}
template <int kD>
constexpr size_t dq_smem() {
  return (4 * kTile * (kD + 4) + kTile * kLP) * sizeof(float) + kPosBytes;
}
template <int kD>
constexpr size_t dkv_smem() {
  return (4 * kTile * (kD + 4) + 2 * kTile * kLP + 2 * kTile) * sizeof(float) +
         kPosBytes;
}

template <typename T, typename OutT, int kD>
cudaError_t fwd(const void* const* p, const long long* s, int B, const Dims& n,
                Pos pos, cudaStream_t stream) {
  const size_t smem = fwd_smem<kD>();
  cudaError_t e = allow_smem(flash_masked_fwd_kernel<T, OutT, kD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n.Tq + kTile - 1) / kTile, n.H, B);
  flash_masked_fwd_kernel<T, OutT, kD><<<grid, kThreads, smem, stream>>>(
      view(p[0], s), view(p[1], s + 3), view(p[2], s + 6), view(p[3], s + 9),
      static_cast<float*>(const_cast<void*>(p[4])), pos, n);
  return cudaGetLastError();
}

template <typename T, int kD>
cudaError_t dq(const void* const* p, const long long* s, int B, const Dims& n,
               Pos pos, cudaStream_t stream) {
  const size_t smem = dq_smem<kD>();
  cudaError_t e = allow_smem(flash_masked_dq_kernel<T, kD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n.Tq + kTile - 1) / kTile, n.H, B);
  flash_masked_dq_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      view(p[0], s), view(p[1], s + 3), view(p[2], s + 6), view(p[3], s + 9),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      view(p[6], s + 12), pos, n);
  return cudaGetLastError();
}

template <typename T, int kD>
cudaError_t dkv(const void* const* p, const long long* s, int B, const Dims& n,
                Pos pos, cudaStream_t stream) {
  const size_t smem = dkv_smem<kD>();
  cudaError_t e = allow_smem(flash_masked_dkv_kernel<T, kD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n.Tk + kTile - 1) / kTile, n.H, B);
  flash_masked_dkv_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
      view(p[0], s), view(p[1], s + 3), view(p[2], s + 6), view(p[3], s + 9),
      static_cast<const float*>(p[4]), static_cast<const float*>(p[5]),
      view(p[6], s + 12), view(p[7], s + 15), pos, n);
  return cudaGetLastError();
}

enum Pass { kFwd, kDq, kDkv };

template <typename T, int kD>
cudaError_t run(Pass pass, const void* const* p, const long long* s, int B,
                const Dims& n, Pos pos, bool out_fp32, cudaStream_t stream) {
  switch (pass) {
    case kFwd:
      return out_fp32 ? fwd<T, float, kD>(p, s, B, n, pos, stream)
                      : fwd<T, T, kD>(p, s, B, n, pos, stream);
    case kDq: return dq<T, kD>(p, s, B, n, pos, stream);
    default: return dkv<T, kD>(p, s, B, n, pos, stream);
  }
}

template <typename T>
cudaError_t run_d(Pass pass, const void* const* p, const long long* s, int B,
                  const Dims& n, Pos pos, bool out_fp32, cudaStream_t stream) {
  if (n.D <= 64) return run<T, 64>(pass, p, s, B, n, pos, out_fp32, stream);
  return run<T, 128>(pass, p, s, B, n, pos, out_fp32, stream);
}

int dispatch(Pass pass, const void* const* p, const void* q_pos, const void* kv_pos,
             const long long* s, int B, int Tq, int Tk, int H, int D, float scale,
             int dtype, int out_fp32, void* stream) {
  if (B < 0 || B > 65535 || Tq < 0 || Tk < 0 || H < 1 || H > 65535 || D < 1 ||
      D > 128 || (q_pos == nullptr) != (kv_pos == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // nothing to launch: no batch, or no output tile (B6 owns the K tiles)
  if (B == 0 || (pass == kDkv ? Tk : Tq) == 0) return 0;
  Dims n;
  n.Tq = Tq;
  n.Tk = Tk;
  n.H = H;
  n.D = D;
  n.scale = scale;
  Pos pos;
  pos.q = static_cast<const int*>(q_pos);
  pos.kv = static_cast<const int*>(kv_pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool f32 = out_fp32 != 0;
  switch (dtype) {
    case 0: return static_cast<int>(run_d<float>(pass, p, s, B, n, pos, f32, st));
    case 1: return static_cast<int>(run_d<__nv_bfloat16>(pass, p, s, B, n, pos, f32, st));
    case 2: return static_cast<int>(run_d<__half>(pass, p, s, B, n, pos, f32, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes. dtype: 0 float32, 1 bfloat16,
// 2 float16 (q, k, v, do, dq, dk, dv share it; the forward's out has it
// too unless out_fp32 is set, then fp32). lse and delta are fp32
// [B, H, Tq] contiguous; q_pos [Tq] and kv_pos [Tk] are int32 contiguous,
// or both null (unmasked). `strides` holds, for each [B, T, H, D] tensor
// in argument order, its batch, time and head strides in elements. Each
// call launches on `stream`, does not synchronise, and returns the
// launch's cudaError_t.

// B4: out [B, Tq, H, D] and lse [B, H, Tq]. strides: q, k, v, out.
extern "C" int flash_masked_fwd_launch(const void* q, const void* k, const void* v,
                                       const void* q_pos, const void* kv_pos,
                                       void* out, void* lse, const long long* strides,
                                       int B, int Tq, int Tk, int H, int D,
                                       float scale, int dtype, int out_fp32,
                                       void* stream) {
  const void* p[5] = {q, k, v, out, lse};
  return dispatch(kFwd, p, q_pos, kv_pos, strides, B, Tq, Tk, H, D, scale, dtype,
                  out_fp32, stream);
}

// B5: dq [B, Tq, H, D]. strides: q, k, v, do, dq.
extern "C" int flash_masked_dq_launch(const void* q, const void* k, const void* v,
                                      const void* dout, const void* q_pos,
                                      const void* kv_pos, const void* lse,
                                      const void* delta, void* dq,
                                      const long long* strides, int B, int Tq, int Tk,
                                      int H, int D, float scale, int dtype,
                                      void* stream) {
  const void* p[7] = {q, k, v, dout, lse, delta, dq};
  return dispatch(kDq, p, q_pos, kv_pos, strides, B, Tq, Tk, H, D, scale, dtype, 0,
                  stream);
}

// B6: dk and dv [B, Tk, H, D]. strides: q, k, v, do, dk, dv.
extern "C" int flash_masked_dkv_launch(const void* q, const void* k, const void* v,
                                       const void* dout, const void* q_pos,
                                       const void* kv_pos, const void* lse,
                                       const void* delta, void* dk, void* dv,
                                       const long long* strides, int B, int Tq, int Tk,
                                       int H, int D, float scale, int dtype,
                                       void* stream) {
  const void* p[8] = {q, k, v, dout, lse, delta, dk, dv};
  return dispatch(kDkv, p, q_pos, kv_pos, strides, B, Tq, Tk, H, D, scale, dtype, 0,
                  stream);
}
