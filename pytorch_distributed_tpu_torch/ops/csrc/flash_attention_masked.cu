// Position-masked flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces three TPU kernels of pytorch_distributed_tpu/ops/flash_attention.py:
//   B4 _fwd_kernel  -> flash_masked_fwd_kernel   (out, lse; _sm90 in bf16/fp16)
//   B5 _dq_kernel   -> flash_masked_dq_kernel    (dq; _sm90 in bf16/fp16)
//   B6 _dkv_kernel  -> flash_masked_dkv_kernel   (dk, dv; _sm90 in bf16/fp16)
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
// Two routes, by dtype:
//   fp32: the CUDA-core kernels below, for all three passes.
//   bf16/fp16: Hopper kernels on the tensor cores for all three
//         (flash_masked_{fwd,dq,dkv}_kernel_sm90, after the CUDA-core ones,
//         built on flash_sm90.cuh as the causal B1-B3). They need D % 8 ==
//         0 and 16-byte aligned bases and strides (TMA); a call that breaks
//         the rule fails, it never falls back.
//
// CUDA-core kernels. What bounds them on this card: operations, as for
// B1-B3 (GPT-2's T = 1024, D = 64 reuse each K/V element up to 16 times).
// They compute in fp32 on the CUDA cores, so their ceiling is the fp32
// rate, not the bf16 tensor rate.
//
// Design. The same 64 x 64 tiles and thread layout as the CUDA-core B1-B3
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

#include <type_traits>

#include "flash_sm90.cuh"
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

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

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
  const int r = kMax ? warp_max(max(x, y)) : warp_min(min(x, y));
  if (threadIdx.x == 0) *red = r;
}

// ---------------------------------------------------------------- B4
template <typename T, int kD>
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
  store_tile<T, kD>(out, b, h, q0, acc, safe, n.Tq, n.D);
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

// ============================================================ Hopper route
// Pieces of B4 and B5, whose CTAs own 128 query rows and stream every K/V
// tile of 64 rows through the ring.

// The producer warp's K/V stream: for each tile, once every consumer warp
// released its stage, the warp stages the tile's 64 kv positions (INT_MAX
// past Tk; INT_MIN for every key without positions) and their min and max
// over the keys < Tk, reduced by shuffles, and loads the K and V tiles by
// TMA unless no row of the CTA (rows q0 .. q0 + 127 below Tq) sees a key
// of the tile. All 32 lanes arrive on the stage's full barrier; lane 0
// brings the TMA bytes.
template <int kBoxes, int kStages>
__device__ __forceinline__ void produce_kv(uint64_t* full, uint64_t* empty,
                                           int (*kv_pos)[64], int (*kv_range)[2], char* ring,
                                           const CUtensorMap* mk, const CUtensorMap* mv,
                                           Pos pos, Dims n, int q0, int h, int b,
                                           int lane) {
  constexpr int kStageBytes = 2 * kBoxes * sm90::kTileBytes;  // K tile, then V tile
  const bool masked = pos.q != nullptr;
  int q_max = INT_MIN;  // over the CTA's rows < Tq
  for (int j = lane; j < 128; j += 32)
    if (q0 + j < n.Tq) q_max = max(q_max, masked ? pos.q[q0 + j] : 0);
  q_max = warp_max(q_max);
  const int nk = (n.Tk + 63) / 64;
  for (int ki = 0; ki < nk; ++ki) {
    const int s = ki % kStages;
    const int k0 = 64 * ki;
    sm90::mbar_wait(&empty[s], ((ki / kStages) & 1) ^ 1);
    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = lane + 32 * jj;
      const bool in = k0 + j < n.Tk;
      const int p = !in ? INT_MAX : masked ? pos.kv[k0 + j] : INT_MIN;
      kv_pos[s][j] = p;
      if (in) {
        lo = min(lo, p);
        hi = max(hi, p);
      }
    }
    lo = warp_min(lo);
    hi = warp_max(hi);
    if (lane == 0) {
      kv_range[s][0] = lo;
      kv_range[s][1] = hi;
      if (q_max >= lo) {  // some row of the CTA sees a key of the tile
        sm90::mbar_arrive_expect_tx(&full[s], kStageBytes);
        sm90::tma_load_kv<kBoxes>(ring + s * kStageBytes, mk, mv, &full[s], h, k0, b);
      } else {
        sm90::mbar_arrive(&full[s]);
      }
    } else {
      sm90::mbar_arrive(&full[s]);
    }
  }
}

// A consumer thread's row positions: qp of its rows rA and rA + 8 (INT_MIN
// past Tq: no key is seen; 0 without positions), and the max and min over
// its warpgroup's rows row0 .. row0 + 63 below Tq (every warp reduces all
// 64, so the four warps decide alike).
__device__ __forceinline__ void row_positions(int (&qp)[2], int& wg_max, int& wg_min, Pos pos,
                                              int Tq, int row0, int rA, int lane) {
  const bool masked = pos.q != nullptr;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rA + 8 * hh;
    qp[hh] = r >= Tq ? INT_MIN : masked ? pos.q[r] : 0;
  }
  wg_max = INT_MIN;
  wg_min = INT_MAX;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int r = row0 + lane + 32 * jj;
    if (r < Tq) {
      const int p = masked ? pos.q[r] : 0;
      wg_max = max(wg_max, p);
      wg_min = min(wg_min, p);
    }
  }
  wg_max = warp_max(wg_max);
  wg_min = warp_min(wg_min);
}

// Scores of the keys a thread's rows do not see (kv_pos > q_pos, or column
// k0 + c at or past Tk) become -inf by a select, so their p is exactly 0;
// kv_pos is the stage's 64 positions, c0 the thread's first column.
__device__ __forceinline__ void mask_scores(float (&sc)[32], const int* kv_pos,
                                            const int (&qp)[2], int k0, int c0, int Tk) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int2 kp = *reinterpret_cast<const int2*>(&kv_pos[8 * jj + c0]);
#pragma unroll
    for (int i = 4 * jj; i < 4 * jj + 4; ++i) {
      const int c = k0 + 8 * jj + c0 + i % 2;
      const bool keep = (qp[(i / 2) % 2] >= (i % 2 ? kp.y : kp.x)) & (c < Tk);
      sc[i] = keep ? sc[i] : -INFINITY;
    }
  }
}

// ---------------------------------------------------------------- B4
// flash_masked_fwd_kernel_sm90: replaces _fwd_kernel
// (pytorch_distributed_tpu/ops/flash_attention.py:73) in bf16/fp16, out
// (in T, or fp32 partials) and lse.
//
// Bound on this card: bytes. On the diagonal hop at B=8, T=1024, H=12,
// D=64 the call must move q, k, v and the positions once and write out and
// lse once: 0.0151 ms at 3.35 TB/s with out in bf16, 0.019 ms with the
// fp32 partials a ring merges; its 12.9 GFLOP take 0.013 ms at 989
// TFLOP/s. The design is the causal B1's (flash_attention_causal.cu): 128
// query rows a CTA, two consumer warpgroups of 64 rows and one producer
// warp, Q loaded once by TMA, K/V tiles of 64 rows through the mbarrier
// ring, S = Q K^T and O += P V by wgmma with the online softmax on the
// accumulator registers (sm90::softmax_pv), and position masks in place of
// the static causal one:
//   - with each K/V tile the producer warp stages the tile's 64 kv
//     positions in shared memory beside the stage (INT_MAX past Tk), with
//     their min and max over the keys < Tk reduced by shuffles, all 32
//     lanes counted on the stage's full barrier; each consumer thread keeps
//     the positions of its two rows in registers, and each warpgroup the
//     max and min over its rows < Tq, reduced once at the start;
//   - per tile and warpgroup: skipped (no products; exact, since every p
//     would be 0) when max q_pos < min kv_pos; unmasked when min q_pos >=
//     max kv_pos and the tile lies inside Tk (below the diagonal: most of
//     the work on the diagonal hop); else keep = q_pos >= kv_pos as a
//     select (positions are not sorted: a zigzag tile can straddle the jump
//     between its two runs). When no row of the CTA needs a tile, the
//     producer loads nothing for it. Every warp releases the stage itself,
//     after its last read of the staged positions;
//   - without positions every row's position counts as 0 and every key's
//     as INT_MIN: no tile is skipped, and only the ragged Tk tail is masked;
//   - query tiles run highest first, as B1's: on every hop pattern of the
//     ring (diagonal, past, zigzag) a later row of a chunk sees no fewer
//     keys than an earlier one;
//   - a row that sees no key keeps l = 0 (masked scores are -inf) and gets
//     out = 0 and lse = -1e30 exactly.
// Numerics as the TPU kernel's: fp32 scores, m, l and O, P rounded to the
// input dtype before O += P V.
template <typename T, typename OutT, int kD>
__global__ void __launch_bounds__(sm90::kSm90Threads, 1)
flash_masked_fwd_kernel_sm90(const __grid_constant__ CUtensorMap mq,
                             const __grid_constant__ CUtensorMap mk,
                             const __grid_constant__ CUtensorMap mv, View out, float* lse,
                             Pos pos, Dims n) {
  using L = sm90::Sm90Layout<kD>;
  constexpr int kStages = L::kStages;
  constexpr int kStageBytes = 2 * L::kRows64;  // K tile, then V tile
  extern __shared__ char smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages], q_full;
  __shared__ __align__(16) int kv_pos[kStages][64];  // the stage's key positions
  __shared__ int kv_range[kStages][2];                // their min and max below Tk
  char* Qs = sm90::align_1024(smem_raw);  // [warpgroup][box][64 rows x 128 B]
  char* ring = Qs + 2 * L::kRows64;

  const int nqt = (n.Tq + 127) / 128;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x);  // highest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * 128;
  const int nk = (n.Tk + 63) / 64;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 32);  // the producer's lanes; lane 0 brings the TMA bytes
      sm90::mbar_init(&empty[s], 8);  // every consumer warp
    }
    sm90::mbar_init(&q_full, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == sm90::kProducerWarp) {
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&q_full, 2 * L::kRows64);
      for (int g = 0; g < 2; ++g)
        for (int e = 0; e < L::kBoxes; ++e)
          sm90::tma_load(Qs + g * L::kRows64 + e * sm90::kTileBytes, &mq, &q_full, 64 * e, h,
                         q0 + 64 * g, b);
    }
    produce_kv<L::kBoxes, kStages>(full, empty, kv_pos, kv_range, ring, &mk, &mv, pos, n, q0,
                                   h, b, lane);
    return;
  }

  const int g = warp / 4;
  const int row0 = q0 + 64 * g;                      // this warpgroup's first row
  const int rA = row0 + 16 * (warp % 4) + lane / 4;  // the thread's rows: rA, rA + 8
  const int c0 = 2 * (lane % 4);
  const char* Qg = Qs + g * L::kRows64;
  const float scale_log2 = n.scale * sm90::kLog2e;
  int qp[2], wg_max, wg_min;
  row_positions(qp, wg_max, wg_min, pos, n.Tq, row0, rA, lane);

  float o[L::kBoxes][32];
#pragma unroll
  for (int e = 0; e < L::kBoxes; ++e)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[e][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // row max of scale * s, log2 units
  float l[2] = {0.f, 0.f};          // this thread's part of the row sum

  sm90::mbar_wait(&q_full, 0);
  for (int ki = 0; ki < nk; ++ki) {
    const int s = ki % kStages;
    sm90::mbar_wait(&full[s], (ki / kStages) & 1);
    const int k0 = 64 * ki;
    const char* Ks = ring + s * kStageBytes;
    const char* Vs = Ks + L::kRows64;
    if (wg_max >= kv_range[s][0]) {  // else every key is in these rows' future
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      sm90::fence_acc(sc);
      sm90::wgmma_fence();
      sm90::wgmma_abt<T, kD>(sc, Qg, Ks);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(sc);

      if (!((wg_min >= kv_range[s][1]) & (k0 + 64 <= n.Tk)))
        mask_scores(sc, kv_pos[s], qp, k0, c0, n.Tk);
      sm90::softmax_pv<T, L::kBoxes>(sc, m, l, o, Vs, scale_log2);
    }
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  OutT* base = static_cast<OutT*>(out.ptr) + b * out.sb + h * out.sh;
  float* lse_bh = lse + (static_cast<int64_t>(b) * n.H + h) * n.Tq;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int r = rA + 8 * hh;
    if (r >= n.Tq) continue;
    const float safe = fmaxf(sum, 1e-30f);
#pragma unroll
    for (int e = 0; e < L::kBoxes; ++e)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int d = 64 * e + 8 * jj + c0;
        if (d >= n.D) continue;
        const float x = o[e][4 * jj + 2 * hh] / safe;
        const float y = o[e][4 * jj + 2 * hh + 1] / safe;
        OutT* dst = base + r * out.st + d;
        if constexpr (std::is_same<OutT, float>::value)
          *reinterpret_cast<float2*>(dst) = make_float2(x, y);
        else
          *reinterpret_cast<uint32_t*>(dst) = sm90::pack2<T>(x, y);
      }
    if (lane % 4 == 0) lse_bh[r] = sum > 0.f ? m[hh] * sm90::kLn2 + logf(safe) : kNegInf;
  }
}

// ---------------------------------------------------------------- B5
// flash_masked_dq_kernel_sm90: replaces _dq_kernel
// (pytorch_distributed_tpu/ops/flash_attention.py:525) in bf16/fp16, dq.
//
// Bound on this card: operations. On the diagonal hop at B=8, T=1024,
// H=12, D=64 its 19.4 GFLOP (6 D per visible pair: three products) take
// 0.0196 ms at 989 TFLOP/s bf16, above the 0.019 ms its bytes take. The
// design is the causal B2's arithmetic (flash_attention_causal.cu) in B4's
// skeleton:
//   - one CTA: 128 query rows of one (b, h), rows 64 g .. 64 g + 63 for
//     consumer warpgroup g; Q and dO arrive once by TMA and stay, and each
//     thread keeps lse and delta of its two rows in registers (lse as
//     -lse log2(e), -inf for a dead row or one past Tq, so its p is exactly
//     0); query tiles run highest first, as B4's;
//   - every K/V tile of 64 rows streams through the ring, and with it the
//     producer warp stages the tile's kv positions (INT_MAX past Tk) and
//     their min and max, loading no tile that no row of the CTA sees
//     (produce_kv, B4's producer: a ring hop's keys are not a causal
//     range, and a zigzag tile can straddle the jump between its runs);
//   - per tile and warpgroup: skipped (no products; exact) when max q_pos
//     < min kv_pos; else S = Q K^T and dP = dO V^T by wgmma (K-major
//     operands, one commit), keep = q_pos >= kv_pos as a select unless min
//     q_pos >= max kv_pos and the tile lies inside Tk; P = exp2(S scale
//     log2(e) - lse log2(e)), dS = P (dP - delta) scale in registers; then
//     dQ += dS K with dS as the register A operand and K read through an
//     MN-major descriptor (sm90::mma_rs), as in B2;
//   - every consumer warp releases a stage itself, after its last read of
//     the staged positions (B4, B6);
//   - dQ accumulates in fp32 registers and is written once; no atomics
//     (the JAX two-pass split: dk and dv are B6's).
// The one deliberate numeric change from the TPU kernel: dS is rounded to
// the input dtype before dQ += dS K (the TPU kernel multiplies fp32 ds by
// fp32-widened k), as B2, B3, B6 and SDPA round it. S and dP are 16-bit
// products summed in fp32, exact per term: only the order differs.
template <typename T, int kD>
__global__ void __launch_bounds__(sm90::kSm90Threads, 1)
flash_masked_dq_kernel_sm90(const __grid_constant__ CUtensorMap mq,
                            const __grid_constant__ CUtensorMap mk,
                            const __grid_constant__ CUtensorMap mv,
                            const __grid_constant__ CUtensorMap mdo, const float* lse,
                            const float* delta, View dq, Pos pos, Dims n) {
  using L = sm90::Sm90Layout<kD>;
  constexpr int kStages = L::kStages;
  constexpr int kStageBytes = 2 * L::kRows64;  // K tile, then V tile
  extern __shared__ char smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages], q_full;
  __shared__ __align__(16) int kv_pos[kStages][64];  // the stage's key positions
  __shared__ int kv_range[kStages][2];                // their min and max below Tk
  char* Qs = sm90::align_1024(smem_raw);  // [warpgroup][box][64 rows x 128 B]
  char* dOs = Qs + 2 * L::kRows64;        // the same for dO
  char* ring = dOs + 2 * L::kRows64;

  const int nqt = (n.Tq + 127) / 128;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x);  // highest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * 128;
  const int nk = (n.Tk + 63) / 64;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 32);  // the producer's lanes; lane 0 brings the TMA bytes
      sm90::mbar_init(&empty[s], 8);  // every consumer warp
    }
    sm90::mbar_init(&q_full, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == sm90::kProducerWarp) {
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&q_full, 4 * L::kRows64);
      for (int g = 0; g < 2; ++g)
        for (int e = 0; e < L::kBoxes; ++e) {
          const int off = g * L::kRows64 + e * sm90::kTileBytes;
          sm90::tma_load(Qs + off, &mq, &q_full, 64 * e, h, q0 + 64 * g, b);
          sm90::tma_load(dOs + off, &mdo, &q_full, 64 * e, h, q0 + 64 * g, b);
        }
    }
    produce_kv<L::kBoxes, kStages>(full, empty, kv_pos, kv_range, ring, &mk, &mv, pos, n, q0,
                                   h, b, lane);
    return;
  }

  const int g = warp / 4;
  const int row0 = q0 + 64 * g;                      // this warpgroup's first row
  const int rA = row0 + 16 * (warp % 4) + lane / 4;  // the thread's rows: rA, rA + 8
  const int c0 = 2 * (lane % 4);
  const char* Qg = Qs + g * L::kRows64;
  const char* dOg = dOs + g * L::kRows64;
  const float scale_log2 = n.scale * sm90::kLog2e;
  const int64_t bh = (static_cast<int64_t>(b) * n.H + h) * n.Tq;

  int qp[2], wg_max, wg_min;
  row_positions(qp, wg_max, wg_min, pos, n.Tq, row0, rA, lane);

  // p = exp2(s scale log2(e) + neg_lse2): -inf for a dead row (lse <=
  // -1e30 / 2) and for rows past Tq, so that their p is exactly 0
  float neg_lse2[2], delta_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rA + 8 * hh;
    const float lse_v = r < n.Tq ? lse[bh + r] : kNegInf;
    neg_lse2[hh] = lse_v <= kNegInf / 2 ? -INFINITY : -lse_v * sm90::kLog2e;
    delta_r[hh] = r < n.Tq ? delta[bh + r] : 0.f;
  }

  float acc[L::kBoxes][32];
#pragma unroll
  for (int e = 0; e < L::kBoxes; ++e)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[e][i] = 0.f;

  sm90::mbar_wait(&q_full, 0);
  for (int ki = 0; ki < nk; ++ki) {
    const int s = ki % kStages;
    sm90::mbar_wait(&full[s], (ki / kStages) & 1);
    const int k0 = 64 * ki;
    const char* Ks = ring + s * kStageBytes;
    const char* Vs = Ks + L::kRows64;
    if (wg_max >= kv_range[s][0]) {  // else every key is in these rows' future
      float sc[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
      sm90::fence_acc(sc);
      sm90::fence_acc(dp);
      sm90::wgmma_fence();
      sm90::wgmma_abt<T, kD>(sc, Qg, Ks);
      sm90::wgmma_abt<T, kD>(dp, dOg, Vs);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(sc);
      sm90::fence_acc(dp);

      if (!((wg_min >= kv_range[s][1]) & (k0 + 64 <= n.Tk)))
        mask_scores(sc, kv_pos[s], qp, k0, c0, n.Tk);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i / 2) % 2;
        const float p = exp2f(fmaf(sc[i], scale_log2, neg_lse2[hh]));
        dp[i] = p * (dp[i] - delta_r[hh]) * n.scale;  // dS
      }
      sm90::mma_rs<T, L::kBoxes>(acc, dp, Ks);
    }
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  sm90::store_rows<T, L::kBoxes>(static_cast<T*>(dq.ptr) + b * dq.sb + h * dq.sh, dq.st, rA,
                                 n.Tq, n.D, acc);
}

// ---------------------------------------------------------------- B6
// flash_masked_dkv_kernel_sm90: replaces _dkv_kernel
// (pytorch_distributed_tpu/ops/flash_attention.py:575) in bf16/fp16, dk
// and dv.
//
// Bound on this card: operations. On the diagonal hop at B=8, T=1024,
// H=12, D=64 its 25.8 GFLOP (8 D per visible pair: four products) take
// 0.0261 ms at 989 TFLOP/s bf16, above the 0.019 ms its bytes take. The
// design is the causal B3's (flash_attention_causal.cu): all four products
// on the tensor cores, every tile kept where the next product reads it,
// with B4's position machinery in place of the static causal mask:
//   - one CTA: 128 keys of one (b, h), keys 64 g .. 64 g + 63 for consumer
//     warpgroup g; K and V arrive once by TMA (maps of Tk rows) and stay;
//     Q and dO tiles of 64 rows (maps of Tq rows) stream through the ring.
//     A ring hop's Q rows are not a causal range, so the CTA visits every
//     Q tile, not B3's qi_first onward;
//   - with each Q tile the producer warp's lanes stage the tile's lse and
//     delta (lse -1e30 past Tq: those rows are dead) and its 64 q
//     positions (INT_MIN past Tq), with their min and max over the rows
//     < Tq reduced by shuffles, all 32 lanes counted on the stage's full
//     barrier; the producer loads no Q tile that no key of the CTA sees;
//     each consumer thread keeps the positions of its two keys in
//     registers (INT_MAX past Tk), and each warpgroup the min and max over
//     its keys < Tk;
//   - per tile and warpgroup: skipped (no products; exact, since every p
//     would be 0) when max q_pos < min kv_pos; unmasked when min q_pos >=
//     max kv_pos and the tile lies inside Tq and Tk; else keep = q_pos >=
//     kv_pos as a select. Without positions every row's position counts as
//     0 and every key's as INT_MIN: no tile is skipped;
//   - S^T = K Q^T and dP^T = V dO^T (K-major operands), P^T = exp(scale
//     S^T - lse[col]) with p = 0 where lse <= -1e30 / 2 (rows past Tq, and
//     every row of a hop that holds only future keys, which so gets exact
//     zero dk and dv), dS^T = P^T (dP^T - delta[col]) scale, then dV += P^T
//     dO and dK += dS^T Q with P^T and dS^T as register A operands;
//   - every consumer warp releases a stage itself, after its last read of
//     the staged positions, as in B4: had one warp released it for its
//     warpgroup, a lagging warp could read the next round's positions and
//     issue a warpgroup product alone;
//   - dK and dV accumulate in fp32 registers and are written once, no
//     atomics; at D = 128 a third, donating warpgroup gives the consumers
//     its registers (setmaxnreg), as in B3.
// The one deliberate numeric change from the TPU kernel: P^T and dS^T are
// rounded to the input dtype before their tensor-core products, as B3
// rounds them.
template <typename T, int kD>
__global__ void __launch_bounds__(sm90::Sm90Layout<kD>::kDkvThreads, 1)
flash_masked_dkv_kernel_sm90(const __grid_constant__ CUtensorMap mq,
                             const __grid_constant__ CUtensorMap mk,
                             const __grid_constant__ CUtensorMap mv,
                             const __grid_constant__ CUtensorMap mdo, const float* lse,
                             const float* delta, View dk, View dv, Pos pos, Dims n) {
  using L = sm90::Sm90Layout<kD>;
  constexpr int kStages = L::kStages;
  constexpr int kStageBytes = 2 * L::kRows64;  // Q tile, then dO tile
  extern __shared__ char smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages], kv_full;
  __shared__ float stats[kStages][2][64];            // lse and delta of the stage's Q rows
  __shared__ __align__(16) int q_pos[kStages][64];   // the stage's query positions
  __shared__ int q_range[kStages][2];                // their min and max below Tq
  char* Ks = sm90::align_1024(smem_raw);  // [warpgroup][box][64 rows x 128 B]
  char* Vs = Ks + 2 * L::kRows64;
  char* ring = Vs + 2 * L::kRows64;

  const int nq = (n.Tq + 63) / 64;
  const int k0 = 128 * static_cast<int>(blockIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int64_t bh = (static_cast<int64_t>(b) * n.H + h) * n.Tq;
  const bool masked = pos.q != nullptr;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 32);  // the producer's lanes; lane 0 brings the TMA bytes
      sm90::mbar_init(&empty[s], 8);  // every consumer warp
    }
    sm90::mbar_init(&kv_full, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= sm90::kProducerWarp) {
    // at D = 128 warpgroup 2 gives 128 registers a thread to the consumers
    // (dK and dV alone hold 128 a thread); warp 8 then produces
    if constexpr (kD == 128) sm90::regs_dec<40>();
    if (warp != sm90::kProducerWarp) return;
    int kv_min = INT_MAX;  // over the CTA's keys < Tk
    for (int j = lane; j < 128; j += 32)
      if (k0 + j < n.Tk) kv_min = min(kv_min, masked ? pos.kv[k0 + j] : INT_MIN);
    kv_min = warp_min(kv_min);
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&kv_full, 4 * L::kRows64);
      for (int g = 0; g < 2; ++g)
        for (int e = 0; e < L::kBoxes; ++e) {
          const int off = g * L::kRows64 + e * sm90::kTileBytes;
          sm90::tma_load(Ks + off, &mk, &kv_full, 64 * e, h, k0 + 64 * g, b);
          sm90::tma_load(Vs + off, &mv, &kv_full, 64 * e, h, k0 + 64 * g, b);
        }
    }
    for (int qi = 0; qi < nq; ++qi) {
      const int s = qi % kStages;
      sm90::mbar_wait(&empty[s], ((qi / kStages) & 1) ^ 1);
      const int q0 = 64 * qi;
      int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = lane + 32 * jj;
        const bool in = q0 + j < n.Tq;
        const int p = !in ? INT_MIN : masked ? pos.q[q0 + j] : 0;
        q_pos[s][j] = p;
        stats[s][0][j] = in ? lse[bh + q0 + j] : kNegInf;
        stats[s][1][j] = in ? delta[bh + q0 + j] : 0.f;
        if (in) {
          lo = min(lo, p);
          hi = max(hi, p);
        }
      }
      lo = warp_min(lo);
      hi = warp_max(hi);
      if (lane == 0) {
        q_range[s][0] = lo;
        q_range[s][1] = hi;
        if (hi >= kv_min) {  // some key of the CTA is seen by a row of the tile
          char* Qt = ring + s * kStageBytes;
          sm90::mbar_arrive_expect_tx(&full[s], kStageBytes);
          for (int e = 0; e < L::kBoxes; ++e) {
            sm90::tma_load(Qt + e * sm90::kTileBytes, &mq, &full[s], 64 * e, h, q0, b);
            sm90::tma_load(Qt + L::kRows64 + e * sm90::kTileBytes, &mdo, &full[s], 64 * e, h,
                           q0, b);
          }
        } else {
          sm90::mbar_arrive(&full[s]);
        }
      } else {
        sm90::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  if constexpr (kD == 128) sm90::regs_inc<232>();
  const int g = warp / 4;
  const int kg = k0 + 64 * g;                      // this warpgroup's first key
  const int cA = kg + 16 * (warp % 4) + lane / 4;  // the thread's keys: cA, cA + 8
  const int c0 = 2 * (lane % 4);
  const char* Kg = Ks + g * L::kRows64;
  const char* Vg = Vs + g * L::kRows64;
  const float scale_log2 = n.scale * sm90::kLog2e;

  // the positions of the thread's keys (INT_MAX past Tk: no row sees it),
  // and the warpgroup's min and max over its keys < Tk (every warp reduces
  // all 64, so the four warps decide alike)
  int kp[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int c = cA + 8 * hh;
    kp[hh] = c >= n.Tk ? INT_MAX : masked ? pos.kv[c] : INT_MIN;
  }
  int wg_min = INT_MAX, wg_max = INT_MIN;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int c = kg + lane + 32 * jj;
    if (c < n.Tk) {
      const int p = masked ? pos.kv[c] : INT_MIN;
      wg_min = min(wg_min, p);
      wg_max = max(wg_max, p);
    }
  }
  wg_min = warp_min(wg_min);
  wg_max = warp_max(wg_max);
  const bool keys_inside = kg + 64 <= n.Tk;

  float dk_acc[L::kBoxes][32], dv_acc[L::kBoxes][32];
#pragma unroll
  for (int e = 0; e < L::kBoxes; ++e)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[e][i] = dv_acc[e][i] = 0.f;

  sm90::mbar_wait(&kv_full, 0);
  for (int qi = 0; qi < nq; ++qi) {
    const int s = qi % kStages;
    sm90::mbar_wait(&full[s], (qi / kStages) & 1);
    const int q0 = 64 * qi;
    const char* Qt = ring + s * kStageBytes;
    const char* dOt = Qt + L::kRows64;
    if (q_range[s][1] >= wg_min) {  // else every key is in these rows' future
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      sm90::fence_acc(st);
      sm90::fence_acc(dpt);
      sm90::wgmma_fence();
      sm90::wgmma_abt<T, kD>(st, Kg, Qt);
      sm90::wgmma_abt<T, kD>(dpt, Vg, dOt);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(st);
      sm90::fence_acc(dpt);

      // cell i: key cA + 8 ((i / 2) % 2), query q0 + 8 (i / 4) + c0 + i % 2;
      // the mask is a select, and only on tiles that need it
      const bool edge = !((q_range[s][0] >= wg_max) & (q0 + 64 <= n.Tq) & keys_inside);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int2 qp = *reinterpret_cast<const int2*>(&q_pos[s][8 * jj + c0]);
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int j = 8 * jj + c0 + cc;
          const float lse_v = stats[s][0][j];
          const float delta_v = stats[s][1][j];
          const bool dead = lse_v <= kNegInf / 2;
          const float neg_lse2 = -lse_v * sm90::kLog2e;
          const int qpj = cc ? qp.y : qp.x;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = 4 * jj + 2 * hh + cc;
            const bool keep = !dead & (!edge | (qpj >= kp[hh]));
            const float e = exp2f(fmaf(st[i], scale_log2, neg_lse2));
            const float p = keep ? e : 0.f;
            dpt[i] = p * (dpt[i] - delta_v) * n.scale;
            st[i] = p;
          }
        }
      }
      uint32_t pa[4][4], dsa[4][4];
      sm90::to_fragments<T>(st, pa);
      sm90::to_fragments<T>(dpt, dsa);
#pragma unroll
      for (int e = 0; e < L::kBoxes; ++e) {
        sm90::fence_acc(dv_acc[e]);
        sm90::fence_acc(dk_acc[e]);
      }
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < L::kBoxes; ++e)
          sm90::wgmma_rs<T, 1>(dv_acc[e], pa[kk],
                               sm90::desc_mnmajor(dOt + e * sm90::kTileBytes, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < L::kBoxes; ++e)
          sm90::wgmma_rs<T, 1>(dk_acc[e], dsa[kk],
                               sm90::desc_mnmajor(Qt + e * sm90::kTileBytes, kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < L::kBoxes; ++e) {
        sm90::fence_acc(dv_acc[e]);
        sm90::fence_acc(dk_acc[e]);
      }
    }
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }

  sm90::store_rows<T, L::kBoxes>(static_cast<T*>(dk.ptr) + b * dk.sb + h * dk.sh, dk.st, cA,
                                 n.Tk, n.D, dk_acc);
  sm90::store_rows<T, L::kBoxes>(static_cast<T*>(dv.ptr) + b * dv.sb + h * dv.sh, dv.st, cA,
                                 n.Tk, n.D, dv_acc);
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

template <typename T, int kD>
cudaError_t fwd(const void* const* p, const long long* s, int B, const Dims& n,
                Pos pos, cudaStream_t stream) {
  const size_t smem = fwd_smem<kD>();
  cudaError_t e = allow_smem(flash_masked_fwd_kernel<T, kD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n.Tq + kTile - 1) / kTile, n.H, B);
  flash_masked_fwd_kernel<T, kD><<<grid, kThreads, smem, stream>>>(
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

template <typename T, typename OutT, int kD>
cudaError_t fwd_sm90(const void* const* p, const long long* s, int B, const Dims& n,
                     Pos pos, cudaStream_t stream) {
  // q has Tq rows, k and v Tk; at Tk = 0 no K/V tile is loaded, and the q
  // map stands in for theirs
  const int Ts[3] = {n.Tq, n.Tk, n.Tk};
  CUtensorMap maps[3];
  cudaError_t e = sm90::make_maps<T>(maps, n.Tk > 0 ? 3 : 1, p, s, B, Ts, n.H, n.D);
  if (e != cudaSuccess) return e;
  if (n.Tk == 0) maps[1] = maps[2] = maps[0];
  const size_t smem = sm90::Sm90Layout<kD>::smem_bytes(2);  // Q stays
  e = allow_smem(flash_masked_fwd_kernel_sm90<T, OutT, kD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n.Tq + 127) / 128, n.H, B);
  flash_masked_fwd_kernel_sm90<T, OutT, kD><<<grid, sm90::kSm90Threads, smem, stream>>>(
      maps[0], maps[1], maps[2], view(p[3], s + 9),
      static_cast<float*>(const_cast<void*>(p[4])), pos, n);
  return cudaGetLastError();
}

template <typename T, int kD>
cudaError_t dq_sm90(const void* const* p, const long long* s, int B, const Dims& n,
                    Pos pos, cudaStream_t stream) {
  // q and do have Tq rows, k and v Tk; at Tk = 0 no K/V tile is loaded,
  // and the q map stands in for theirs
  const int Ts[4] = {n.Tq, n.Tk, n.Tk, n.Tq};
  CUtensorMap maps[4];
  cudaError_t e;
  if (n.Tk > 0) {
    e = sm90::make_maps<T>(maps, 4, p, s, B, Ts, n.H, n.D);
  } else {
    e = sm90::make_maps<T>(maps, 1, p, s, B, Ts, n.H, n.D);
    if (e == cudaSuccess) e = sm90::make_maps<T>(maps + 3, 1, p + 3, s + 9, B, Ts + 3, n.H, n.D);
    maps[1] = maps[2] = maps[0];
  }
  if (e != cudaSuccess) return e;
  const size_t smem = sm90::Sm90Layout<kD>::smem_bytes(4);  // Q and dO stay
  e = allow_smem(flash_masked_dq_kernel_sm90<T, kD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n.Tq + 127) / 128, n.H, B);
  flash_masked_dq_kernel_sm90<T, kD><<<grid, sm90::kSm90Threads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(p[4]),
      static_cast<const float*>(p[5]), view(p[6], s + 12), pos, n);
  return cudaGetLastError();
}

template <typename T, int kD>
cudaError_t dkv_sm90(const void* const* p, const long long* s, int B, const Dims& n,
                     Pos pos, cudaStream_t stream) {
  // q and do have Tq rows, k and v Tk; at Tq = 0 no Q tile is loaded, and
  // the k map stands in for theirs
  const int Ts[4] = {n.Tq, n.Tk, n.Tk, n.Tq};
  CUtensorMap maps[4];
  cudaError_t e;
  if (n.Tq > 0) {
    e = sm90::make_maps<T>(maps, 4, p, s, B, Ts, n.H, n.D);
  } else {
    e = sm90::make_maps<T>(maps + 1, 2, p + 1, s + 3, B, Ts + 1, n.H, n.D);
    maps[0] = maps[3] = maps[1];
  }
  if (e != cudaSuccess) return e;
  using L = sm90::Sm90Layout<kD>;
  const size_t smem = L::smem_bytes(4);  // K and V stay
  e = allow_smem(flash_masked_dkv_kernel_sm90<T, kD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n.Tk + 127) / 128, n.H, B);
  flash_masked_dkv_kernel_sm90<T, kD><<<grid, L::kDkvThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(p[4]),
      static_cast<const float*>(p[5]), view(p[6], s + 12), view(p[7], s + 15), pos, n);
  return cudaGetLastError();
}

enum Pass { kFwd, kDq, kDkv };

// fp32: the CUDA-core kernels. bf16/fp16: the Hopper route (B4's out in T
// or fp32).
template <typename T, int kD>
cudaError_t run(Pass pass, const void* const* p, const long long* s, int B,
                const Dims& n, Pos pos, bool out_fp32, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    switch (pass) {
      case kFwd: return fwd<T, kD>(p, s, B, n, pos, stream);  // fp32 out either way
      case kDq: return dq<T, kD>(p, s, B, n, pos, stream);
      default: return dkv<T, kD>(p, s, B, n, pos, stream);
    }
  } else {
    switch (pass) {
      case kFwd:
        return out_fp32 ? fwd_sm90<T, float, kD>(p, s, B, n, pos, stream)
                        : fwd_sm90<T, T, kD>(p, s, B, n, pos, stream);
      case kDq: return dq_sm90<T, kD>(p, s, B, n, pos, stream);
      default: return dkv_sm90<T, kD>(p, s, B, n, pos, stream);
    }
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
