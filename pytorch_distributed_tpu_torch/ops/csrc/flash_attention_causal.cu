// Static-causal flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces three TPU kernels of pytorch_distributed_tpu/ops/flash_attention.py:
//   B1 _fwd_kernel_pruned  -> flash_causal_fwd_kernel   (out, lse)
//   B2 _dq_kernel_pruned   -> flash_causal_dq_kernel    (dq)
//   B3 _dkv_kernel_pruned  -> flash_causal_dkv_kernel   (dk, dv)
// (each with an _sm90 kernel for bf16/fp16)
// Causal self-attention with Tq == Tk: query row r sees key rows c <= r.
// q, k, v, do are read by stride in the model's [B, T, H, D] layout (the
// non-contiguous q/k/v views of GPT-2's c_attn split included), so no call
// copies or transposes an operand; D must be contiguous. lse and delta are
// [B, H, T] fp32, the outputs [B, T, H, D] with the strides given.
//
// Two routes, by dtype:
//   fp32: the CUDA-core kernels below, for all three passes (exact fp32
//         products: wgmma has no fp32 B operand read transposed).
//   bf16/fp16: all three are Hopper kernels on the tensor cores
//         (flash_causal_{fwd,dq,dkv}_kernel_sm90, after the CUDA-core
//         ones). They need D % 8 == 0 and 16-byte aligned bases and
//         strides (TMA); a call that breaks the rule fails, it never falls
//         back.
//
// CUDA-core kernels. What bounds them on this card: operations. At
// GPT-2's shapes (T = 1024, D = 64) each K/V element is reused by up to 16
// Q tiles, far above the card's bytes-per-operation ratio. They compute in
// fp32 on the CUDA cores, so their ceiling is the fp32 rate, not the bf16
// tensor rate.
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
#include <type_traits>

#include "flash_sm90.cuh"
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

// ============================================================ Hopper route
// B1-B3 in bf16/fp16 (pieces in flash_sm90.cuh). A CTA is two consumer
// warpgroups and one producer warp. The producer's lane 0 starts TMA loads
// into a ring of kStages shared-memory stages, each guarded by a "full"
// and an "empty" mbarrier; each consumer warpgroup runs its products as
// wgmma on the tensor cores, fp32 accumulators in registers, and releases
// a stage once its products have read it. D = 64 and 128 are instantiated
// (a head below 128 wide is zero-filled by TMA up to the tile); no operand
// is copied or transposed: the transposed products read the same swizzled
// tiles through MN-major descriptors.

using sm90::align_1024;
using sm90::kProducerWarp;
using sm90::kSm90Threads;
using sm90::Sm90Layout;

// ---------------------------------------------------------------- B1
// flash_causal_fwd_kernel_sm90: replaces _fwd_kernel_pruned
// (pytorch_distributed_tpu/ops/flash_attention.py:179), out and lse.
//
// Bound on this card: bytes. At B=8, T=1024, H=12, D=64 the call must move
// q, k, v once and write out and lse once, 0.0151 ms at 3.35 TB/s; its
// 12.9 GFLOP (4 D per visible pair) take 0.013 ms at 989 TFLOP/s bf16.
// The design reads each operand tile into shared memory once per CTA by
// TMA and keeps both products on the tensor cores, with the score tile in
// registers from one product to the next:
//   - one CTA: 128 query rows of one (b, h), rows 64 g .. 64 g + 63 for
//     consumer warpgroup g; the Q tiles arrive once; K/V tiles of 64 rows
//     0 .. last_ki stream through the ring (the pruning: tiles above the
//     diagonal are never loaded); the longest rows run first;
//   - per K/V tile: S = Q K^T by wgmma (both operands K-major in shared
//     memory); the online softmax on the accumulator registers in the log2
//     domain (a row's max reduces over the 4 threads that hold it, its
//     sum once at the end);
//     the causal mask only on tiles that cross the diagonal or the ragged
//     tail (TMA's zero rows past T would score 0, so they are masked);
//     P rounded to the input dtype in registers (the TPU kernel's
//     p.astype(v.dtype)) is the register A operand of O += P V, V read
//     through an MN-major descriptor;
//   - out and lse written once at the end, as the TPU kernel: fp32 m, l and
//     O, lse = -1e30 where l = 0.
template <typename T, int kD>
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_causal_fwd_kernel_sm90(const __grid_constant__ CUtensorMap mq,
                             const __grid_constant__ CUtensorMap mk,
                             const __grid_constant__ CUtensorMap mv, View out, float* lse,
                             Dims n) {
  using L = Sm90Layout<kD>;
  constexpr int kStages = L::kStages;
  constexpr int kStageBytes = 2 * L::kRows64;  // K tile, then V tile
  extern __shared__ char smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages], q_full;
  char* Qs = align_1024(smem_raw);  // [warpgroup][box][64 rows x 128 B]
  char* ring = Qs + 2 * L::kRows64;

  const int nqt = (n.T + 127) / 128;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x);  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * 128;
  const int last_ki = min(2 * qt + 1, (n.T - 1) / 64);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::mbar_init(&q_full, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&q_full, 2 * L::kRows64);
      for (int g = 0; g < 2; ++g)
        for (int e = 0; e < L::kBoxes; ++e)
          sm90::tma_load(Qs + g * L::kRows64 + e * sm90::kTileBytes, &mq, &q_full, 64 * e, h,
                         q0 + 64 * g, b);
      for (int ki = 0; ki <= last_ki; ++ki) {
        const int s = ki % kStages;
        sm90::mbar_wait(&empty[s], ((ki / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], kStageBytes);
        sm90::tma_load_kv<L::kBoxes>(ring + s * kStageBytes, &mk, &mv, &full[s], h, 64 * ki, b);
      }
    }
    return;
  }

  const int g = warp / 4;
  const int row0 = q0 + 64 * g;                      // this warpgroup's first row
  const int rA = row0 + 16 * (warp % 4) + lane / 4;  // the thread's rows: rA, rA + 8
  const int c0 = 2 * (lane % 4);
  const char* Qg = Qs + g * L::kRows64;
  const float scale_log2 = n.scale * sm90::kLog2e;

  float o[L::kBoxes][32];
#pragma unroll
  for (int e = 0; e < L::kBoxes; ++e)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[e][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // row max of scale * s, log2 units
  float l[2] = {0.f, 0.f};          // this thread's part of the row sum

  sm90::mbar_wait(&q_full, 0);
  for (int ki = 0; ki <= last_ki; ++ki) {
    const int s = ki % kStages;
    sm90::mbar_wait(&full[s], (ki / kStages) & 1);
    const int k0 = 64 * ki;
    const char* Ks = ring + s * kStageBytes;
    const char* Vs = Ks + L::kRows64;
    if (k0 <= row0 + 63) {  // this warpgroup's rows see part of the tile
      float sc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = 0.f;
      sm90::fence_acc(sc);
      sm90::wgmma_fence();
      sm90::wgmma_abt<T, kD>(sc, Qg, Ks);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_acc(sc);

      // masked scores become -inf (branch-free: the mask is a select)
      if ((k0 + 63 > row0) || (k0 + 64 > n.T)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = k0 + 8 * (i / 4) + c0 + i % 2;
          const bool keep = (c <= rA + 8 * ((i / 2) % 2)) & (c < n.T);
          sc[i] = keep ? sc[i] : -INFINITY;
        }
      }
      sm90::softmax_pv<T, L::kBoxes>(sc, m, l, o, Vs, scale_log2);
    }
    if (threadIdx.x % 128 == 0) sm90::mbar_arrive(&empty[s]);
  }

  T* base = static_cast<T*>(out.ptr) + b * out.sb + h * out.sh;
  float* lse_bh = lse + (static_cast<int64_t>(b) * n.H + h) * n.T;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int r = rA + 8 * hh;
    if (r >= n.T) continue;
    const float safe = fmaxf(sum, 1e-30f);
#pragma unroll
    for (int e = 0; e < L::kBoxes; ++e)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int d = 64 * e + 8 * jj + c0;
        if (d < n.D)
          *reinterpret_cast<uint32_t*>(base + r * out.st + d) = sm90::pack2<T>(
              o[e][4 * jj + 2 * hh] / safe, o[e][4 * jj + 2 * hh + 1] / safe);
      }
    if (lane % 4 == 0) lse_bh[r] = sum > 0.f ? m[hh] * sm90::kLn2 + logf(safe) : kNegInf;
  }
}

// ---------------------------------------------------------------- B2
// flash_causal_dq_kernel_sm90: replaces _dq_kernel_pruned
// (pytorch_distributed_tpu/ops/flash_attention.py:293), dq.
//
// Bound on this card: operations. At B=8, T=1024, H=12, D=64 its 19.4
// GFLOP (6 D per visible pair: three products) take 0.0196 ms at 989
// TFLOP/s bf16, above the 0.0190 ms its bytes take. The design is B1's
// with one more product, every tile kept where the next product reads it:
//   - one CTA: 128 query rows of one (b, h), rows 64 g .. 64 g + 63 for
//     consumer warpgroup g; Q and dO arrive once by TMA and stay, and each
//     thread keeps lse and delta of its two rows in registers; K/V tiles
//     of 64 rows 0 .. last_ki stream through the ring (the pruning: tiles
//     above the diagonal are never loaded); the longest rows run first;
//   - per K/V tile: S = Q K^T and dP = dO V^T by wgmma (K-major operands);
//     P = exp2(S scale log2(e) - lse log2(e)) with the causal mask (a
//     select) on tiles that cross the diagonal or the ragged tail, and
//     p = 0 where lse <= -1e30 / 2; dS = P (dP - delta) scale in
//     registers; then dQ += dS K with dS as the register A operand and K
//     read through an MN-major descriptor, as V is in B1's O += P V;
//   - dQ accumulates in fp32 registers and is written once; no atomics
//     (the JAX two-pass split: dk and dv are B3's).
// The one deliberate numeric change from the TPU kernel: dS is rounded to
// the input dtype before dQ += dS K (the TPU kernel multiplies fp32 ds by
// fp32-widened k), as B3's Hopper kernel and SDPA round it. S and dP are
// 16-bit products summed in fp32, exact per term: only the order differs.
template <typename T, int kD>
__global__ void __launch_bounds__(kSm90Threads, 1)
flash_causal_dq_kernel_sm90(const __grid_constant__ CUtensorMap mq,
                            const __grid_constant__ CUtensorMap mk,
                            const __grid_constant__ CUtensorMap mv,
                            const __grid_constant__ CUtensorMap mdo, const float* lse,
                            const float* delta, View dq, Dims n) {
  using L = Sm90Layout<kD>;
  constexpr int kStages = L::kStages;
  constexpr int kStageBytes = 2 * L::kRows64;  // K tile, then V tile
  extern __shared__ char smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages], q_full;
  char* Qs = align_1024(smem_raw);  // [warpgroup][box][64 rows x 128 B]
  char* dOs = Qs + 2 * L::kRows64;  // the same for dO
  char* ring = dOs + 2 * L::kRows64;

  const int nqt = (n.T + 127) / 128;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x);  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * 128;
  const int last_ki = min(2 * qt + 1, (n.T - 1) / 64);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::mbar_init(&q_full, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&q_full, 4 * L::kRows64);
      for (int g = 0; g < 2; ++g)
        for (int e = 0; e < L::kBoxes; ++e) {
          const int off = g * L::kRows64 + e * sm90::kTileBytes;
          sm90::tma_load(Qs + off, &mq, &q_full, 64 * e, h, q0 + 64 * g, b);
          sm90::tma_load(dOs + off, &mdo, &q_full, 64 * e, h, q0 + 64 * g, b);
        }
      for (int ki = 0; ki <= last_ki; ++ki) {
        const int s = ki % kStages;
        sm90::mbar_wait(&empty[s], ((ki / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&full[s], kStageBytes);
        sm90::tma_load_kv<L::kBoxes>(ring + s * kStageBytes, &mk, &mv, &full[s], h, 64 * ki, b);
      }
    }
    return;
  }

  const int g = warp / 4;
  const int row0 = q0 + 64 * g;                      // this warpgroup's first row
  const int rA = row0 + 16 * (warp % 4) + lane / 4;  // the thread's rows: rA, rA + 8
  const int c0 = 2 * (lane % 4);
  const char* Qg = Qs + g * L::kRows64;
  const char* dOg = dOs + g * L::kRows64;
  const float scale_log2 = n.scale * sm90::kLog2e;
  const int64_t bh = (static_cast<int64_t>(b) * n.H + h) * n.T;

  // p = exp2(s scale log2(e) + neg_lse2): -inf for a dead row (lse <=
  // -1e30 / 2) and for rows past T, so that their p is exactly 0
  float neg_lse2[2], delta_r[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rA + 8 * hh;
    const float lse_v = r < n.T ? lse[bh + r] : kNegInf;
    neg_lse2[hh] = lse_v <= kNegInf / 2 ? -INFINITY : -lse_v * sm90::kLog2e;
    delta_r[hh] = r < n.T ? delta[bh + r] : 0.f;
  }
  float acc[L::kBoxes][32];
#pragma unroll
  for (int e = 0; e < L::kBoxes; ++e)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[e][i] = 0.f;

  sm90::mbar_wait(&q_full, 0);
  for (int ki = 0; ki <= last_ki; ++ki) {
    const int s = ki % kStages;
    sm90::mbar_wait(&full[s], (ki / kStages) & 1);
    const int k0 = 64 * ki;
    const char* Ks = ring + s * kStageBytes;
    const char* Vs = Ks + L::kRows64;
    if (k0 <= row0 + 63) {  // this warpgroup's rows see part of the tile
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

      // masked scores become -inf (a select), so their p is exactly 0
      if ((k0 + 63 > row0) || (k0 + 64 > n.T)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int c = k0 + 8 * (i / 4) + c0 + i % 2;
          const bool keep = (c <= rA + 8 * ((i / 2) % 2)) & (c < n.T);
          sc[i] = keep ? sc[i] : -INFINITY;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i / 2) % 2;
        const float p = exp2f(fmaf(sc[i], scale_log2, neg_lse2[hh]));
        dp[i] = p * (dp[i] - delta_r[hh]) * n.scale;  // dS
      }
      sm90::mma_rs<T, L::kBoxes>(acc, dp, Ks);
    }
    if (threadIdx.x % 128 == 0) sm90::mbar_arrive(&empty[s]);
  }

  sm90::store_rows<T, L::kBoxes>(static_cast<T*>(dq.ptr) + b * dq.sb + h * dq.sh, dq.st, rA,
                                 n.T, n.D, acc);
}

// ---------------------------------------------------------------- B3
// flash_causal_dkv_kernel_sm90: replaces _dkv_kernel_pruned
// (pytorch_distributed_tpu/ops/flash_attention.py:334), dk and dv.
//
// Bound on this card: operations. At B=8, T=1024, H=12, D=64 its 25.8
// GFLOP (8 D per visible pair: four products) take 0.0261 ms at 989
// TFLOP/s bf16, above the 0.0190 ms its bytes take. The design puts all
// four products on the tensor cores and keeps every tile where the next
// product reads it:
//   - one CTA: 128 keys of one (b, h), keys 64 g .. 64 g + 63 for consumer
//     warpgroup g; K and V arrive once by TMA and stay; Q and dO tiles of
//     64 rows from qi_first = k0 / 64 to the last stream through the ring,
//     with their rows' lse and delta (fp32) staged beside them by the
//     producer warp's lanes; the CTAs with the most Q tiles run first;
//   - the transposed products, so no tile is ever transposed in shared
//     memory: S^T = K Q^T and dP^T = V dO^T (K-major operands),
//     P^T = exp(scale S^T - lse[col]) with the causal mask on tiles that
//     cross the diagonal or the ragged tail and p = 0 where
//     lse <= -1e30 / 2, dS^T = P^T (dP^T - delta[col]) scale, then
//     dV += P^T dO and dK += dS^T Q with P^T and dS^T as register A
//     operands and dO, Q read through MN-major descriptors;
//   - dK and dV accumulate in fp32 registers and are written once; no
//     atomics (the JAX two-pass split: dq is B2's); at D = 128 they hold
//     128 registers a thread, so a third warpgroup (the producer warp and
//     three idle ones) gives its registers to the consumers (setmaxnreg)
//     and nothing spills.
// The one deliberate numeric change from the TPU kernel: P^T and dS^T are
// rounded to the input dtype before their tensor-core products (the TPU
// kernel multiplies fp32 p and ds by fp32-widened do and q), as
// FlashAttention-2/3 and SDPA round them.
template <typename T, int kD>
__global__ void __launch_bounds__(Sm90Layout<kD>::kDkvThreads, 1)
flash_causal_dkv_kernel_sm90(const __grid_constant__ CUtensorMap mq,
                             const __grid_constant__ CUtensorMap mk,
                             const __grid_constant__ CUtensorMap mv,
                             const __grid_constant__ CUtensorMap mdo, const float* lse,
                             const float* delta, View dk, View dv, Dims n) {
  using L = Sm90Layout<kD>;
  constexpr int kStages = L::kStages;
  constexpr int kStageBytes = 2 * L::kRows64;  // Q tile, then dO tile
  extern __shared__ char smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages], kv_full;
  __shared__ float stats[kStages][2][64];  // lse and delta of the stage's Q rows
  char* Ks = align_1024(smem_raw);  // [warpgroup][box][64 rows x 128 B]
  char* Vs = Ks + 2 * L::kRows64;
  char* ring = Vs + 2 * L::kRows64;

  const int nq = (n.T + 63) / 64;
  const int k0 = 128 * static_cast<int>(blockIdx.x);  // the first CTAs have the most Q tiles
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int qi_first = k0 / 64;
  const int64_t bh = (static_cast<int64_t>(b) * n.H + h) * n.T;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 32);  // the producer's lanes; lane 0 brings the TMA bytes
      sm90::mbar_init(&empty[s], 2);
    }
    sm90::mbar_init(&kv_full, 1);
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kProducerWarp) {
    // at D = 128 warpgroup 2 gives 128 registers a thread to the consumers
    // (dK and dV alone hold 128 a thread); warp 8 then produces
    if constexpr (kD == 128) sm90::regs_dec<40>();
    if (warp != kProducerWarp) return;
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&kv_full, 4 * L::kRows64);
      for (int g = 0; g < 2; ++g)
        for (int e = 0; e < L::kBoxes; ++e) {
          const int off = g * L::kRows64 + e * sm90::kTileBytes;
          sm90::tma_load(Ks + off, &mk, &kv_full, 64 * e, h, k0 + 64 * g, b);
          sm90::tma_load(Vs + off, &mv, &kv_full, 64 * e, h, k0 + 64 * g, b);
        }
    }
    for (int qi = qi_first; qi < nq; ++qi) {
      const int it = qi - qi_first;
      const int s = it % kStages;
      sm90::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      const int q0 = 64 * qi;
#pragma unroll
      for (int j = lane; j < 64; j += 32) {
        const bool in = q0 + j < n.T;
        stats[s][0][j] = in ? lse[bh + q0 + j] : 0.f;
        stats[s][1][j] = in ? delta[bh + q0 + j] : 0.f;
      }
      if (lane == 0) {
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

  float dk_acc[L::kBoxes][32], dv_acc[L::kBoxes][32];
#pragma unroll
  for (int e = 0; e < L::kBoxes; ++e)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[e][i] = dv_acc[e][i] = 0.f;

  sm90::mbar_wait(&kv_full, 0);
  for (int qi = qi_first; qi < nq; ++qi) {
    const int it = qi - qi_first;
    const int s = it % kStages;
    sm90::mbar_wait(&full[s], (it / kStages) & 1);
    const int q0 = 64 * qi;
    const char* Qt = ring + s * kStageBytes;
    const char* dOt = Qt + L::kRows64;
    if (q0 + 63 >= kg && kg < n.T) {  // some query of the tile sees one of these keys
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

      // cell i: key cA + 8 ((i / 2) % 2), query q0 + 8 (i / 4) + c0 + i % 2
      const bool edge = (kg + 63 > q0) || (q0 + 64 > n.T);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int j = 8 * jj + c0 + cc;
          const int r = q0 + j;
          const float lse_v = stats[s][0][j];
          const float delta_v = stats[s][1][j];
          const bool dead = lse_v <= kNegInf / 2;
          const float neg_lse2 = -lse_v * sm90::kLog2e;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = 4 * jj + 2 * hh + cc;
            const bool keep = !dead & (!edge | ((cA + 8 * hh <= r) & (r < n.T)));
            const float e = exp2f(fmaf(st[i], scale_log2, neg_lse2));
            const float p = keep ? e : 0.f;
            dpt[i] = p * (dpt[i] - delta_v) * n.scale;
            st[i] = p;
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
    if (threadIdx.x % 128 == 0) sm90::mbar_arrive(&empty[s]);
  }

  sm90::store_rows<T, L::kBoxes>(static_cast<T*>(dk.ptr) + b * dk.sb + h * dk.sh, dk.st, cA,
                                 n.T, n.D, dk_acc);
  sm90::store_rows<T, L::kBoxes>(static_cast<T*>(dv.ptr) + b * dv.sb + h * dv.sh, dv.st, cA,
                                 n.T, n.D, dv_acc);
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

// TMA maps of q, k, v (and do): every operand has T rows.
template <typename T>
cudaError_t make_maps(CUtensorMap* maps, int count, const void* const* p, const long long* s,
                      int B, const Dims& n) {
  const int Ts[4] = {n.T, n.T, n.T, n.T};
  return sm90::make_maps<T>(maps, count, p, s, B, Ts, n.H, n.D);
}

template <typename T, int kD>
cudaError_t fwd_sm90(const void* const* p, const long long* s, int B, const Dims& n,
                     cudaStream_t stream) {
  CUtensorMap maps[3];
  cudaError_t e = make_maps<T>(maps, 3, p, s, B, n);
  if (e != cudaSuccess) return e;
  const size_t smem = Sm90Layout<kD>::smem_bytes(2);  // Q stays
  e = allow_smem(flash_causal_fwd_kernel_sm90<T, kD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n.T + 127) / 128, n.H, B);
  flash_causal_fwd_kernel_sm90<T, kD><<<grid, kSm90Threads, smem, stream>>>(
      maps[0], maps[1], maps[2], view(p[3], s + 9),
      static_cast<float*>(const_cast<void*>(p[4])), n);
  return cudaGetLastError();
}

template <typename T, int kD>
cudaError_t dq_sm90(const void* const* p, const long long* s, int B, const Dims& n,
                    cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t e = make_maps<T>(maps, 4, p, s, B, n);
  if (e != cudaSuccess) return e;
  const size_t smem = Sm90Layout<kD>::smem_bytes(4);  // Q and dO stay
  e = allow_smem(flash_causal_dq_kernel_sm90<T, kD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n.T + 127) / 128, n.H, B);
  flash_causal_dq_kernel_sm90<T, kD><<<grid, kSm90Threads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(p[4]),
      static_cast<const float*>(p[5]), view(p[6], s + 12), n);
  return cudaGetLastError();
}

template <typename T, int kD>
cudaError_t dkv_sm90(const void* const* p, const long long* s, int B, const Dims& n,
                     cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t e = make_maps<T>(maps, 4, p, s, B, n);
  if (e != cudaSuccess) return e;
  const size_t smem = Sm90Layout<kD>::smem_bytes(4);  // K and V stay
  e = allow_smem(flash_causal_dkv_kernel_sm90<T, kD>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((n.T + 127) / 128, n.H, B);
  flash_causal_dkv_kernel_sm90<T, kD><<<grid, Sm90Layout<kD>::kDkvThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(p[4]),
      static_cast<const float*>(p[5]), view(p[6], s + 12), view(p[7], s + 15), n);
  return cudaGetLastError();
}

enum Pass { kFwd, kDq, kDkv };

// fp32: the CUDA-core kernels. bf16/fp16: the Hopper route.
template <typename T, int kD>
cudaError_t run(Pass pass, const void* const* p, const long long* s, int B,
                const Dims& n, cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    switch (pass) {
      case kFwd: return fwd<T, kD>(p, s, B, n, stream);
      case kDq: return dq<T, kD>(p, s, B, n, stream);
      default: return dkv<T, kD>(p, s, B, n, stream);
    }
  } else {
    switch (pass) {
      case kFwd: return fwd_sm90<T, kD>(p, s, B, n, stream);
      case kDq: return dq_sm90<T, kD>(p, s, B, n, stream);
      default: return dkv_sm90<T, kD>(p, s, B, n, stream);
    }
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
