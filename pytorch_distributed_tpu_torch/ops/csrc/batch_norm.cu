// BatchNorm over a stats group for Hopper (sm_90a): the statistics' sums,
// the normalization, the backward's sums and the data gradient.
//
// Replaces no TPU kernel. On the TPU, XLA fused flax's BatchNorm (its jnp
// reductions and elementwise ops, with the group's sums as one psum) into
// the neighbouring ops. On the card the port ran the same arithmetic as
// plain PyTorch in fp32 (models/resnet.py): a cast of every 16-bit
// activation to fp32, two reductions, broadcasts of (1, C, 1, 1) views that
// ATen runs on its strided path, a cast back, and autograd replaying the
// chain with its fp32 intermediates saved. These four kernels compute the
// same function with the activation read and written in its own dtype and
// every sum and product in fp32 registers; the group's two all-reduces
// stay between them, in the caller (ops/batch_norm.py, models/resnet.py).
//
// What bounds it: bytes. Each element takes a handful of fp32 operations
// against 2 bytes read or written, far below the ~20 operations a byte
// where the card's CUDA cores would become the limit. The least traffic is
// 8 passes over the activation a step: bn_stats reads x; bn_fwd_elemt reads
// x and writes y; bn_bwd_reduce reads dy and x; bn_bwd_elemt reads dy and x
// and writes dx. The design meets that count and keeps the loads wide:
//   x is [N, C, H, W] in channels_last memory, so it is a [rows, C] matrix
//   (rows = N H W) with C contiguous channels a row. A thread owns V
//   consecutive channels (V = 8 for 16-bit types, one 16-byte load; 4 for
//   fp32; so every row starts 16-byte aligned: C a multiple of 8, or of 4
//   in fp32, as every channel count of ResNet-50 is, and 16-byte aligned
//   pointers, as the allocator's are; other rows are refused) and walks
//   rows with a grid stride, 4 rows' loads in flight before
//   the first is used (8 in bn_stats, which reads x alone); a CTA is tx channel groups by ty rows (tx a
//   power of two up to 32, tx ty = 256), so a warp reads whole rows of
//   narrow tensors and 512 contiguous bytes of wide ones. The grid
//   (gx, gy) comes from the wrapper: gy = the channel tiles, gx = row
//   slices enough for one wave of 4 CTAs on every SM (at most 64
//   registers a thread, so 4 CTAs of 256 fit an SM).
//   Per-channel constants (mean, variance, scale) are computed once a
//   thread, in registers, from the group's all-reduced sums.
//   The reductions are deterministic, with no float atomics: each CTA sums
//   its rows in registers, then its ty rows in a fixed tree in shared
//   memory, and writes one partial row of 2C floats to scratch; a second
//   kernel sums the gx partials of each column in a fixed order (lane l of
//   32 takes partials l, l + 32, ..., then a tree over the lanes). A launch
//   on the same input and geometry gives the same bits.
//
// The statistics are flax's, the plain version's op for op: mean = Σx / n,
// var = max(Σx² / n − mean², 0), each step rounded on its own (explicit _rn
// intrinsics, so no contraction moves them between kernels). Where the
// variance was clamped to 0 the data gradient drops the term that passes
// through the variance, as autograd of the clamp does.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a CTA of the row kernels: tx * ty
constexpr int kMaxVec = 8;      // channels a thread owns (16-bit types)
constexpr int kUnroll = 4;      // rows whose loads are in flight together
constexpr int kStatsUnroll = 8; // the same for bn_stats, which reads x alone
constexpr int kFinalX = 32;     // finalize: columns a CTA sums
constexpr int kFinalY = 32;     // finalize: lanes over the partials

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

// Two 16-bit values of one 32-bit word (the first in the low half), widened.
__device__ __forceinline__ void unpack2(uint32_t w, const __nv_bfloat16*, float& a, float& b) {
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack2(uint32_t w, const __half*, float& a, float& b) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w));
  a = f.x;
  b = f.y;
}

// Two floats rounded to one 32-bit word of 16-bit values (a in the low half).
__device__ __forceinline__ uint32_t pack2(float a, float b, const __nv_bfloat16*) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, const __half*) {
  const __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// V consecutive elements at p (16 bytes, p 16-byte aligned), widened: one
// 16-byte load.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  static_assert(V * sizeof(T) == 16, "a thread's channels are one 16-byte load");
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(u[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) unpack2(u[i], p, v[2 * i], v[2 * i + 1]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  static_assert(V * sizeof(T) == 16, "a thread's channels are one 16-byte store");
  uint32_t u[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = __float_as_uint(v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) u[i] = pack2(v[2 * i], v[2 * i + 1], p);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

// flax's statistics of channel c from the group's sums [Σx (C), Σx² (C), n].
struct Moments {
  float mean, var;
  bool clamped;
};
__device__ __forceinline__ Moments moments(const float* stats, int C, int c) {
  const float n = stats[2 * C];
  const float mean = __fdiv_rn(stats[c], n);
  const float raw = __fsub_rn(__fdiv_rn(stats[C + c], n), __fmul_rn(mean, mean));
  // raw < 0 is the clamp; a NaN stays NaN, as torch.clamp keeps it
  return {mean, raw < 0.f ? 0.f : raw, raw < 0.f};
}

__device__ __forceinline__ float inv_std(float var, float eps) { return rsqrtf(__fadd_rn(var, eps)); }

// Partial sums of V channels over this CTA's rows: kBwd false gives Σx and
// Σx², kBwd true Σdy and Σdy (x − mean). part: [gridDim.x, 2C] fp32, row
// blockIdx.x written by the CTAs of that row slice (every channel tile).
template <typename T, int V, bool kBwd>
__global__ void __launch_bounds__(kThreads)
    bn_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const float* __restrict__ stats, float* __restrict__ part,
                      long long rows, int C) {
  constexpr int kRows = kBwd ? kUnroll : kStatsUnroll;  // loads in flight
  __shared__ float red[2][kThreads * kMaxVec];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int c0 = (blockIdx.y * TX + tx) * V;
  const bool live = c0 < C;
  float a[V], b[V], mean[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    a[i] = 0.f;
    b[i] = 0.f;
    mean[i] = 0.f;
  }
  if (live) {
    if constexpr (kBwd) {
#pragma unroll
      for (int i = 0; i < V; ++i) mean[i] = moments(stats, C, c0 + i).mean;
    }
    const long long step = static_cast<long long>(gridDim.x) * TY;
    long long r = static_cast<long long>(blockIdx.x) * TY + ty;
    for (; r + (kRows - 1) * step < rows; r += kRows * step) {
      float v[kRows][V], g[kRows][V];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        load_vec<T, V>(x + (r + u * step) * C + c0, v[u]);
        if constexpr (kBwd) load_vec<T, V>(dy + (r + u * step) * C + c0, g[u]);
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if constexpr (kBwd) {
            a[i] += g[u][i];
            b[i] = fmaf(g[u][i], v[u][i] - mean[i], b[i]);
          } else {
            a[i] += v[u][i];
            b[i] = fmaf(v[u][i], v[u][i], b[i]);
          }
        }
      }
    }
    for (; r < rows; r += step) {
      float v[V], g[V];
      load_vec<T, V>(x + r * C + c0, v);
      if constexpr (kBwd) load_vec<T, V>(dy + r * C + c0, g);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if constexpr (kBwd) {
          a[i] += g[i];
          b[i] = fmaf(g[i], v[i] - mean[i], b[i]);
        } else {
          a[i] += v[i];
          b[i] = fmaf(v[i], v[i], b[i]);
        }
      }
    }
  }
  // the CTA's ty rows, summed in a fixed tree
  const int slot = (ty * TX + tx) * V;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red[0][slot + i] = a[i];
    red[1][slot + i] = b[i];
  }
  __syncthreads();
  for (int half = TY / 2; half > 0; half /= 2) {
    if (ty < half) {
      const int other = slot + half * TX * V;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        red[0][slot + i] += red[0][other + i];
        red[1][slot + i] += red[1][other + i];
      }
    }
    __syncthreads();
  }
  if (ty == 0 && live) {
    float* out = part + static_cast<long long>(blockIdx.x) * 2 * C;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      out[c0 + i] = red[0][slot + i];
      out[C + c0 + i] = red[1][slot + i];
    }
  }
}

// Sums the `parts` partial rows of each of the 2C columns in a fixed order
// into out[0, 2C). Forward (kBwd false): out[2C] = rows, the count, so out
// is the [Σx, Σx², n] buffer the group all-reduces. Backward: also this
// rank's dbias = Σdy and dweight = Σdy (x − mean) / sqrt(var + eps).
template <bool kBwd>
__global__ void __launch_bounds__(kFinalX* kFinalY)
    bn_finalize_kernel(const float* __restrict__ part, int parts, int C, long long rows,
                       const float* __restrict__ stats, float eps, float* __restrict__ out,
                       float* __restrict__ dweight, float* __restrict__ dbias) {
  __shared__ float red[kFinalY][kFinalX + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int W = 2 * C;
  const int j = blockIdx.x * kFinalX + tx;
  float s = 0.f;
  if (j < W) {
    for (int p = ty; p < parts; p += kFinalY) s += part[static_cast<long long>(p) * W + j];
  }
  red[ty][tx] = s;
  __syncthreads();
  for (int half = kFinalY / 2; half > 0; half /= 2) {
    if (ty < half) red[ty][tx] += red[ty + half][tx];
    __syncthreads();
  }
  if (ty != 0 || j >= W) return;
  s = red[0][tx];
  out[j] = s;
  if constexpr (kBwd) {
    if (j < C) {
      dbias[j] = s;
    } else {
      dweight[j - C] = s * inv_std(moments(stats, C, j - C).var, eps);
    }
  } else {
    if (j == 0) out[W] = static_cast<float>(rows);
  }
}

// y = (x − mean) scale + bias, scale = weight / sqrt(var + eps); the CTAs
// of row slice 0 write mean and var (C each, fp32).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_fwd_elemt_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ stats,
                        const float* __restrict__ weight, const float* __restrict__ bias,
                        float* __restrict__ mean_out, float* __restrict__ var_out, long long rows,
                        int C, float eps) {
  const int ty = threadIdx.y, TY = blockDim.y;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c0 >= C) return;
  float mean[V], scale[V], shift[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const Moments m = moments(stats, C, c0 + i);
    mean[i] = m.mean;
    scale[i] = __fmul_rn(inv_std(m.var, eps), weight[c0 + i]);
    shift[i] = bias[c0 + i];
    if (blockIdx.x == 0 && ty == 0) {
      mean_out[c0 + i] = m.mean;
      var_out[c0 + i] = m.var;
    }
  }
  const long long step = static_cast<long long>(gridDim.x) * TY;
  long long r = static_cast<long long>(blockIdx.x) * TY + ty;
  for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_vec<T, V>(x + (r + u * step) * C + c0, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[u][i] = fmaf(v[u][i] - mean[i], scale[i], shift[i]);
      store_vec<T, V>(y + (r + u * step) * C + c0, v[u]);
    }
  }
  for (; r < rows; r += step) {
    float v[V];
    load_vec<T, V>(x + r * C + c0, v);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = fmaf(v[i] - mean[i], scale[i], shift[i]);
    store_vec<T, V>(y + r * C + c0, v);
  }
}

// dx = weight invstd (dy − Σ_g dy / n − (x − mean) invstd² Σ_g dy (x − mean) / n),
// sums = [Σ_g dy, Σ_g dy (x − mean)] all-reduced over the group; the last
// term is dropped in a channel whose variance was clamped.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    bn_bwd_elemt_kernel(const T* __restrict__ dy, const T* __restrict__ x, T* __restrict__ dx,
                        const float* __restrict__ stats, const float* __restrict__ weight,
                        const float* __restrict__ sums, long long rows, int C, float eps) {
  const int ty = threadIdx.y, TY = blockDim.y;
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  if (c0 >= C) return;
  const float n = stats[2 * C];
  float mean[V], gain[V], mdy[V], k[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = c0 + i;
    const Moments m = moments(stats, C, c);
    const float is = inv_std(m.var, eps);
    mean[i] = m.mean;
    gain[i] = weight[c] * is;
    mdy[i] = sums[c] / n;
    k[i] = m.clamped ? 0.f : is * is * sums[C + c] / n;
  }
  const long long step = static_cast<long long>(gridDim.x) * TY;
  long long r = static_cast<long long>(blockIdx.x) * TY + ty;
  for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
    float v[kUnroll][V], g[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load_vec<T, V>(x + (r + u * step) * C + c0, v[u]);
      load_vec<T, V>(dy + (r + u * step) * C + c0, g[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[u][i] = gain[i] * fmaf(mean[i] - v[u][i], k[i], g[u][i] - mdy[i]);
      store_vec<T, V>(dx + (r + u * step) * C + c0, v[u]);
    }
  }
  for (; r < rows; r += step) {
    float v[V], g[V];
    load_vec<T, V>(x + r * C + c0, v);
    load_vec<T, V>(dy + r * C + c0, g);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = gain[i] * fmaf(mean[i] - v[i], k[i], g[i] - mdy[i]);
    store_vec<T, V>(dx + r * C + c0, v);
  }
}

// The geometry the wrapper chose: tx channel groups by ty rows a CTA
// (tx a power of two, tx ty = kThreads), gx row slices, gy channel tiles.
struct Grid {
  int tx, ty, gx, gy;
};

// The arguments the kernels take: every row 16-byte aligned (C elt a
// multiple of 16, each activation's pointer 16-byte aligned), so a thread's
// V = 16 / elt channels are one load; the grid the wrapper computes.
bool valid(const Grid& g, long long rows, int C, int elt, const void* const* ptrs, int n_ptrs) {
  if (rows < 0 || C < 1 || (static_cast<long long>(C) * elt) % 16 != 0 || g.tx < 1 ||
      g.tx * g.ty != kThreads || (g.tx & (g.tx - 1)) != 0 || g.gx < 1 || g.gy < 1 ||
      g.gy > 65535)
    return false;
  const int groups = C * elt / 16;
  if (g.gy != (groups + g.tx - 1) / g.tx) return false;
  for (int i = 0; i < n_ptrs; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  return true;
}

int elt_size(int dtype) { return dtype == 0 ? 4 : 2; }

cudaError_t finalize(bool bwd, const float* part, int parts, int C, long long rows,
                     const float* stats, float eps, float* out, float* dweight, float* dbias,
                     cudaStream_t s) {
  const dim3 grid((2 * C + kFinalX - 1) / kFinalX), block(kFinalX, kFinalY);
  if (bwd)
    bn_finalize_kernel<true><<<grid, block, 0, s>>>(part, parts, C, rows, stats, eps, out,
                                                    dweight, dbias);
  else
    bn_finalize_kernel<false><<<grid, block, 0, s>>>(part, parts, C, rows, stats, eps, out,
                                                     dweight, dbias);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_reduce(bool bwd, const void* x, const void* dy, const float* stats,
                          float* part, float* out, float* dweight, float* dbias,
                          long long rows, int C, float eps, const Grid& g, cudaStream_t s) {
  const dim3 grid(g.gx, g.gy), block(g.tx, g.ty);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  if (bwd)
    bn_partial_kernel<T, V, true><<<grid, block, 0, s>>>(xt, dyt, stats, part, rows, C);
  else
    bn_partial_kernel<T, V, false><<<grid, block, 0, s>>>(xt, dyt, stats, part, rows, C);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return finalize(bwd, part, g.gx, C, rows, stats, eps, out, dweight, dbias, s);
}

template <typename T, int V>
cudaError_t launch_fwd_elemt(const void* x, void* y, const float* stats, const float* weight,
                             const float* bias, float* mean, float* var, long long rows, int C,
                             float eps, const Grid& g, cudaStream_t s) {
  bn_fwd_elemt_kernel<T, V><<<dim3(g.gx, g.gy), dim3(g.tx, g.ty), 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), stats, weight, bias, mean, var, rows, C, eps);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_bwd_elemt(const void* dy, const void* x, void* dx, const float* stats,
                             const float* weight, const float* sums, long long rows, int C,
                             float eps, const Grid& g, cudaStream_t s) {
  bn_bwd_elemt_kernel<T, V><<<dim3(g.gx, g.gy), dim3(g.tx, g.ty), 0, s>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<T*>(dx), stats, weight,
      sums, rows, C, eps);
  return cudaGetLastError();
}

}  // namespace

// One instantiation per dtype: 0 float32, 1 bfloat16, 2 float16, each with
// V = 16 / element size channels a thread.
#define BN_DISPATCH(dtype, FN, ...)                               \
  switch (dtype) {                                                \
    case 0:                                                       \
      return static_cast<int>(FN<float, 4>(__VA_ARGS__));         \
    case 1:                                                       \
      return static_cast<int>(FN<__nv_bfloat16, 8>(__VA_ARGS__)); \
    case 2:                                                       \
      return static_cast<int>(FN<__half, 8>(__VA_ARGS__));        \
    default:                                                      \
      return static_cast<int>(cudaErrorInvalidValue);             \
  }

// Plain C entry points, loaded with ctypes. Each launches on `stream`, does
// not synchronise, allocates nothing, and returns the first launch error
// (cudaError_t; cudaErrorInvalidValue for arguments it refuses, before any
// launch). x, dy, y, dx: [rows, C] in the dtype; stats: [Σx, Σx², n], 2C + 1
// fp32; sums: 2C fp32; weight, bias, mean, var, dweight, dbias: C fp32;
// part: scratch of gx * 2C fp32.

// bn_stats: stats = [Σx, Σx², rows] of this rank's rows.
extern "C" int bn_stats_launch(const void* x, void* part, void* stats, long long rows, int C,
                               int dtype, int tx, int ty, int gx, int gy, void* stream) {
  const Grid g{tx, ty, gx, gy};
  const void* ptrs[] = {x};
  if (!valid(g, rows, C, elt_size(dtype), ptrs, 1)) return static_cast<int>(cudaErrorInvalidValue);
  BN_DISPATCH(dtype, launch_reduce, false, x, nullptr, nullptr, static_cast<float*>(part),
              static_cast<float*>(stats), nullptr, nullptr, rows, C, 0.f, g,
              static_cast<cudaStream_t>(stream))
}

// bn_fwd_elemt: y from x and the group's stats; mean and var for the
// running statistics.
extern "C" int bn_fwd_elemt_launch(const void* x, void* y, const void* stats, const void* weight,
                                   const void* bias, void* mean, void* var, long long rows, int C,
                                   float eps, int dtype, int tx, int ty, int gx, int gy,
                                   void* stream) {
  const Grid g{tx, ty, gx, gy};
  const void* ptrs[] = {x, y};
  if (!valid(g, rows, C, elt_size(dtype), ptrs, 2)) return static_cast<int>(cudaErrorInvalidValue);
  BN_DISPATCH(dtype, launch_fwd_elemt, x, y, static_cast<const float*>(stats),
              static_cast<const float*>(weight), static_cast<const float*>(bias),
              static_cast<float*>(mean), static_cast<float*>(var), rows, C, eps, g,
              static_cast<cudaStream_t>(stream))
}

// bn_bwd_reduce: sums = [Σdy, Σdy (x − mean)] of this rank's rows (the copy
// the group all-reduces), dbias and dweight from the same sums.
extern "C" int bn_bwd_reduce_launch(const void* dy, const void* x, const void* stats, void* part,
                                    void* sums, void* dweight, void* dbias, long long rows, int C,
                                    float eps, int dtype, int tx, int ty, int gx, int gy,
                                    void* stream) {
  const Grid g{tx, ty, gx, gy};
  const void* ptrs[] = {dy, x};
  if (!valid(g, rows, C, elt_size(dtype), ptrs, 2)) return static_cast<int>(cudaErrorInvalidValue);
  BN_DISPATCH(dtype, launch_reduce, true, x, dy, static_cast<const float*>(stats),
              static_cast<float*>(part), static_cast<float*>(sums), static_cast<float*>(dweight),
              static_cast<float*>(dbias), rows, C, eps, g, static_cast<cudaStream_t>(stream))
}

// bn_bwd_elemt: dx from dy, x, the group's stats and the group's sums.
extern "C" int bn_bwd_elemt_launch(const void* dy, const void* x, void* dx, const void* stats,
                                   const void* weight, const void* sums, long long rows, int C,
                                   float eps, int dtype, int tx, int ty, int gx, int gy,
                                   void* stream) {
  const Grid g{tx, ty, gx, gy};
  const void* ptrs[] = {dy, x, dx};
  if (!valid(g, rows, C, elt_size(dtype), ptrs, 3)) return static_cast<int>(cudaErrorInvalidValue);
  BN_DISPATCH(dtype, launch_bwd_elemt, dy, x, dx, static_cast<const float*>(stats),
              static_cast<const float*>(weight), static_cast<const float*>(sums), rows, C, eps, g,
              static_cast<cudaStream_t>(stream))
}
