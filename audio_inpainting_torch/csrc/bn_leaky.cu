// Train-mode BatchNorm + LeakyReLU for Hopper (sm_90a), forward and
// backward, NCHW, deterministic.
//
// Replaces no TPU kernel: the JAX package left BatchNorm and LeakyReLU to
// XLA, which fused them. In the port the pair ran as cuDNN's per-channel
// BatchNorm kernels (bn_fw_tr_1C11, bn_bw_1C11) with a cast, a second
// statistics pass (var_mean), two running-average updates and the
// LeakyReLU around them. For each channel c over the M = N * H * W
// elements of the batch:
//
//     mean, var = the batch's mean and biased variance, in fp32
//     rstd      = 1 / sqrt(var + eps)
//     xhat      = (x - mean) * rstd
//     z         = weight[c] * xhat + bias[c]
//     y         = z > 0 ? z : slope * z                      (fp32 out)
//     running   = running + (1 - momentum) * (batch - running)
//
// and backward, with dz = dy * (z > 0 ? 1 : slope) and means over M:
//
//     dbias[c]   = sum dz,    dweight[c] = sum dz * xhat
//     dx         = weight[c] * rstd * (dz - mean(dz) - xhat * mean(dz * xhat))
//
// in the input's dtype (bf16 or fp32). The plain torch versions of this
// arithmetic are `bn_leaky_forward_ref` and `bn_leaky_backward_ref` in
// audio_inpainting_torch/ops/bn_leaky.py.
//
// What bounds it on an H100: bytes. The arithmetic is a few operations an
// element. Read once and written once, a bf16 element costs 6 bytes
// forward (x in, fp32 y out) and 8 backward (fp32 dy and x in, dx out);
// this design reads x twice forward and dy and x twice backward, 8 and 14
// bytes, whose second reads may come from the 50 MB L2. At the GAN's
// (516, 1728) grid an epoch's 16 passes each way move 2.2 GB that way,
// 0.66 ms at 3.35 TB/s. At N = 1 with 16-64 channels a kernel with a block
// a channel (cuDNN's 1C11) leaves most of the 132 SMs idle.
//
// Design:
//   - Each (n, c) plane of H * W contiguous elements is split into K
//     chunks of L elements (a multiple of the vector width), with K chosen
//     by the wrapper from the channel count and H * W so that the N * C * K
//     blocks cover the SMs. A thread moves 16 bytes a load (8 bf16 or 4
//     fp32), neighbouring threads on neighbouring addresses.
//   - Forward, two kernels. fwd_stats: a block's count, mean and M2 of its
//     chunk (per thread by vectors, then Chan's rule in a fixed warp and
//     block tree) into a partial. fwd_apply: every block of a channel
//     combines the channel's N * K partials in one fixed order, so all of
//     them hold the same bits, then normalizes its chunk, applies the
//     affine and the LeakyReLU and writes fp32; the first block of the
//     channel writes mean and rstd for the backward and moves the running
//     averages.
//   - Backward, two kernels. bwd_sums: recompute z from the saved input,
//     mean, rstd, weight and bias, and sum dz and dz * xhat over the chunk.
//     bwd_apply: combine the channel's partial sums in the same fixed
//     order, write dx, and from the first block the weight and bias
//     gradients. xhat and z are computed with explicitly rounded
//     intrinsics, so the backward's z equals the forward's bit for bit.
//   - Deterministic: no atomics; the partition depends on the shape and
//     the card alone, and every sum runs in one fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// count, mean and M2 (sum of squared deviations) of a set of elements
struct Stats {
  float n, mean, m2;
};

// Chan, Golub and LeVeque's pairwise update; not commutative in its bits,
// so every caller combines in a fixed order
__device__ __forceinline__ Stats combine(Stats a, Stats b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float delta = b.mean - a.mean;
  const float r = b.n / n;
  return Stats{n, a.mean + delta * r, a.m2 + b.m2 + delta * delta * a.n * r};
}

// lane 0 ends with the warp's combination, in a fixed tree
__device__ __forceinline__ Stats warp_combine(Stats s) {
  for (int off = 16; off > 0; off >>= 1) {
    const Stats o{__shfl_down_sync(kFull, s.n, off), __shfl_down_sync(kFull, s.mean, off),
                  __shfl_down_sync(kFull, s.m2, off)};
    s = combine(s, o);
  }
  return s;
}

__device__ __forceinline__ float2 warp_sum(float2 s) {
  for (int off = 16; off > 0; off >>= 1) {
    s.x += __shfl_down_sync(kFull, s.x, off);
    s.y += __shfl_down_sync(kFull, s.y, off);
  }
  return s;
}

// thread 0 ends with the block's combination
__device__ __forceinline__ Stats block_combine(Stats s) {
  __shared__ Stats part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_combine(s);
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) s = warp_combine(lane < kWarps ? part[lane] : Stats{0.f, 0.f, 0.f});
  return s;
}

__device__ __forceinline__ float2 block_sum(float2 s) {
  __shared__ float2 part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_sum(s);
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) s = warp_sum(lane < kWarps ? part[lane] : make_float2(0.f, 0.f));
  return s;
}

// Loads and stores of V consecutive elements: one 16-byte access where
// V > 1, else one element.
template <typename T, int V>
struct Io;

template <>
struct Io<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = *p; }
  static __device__ __forceinline__ void store(float* p, const float* v) { *p = v[0]; }
};

template <>
struct Io<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    uint4 a;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    *reinterpret_cast<uint4*>(p) = a;
  }
};

template <>
struct Io<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

// V floats of an fp32 tensor that runs beside a V-wide access of T
template <int V>
__device__ __forceinline__ void load_f32(const float* p, float* v) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 4) Io<float, 4>::load(p + j, v + j);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = p[j];
  }
}

template <int V>
__device__ __forceinline__ void store_f32(float* p, const float* v) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V; j += 4) Io<float, 4>::store(p + j, v + j);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = v[j];
  }
}

// the pre-activation, rounded step by step so that every kernel gets the
// same bits from the same inputs
__device__ __forceinline__ float normalize(float x, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(x, mean), rstd);
}

__device__ __forceinline__ float affine(float xhat, float w, float b) {
  return __fmaf_rn(xhat, w, b);
}

struct Chunk {
  size_t base;     // the plane's first element
  int start, end;  // the chunk's extent inside the plane
};

__device__ __forceinline__ Chunk chunk_of(int hw, int L) {
  const int start = blockIdx.x * L;
  return Chunk{static_cast<size_t>(blockIdx.y) * hw, start, min(start + L, hw)};
}

// The channel's N * K partials in one fixed order: lane j folds partials
// j, j + 32, ... (index n * K + k), then the warp's tree. Every block of
// the channel gets the same bits.
__device__ Stats channel_stats(const float* part, int c, int C, int N, int K) {
  __shared__ Stats result;
  if (threadIdx.x < 32) {
    Stats s{0.f, 0.f, 0.f};
    for (int q = threadIdx.x; q < N * K; q += 32) {
      const int n = q / K, k = q - n * K;
      const float* p = part + ((static_cast<size_t>(n) * C + c) * K + k) * 3;
      s = combine(s, Stats{p[0], p[1], p[2]});
    }
    s = warp_combine(s);
    if (threadIdx.x == 0) result = s;
  }
  __syncthreads();
  return result;
}

__device__ float2 channel_sums(const float* part, int c, int C, int N, int K) {
  __shared__ float2 result;
  if (threadIdx.x < 32) {
    float2 s = make_float2(0.f, 0.f);
    for (int q = threadIdx.x; q < N * K; q += 32) {
      const int n = q / K, k = q - n * K;
      const float* p = part + ((static_cast<size_t>(n) * C + c) * K + k) * 2;
      s.x += p[0];
      s.y += p[1];
    }
    s = warp_sum(s);
    if (threadIdx.x == 0) result = s;
  }
  __syncthreads();
  return result;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_leaky_fwd_stats(const T* __restrict__ x, float* __restrict__ part, int hw, int K, int L) {
  const Chunk ch = chunk_of(hw, L);
  Stats s{0.f, 0.f, 0.f};
  for (int i = ch.start + threadIdx.x * V; i < ch.end; i += kThreads * V) {
    float v[V];
    Io<T, V>::load(x + ch.base + i, v);
    float t[V];
#pragma unroll
    for (int j = 0; j < V; ++j) t[j] = v[j];
#pragma unroll
    for (int w = V / 2; w > 0; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] += t[j + w];
    const float vm = t[0] * (1.f / V);
    float m2 = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = v[j] - vm;
      m2 = fmaf(d, d, m2);
    }
    s = combine(s, Stats{static_cast<float>(V), vm, m2});
  }
  s = block_combine(s);
  if (threadIdx.x == 0) {
    float* p = part + (static_cast<size_t>(blockIdx.y) * K + blockIdx.x) * 3;
    p[0] = s.n;
    p[1] = s.mean;
    p[2] = s.m2;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_leaky_fwd_apply(const T* __restrict__ x, const float* __restrict__ weight,
                   const float* __restrict__ bias, const float* __restrict__ part,
                   float* __restrict__ y, float* __restrict__ save_mean,
                   float* __restrict__ save_rstd, float* __restrict__ running_mean,
                   float* __restrict__ running_var, int N, int C, int hw, int K, int L,
                   float eps, float slope, float step) {
  const int c = blockIdx.y % C;
  const Stats s = channel_stats(part, c, C, N, K);
  const float mean = s.mean, var = s.m2 / s.n;
  const float rstd = 1.f / sqrtf(var + eps);
  const float w = weight[c], b = bias[c];
  const Chunk ch = chunk_of(hw, L);
  for (int i = ch.start + threadIdx.x * V; i < ch.end; i += kThreads * V) {
    float v[V];
    Io<T, V>::load(x + ch.base + i, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float z = affine(normalize(v[j], mean, rstd), w, b);
      v[j] = z > 0.f ? z : __fmul_rn(z, slope);
    }
    store_f32<V>(y + ch.base + i, v);
  }
  if (blockIdx.x == 0 && blockIdx.y == c && threadIdx.x == 0) {
    save_mean[c] = mean;
    save_rstd[c] = rstd;
    running_mean[c] = __fmaf_rn(step, __fsub_rn(mean, running_mean[c]), running_mean[c]);
    running_var[c] = __fmaf_rn(step, __fsub_rn(var, running_var[c]), running_var[c]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_leaky_bwd_sums(const float* __restrict__ dy, const T* __restrict__ x,
                  const float* __restrict__ weight, const float* __restrict__ bias,
                  const float* __restrict__ mean, const float* __restrict__ rstd,
                  float* __restrict__ part, int C, int hw, int K, int L, float slope) {
  const int c = blockIdx.y % C;
  const float m = mean[c], r = rstd[c], w = weight[c], b = bias[c];
  const Chunk ch = chunk_of(hw, L);
  float2 s = make_float2(0.f, 0.f);
  for (int i = ch.start + threadIdx.x * V; i < ch.end; i += kThreads * V) {
    float v[V], g[V];
    Io<T, V>::load(x + ch.base + i, v);
    load_f32<V>(dy + ch.base + i, g);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xhat = normalize(v[j], m, r);
      const float dz = affine(xhat, w, b) > 0.f ? g[j] : g[j] * slope;
      s.x += dz;
      s.y = fmaf(dz, xhat, s.y);
    }
  }
  s = block_sum(s);
  if (threadIdx.x == 0) {
    float* p = part + (static_cast<size_t>(blockIdx.y) * K + blockIdx.x) * 2;
    p[0] = s.x;
    p[1] = s.y;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
bn_leaky_bwd_apply(const float* __restrict__ dy, const T* __restrict__ x,
                   const float* __restrict__ weight, const float* __restrict__ bias,
                   const float* __restrict__ mean, const float* __restrict__ rstd,
                   const float* __restrict__ part, T* __restrict__ dx,
                   float* __restrict__ dweight, float* __restrict__ dbias, int N, int C,
                   int hw, int K, int L, float slope) {
  const int c = blockIdx.y % C;
  const float2 s = channel_sums(part, c, C, N, K);
  const float count = static_cast<float>(N) * static_cast<float>(hw);
  const float mdz = s.x / count, mdzx = s.y / count;
  const float m = mean[c], r = rstd[c], w = weight[c], b = bias[c];
  const float scale = w * r;
  const Chunk ch = chunk_of(hw, L);
  for (int i = ch.start + threadIdx.x * V; i < ch.end; i += kThreads * V) {
    float v[V], g[V];
    Io<T, V>::load(x + ch.base + i, v);
    load_f32<V>(dy + ch.base + i, g);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xhat = normalize(v[j], m, r);
      const float dz = affine(xhat, w, b) > 0.f ? g[j] : g[j] * slope;
      v[j] = scale * ((dz - mdz) - xhat * mdzx);
    }
    Io<T, V>::store(dx + ch.base + i, v);
  }
  if (blockIdx.x == 0 && blockIdx.y == c && threadIdx.x == 0) {
    dweight[c] = s.y;
    dbias[c] = s.x;
  }
}

template <typename T, int V>
cudaError_t forward(const void* x, const float* weight, const float* bias, float* running_mean,
                    float* running_var, float* y, float* save_mean, float* save_rstd,
                    float* part, int N, int C, int hw, int K, int L, float eps, float slope,
                    float step, cudaStream_t stream) {
  const dim3 grid(K, N * C);
  const T* xt = static_cast<const T*>(x);
  bn_leaky_fwd_stats<T, V><<<grid, kThreads, 0, stream>>>(xt, part, hw, K, L);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_leaky_fwd_apply<T, V><<<grid, kThreads, 0, stream>>>(
      xt, weight, bias, part, y, save_mean, save_rstd, running_mean, running_var, N, C, hw, K,
      L, eps, slope, step);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t backward(const float* dy, const void* x, const float* weight, const float* bias,
                     const float* mean, const float* rstd, void* dx, float* dweight,
                     float* dbias, float* part, int N, int C, int hw, int K, int L,
                     float slope, cudaStream_t stream) {
  const dim3 grid(K, N * C);
  const T* xt = static_cast<const T*>(x);
  bn_leaky_bwd_sums<T, V><<<grid, kThreads, 0, stream>>>(dy, xt, weight, bias, mean, rstd,
                                                         part, C, hw, K, L, slope);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bn_leaky_bwd_apply<T, V><<<grid, kThreads, 0, stream>>>(
      dy, xt, weight, bias, mean, rstd, part, static_cast<T*>(dx), dweight, dbias, N, C, hw,
      K, L, slope);
  return cudaGetLastError();
}

bool valid(int N, int C, int hw, int K, int L, int vec, int width) {
  return N >= 1 && C >= 1 && hw >= 1 && N * C <= 65535 && K >= 1 && L >= 1 &&
         (vec == 1 || (vec == width && hw % vec == 0 && L % vec == 0)) &&
         static_cast<long long>(K - 1) * L < hw && static_cast<long long>(K) * L >= hw;
}

}  // namespace

// x: (N, C, H, W) contiguous, bf16 (x_bf16 = 1) or fp32; hw = H * W; each
// plane in K chunks of L elements; vec 1, or 16 bytes over the element
// size with every pointer 16-byte aligned. part: N * C * K * 3 floats.
// step = 1 - momentum. Returns a cudaError_t, 0 on success.
extern "C" int bn_leaky_forward(const void* x, const float* weight, const float* bias,
                                float* running_mean, float* running_var, float* y,
                                float* save_mean, float* save_rstd, float* part, int x_bf16,
                                int vec, int N, int C, int hw, int K, int L, float eps,
                                float slope, float step, void* stream) {
  const int width = x_bf16 ? 8 : 4;
  if (!valid(N, C, hw, K, L, vec, width)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && vec > 1)
    return forward<__nv_bfloat16, 8>(x, weight, bias, running_mean, running_var, y, save_mean,
                                     save_rstd, part, N, C, hw, K, L, eps, slope, step, s);
  if (x_bf16)
    return forward<__nv_bfloat16, 1>(x, weight, bias, running_mean, running_var, y, save_mean,
                                     save_rstd, part, N, C, hw, K, L, eps, slope, step, s);
  if (vec > 1)
    return forward<float, 4>(x, weight, bias, running_mean, running_var, y, save_mean,
                             save_rstd, part, N, C, hw, K, L, eps, slope, step, s);
  return forward<float, 1>(x, weight, bias, running_mean, running_var, y, save_mean, save_rstd,
                           part, N, C, hw, K, L, eps, slope, step, s);
}

// dy: fp32 like the forward's output; dx in x's dtype; part: N * C * K * 2
// floats; the rest as for bn_leaky_forward.
extern "C" int bn_leaky_backward(const float* dy, const void* x, const float* weight,
                                 const float* bias, const float* mean, const float* rstd,
                                 void* dx, float* dweight, float* dbias, float* part,
                                 int x_bf16, int vec, int N, int C, int hw, int K, int L,
                                 float slope, void* stream) {
  const int width = x_bf16 ? 8 : 4;
  if (!valid(N, C, hw, K, L, vec, width)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && vec > 1)
    return backward<__nv_bfloat16, 8>(dy, x, weight, bias, mean, rstd, dx, dweight, dbias,
                                      part, N, C, hw, K, L, slope, s);
  if (x_bf16)
    return backward<__nv_bfloat16, 1>(dy, x, weight, bias, mean, rstd, dx, dweight, dbias,
                                      part, N, C, hw, K, L, slope, s);
  if (vec > 1)
    return backward<float, 4>(dy, x, weight, bias, mean, rstd, dx, dweight, dbias, part, N, C,
                              hw, K, L, slope, s);
  return backward<float, 1>(dy, x, weight, bias, mean, rstd, dx, dweight, dbias, part, N, C,
                            hw, K, L, slope, s);
}
