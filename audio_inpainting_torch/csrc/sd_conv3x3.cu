// The SD UNet's 3x3, stride-1, pad-1 fp32 convolution with bias, for
// Hopper (sm_90a), NCHW, as a deterministic split-K implicit GEMM.
//
// Replaces no TPU kernel: the JAX package left its convolutions to XLA. In
// the port these convs ran as cuDNN's fp32 kernels, whose heuristics pick
// implicit_convolve_sgemm and precomputed_convolve_sgemm for the UNet's
// wide up-path shapes: 40 blocks on 132 SMs, about 3 % of the fp32 peak.
// For x (N, C, H, W), weight (K, C, 3, 3) and bias (K,):
//
//     y[n, k, h, w] = bias[k] + sum_{c, r, s} x[n, c, h + r - 1, w + s - 1]
//                                              * weight[k, c, r, s]
//
// with x zero outside the image. As a GEMM: M = N * H * W output pixels,
// N = K output channels, depth C * 9, the weight already a row-major
// (K, C * 9) matrix. The plain torch version of this arithmetic is
// `sd_conv3x3_ref` in audio_inpainting_torch/ops/sd_conv3x3.py.
//
// What bounds it on an H100: operations. The UNet's routed shapes have
// 3.8-60 GFLOP a call (2 x M x N x C x 9) over 15-126 MB of operands, the
// weight the most: 63-755 FLOPs a byte, against the card's 20 (67 TFLOP/s
// of fp32 FMA over 3.35 TB/s). TF32, 3xTF32 and the 16-bit types are not used,
// so the tensor cores are not either.
//
// Design:
//   - A block computes 128 pixels x 128 output channels with 256 threads,
//     each an 8 x 8 register tile: 8 neighbouring pixels of one output row
//     by 8 channels (two groups of 4, 64 apart, so that a warp's reads of
//     the weight tile fall in distinct banks). The 128 pixels are `img`
//     images x `th` rows x `tw` columns (tw in 8, 16, 32).
//   - The depth runs in stages of 4 input channels. A stage brings into
//     shared memory the input patch of those channels, (th + 2) x (tw + 2)
//     with the halo zero-filled (16-byte cp.async for a row's interior,
//     4-byte for its two halo columns, zero fill outside the image), and
//     the 36 x 128 weight tile, transposed to (depth, channel) by 4-byte
//     cp.async. Three stages are in flight.
//   - For each input channel and kernel row a thread reads the 10 patch
//     values under its 8 pixels once and uses them for the three kernel
//     columns: 4 shared loads of the patch and 6 of the weight tile feed
//     192 FMAs.
//   - The GEMMs are narrow and deep (M 128-2,048, depth 2,880-23,040), so
//     the depth is split into `slices` ranges of input channels, chosen by
//     the wrapper from the tile count and the SM count. Each slice writes
//     its fp32 partial sums to a workspace of its own, and a second kernel
//     sums the slices in one fixed order and adds the bias.
//   - Deterministic: no atomics; the partition depends on the shape and
//     the card alone, and every sum runs in one fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;                 // output pixels a block
constexpr int kBN = 128;                 // output channels a block
constexpr int kCK = 4;                   // input channels a stage
constexpr int kDepth = kCK * 9;          // GEMM depth a stage
constexpr int kStages = 3;
constexpr int kBNP = kBN + 4;            // row stride of the weight tile
constexpr int kPatchFloats = 1600;       // the largest patch a stage holds
constexpr int kStageFloats = kPatchFloats + kDepth * kBNP;
constexpr int kSmemBytes = kStages * kStageFloats * 4;
constexpr int kMaxDevices = 64;

struct Shape {
  int n, c, h, w, k;       // batch, input channels, height, width, output channels
  int th, tw, img, pw;     // tile rows, columns and images; patch row stride
  int tiles_h, tiles_w;    // tiles down and across an image
  int ci_per_slice;        // input channels a slice, a multiple of kCK
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copies of 4 and 16 bytes; where `valid` is false nothing is read and
// the destination is zero-filled
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One stage into `st`: input channels c0 .. c0 + kCK - 1 of the tile at
// image n0, row h0, column w0 and output channel k0.
//
// The patch: channel c, image i, patch row j (input row h0 - 1 + j) at
// st + ((c * img + i) * (th + 2) + j) * pw; input column w0 - 1 + q at
// column 3 + q, so the interior starts 16-byte aligned at column 4.
// The weight tile: depth kk (= c * 9 + r * 3 + s) and channel n at
// st + kPatchFloats + kk * kBNP + n; consecutive threads read consecutive
// kk of one weight row.
__device__ __forceinline__ void load_stage(float* st, const float* __restrict__ x,
                                           const float* __restrict__ wt, const Shape s, int n0,
                                           int h0, int w0, int k0, int c0, int tid) {
  const int chunks = s.tw / 4 + 2;
  const int rows = s.th + 2;
  const int items = kCK * s.img * rows * chunks;
  for (int it = tid; it < items; it += kThreads) {
    const int chunk = it % chunks;
    const int plane = it / chunks;          // (c * img + i) * rows + j
    const int j = plane % rows;
    const int ci = plane / rows;            // c * img + i
    const int i = ci % s.img, c = ci / s.img;
    const int h = h0 + j - 1;
    const bool in_rows = h >= 0 && h < s.h;
    const float* row = x + ((static_cast<int64_t>(n0 + i) * s.c + c0 + c) * s.h + h) * s.w;
    float* dst = st + plane * s.pw;
    if (chunk == 0) {
      const bool v = in_rows && w0 > 0;
      cp_async4(dst + 3, v ? row + w0 - 1 : x, v);
    } else if (chunk == chunks - 1) {
      const bool v = in_rows && w0 + s.tw < s.w;
      cp_async4(dst + s.tw + 4, v ? row + w0 + s.tw : x, v);
    } else {
      const int q = 4 * (chunk - 1);
      cp_async16(dst + 4 + q, in_rows ? row + w0 + q : x, in_rows);
    }
  }
  float* bs = st + kPatchFloats;
  const int64_t depth = static_cast<int64_t>(s.c) * 9;
  for (int it = tid; it < kDepth * kBN; it += kThreads) {
    const int n = it / kDepth, kk = it - n * kDepth;
    const bool v = k0 + n < s.k;
    cp_async4(bs + kk * kBNP + n, v ? wt + (k0 + n) * depth + c0 * 9 + kk : wt, v);
  }
}

// The FMAs of one stage: acc[i][j] for pixel i and channel j of the thread.
__device__ __forceinline__ void compute_stage(const float* st, int a_off, int b_off,
                                              int cstride, int pw, float (&acc)[8][8]) {
  const float* bs = st + kPatchFloats + b_off;
#pragma unroll
  for (int c = 0; c < kCK; ++c) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      // input columns w - 1 .. w + 8 under the thread's pixels w .. w + 7
      const float* pa = st + a_off + c * cstride + r * pw;
      const float4 lo = *reinterpret_cast<const float4*>(pa + 1);
      const float4 hi = *reinterpret_cast<const float4*>(pa + 5);
      const float a[10] = {pa[0], lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w, pa[9]};
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float* pb = bs + ((c * 3 + r) * 3 + q) * kBNP;
        const float4 b0 = *reinterpret_cast<const float4*>(pb);
        const float4 b1 = *reinterpret_cast<const float4*>(pb + 64);
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(a[i + q], b[jj], acc[i][jj]);
      }
    }
  }
}

// grid (tiles of pixels, tiles of output channels, slices); slice z's
// partial sums into ws + z * N * K * H * W, laid out as the output
__global__ void __launch_bounds__(kThreads, 2)
    sd_conv3x3_igemm(const float* __restrict__ x, const float* __restrict__ wt,
                     float* __restrict__ ws, const Shape s) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a warp: 4 pixel groups x 8 channel groups; the block: 16 x 16
  const int mg = (warp & 3) * 4 + (lane >> 3);
  const int ng = (warp >> 2) * 8 + (lane & 7);

  int t = blockIdx.x;
  const int w0 = (t % s.tiles_w) * s.tw;
  t /= s.tiles_w;
  const int h0 = (t % s.tiles_h) * s.th;
  const int n0 = (t / s.tiles_h) * s.img;
  const int k0 = blockIdx.y * kBN;
  const int c_begin = blockIdx.z * s.ci_per_slice;
  const int steps = (min(s.c, c_begin + s.ci_per_slice) - c_begin) / kCK;

  // the thread's 8 pixels: image gi, row gh, columns gw .. gw + 7 of the tile
  const int per_row = s.tw / 8;
  const int grow = mg / per_row;
  const int gi = grow / s.th, gh = grow % s.th, gw = (mg % per_row) * 8;
  const int rows = s.th + 2;
  const int cstride = s.img * rows * s.pw;
  const int a_off = (gi * rows + gh) * s.pw + gw + 3;
  const int b_off = ng * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < steps)
      load_stage(smem + st * kStageFloats, x, wt, s, n0, h0, w0, k0, c_begin + st * kCK, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage kt has landed; every thread is done with stage kt - 1
    const int next = kt + kStages - 1;
    if (next < steps)
      load_stage(smem + (next % kStages) * kStageFloats, x, wt, s, n0, h0, w0, k0,
                 c_begin + next * kCK, tid);
    cp_async_commit();
    compute_stage(smem + (kt % kStages) * kStageFloats, a_off, b_off, cstride, s.pw, acc);
  }

  const int64_t plane = static_cast<int64_t>(s.h) * s.w;
  float* out = ws + (static_cast<int64_t>(blockIdx.z) * s.n + n0 + gi) * s.k * plane +
               static_cast<int64_t>(h0 + gh) * s.w + w0 + gw;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = k0 + b_off + (j & 3) + (j >> 2) * 64;
    if (k < s.k) {
      float4* o = reinterpret_cast<float4*>(out + k * plane);
      o[0] = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      o[1] = make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
    }
  }
}

// y = ws[0] + ws[1] + ... + ws[slices - 1] + bias, in that order, by
// vectors of 4 (H * W is a multiple of 8)
__global__ void __launch_bounds__(kThreads)
    sd_conv3x3_reduce(const float4* __restrict__ ws, const float* __restrict__ bias,
                      float4* __restrict__ y, int slices, int64_t total4, int plane4, int k) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < total4;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    float4 acc = ws[i];
    for (int z = 1; z < slices; ++z) {
      const float4 v = ws[z * total4 + i];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    const float b = bias[(i / plane4) % k];
    acc.x += b;
    acc.y += b;
    acc.z += b;
    acc.w += b;
    y[i] = acc;
  }
}

bool smem_ready[kMaxDevices];

}  // namespace

// x (N, C, H, W), weight (K, C, 3, 3), bias (K,), y (N, K, H, W),
// fp32 and contiguous, x 16-byte aligned; ws: slices * N * K * H * W
// floats. Tiles of th x tw pixels (img = 128 / (th * tw) images a tile);
// the depth in `slices` ranges of ci_per_slice input channels (the last
// may be shorter, none empty). Returns a cudaError_t, 0 on success.
extern "C" int sd_conv3x3_forward(const float* x, const float* weight, const float* bias,
                                  float* ws, float* y, int N, int C, int H, int W, int K,
                                  int th, int tw, int slices, int ci_per_slice, void* stream) {
  if (th < 1 || tw < 8 || tw % 8 || kBM % (th * tw)) return cudaErrorInvalidValue;
  Shape s{N, C, H, W, K, th, tw, kBM / (th * tw), tw + 12, 0, 0, ci_per_slice};
  if (H % th || W % tw || N % s.img || C % kCK || ci_per_slice % kCK || ci_per_slice < kCK ||
      slices < 1 || static_cast<int64_t>(slices - 1) * ci_per_slice >= C ||
      static_cast<int64_t>(slices) * ci_per_slice < C ||
      kCK * s.img * (th + 2) * s.pw > kPatchFloats)
    return cudaErrorInvalidValue;
  s.tiles_h = H / th;
  s.tiles_w = W / tw;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!smem_ready[dev]) {
    err = cudaFuncSetAttribute(sd_conv3x3_igemm, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    smem_ready[dev] = true;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(N / s.img * s.tiles_h * s.tiles_w, (K + kBN - 1) / kBN, slices);
  sd_conv3x3_igemm<<<grid, kThreads, kSmemBytes, st>>>(x, weight, ws, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total4 = static_cast<int64_t>(N) * K * H * W / 4;
  const int64_t blocks = (total4 + kThreads - 1) / kThreads;
  sd_conv3x3_reduce<<<static_cast<unsigned>(blocks < (1 << 20) ? blocks : (1 << 20)), kThreads,
                      0, st>>>(reinterpret_cast<const float4*>(ws), bias,
                               reinterpret_cast<float4*>(y), slices, total4, H * W / 4, K);
  return cudaGetLastError();
}
