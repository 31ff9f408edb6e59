// AR recurrence for Hopper (sm_90a): B independent order-p recurrences.
//
// Replaces the Pallas TPU kernel `_kernel` launched by
// `ar_extrapolate_pallas` in audio_inpainting_tpu/ops/pallas/ar_scan.py.
// For every row b and step t:
//
//     pred_t  = ((<state_t, w_b> + bias_b) + noise_std_b * eps[b, t]) * gain_b
//     state_{t+1} = state_t shifted left one sample, pred_t appended
//
// with the same operation order as the TPU kernel and as the plain torch
// loop `ar_extrapolate_ref` (audio_inpainting_torch/ops/ar_scan.py).
//
// What bounds it on an H100. The roofline bound is tiny: 2*B*p*steps FLOPs
// against 67 TFLOP/s of fp32 CUDA-core peak, and 4*B*steps bytes of eps in
// + 4*B*steps bytes out + 4*B*(2p+3) bytes of parameters against
// 3.35 TB/s. Bytes are the larger of the two at every shape the restore
// path runs (for p = 30: 8 bytes against 60 FLOPs per step and row, and
// the card does ~20 FLOPs per byte). Neither is the real floor: each step
// depends on the previous one, so a row takes at least steps x the latency
// of one dependent step (a shared-memory read, the dot product's shuffle
// reduction, the update and a shared-memory write: some hundreds of
// cycles). The card only hides that latency by running many rows at once.
//
// Design against that floor:
//   - one warp per row, four rows per block, so the facade's ~700 rows run
//     as ~700 independent chains spread over all SMs;
//   - the state is a ring buffer of p floats in shared memory with a head
//     index: a step overwrites the oldest slot with pred and moves the
//     head, so nothing shifts;
//   - w sits in registers, ceil(p/32) values per lane, for p <= 128
//     (K = 1..4). Larger p keeps w beside the ring in shared memory (K = 0);
//   - the dot product is per-lane partial sums and a __shfl_xor_sync
//     butterfly, which leaves the sum in every lane, so no broadcast;
//   - eps is read coalesced, 32 steps at a time, one per lane, and handed
//     out with __shfl_sync; the outputs collect one per lane and leave as
//     one coalesced 128-byte store every 32 steps;
//   - the ragged tail of `steps` and the last block's missing rows are
//     masked.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr size_t kMaxSmemPerBlock = 232448;  // 227 KB opt-in limit on sm_90
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_xor_sync(kFullMask, v, offset);
  }
  return v;
}

// K > 0: lane l holds w[l + 32 k] for k < K in registers (p <= 32 K).
// K == 0: w lives in shared memory right after the ring.
template <int K>
__global__ void ar_scan_kernel(const float* __restrict__ state0,
                               const float* __restrict__ w,
                               const float* __restrict__ bias,
                               const float* __restrict__ noise_std,
                               const float* __restrict__ gain,
                               const float* __restrict__ eps,
                               float* __restrict__ out, int B, int p,
                               int steps) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= B) return;  // the whole warp leaves together

  float* ring = smem + static_cast<size_t>(warp) * p * (K == 0 ? 2 : 1);
  const float* w_row = w + static_cast<size_t>(row) * p;
  const float* s_row = state0 + static_cast<size_t>(row) * p;
  for (int j = lane; j < p; j += 32) {
    ring[j] = s_row[j];
    if constexpr (K == 0) ring[p + j] = w_row[j];
  }
  float w_reg[K > 0 ? K : 1];
  if constexpr (K > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = lane + 32 * k;
      w_reg[k] = j < p ? w_row[j] : 0.0f;
    }
  }
  __syncwarp();

  const float b = bias[row];
  const float s = noise_std[row];
  const float g = gain[row];
  const float* e_row = eps + static_cast<size_t>(row) * steps;
  float* o_row = out + static_cast<size_t>(row) * steps;
  int head = 0;  // ring[head] is the oldest sample, state[0]

  for (int t0 = 0; t0 < steps; t0 += 32) {
    const int n = min(32, steps - t0);
    const float e_lane = lane < n ? e_row[t0 + lane] : 0.0f;
    float o_lane = 0.0f;
    for (int i = 0; i < n; ++i) {
      // state[j] = ring[(head + j) mod p]
      float part = 0.0f;
      if constexpr (K > 0) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int j = lane + 32 * k;
          if (j < p) {
            int idx = head + j;
            if (idx >= p) idx -= p;
            part = fmaf(ring[idx], w_reg[k], part);
          }
        }
      } else {
        for (int j = lane; j < p; j += 32) {
          int idx = head + j;
          if (idx >= p) idx -= p;
          part = fmaf(ring[idx], ring[p + j], part);
        }
      }
      const float dot = warp_sum(part);
      const float e = __shfl_sync(kFullMask, e_lane, i);
      // ((dot + b) + s * e) * g, rounded step by step as the TPU kernel
      // does: the _rn intrinsics keep nvcc from contracting into an FMA
      const float pred =
          __fmul_rn(__fadd_rn(__fadd_rn(dot, b), __fmul_rn(s, e)), g);
      if (lane == i) o_lane = pred;
      __syncwarp();  // every lane has read ring[head] before it is replaced
      if (lane == 0) ring[head] = pred;
      head = head + 1 == p ? 0 : head + 1;
      __syncwarp();  // the new sample is visible to the whole warp
    }
    if (lane < n) o_row[t0 + lane] = o_lane;
  }
}

template <int K>
cudaError_t launch(const float* state0, const float* w, const float* bias,
                   const float* noise_std, const float* gain,
                   const float* eps, float* out, int B, int p, int steps,
                   int warps, size_t smem, cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        ar_scan_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (B + warps - 1) / warps;
  ar_scan_kernel<K><<<blocks, warps * 32, smem, stream>>>(
      state0, w, bias, noise_std, gain, eps, out, B, p, steps);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. All pointers are device pointers to
// contiguous float32: state0, w (B, p); bias, noise_std, gain (B,);
// eps, out (B, steps). Launches on `stream` and does not synchronise.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int ar_scan_launch(const float* state0, const float* w,
                              const float* bias, const float* noise_std,
                              const float* gain, const float* eps,
                              float* out, int B, int p, int steps,
                              void* stream) {
  if (B < 1 || p < 1 || steps < 1) return cudaErrorInvalidValue;
  const int k = (p + 31) / 32;
  const size_t per_warp = static_cast<size_t>(p) * sizeof(float) * (k <= 4 ? 1 : 2);
  int warps = kWarpsPerBlock;
  while (warps > 1 && warps * per_warp > kMaxSmemPerBlock) --warps;
  if (warps * per_warp > kMaxSmemPerBlock) return cudaErrorInvalidValue;
  const size_t smem = warps * per_warp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1:
      return launch<1>(state0, w, bias, noise_std, gain, eps, out, B, p, steps, warps, smem, st);
    case 2:
      return launch<2>(state0, w, bias, noise_std, gain, eps, out, B, p, steps, warps, smem, st);
    case 3:
      return launch<3>(state0, w, bias, noise_std, gain, eps, out, B, p, steps, warps, smem, st);
    case 4:
      return launch<4>(state0, w, bias, noise_std, gain, eps, out, B, p, steps, warps, smem, st);
    default:
      return launch<0>(state0, w, bias, noise_std, gain, eps, out, B, p, steps, warps, smem, st);
  }
}
