// AR recurrence for Hopper (sm_90a) as a blocked scan: B independent
// order-p recurrences, L outputs per dependent update.
//
// Replaces the Pallas TPU kernel `_kernel` launched by
// `ar_extrapolate_pallas` (audio_inpainting_tpu/ops/pallas/ar_scan.py:39).
// For every row and step t it computes the same function:
//
//     pred_t  = ((<state_t, w> + bias) + noise_std * eps[t]) * gain
//     state_{t+1} = state_t shifted left one sample, pred_t appended
//
// The gain sits inside the recurrence, as in the TPU kernel: the gained
// prediction is fed back. With w' = gain * w and u_t = gain * (bias +
// noise_std * eps[t]) that is y_t = <w', state_t> + u_t, a linear
// recurrence. So a block of L outputs is an affine map of the block's
// entry state s (p samples, oldest first) and its noise:
//
//     y = Gt^T s + T(h) u
//
// h is the impulse response (h_0 = 1, h_n = sum_{i=1..min(n,p)}
// w'_{p-i} h_{n-i}), T(h) the lower-triangular Toeplitz matrix of h, and
// G[j][c] = sum_{m <= min(j,c)} h_{j-m} w'_{c-m} the response of y_j to
// s_c. The next entry state is the last p samples of y (L >= p). The
// plain torch version of this algebra is `ar_extrapolate_blocked_ref` in
// audio_inpainting_torch/ops/ar_scan.py.
//
// What bounds it on an H100. The roofline bound is tiny: bytes (eps in,
// out, parameters) over 3.35 TB/s at the restore path's shapes. The real
// floor is the chain: ceil(steps / L) dependent block updates per row,
// each a p-long matvec G s read from shared memory and a barrier.
// Computed one sample at a time the chain was `steps` long.
//
// Design:
//   - L = 32 * ceil(p / 32) threads per row, thread j owns y_j of every
//     block; rows with L < 128 share a block of threads (four rows of
//     order <= 32 in one block of 128 threads).
//   - Set-up per row: warp 0 of the row solves for h 32 samples at a
//     time (the terms reaching back before the chunk as independent dot
//     products, then a 31-step forward substitution through shuffles),
//     then every thread walks diagonals j - c of G, whose entries are
//     running sums of h_j w'_c. G is kept transposed with a row stride of
//     L + 1, so both the diagonal walk and the main loop's reads are free
//     of bank conflicts. This bounds the order: G must fit in the 227 KB
//     of shared memory, so p <= 224.
//   - Main loop, one block of L outputs per iteration: thread j sums
//     h_{j-m} u_m over m <= j (the noise part, which does not depend on
//     the chain; a zero prefix in front of h masks m > j) and G[j][c] s_c
//     over c, the state and noise read as float4 broadcasts, into four
//     accumulators. The entry state and the noise are double-buffered,
//     so one __syncthreads per block suffices.
//   - eps streams in through cp.async into a ring of kStages blocks in
//     shared memory, kStages - 1 blocks ahead of the chain, so a block
//     never waits on device memory; each block's outputs leave as
//     coalesced stores.
//   - The ragged last block and the idle rows of the last block of
//     threads are masked; idle rows still meet every barrier.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kRowThreads = 128;  // rows with L < 128 share a block of threads
constexpr int kMaxOrder = 224;    // G (p x (L + 1) floats) within 227 KB
constexpr int kStages = 8;        // blocks of eps in flight ahead of the chain
constexpr size_t kMaxSmemPerBlock = 232448;  // 227 KB opt-in limit on sm_90
constexpr size_t kDefaultSmem = 48 * 1024;

// One row's shared memory, in floats. Every part starts on a 16-byte
// boundary, for the float4 reads of the state and the noise.
struct Layout {
  int p4, L, ld;         // order rounded up to 4, block length, G's stride
  int g, h, s, u, w, e, total;
};

__host__ __device__ inline Layout row_layout(int p) {
  Layout o;
  o.p4 = (p + 3) & ~3;
  o.L = 32 * ((p + 31) / 32);
  o.ld = o.L + 1;
  o.g = 0;                               // Gt[c * ld + j], c < p4
  o.h = (o.p4 * o.ld + 3) & ~3;          // L zeros, then h_0 .. h_{L-1}
  o.s = o.h + 2 * o.L;                   // two entry states of p4
  o.u = o.s + 2 * o.p4;                  // two blocks of noise u
  o.w = o.u + 2 * o.L;                   // w' = gain * w
  o.e = o.w + o.p4;                      // kStages blocks of raw eps
  o.total = o.e + kStages * o.L;
  return o;
}

// 4-byte asynchronous copy into shared memory; zero-filled when !valid
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// at most 224 threads: one row of L <= 224, or rows of L < 128 sharing 128
__global__ void __launch_bounds__(256)
ar_scan_blocked(const float* __restrict__ state0, const float* __restrict__ w,
                const float* __restrict__ bias,
                const float* __restrict__ noise_std,
                const float* __restrict__ gain, const float* __restrict__ eps,
                float* __restrict__ out, int B, int p, int steps) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay = row_layout(p);
  const int L = lay.L, ld = lay.ld, p4 = lay.p4;
  const int group = threadIdx.x / L;
  const int j = threadIdx.x - group * L;
  const int row_raw = blockIdx.x * (blockDim.x / L) + group;
  const bool active = row_raw < B;
  const int row = active ? row_raw : B - 1;

  float* base = smem + static_cast<size_t>(group) * lay.total;
  float* Gt = base + lay.g;
  float* H = base + lay.h;  // H[L + i] = h_i, H[i] = 0 for i < L
  float* S = base + lay.s;
  float* U = base + lay.u;
  float* Wp = base + lay.w;
  float* E = base + lay.e;

  const float g = gain[row];
  const float b = bias[row];
  const float sd = noise_std[row];
  const float* e_row = eps + static_cast<size_t>(row) * steps;
  float* o_row = out + static_cast<size_t>(row) * steps;

  // eps of block k goes to E[k % kStages]: each thread copies, and later
  // reads, only its own sample j, so no barrier guards the ring
  auto fetch = [&](int k) {
    const int t = k * L + j;
    cp_async_f32(E + (k % kStages) * L + j, e_row + (t < steps ? t : 0), t < steps);
  };
  for (int k = 0; k < kStages - 1; ++k) fetch(k);

  // w', the entry state and the zero pads (state past p, G's rows past p,
  // h's prefix)
  for (int c = j; c < p4; c += L) {
    const bool in = c < p;
    Wp[c] = in ? g * w[static_cast<size_t>(row) * p + c] : 0.0f;
    S[c] = in ? state0[static_cast<size_t>(row) * p + c] : 0.0f;
    S[p4 + c] = 0.0f;
  }
  for (int i = j; i < (p4 - p) * ld; i += L) Gt[p * ld + i] = 0.0f;
  H[j] = 0.0f;
  __syncthreads();

  // The impulse response, by warp 0 of the row, 32 samples at a time:
  // h_n = sum_{i=1..min(n,p)} v_i h_{n-i} with v_i = w'_{p-i}. Lane j
  // first sums the terms that reach back before its chunk, then the
  // chunk is solved forward: at step k lane k holds h_{q+k}, broadcasts
  // it, and the lanes above add v_{j-k} h_{q+k}.
  if (j < 32) {
    float* h = H + L;
    float v[32];  // v[k] = v_{j-k}, 0 outside 1..p
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int i = j - k;
      v[k] = i >= 1 && i <= p ? Wp[p - i] : 0.0f;
    }
    for (int q = 0; q < L; q += 32) {
      const int n = q + j;
      float acc = n == 0 ? 1.0f : 0.0f;
      const int top = min(n, p);
      for (int i = j + 1; i <= top; ++i) acc = fmaf(Wp[p - i], h[n - i], acc);
#pragma unroll
      for (int k = 0; k < 31; ++k) {
        const float hk = __shfl_sync(kFullMask, acc, k);
        if (j > k) acc = fmaf(v[k], hk, acc);
      }
      h[n] = acc;
      __syncwarp();
    }
  }
  __syncthreads();

  // G along its diagonals j - c = delta: G[j][c] = G[j-1][c-1] + h_j w'_c
  for (int t = j; t < L + p - 1; t += L) {
    const int delta = t - (p - 1);
    int jj = delta > 0 ? delta : 0;
    int c = jj - delta;
    float acc = 0.0f;
    for (; jj < L && c < p; ++jj, ++c) {
      acc = fmaf(H[L + jj], Wp[c], acc);
      Gt[c * ld + jj] = acc;
    }
  }
  cp_async_wait<kStages - 2>();  // block 0's eps has landed
  U[j] = g * (b + sd * E[j]);
  __syncthreads();

  // m runs to the end of this thread's warp: h_{j-m} is 0 past m = j
  const int m_end = (j / 32 + 1) * 32;
  const int nblocks = (steps + L - 1) / L;
  for (int k = 0; k < nblocks; ++k) {
    const int t0 = k * L;
    const int cur = k & 1;
    const float* Sc = S + cur * p4;
    const float* Uc = U + cur * L;
    fetch(k + kStages - 1);

    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    const float* hj = H + L + j;
#pragma unroll 4
    for (int m = 0; m < m_end; m += 4) {
      const float4 u4 = *reinterpret_cast<const float4*>(Uc + m);
      a0 = fmaf(hj[-m], u4.x, a0);
      a1 = fmaf(hj[-m - 1], u4.y, a1);
      a2 = fmaf(hj[-m - 2], u4.z, a2);
      a3 = fmaf(hj[-m - 3], u4.w, a3);
    }
    const float* gj = Gt + j;
#pragma unroll 4
    for (int c = 0; c < p4; c += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(Sc + c);
      a0 = fmaf(gj[c * ld], s4.x, a0);
      a1 = fmaf(gj[(c + 1) * ld], s4.y, a1);
      a2 = fmaf(gj[(c + 2) * ld], s4.z, a2);
      a3 = fmaf(gj[(c + 3) * ld], s4.w, a3);
    }
    const float y = (a0 + a1) + (a2 + a3);

    if (active && t0 + j < steps) o_row[t0 + j] = y;
    if (j >= L - p) S[(cur ^ 1) * p4 + j - (L - p)] = y;
    cp_async_wait<kStages - 2>();  // block k + 1's eps has landed
    U[(cur ^ 1) * L + j] = g * (b + sd * E[((k + 1) % kStages) * L + j]);
    __syncthreads();
  }
  cp_async_wait<0>();
}

}  // namespace

// Plain C entry point for ctypes. All pointers are device pointers to
// contiguous float32: state0, w (B, p); bias, noise_std, gain (B,);
// eps, out (B, steps). Launches on `stream` and does not synchronise.
// Returns the cudaError_t of the launch (0 on success);
// cudaErrorInvalidValue for an order above 224.
extern "C" int ar_scan_launch(const float* state0, const float* w,
                              const float* bias, const float* noise_std,
                              const float* gain, const float* eps,
                              float* out, int B, int p, int steps,
                              void* stream) {
  if (B < 1 || p < 1 || p > kMaxOrder || steps < 1) return cudaErrorInvalidValue;
  const Layout lay = row_layout(p);
  const int rows = lay.L < kRowThreads ? kRowThreads / lay.L : 1;
  const size_t smem = static_cast<size_t>(rows) * lay.total * sizeof(float);
  if (smem > kMaxSmemPerBlock) return cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        ar_scan_blocked, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (B + rows - 1) / rows;
  ar_scan_blocked<<<blocks, rows * lay.L, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      state0, w, bias, noise_std, gain, eps, out, B, p, steps);
  return cudaGetLastError();
}
