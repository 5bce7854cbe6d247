// Frequency discriminator + decimating FIR for the WBFM mono receiver, one
// pass over the samples, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K1  luaradio_tpu/ops/wbfm_pallas.py make_wbfm_pallas / _kernel
//       (interleaved float32 I/Q, the flagship step's wire)
//   K2  luaradio_tpu/ops/wbfm_pallas.py make_disc_fir_pallas / _planar_kernel
//       (re/im planes of a graph's complex stream)
//
// Both compute, per channel c, over the window w = [carry (K samples) | x
// (T samples)]:
//   m[i] = atan2(Im, Re)(w[i+1] * conj(w[i])) * inv_gain,   0 <= i < K-1+T
//   y[j] = sum_{q<K} h[K-1-q] * m[j*D + q],                 0 <= j < T/D
// i.e. the discriminator followed by the decimating FIR (deemphasis folded
// into h), with m kept in shared memory: one read of each sample and one
// write of each output reach device memory.
//
// What bounds it on an H100: per sample 8 bytes in, per output 4 bytes out,
// and 2K flops per output (K = 640 on the flagship step: ~1.3 flops per
// byte in, so bytes and fp32 FMAs bind about equally).  Design:
//   * one block per (output tile of kTileOut outputs, channel); blocks are
//     independent, so any T with T % D == 0 runs in the kernel (the tile at
//     the end is masked), unlike the TPU kernel's whole-tile grid;
//   * phase 1 forms m for the tile plus its K-1 halo into shared memory,
//     stored polyphase (D rows, row = m index mod D) so that phase 2 reads
//     consecutive addresses across a warp for any D; rows are padded by one
//     float every kPerThread floats so the stride kPerThread+1 per thread
//     is free of bank conflicts;
//   * phase 2: each thread owns kPerThread consecutive outputs and slides a
//     register window along each polyphase row, so one shared load feeds
//     kPerThread FP32 FMAs; taps sit reversed in shared memory and are read
//     as warp-wide broadcasts.
//   * The conj-multiply uses __fmul_rn/__fadd_rn/__fsub_rn: an FMA
//     contraction there changes the last ulp of Re/Im, and near the +-pi
//     branch cut that flips m by a full turn (wbfm_pallas.py:27-29).
//     atan2f keeps the IEEE signed-zero rules.
// A plain first version: cp.async/TMA double-buffering and a tensor-core
// FIR are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kTileOut = kThreads * kPerThread;

// Complex samples of one stream: re at re[c*row + i*step], im likewise.
struct Stream {
  const float* re;
  const float* im;
  int64_t row;
  int64_t step;
};

template <bool kInterleaved>
__device__ __forceinline__ float2 load(const Stream& s, int c, int64_t i) {
  if (kInterleaved) {
    // re/im adjacent, step 2: one 8-byte load
    return reinterpret_cast<const float2*>(s.re + c * s.row)[i];
  }
  const int64_t o = c * s.row + i * s.step;
  return make_float2(s.re[o], s.im[o]);
}

template <bool kInterleaved>
__device__ __forceinline__ float2 window_sample(const Stream& carry,
                                                const Stream& x, int c,
                                                int64_t i, int k) {
  return i < k ? load<kInterleaved>(carry, c, i)
               : load<kInterleaved>(x, c, i - k);
}

__host__ __device__ inline int padded(int idx) {
  return idx + idx / kPerThread;
}

template <bool kInterleaved>
__global__ void __launch_bounds__(kThreads)
disc_fir_kernel(Stream carry, Stream x, const float* __restrict__ taps,
                float* __restrict__ out, int t, int k, int d, float inv_gain,
                int row_len) {
  extern __shared__ float smem[];
  float* hr = smem;      // hr[q] = h[K-1-q]
  float* ms = smem + k;  // d polyphase rows of row_len floats

  const int c = blockIdx.y;
  const int n_out = t / d;
  const int j0 = blockIdx.x * kTileOut;
  const int64_t s0 = static_cast<int64_t>(j0) * d;
  const int64_t m_total = static_cast<int64_t>(k) - 1 + t;
  const int n_m = kTileOut * d - d + k;

  for (int q = threadIdx.x; q < k; q += kThreads) hr[q] = taps[k - 1 - q];

  // phase 1: discriminator into shared memory (local index i -> row i % d,
  // column i / d), tracked incrementally to keep divisions out of the loop
  const int step_col = kThreads / d, step_ph = kThreads % d;
  int ph = threadIdx.x % d, col = threadIdx.x / d;
  for (int i = threadIdx.x; i < n_m; i += kThreads) {
    const int64_t g = s0 + i;
    float m = 0.f;
    if (g < m_total) {
      const float2 p = window_sample<kInterleaved>(carry, x, c, g, k);
      const float2 q = window_sample<kInterleaved>(carry, x, c, g + 1, k);
      const float tre = __fadd_rn(__fmul_rn(q.x, p.x), __fmul_rn(q.y, p.y));
      const float tim = __fsub_rn(__fmul_rn(q.y, p.x), __fmul_rn(q.x, p.y));
      m = atan2f(tim, tre) * inv_gain;
    }
    ms[ph * row_len + padded(col)] = m;
    col += step_col;
    ph += step_ph;
    if (ph >= d) {
      ph -= d;
      ++col;
    }
  }
  __syncthreads();

  // phase 2: y[jl] = sum_q hr[q] * m[jl*d + q]; with q = r*d + ph the m
  // value sits in row ph, column jl + r
  const int jl0 = threadIdx.x * kPerThread;
  float acc[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) acc[u] = 0.f;
  for (int p = 0; p < d; ++p) {
    const float* mrow = ms + p * row_len;
    float win[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) win[u] = mrow[padded(jl0 + u)];
    int next = jl0 + kPerThread;
    for (int q = p; q < k; q += d) {
      const float h = hr[q];
#pragma unroll
      for (int u = 0; u < kPerThread; ++u) acc[u] = fmaf(h, win[u], acc[u]);
#pragma unroll
      for (int u = 0; u + 1 < kPerThread; ++u) win[u] = win[u + 1];
      win[kPerThread - 1] = mrow[padded(next++)];
    }
  }
  float* orow = out + static_cast<int64_t>(c) * n_out;
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int j = j0 + jl0 + u;
    if (j < n_out) orow[j] = acc[u];
  }
}

template <bool kInterleaved>
int launch(const Stream& carry, const Stream& x, const float* taps,
           float* out, int c, int t, int k, int d, float inv_gain,
           cudaStream_t stream) {
  if (c <= 0 || t <= 0 || k <= 0 || d <= 0 || t % d || c > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // columns read per row: kTileOut outputs + (k-1)/d halo + one look-ahead
  const int cols = kTileOut + (k - 1) / d + 2;
  const int row_len = padded(cols) + 1;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(k) + static_cast<size_t>(d) * row_len);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        disc_fir_kernel<kInterleaved>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int n_out = t / d;
  dim3 grid((n_out + kTileOut - 1) / kTileOut, c);
  disc_fir_kernel<kInterleaved><<<grid, kThreads, smem, stream>>>(
      carry, x, taps, out, t, k, d, inv_gain, row_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1.  carry: complex64 [C, K] (interleaved float pairs), x: float32
// [C, 2T] interleaved I/Q, taps: float32 [K], out: float32 [C, T/D].
// Returns the cudaError_t of the launch.
int lr_wbfm_mono(const void* carry, const void* x, const void* taps,
                 void* out, int c, int t, int k, int d, float inv_gain,
                 void* stream) {
  const float* cf = static_cast<const float*>(carry);
  const float* xf = static_cast<const float*>(x);
  Stream cs{cf, cf + 1, 2 * static_cast<int64_t>(k), 2};
  Stream xs{xf, xf + 1, 2 * static_cast<int64_t>(t), 2};
  return launch<true>(cs, xs, static_cast<const float*>(taps),
                      static_cast<float*>(out), c, t, k, d, inv_gain,
                      static_cast<cudaStream_t>(stream));
}

// K2.  Planes given by base pointer, row stride and element step (in
// floats): carry re/im [C, K], x re/im [C, T]; out float32 [C, T/D].
int lr_disc_fir(const void* carry_re, const void* carry_im,
                long long carry_row, long long carry_step, const void* re,
                const void* im, long long x_row, long long x_step,
                const void* taps, void* out, int c, int t, int k, int d,
                float inv_gain, void* stream) {
  Stream cs{static_cast<const float*>(carry_re),
            static_cast<const float*>(carry_im), carry_row, carry_step};
  Stream xs{static_cast<const float*>(re), static_cast<const float*>(im),
            x_row, x_step};
  return launch<false>(cs, xs, static_cast<const float*>(taps),
                       static_cast<float*>(out), c, t, k, d, inv_gain,
                       static_cast<cudaStream_t>(stream));
}

const char* lr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
