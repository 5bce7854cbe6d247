// The windowed gather shared by csrc/window.cu (S8) and csrc/wbfm_proto.cu
// (S4's dma_only stage): over the stream xc = [carry | x] of each row,
//
//   out[c, w * ow + j] = xc[c, w * step + j],   0 <= j < ow, 0 <= w < nwin,
//
// with xc[c, p] = carry[c, p] for p < head and x[c, p - head] after it.
// x is float32 [rows, xw] and carry float32 [rows, head], rows contiguous;
// out float32 [rows, nwin * ow].  A plain coalesced copy: a thread takes
// four consecutive outputs by float4 where head, step, ow and xw are
// multiples of four and the three pointers 16-byte aligned (a group of
// four then never straddles the carry's end or a window's), else one; a
// grid-stride loop of CTAs of kGatherThreads.  Bytes bound it: each
// output float is read once (the L2 serves a window's overlap with the
// next) and written once.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace lr_window {

constexpr int kGatherThreads = 256;

template <int V>
__global__ void __launch_bounds__(kGatherThreads)
    gather_kernel(const float* __restrict__ x, int64_t xw,
                  const float* __restrict__ carry, int64_t head, int64_t step,
                  int64_t ow, int64_t nwin, int64_t rows,
                  float* __restrict__ out) {
  const int64_t per_row = nwin * ow;
  const int64_t groups = rows * per_row / V;
  for (int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       g < groups; g += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t o = g * V;
    const int64_t row = o / per_row, rem = o - row * per_row;
    const int64_t w = rem / ow, j = rem - w * ow;
    const int64_t p = w * step + j;
    const float* src = p < head ? carry + row * head + p
                                : x + row * xw + (p - head);
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(out + o) =
          __ldg(reinterpret_cast<const float4*>(src));
    } else {
      out[o] = __ldg(src);
    }
  }
}

inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 132;
  return n > 0 ? n : 132;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Launch the gather on `stream`; returns the cudaError_t of the launch.
inline int launch_gather(const float* x, int64_t xw, const float* carry,
                         int64_t head, int64_t step, int64_t ow,
                         int64_t nwin, int64_t rows, float* out,
                         cudaStream_t stream) {
  if (rows < 0 || xw < 0 || head < 0 || step < 0 || ow < 0 || nwin < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = rows * nwin * ow;
  if (total == 0) return 0;
  const bool vec = head % 4 == 0 && step % 4 == 0 && ow % 4 == 0 &&
                   xw % 4 == 0 && aligned16(x) && aligned16(out) &&
                   (head == 0 || aligned16(carry));
  const int64_t groups = total / (vec ? 4 : 1);
  int64_t blocks = (groups + kGatherThreads - 1) / kGatherThreads;
  const int64_t cap = static_cast<int64_t>(sm_count()) * 16;
  if (blocks > cap) blocks = cap;
  if (vec)
    gather_kernel<4><<<static_cast<unsigned>(blocks), kGatherThreads, 0,
                       stream>>>(x, xw, carry, head, step, ow, nwin, rows,
                                 out);
  else
    gather_kernel<1><<<static_cast<unsigned>(blocks), kGatherThreads, 0,
                       stream>>>(x, xw, carry, head, step, ow, nwin, rows,
                                 out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lr_window
