// Measurement probe: mma.sync throughput and latency (TF32 m16n8k8 and
// BF16 m16n8k16) and atan2f throughput and latency on one card, the
// numbers csrc/wbfm.cu's design rests on.  Not part of the package.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o hopper_probe \
//       scratch/hopper_probe.cu && ./hopper_probe
//
// Rates are per SM per clock at the card's rated clock
// (cudaDevAttrClockRate).
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
template <int kChains>
__global__ void tf32_tp(int iters, float* sink) {
  float acc[kChains][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u}, b0 = threadIdx.x ^ 5u, b1 = 11u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0; for (int c = 0; c < kChains; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int kChains>
__global__ void bf16_tp(int iters, float* sink) {
  float acc[kChains][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u}, b0 = threadIdx.x ^ 5u, b1 = 11u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  float s = 0; for (int c = 0; c < kChains; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void atan2_tp(int iters, float* sink) {
  float x = threadIdx.x * 0.001f + 0.5f, y = 0.25f, s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  for (int i = 0; i < iters; ++i) {
    s0 += atan2f(y + s0 * 1e-9f, x); s1 += atan2f(x, y + s1 * 1e-9f);
    s2 += atan2f(-y - s2 * 1e-9f, x); s3 += atan2f(-x, y + s3 * 1e-9f);
  }
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s0 + s1 + s2 + s3;
}
template <typename K>
float run(K k, int blocks, int threads, int iters, float* sink) {
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  k<<<blocks, threads>>>(10, sink);
  cudaEventRecord(a); k<<<blocks, threads>>>(iters, sink); cudaEventRecord(b); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b); return ms;
}
int main() {
  float* sink; cudaMalloc(&sink, 132 * 1024 * 4 * 8);
  int clk; cudaDeviceGetAttribute(&clk, cudaDevAttrClockRate, 0);
  printf("clock %d kHz\n", clk);
  const int iters = 4096;
  for (int wps : {4, 8, 16, 32}) {
    int blocks = 132, threads = wps * 32;
    float ms = run(tf32_tp<4>, blocks, threads, iters, sink);
    double mma = double(blocks) * wps * iters * 4;
    printf("tf32 m16n8k8, %d warps/SM, 4 chains: %.3f ms, %.3f mma/cycle/SM at %.0f MHz-equivalent (%.1f TFLOPS)\n", wps, ms, mma / 132 / (ms * 1e-3 * clk * 1e3), clk / 1e3, mma * 2048 / (ms * 1e-3) / 1e12);
    ms = run(bf16_tp<4>, blocks, threads, iters, sink);
    printf("bf16 m16n8k16, %d warps/SM, 4 chains: %.3f ms, %.3f mma/cycle/SM (%.1f TFLOPS)\n", wps, ms, mma / 132 / (ms * 1e-3 * clk * 1e3), mma * 4096 / (ms * 1e-3) / 1e12);
  }
  float ms = run(tf32_tp<1>, 1, 32, iters, sink);
  printf("tf32 latency: %.1f cycles per dependent mma\n", ms * 1e-3 * clk * 1e3 / iters);
  ms = run(bf16_tp<1>, 1, 32, iters, sink);
  printf("bf16 latency: %.1f cycles per dependent mma\n", ms * 1e-3 * clk * 1e3 / iters);
  for (int wps : {8, 16, 32}) {
    ms = run(atan2_tp, 132, wps * 32, iters, sink);
    double n = 132.0 * wps * 32 * iters * 4;
    printf("atan2f, %d warps/SM: %.3f ms, %.2f G/s, %.2f cycles per warp-atan2 per SM\n", wps, ms, n / (ms * 1e-3) / 1e9, (ms * 1e-3 * clk * 1e3) * 132 / (n / 32));
  }
  ms = run(atan2_tp, 1, 32, iters, sink);
  printf("atan2f latency (4 indep chains, 1 warp): %.1f cycles per iteration\n", ms * 1e-3 * clk * 1e3 / iters);
  return 0;
}
