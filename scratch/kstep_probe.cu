// Measurement probe: the cycles one k-step of csrc/wbfm.cu's FIR costs a
// warp in isolation (two ldmatrix.x4, four tap loads, six TF32
// mma.sync, the 16-wide warp tile's addressing) and without each part in
// turn, at 1, 4 and 8 warps a SM.  Not part of the package.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o kstep_probe \
//       scratch/kstep_probe.cu && ./kstep_probe
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
__device__ __forceinline__ uint32_t sa(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
__device__ __forceinline__ void ldsm(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n" : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// kVar: 0 full (2 ldsm + 4 lds + 6 mma), 1 no ldsm, 2 no B lds, 3 no mma, 4 ldsm only dependent-free
template <int kVar>
__global__ void kstep(int steps, long long* cyc, float* sink) {
  extern __shared__ __align__(16) float sm[];
  for (int i = threadIdx.x; i < 16384; i += blockDim.x) sm[i] = (i % 97) * 0.01f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = 16 * a_row + ((lane >> 4) << 2);
  const int b_off = 16 + (lane & 3) - (lane >> 2);
  const uint32_t hb = sa(sm), lb = sa(sm + 4096);
  const float* g = sm + 8192;
  float acc[6][4] = {};
  uint32_t ah[4] = {1, 2, 3, 4}, al[4] = {5, 6, 7, 8};
  uint32_t b0 = 1, b1 = 2, b2 = 3, b3 = 4;
  long long t0 = clock64();
  for (int k = 0; k < steps; ++k) {
    int col = (a_col + 8 * (k & 15)) & 1023;
    col ^= ((col >> 4) & 7) << 2;
    if (kVar != 1) { ldsm(hb + 4 * col, ah); ldsm(lb + 4 * col, al); }
    if (kVar != 2) {
      const int bi = b_off + 8 * (k & 7);
      b0 = __float_as_uint(g[bi]); b1 = __float_as_uint(g[bi + 4]);
      b2 = __float_as_uint(g[bi + 100]); b3 = __float_as_uint(g[bi + 104]);
    }
    if (kVar != 3) {
      mma(acc[0], al, b0, b1); mma(acc[1], ah, b2, b3); mma(acc[2], ah, b0, b1);
      mma(acc[3], al, b2, b3); mma(acc[4], ah, b0, b3); mma(acc[5], ah, b2, b1);
    } else {
      acc[0][0] += __uint_as_float(ah[0] ^ al[1] ^ b0 ^ b3);
    }
  }
  long long t1 = clock64();
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
  float s = 0; for (int i = 0; i < 6; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int V> void run(int threads, long long* cyc, float* sink, const char* name) {
  cudaFuncSetAttribute(kstep<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
  const int steps = 4096;
  kstep<V><<<132, threads, 65536>>>(steps, cyc, sink);
  cudaDeviceSynchronize();
  long long h[132]; cudaMemcpy(h, cyc, sizeof(h), cudaMemcpyDeviceToHost);
  double s = 0; for (int i = 0; i < 132; ++i) s += h[i];
  printf("%-28s %4d threads/SM: %.1f cycles per k-step per warp (err %s)\n", name, threads, s / 132 / steps, cudaGetErrorString(cudaGetLastError()));
}
int main() {
  long long* cyc; float* sink; cudaMalloc(&cyc, 132 * 8); cudaMalloc(&sink, 132 * 1024 * 4);
  for (int th : {32, 128, 256}) {
    run<0>(th, cyc, sink, "full k-step");
    run<1>(th, cyc, sink, "no ldmatrix");
    run<2>(th, cyc, sink, "no B lds");
    run<3>(th, cyc, sink, "no mma");
  }
  return 0;
}
