// The loop-carried chain of K3's walker (csrc/pll.cu step) alone, in one
// thread: d = (theta - phi_l) - inc -> I2F -> FMUL -> FADD -> F2I -> inc,
// with phi_l += inc and the fk update (FMUL, FADD, two FMNMX) beside it,
// theta drawn by an LCG off the chain.  csrc/pll.cu chain_probe_kernel
// runs the chain as written before (phi_l += inc, then theta - phi_l: two
// integer operations after the F2I); this one has the walker's single
// subtraction.  Built and run by scratch/pll_ab.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//        -o libpll_chain_probe.so scratch/pll_chain_probe.cu
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t sub_u32(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("sub.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__global__ void walker_chain_probe(int steps, float k_ab, float k_b,
                                   float fmin_k, float fmax_k, float fk,
                                   uint32_t seed, long long* cycles,
                                   uint32_t* sink) {
  uint32_t phi_l = 0, inc = 0, th = seed;
  const long long t0 = clock64();
#pragma unroll 4
  for (int i = 0; i < steps; ++i) {
    th = th * 1664525u + 1013904223u;
    const uint32_t d = sub_u32(th - phi_l, inc);
    phi_l += inc;
    const float d_f = __int2float_rn(static_cast<int32_t>(d));
    inc = static_cast<uint32_t>(
        __float2int_rz(__fadd_rn(fk, __fmul_rn(k_ab, d_f))));
    fk = fminf(fmaxf(__fadd_rn(fk, __fmul_rn(k_b, d_f)), fmin_k), fmax_k);
  }
  cycles[0] = clock64() - t0;
  sink[0] = phi_l + inc + static_cast<uint32_t>(fk);
}

}  // namespace

extern "C" int lr_walker_chain_probe(int steps, float k_ab, float k_b,
                                     float fmin_k, float fmax_k, float fk,
                                     void* cycles, void* sink,
                                     void* stream) {
  walker_chain_probe<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, k_ab, k_b, fmin_k, fmax_k, fk, 12345u,
      static_cast<long long*>(cycles), static_cast<uint32_t*>(sink));
  return static_cast<int>(cudaGetLastError());
}
