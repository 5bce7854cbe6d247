// The loop-carried chain of K3's fractional-multiplier phi_m walk
// (csrc/pll.cu, lane 0 of warp 2) alone, in one thread:
//   p = (phi_m + fk k_fm) + k_amb e;  phi_m = p - 2 pi rint(p / 2 pi)
// each operation rounded alone (two FADD, then the IEEE division, FRND,
// FMUL and FSUB of wrap_pi), with fk and e drawn by an LCG off the chain.
// Built and run by scratch/phim_probe.py.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void phim_walk_probe(int steps, float k_fm, float k_amb,
                                float two_pi, long long* cycles,
                                float* sink) {
  uint32_t s = 12345u;
  float phi_m = 0.0f;
  const long long t0 = clock64();
#pragma unroll 4
  for (int i = 0; i < steps; ++i) {
    s = s * 1664525u + 1013904223u;
    const float fk = __int2float_rn(static_cast<int32_t>(s >> 12));
    const float e = __int2float_rn(static_cast<int32_t>(s & 0xffffu) -
                                   32768) * 1e-5f;
    const float p = __fadd_rn(__fadd_rn(phi_m, __fmul_rn(fk, k_fm)),
                              __fmul_rn(k_amb, e));
    phi_m = __fsub_rn(p, __fmul_rn(two_pi, rintf(__fdiv_rn(p, two_pi))));
  }
  cycles[0] = clock64() - t0;
  sink[0] = phi_m;
}

}  // namespace

extern "C" int lr_phim_walk_probe(int steps, float k_fm, float k_amb,
                                  float two_pi, void* cycles, void* sink,
                                  void* stream) {
  phim_walk_probe<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, k_fm, k_amb, two_pi, static_cast<long long*>(cycles),
      static_cast<float*>(sink));
  return static_cast<int>(cudaGetLastError());
}
