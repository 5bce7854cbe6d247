// The overlap-and-discard PLL scan, for Hopper (sm_90a).
//
// Not a port of a Pallas kernel: the JAX package runs this tier as one
// lax.scan (luaradio_tpu/ops/pll_overlap.py:74-193, pll_overlap_discard),
// which XLA compiles into one loop on the device.  This is the port's own
// kernel for that scan; the segment set-up, the boundary check, the
// cumprod chaining of the multiplied oscillator and the output reshape
// stay in torch (ops/pll_overlap.py), all O(S).
//
// What it computes: each row of a chunk x[C, 0..N) split into S segments
// of L samples (C rows of a channel bank: one launch carries C x S
// segments, and each row's segments compute what a one-row launch of that
// row computes),
// each run from a guessed state over W warm-up samples of its left
// neighbour's tail and then its own L samples, the reference's per-sample
// loop (pll.lua:138-167) in phasor form:
//   err = atan2(Im, Re)(x * conj(v));  f2 = fr + beta err
//   v  *= e^{j (f2 + alpha err)};      m *= e^{j (mult f2 + alpha err)}
//   each renormalized by 1.5 - 0.5 |.|^2;  fr = clamp(f2, fmin, fmax)
// Segment 0 of each row starts from the true carry and holds it through
// the warm-up (its warm-up input is the zero padding).
//
// What bounds it on an H100: each segment is a serial chain of W+L steps
// (atan2f, two sincos, ~30 flops a step); S <= 4096 segments give at most
// 32 blocks, so the card is mostly idle and the time is the chain's
// latency.  Design: one thread per segment (g = c S + s over the bank),
// its (vr, vi, mr, mi, fr) in registers; blocks of 128 threads; each
// thread walks its samples in order (consecutive addresses, served by L1),
// and the outputs are written [L, C S] so that neighbouring segments land
// at neighbouring addresses.
//
// Rounding follows the plain PyTorch twin (pll_overlap_discard_reference),
// where each * and + is its own elementwise kernel: every product and sum
// is __fmul_rn/__fadd_rn/__fsub_rn so nvcc cannot contract it into an
// FMA; atan2f, sinf and cosf are the libdevice functions torch calls on
// the card; clamp keeps torch.clamp's NaN propagation.  No fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

struct Loop {
  float alpha, beta, mult, fmin, fmax;
};

__device__ __forceinline__ float clamp_nan(float v, float lo, float hi) {
  // torch.clamp on the card: NaN passes through, else min(max(v, lo), hi)
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// 1.5 - 0.5 * (a*a + b*b), one rounding per operation
__device__ __forceinline__ float renorm(float a, float b) {
  return __fsub_rn(1.5f,
                   __fmul_rn(0.5f, __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b))));
}

__global__ void __launch_bounds__(kThreads)
overlap_scan_kernel(const float2* __restrict__ x, int rows, int seg_per_row,
                    int lseg, int warm, const float* __restrict__ init,
                    Loop k, float* __restrict__ o_r, float* __restrict__ o_i,
                    float* __restrict__ o_e, float* __restrict__ snap,
                    float* __restrict__ exit_state) {
  // s: this thread's segment over the bank (the column of every [., C S]
  // array); sr: its index within its row
  const int s_count = rows * seg_per_row;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= s_count) return;
  const int sr = s % seg_per_row;
  x += static_cast<int64_t>(s / seg_per_row) * seg_per_row * lseg;
  float vr = init[s], vi = init[s_count + s], mr = init[2 * s_count + s],
        mi = init[3 * s_count + s], fr = init[4 * s_count + s];
  // sample i of this segment's walk is x[row, sr*L - W + i]; segment 0's
  // warm-up reads the zero padding
  const int64_t base = static_cast<int64_t>(sr) * lseg - warm;
  const int steps = warm + lseg;
  for (int i = 0; i < steps; ++i) {
    if (i == warm) {
      snap[s] = vr;
      snap[s_count + s] = vi;
      snap[2 * s_count + s] = mr;
      snap[3 * s_count + s] = mi;
      snap[4 * s_count + s] = fr;
    }
    const int64_t g = base + i;
    const float2 xv = g >= 0 ? x[g] : make_float2(0.f, 0.f);
    const float pr = __fadd_rn(__fmul_rn(xv.x, vr), __fmul_rn(xv.y, vi));
    const float pi = __fsub_rn(__fmul_rn(xv.y, vr), __fmul_rn(xv.x, vi));
    const float err = atan2f(pi, pr);
    const float f2 = __fadd_rn(fr, __fmul_rn(k.beta, err));
    const float dl = __fadd_rn(f2, __fmul_rn(k.alpha, err));
    const float dm = __fadd_rn(__fmul_rn(k.mult, f2), __fmul_rn(k.alpha, err));
    const float sl = sinf(dl), cl = cosf(dl);
    const float sm = sinf(dm), cm = cosf(dm);
    const float vr2 = __fsub_rn(__fmul_rn(vr, cl), __fmul_rn(vi, sl));
    const float vi2 = __fadd_rn(__fmul_rn(vr, sl), __fmul_rn(vi, cl));
    const float mr2 = __fsub_rn(__fmul_rn(mr, cm), __fmul_rn(mi, sm));
    const float mi2 = __fadd_rn(__fmul_rn(mr, sm), __fmul_rn(mi, cm));
    const float gv = renorm(vr2, vi2);
    const float gm = renorm(mr2, mi2);
    const float f3 = clamp_nan(f2, k.fmin, k.fmax);
    if (i >= warm) {
      const int64_t o = static_cast<int64_t>(i - warm) * s_count + s;
      o_r[o] = mr;
      o_i[o] = mi;
      o_e[o] = err;
    }
    if (sr != 0 || i >= warm) {
      vr = __fmul_rn(vr2, gv);
      vi = __fmul_rn(vi2, gv);
      mr = __fmul_rn(mr2, gm);
      mi = __fmul_rn(mi2, gm);
      fr = f3;
    }
  }
  exit_state[s] = vr;
  exit_state[s_count + s] = vi;
  exit_state[2 * s_count + s] = mr;
  exit_state[3 * s_count + s] = mi;
  exit_state[4 * s_count + s] = fr;
}

// Measurement probe, not a port of anything: one thread runs only the
// dependent chain of the scan's step through the VCO v (x * conj(v) ->
// atan2f -> f2, dl -> sinf/cosf(dl) -> the v product -> renorm -> v; fr
// rides along), with no m update and no loads or stores, for `steps`
// steps.  The input samples come from an LCG off the chain.  Its time a
// step is the latency floor of one segment's walk; cycles[0] gets the
// clock64() count.
__global__ void overlap_chain_probe_kernel(int steps, Loop k, uint32_t seed,
                                           long long* cycles, float* sink) {
  float vr = 1.f, vi = 0.f, fr = 0.5f * (k.fmin + k.fmax);
  uint32_t r = seed;
  const long long t0 = clock64();
  for (int i = 0; i < steps; ++i) {
    r = r * 1664525u + 1013904223u;
    const float xr = __int2float_rn(static_cast<int32_t>(r)) * 4.6566e-10f;
    r = r * 1664525u + 1013904223u;
    const float xi = __int2float_rn(static_cast<int32_t>(r)) * 4.6566e-10f;
    const float pr = __fadd_rn(__fmul_rn(xr, vr), __fmul_rn(xi, vi));
    const float pi = __fsub_rn(__fmul_rn(xi, vr), __fmul_rn(xr, vi));
    const float err = atan2f(pi, pr);
    const float f2 = __fadd_rn(fr, __fmul_rn(k.beta, err));
    const float dl = __fadd_rn(f2, __fmul_rn(k.alpha, err));
    const float sl = sinf(dl), cl = cosf(dl);
    const float vr2 = __fsub_rn(__fmul_rn(vr, cl), __fmul_rn(vi, sl));
    const float vi2 = __fadd_rn(__fmul_rn(vr, sl), __fmul_rn(vi, cl));
    const float gv = renorm(vr2, vi2);
    vr = __fmul_rn(vr2, gv);
    vi = __fmul_rn(vi2, gv);
    fr = clamp_nan(f2, k.fmin, k.fmax);
  }
  cycles[0] = clock64() - t0;
  sink[0] = vr + vi + fr;
}

}  // namespace

extern "C" {

// x: complex64 [C, S*L] (interleaved float pairs, rows contiguous); init:
// float32 [5, C*S] (vr, vi, mr, mi, fr; column c S + s is row c's segment
// s); the loop constants alpha, beta, fmin, fmax and mult; o_r, o_i, o_e:
// float32 [L, C*S]; snap (the state entering step W) and exit_state:
// float32 [5, C*S].  Returns the cudaError_t of the launch.
int lr_pll_overlap_scan(const void* x, int rows, int seg_per_row, int lseg,
                        int warm, const void* init, float alpha, float beta,
                        float fmin, float fmax, float mult, void* o_r,
                        void* o_i, void* o_e, void* snap, void* exit_state,
                        void* stream) {
  if (rows < 1 || seg_per_row < 1 || lseg < 1 || warm < 0 || warm > lseg ||
      static_cast<long long>(rows) * seg_per_row > (1LL << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  Loop k{alpha, beta, mult, fmin, fmax};
  const int blocks = (rows * seg_per_row + kThreads - 1) / kThreads;
  overlap_scan_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(x), rows, seg_per_row, lseg, warm,
      static_cast<const float*>(init), k, static_cast<float*>(o_r),
      static_cast<float*>(o_i), static_cast<float*>(o_e),
      static_cast<float*>(snap), static_cast<float*>(exit_state));
  return static_cast<int>(cudaGetLastError());
}

// The chain probe (see overlap_chain_probe_kernel), with the loop
// constants alpha, beta, fmin, fmax: cycles int64 [1], sink float32 [1].
int lr_overlap_chain_probe(int steps, float alpha, float beta, float fmin,
                           float fmax, void* cycles, void* sink,
                           void* stream) {
  Loop k{alpha, beta, 0.f, fmin, fmax};
  overlap_chain_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, k, 12345u, static_cast<long long*>(cycles),
      static_cast<float*>(sink));
  return static_cast<int>(cudaGetLastError());
}

const char* lr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
