// The PLL ablations S7 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of scratch/pll_ablate.py (`run_variant`
// :73 -> `make_kernel` :25, pallas_call :78): a float-radian PLL with a
// vector oscillator, one sample at a time, in four bodies that price its
// parts: `full`, `no-osc`, `no-atan` (the detector's atan2 replaced by
// its input product, a cost probe, not a valid PLL) and `bare` (no
// oscillator update: detector and loop filter only).
//
// What it computes, per sample i of x float32 [2, n] (re row, im row),
// from the state float32 [3] = (oscillator angle, phi_m, freq):
//
//   (vr, vi) = (cos s0, sin s0) at the start
//   pr = xr vr + xi vi;  pi = xi vr - xr vi
//   err[i] = atan2(pi, pr)        (full, no-osc)
//          = pi pr 1e-3           (no-atan, bare)
//   freq += beta err;  dl = freq + alpha err
//   unless bare: (s, c) = _sincos_small(dl); (vr, vi) rotated by (c, s)
//                and renormalized by 1.5 - 0.5 |v|^2
//   phi_m += freq mult + alpha err;  phi_m -= 2 pi where phi_m > 2 pi
//   freq = clip(freq, fmin, fmax)
//
// and the state out (atan2(vi, vr), phi_m, freq).  `no-osc` computes what
// `full` computes: the TPU body takes the oscillator branch for every
// variant but `bare` (pll_ablate.py:41, :48), whatever its docstring
// says, so the port keeps that.  The TPU grid's block size k does not
// enter the function: the carry crosses blocks in scratch, so the port
// has no k.
//
// Float32 operations in the TPU body's order, each product and sum
// rounded on its own (__fmul_rn/__fadd_rn: no contraction into FMAs), so
// the plain PyTorch twin (ops/pll_ablate.py) gives the same bits on the
// card: _sincos_small's polynomial is copied term by term, and CUDA
// atan2f stands where the body calls its polynomial _atan2 (the port's
// rule: atan2f keeps IEEE signed zeros), as torch.atan2 computes it.
//
// What bounds it on an H100: the loop-carried chain of one step, a
// latency.  Bytes are 12 a sample (x read, err written): 2^21 samples
// take 0.0075 ms at 3.35 TB/s, three orders below the chain.  The chain
// floor is measured by chain_probe_kernel below (clock64, one thread,
// inputs from registers: the step alone), as scratch/pll_chain_probe.cu
// measures K3's.
//
// Design.  One thread walks the chain (the TPU's scalar core): lane 0 of
// warp 0.  Four more warps stage x through shared memory in chunks of
// kChunk samples, double-buffered: while the walker runs chunk j they
// load chunk j + 1 and store the errors of chunk j - 1, coalesced, so
// the walker reads only shared memory.  The variant is a template
// parameter.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFull = 0, kNoOsc = 1, kNoAtan = 2, kBare = 3;
constexpr int kChunk = 2048;       // samples a shared-memory stage holds
constexpr int kLoaders = 128;      // threads of warps 1-4
constexpr int kThreads = 32 + kLoaders;

struct Consts {
  float alpha, beta, fmin, fmax, mult;
};

// numpy's float32 of each double constant (the TPU body's np.float32)
#define LR_F32(v) static_cast<float>(v)

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// luaradio_tpu/ops/pll.py _sincos_small, term by term.
__device__ __forceinline__ void sincos_small(float d, float& s, float& c) {
  const float d2 = mul(d, d);
  // innermost term first, as the body nests them
  float ps = mul(d2, LR_F32(1.0 / 362880.0));
  ps = mul(d2, add(LR_F32(-1.0 / 5040.0), ps));
  ps = mul(d2, add(LR_F32(1.0 / 120.0), ps));
  ps = mul(d2, add(LR_F32(-1.0 / 6.0), ps));
  s = mul(d, add(LR_F32(1.0), ps));
  float pc = mul(d2, LR_F32(1.0 / 40320.0));
  pc = mul(d2, add(LR_F32(-1.0 / 720.0), pc));
  pc = mul(d2, add(LR_F32(1.0 / 24.0), pc));
  pc = mul(d2, add(LR_F32(-0.5), pc));
  c = add(LR_F32(1.0), pc);
}

struct Loop {
  float vr, vi, phim, freq;
};

// One step of variant V; returns err.
template <int V>
__device__ __forceinline__ float step(float xr, float xi, Loop& s,
                                      const Consts& k) {
  const float pr = add(mul(xr, s.vr), mul(xi, s.vi));
  const float pi = sub(mul(xi, s.vr), mul(xr, s.vi));
  float err;
  if constexpr (V == kFull || V == kNoOsc)
    err = atan2f(pi, pr);
  else
    err = mul(mul(pi, pr), LR_F32(1e-3));
  s.freq = add(s.freq, mul(k.beta, err));
  const float dl = add(s.freq, mul(k.alpha, err));
  if constexpr (V != kBare) {
    float sl, cl;
    sincos_small(dl, sl, cl);
    const float vr2 = sub(mul(s.vr, cl), mul(s.vi, sl));
    const float vi2 = add(mul(s.vr, sl), mul(s.vi, cl));
    const float gv = sub(LR_F32(1.5),
                         mul(LR_F32(0.5), add(mul(vr2, vr2), mul(vi2, vi2))));
    s.vr = mul(vr2, gv);
    s.vi = mul(vi2, gv);
  }
  const float dm = add(mul(s.freq, k.mult), mul(k.alpha, err));
  const float two_pi = LR_F32(2.0 * 3.141592653589793);
  s.phim = add(s.phim, dm);
  s.phim = sub(s.phim, s.phim > two_pi ? two_pi : 0.0f);
  // jnp.clip: minimum(maximum(freq, fmin), fmax), NaN kept
  const float lo = s.freq < k.fmin ? k.fmin : s.freq;
  s.freq = lo > k.fmax ? k.fmax : lo;
  return err;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    ablate_kernel(const float* __restrict__ x, int64_t n,
                  const float* __restrict__ state, Consts k,
                  float* __restrict__ err, float* __restrict__ state_out) {
  __shared__ float sre[2][kChunk], sim[2][kChunk], serr[2][kChunk];
  const int64_t chunks = (n + kChunk - 1) / kChunk;
  const int tid = threadIdx.x - 32;          // loader index (warps 1-4)
  auto length = [&](int64_t j) {
    const int64_t left = n - j * kChunk;
    return static_cast<int>(left < kChunk ? left : kChunk);
  };
  auto load = [&](int64_t j) {
    const int64_t base = j * kChunk;
    const int len = length(j);
    for (int i = tid; i < len; i += kLoaders) {
      sre[j & 1][i] = x[base + i];
      sim[j & 1][i] = x[n + base + i];
    }
  };
  auto store = [&](int64_t j) {
    const int64_t base = j * kChunk;
    const int len = length(j);
    for (int i = tid; i < len; i += kLoaders) err[base + i] = serr[j & 1][i];
  };
  Loop s{0.0f, 0.0f, 0.0f, 0.0f};
  if (threadIdx.x == 0) {
    s.vr = cosf(state[0]);
    s.vi = sinf(state[0]);
    s.phim = state[1];
    s.freq = state[2];
  }
  if (tid >= 0 && chunks > 0) load(0);
  __syncthreads();
  for (int64_t j = 0; j < chunks; ++j) {
    if (threadIdx.x == 0) {
      const float* re = sre[j & 1];
      const float* im = sim[j & 1];
      float* e = serr[j & 1];
      const int len = length(j);
#pragma unroll 8
      for (int i = 0; i < len; ++i) e[i] = step<V>(re[i], im[i], s, k);
    } else if (tid >= 0) {
      if (j + 1 < chunks) load(j + 1);
      if (j > 0) store(j - 1);
    }
    __syncthreads();
  }
  if (tid >= 0 && chunks > 0) store(chunks - 1);
  if (threadIdx.x == 0) {
    state_out[0] = atan2f(s.vi, s.vr);
    state_out[1] = s.phim;
    state_out[2] = s.freq;
  }
}

// Measurement probe, not a port of anything: one thread runs variant V's
// step alone for `blocks` x 8 steps, its inputs cycling through 8 pairs
// held in registers (off the chain: no load, no store), and records the
// clock64() count.  Its time a step is the loop-carried chain's: the
// floor of `full`; the kernel can beat the probe of a shorter step
// (no-atan), so there it is a cost, not a floor.
template <int V>
__global__ void chain_probe_kernel(int64_t blocks, Consts k, uint32_t seed,
                                   long long* __restrict__ cycles,
                                   float* __restrict__ sink) {
  float xs[16];
  uint32_t th = seed;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    th = th * 1664525u + 1013904223u;
    xs[i] = __int2float_rn(static_cast<int32_t>(th)) * 4.656612873e-10f;
  }
  Loop s{1.0f, 0.0f, 0.0f, 0.0f};
  const long long t0 = clock64();
  for (int64_t b = 0; b < blocks; ++b) {
#pragma unroll
    for (int i = 0; i < 8; ++i) step<V>(xs[2 * i], xs[2 * i + 1], s, k);
  }
  cycles[0] = clock64() - t0;
  sink[0] = s.vr;
  sink[1] = s.vi;
  sink[2] = s.phim;
  sink[3] = s.freq;
}

}  // namespace

extern "C" {

// x float32 [2, n] (rows contiguous), state float32 [3]; err float32
// [n], state_out float32 [3].  variant: 0 full, 1 no-osc, 2 no-atan,
// 3 bare.  Returns the cudaError_t of the launch.
int lr_pll_ablate(const void* x, long long n, const void* state,
                  float alpha, float beta, float fmin, float fmax,
                  float mult, int variant, void* err, void* state_out,
                  void* stream) {
  if (n < 0 || variant < 0 || variant > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const Consts k{alpha, beta, fmin, fmax, mult};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* sp = static_cast<const float*>(state);
  float* ep = static_cast<float*>(err);
  float* so = static_cast<float*>(state_out);
  switch (variant) {
    case kFull:
      ablate_kernel<kFull><<<1, kThreads, 0, s>>>(xp, n, sp, k, ep, so);
      break;
    case kNoOsc:
      ablate_kernel<kNoOsc><<<1, kThreads, 0, s>>>(xp, n, sp, k, ep, so);
      break;
    case kNoAtan:
      ablate_kernel<kNoAtan><<<1, kThreads, 0, s>>>(xp, n, sp, k, ep, so);
      break;
    default:
      ablate_kernel<kBare><<<1, kThreads, 0, s>>>(xp, n, sp, k, ep, so);
  }
  return static_cast<int>(cudaGetLastError());
}

// The chain probe of variant `variant`: blocks x 8 steps; cycles int64
// [1], sink float32 [4].
int lr_pll_ablate_chain_probe(long long blocks, float alpha, float beta,
                              float fmin, float fmax, float mult,
                              int variant, void* cycles, void* sink,
                              void* stream) {
  if (blocks < 0 || variant < 0 || variant > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const Consts k{alpha, beta, fmin, fmax, mult};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* cp = static_cast<long long*>(cycles);
  float* sp = static_cast<float*>(sink);
  switch (variant) {
    case kFull:
      chain_probe_kernel<kFull><<<1, 1, 0, s>>>(blocks, k, 12345u, cp, sp);
      break;
    case kNoOsc:
      chain_probe_kernel<kNoOsc><<<1, 1, 0, s>>>(blocks, k, 12345u, cp, sp);
      break;
    case kNoAtan:
      chain_probe_kernel<kNoAtan><<<1, 1, 0, s>>>(blocks, k, 12345u, cp, sp);
      break;
    default:
      chain_probe_kernel<kBare><<<1, 1, 0, s>>>(blocks, k, 12345u, cp, sp);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
