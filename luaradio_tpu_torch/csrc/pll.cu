// The sequential PLL in the phase domain, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   K3  luaradio_tpu/ops/pll.py pll_pallas / _pll_phase_kernel
//
// What it computes, for one complex stream x[0..N) and the state
// (phi_locked, phi_multiplied, freq) in radians:
//   theta[i] = arg(x[i]) as int32 turns (2^32 = 2 pi), zero[i] = (x[i] == 0);
//   per sample, in order:
//     record phi_m (the output oscillator BEFORE this update);
//     d    = theta[i] - phi_l                      (wraps mod 2^32)
//     d_f  = zero[i] ? 0 : float(d);  err[i] = d_f * 2 pi / 2^32
//     inc  = trunc(fk + (alpha + beta) d_f);  phi_l += inc
//     phi_m: integer mult  += mult*inc - trunc((mult-1) alpha d_f)
//            otherwise     float radians + fk*mult*2pi/2^32
//                          + (alpha + mult beta) err, wrapped (round half
//                          even) to [-pi, pi]
//     fk   = clip(fk + beta d_f, fmin, fmax)       (fk in turns, float)
//   out[i] = (cos, sin)(recorded phi_m).
// The host computes the float32 constants exactly as the TPU kernel does
// (pll.py:163-176); the entry and exit conversions of the state are the
// TPU kernel's (pll.py:143-156, :211-223).
//
// What bounds it on an H100: not bytes (20 bytes a sample: 8 in, 8 out,
// 4 err) but the loop-carried chain of one step, phi_l -> IADD -> I2F ->
// FMUL -> FADD -> F2I -> IADD -> phi_l, which no parallelism shortens.
// Design (a simple first version):
//   * one stream is one serial chain, so one thread block takes it;
//   * per tile of kTile samples: all threads compute theta (atan2f, the
//     clip at pll.py:247-248, round half even) and the zero flags into
//     shared memory; thread 0 walks the chain over the tile, its state in
//     registers from tile to tile, and writes phi_m and err to shared
//     memory; then all threads write out = (cosf, sinf)(phi_m) and err,
//     coalesced;
//   * any N (the last tile is short); no tile constraint;
//   * phases are uint32 (signed overflow is undefined in C++) and are
//     reinterpreted as int32 only for the int->float converts;
//     __float2int_rz is the truncating convert of .astype(int32),
//     __float2int_rn/rintf the round half even of jnp.round; both
//     saturate as XLA's converts do;
//   * every product and sum of the chain is __fmul_rn/__fadd_rn so nvcc
//     cannot contract it into an FMA: the plain PyTorch twin
//     (ops/pll.py) rounds each operation on its own, and so does this.
// Overlapping the parallel phases of the next tile with the chain (double
// buffering) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;

struct Consts {
  float to_i;    // radians -> turns, float32(2^32 / 2 pi)
  float to_f;    // turns -> radians, float32(2 pi / 2^32)
  float two_pi;  // float32(2 pi)
  float k_ab;    // alpha + beta
  float k_amb;   // alpha + mult * beta
  float k_fm;    // to_f * mult
  float k_b;     // beta
  float fmin_k;  // fmin * to_i
  float fmax_k;  // fmax * to_i
  float k_corr;  // (mult - 1) * alpha (integer mult)
  uint32_t mult_i;
};

__device__ __forceinline__ float i2f(uint32_t v) {
  return __int2float_rn(static_cast<int32_t>(v));
}

__device__ __forceinline__ float wrap_pi(float p, float two_pi) {
  // p - 2 pi * round_half_even(p / 2 pi), each operation rounded alone
  return __fsub_rn(p, __fmul_rn(two_pi, rintf(__fdiv_rn(p, two_pi))));
}

template <bool kIntMult>
__global__ void __launch_bounds__(kThreads)
pll_phase_kernel(const float2* __restrict__ x, int64_t n,
                 const float* __restrict__ state_in, Consts c,
                 float2* __restrict__ out, float* __restrict__ err,
                 float* __restrict__ state_out) {
  __shared__ int32_t s_th[kTile];
  __shared__ float s_phim[kTile];
  __shared__ float s_err[kTile];
  __shared__ uint8_t s_zero[kTile];

  // the chain's state, live in thread 0 only
  uint32_t phi_l = 0, phi_m = 0;
  float phi_mf = 0.f, fk = 0.f;
  if (threadIdx.x == 0) {
    phi_l = static_cast<uint32_t>(
        __float2int_rn(__fmul_rn(state_in[0], c.to_i)));
    fk = i2f(static_cast<uint32_t>(
        __float2int_rn(__fmul_rn(state_in[2], c.to_i))));
    phi_mf = wrap_pi(state_in[1], c.two_pi);
    phi_m = static_cast<uint32_t>(__float2int_rn(__fmul_rn(phi_mf, c.to_i)));
  }

  for (int64_t base = 0; base < n; base += kTile) {
    const int len = static_cast<int>(n - base < kTile ? n - base : kTile);
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float2 v = x[base + i];
      const float t = fminf(fmaxf(__fmul_rn(atan2f(v.y, v.x), c.to_i),
                                  -2147483648.0f),
                            2147483392.0f);
      s_th[i] = __float2int_rn(t);
      s_zero[i] = (v.x == 0.f && v.y == 0.f) ? 1 : 0;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll 4
      for (int i = 0; i < len; ++i) {
        s_phim[i] = kIntMult ? __fmul_rn(i2f(phi_m), c.to_f) : phi_mf;
        const uint32_t d = static_cast<uint32_t>(s_th[i]) - phi_l;
        const float d_f = s_zero[i] ? 0.f : i2f(d);
        const float e = __fmul_rn(d_f, c.to_f);
        s_err[i] = e;
        const uint32_t inc = static_cast<uint32_t>(
            __float2int_rz(__fadd_rn(fk, __fmul_rn(c.k_ab, d_f))));
        phi_l += inc;
        if (kIntMult) {
          phi_m += c.mult_i * inc - static_cast<uint32_t>(
              __float2int_rz(__fmul_rn(c.k_corr, d_f)));
        } else {
          const float p = __fadd_rn(__fadd_rn(phi_mf, __fmul_rn(fk, c.k_fm)),
                                    __fmul_rn(c.k_amb, e));
          phi_mf = wrap_pi(p, c.two_pi);
        }
        fk = fminf(fmaxf(__fadd_rn(fk, __fmul_rn(c.k_b, d_f)), c.fmin_k),
                   c.fmax_k);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const float p = s_phim[i];
      out[base + i] = make_float2(cosf(p), sinf(p));
      err[base + i] = s_err[i];
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    state_out[0] = __fmul_rn(i2f(phi_l), c.to_f);
    state_out[1] = kIntMult ? __fmul_rn(i2f(phi_m), c.to_f) : phi_mf;
    state_out[2] = __fmul_rn(fk, c.to_f);
  }
}

// Measurement probe, not a port of anything: one thread runs only the
// loop-carried chain of K3's step (phi_l -> IADD -> I2F -> FMUL -> FADD ->
// F2I -> IADD -> phi_l) for `steps` steps, the input phase drawn by an LCG
// off the chain.  Its time per step is the dependency-chain floor of the
// sequential PLL on this card; cycles[0] gets the clock64() count.
__global__ void chain_probe_kernel(int steps, float k_ab, float fk,
                                   uint32_t seed, long long* cycles,
                                   uint32_t* sink) {
  uint32_t phi = 0, th = seed;
  const long long t0 = clock64();
#pragma unroll 4
  for (int i = 0; i < steps; ++i) {
    th = th * 1664525u + 1013904223u;
    const float d_f = i2f(th - phi);
    phi += static_cast<uint32_t>(
        __float2int_rz(__fadd_rn(fk, __fmul_rn(k_ab, d_f))));
  }
  cycles[0] = clock64() - t0;
  sink[0] = phi;
}

}  // namespace

extern "C" {

// K3.  x: complex64 [N] (interleaved float pairs), state_in: float32 [3]
// radians; out: complex64 [N], err: float32 [N], state_out: float32 [3].
// int_mult != 0 selects the integer-multiplier chain (mult_i, k_corr).
// Returns the cudaError_t of the launch.
int lr_pll_phase(const void* x, long long n, const void* state_in,
                 float to_i, float to_f, float two_pi, float k_ab,
                 float k_amb, float k_fm, float k_b, float fmin_k,
                 float fmax_k, float k_corr, int mult_i, int int_mult,
                 void* out, void* err, void* state_out, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  Consts c{to_i, to_f, two_pi, k_ab, k_amb, k_fm, k_b, fmin_k, fmax_k,
           k_corr, static_cast<uint32_t>(mult_i)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* xp = static_cast<const float2*>(x);
  const float* sp = static_cast<const float*>(state_in);
  float2* op = static_cast<float2*>(out);
  float* ep = static_cast<float*>(err);
  float* so = static_cast<float*>(state_out);
  if (int_mult) {
    pll_phase_kernel<true><<<1, kThreads, 0, s>>>(xp, n, sp, c, op, ep, so);
  } else {
    pll_phase_kernel<false><<<1, kThreads, 0, s>>>(xp, n, sp, c, op, ep, so);
  }
  return static_cast<int>(cudaGetLastError());
}

// The chain probe (see chain_probe_kernel): cycles int64 [1], sink
// uint32 [1].
int lr_pll_chain_probe(int steps, float k_ab, float fk, void* cycles,
                       void* sink, void* stream) {
  chain_probe_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, k_ab, fk, 12345u, static_cast<long long*>(cycles),
      static_cast<uint32_t*>(sink));
  return static_cast<int>(cudaGetLastError());
}

const char* lr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
