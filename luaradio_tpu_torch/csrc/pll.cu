// The sequential PLL in the phase domain, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   K3  luaradio_tpu/ops/pll.py pll_pallas / _pll_phase_kernel
//
// What it computes, for each of C complex streams x[c, 0..N) and its state
// (phi_locked, phi_multiplied, freq) in radians (the JAX package banks the
// kernel as jax.vmap over C; here each row takes a thread block of its own,
// so a bank of C streams is one launch of C blocks, and each row's bits are
// those of a one-row launch of that row):
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
// 4 err) but the loop-carried chain of one step, which no parallelism
// shortens: F2I -> inc -> d = (theta - phi_l) - inc -> I2F -> FMUL ->
// FADD -> F2I, one integer operation between the two converts.
//
// Design.  Only (phi_l, fk) is truly sequential.  For an integer
// multiplier everything else follows from wrapping uint32 sums of what the
// chain records: with d[i] the walk's phase error,
//   phi_l[i] = theta[i] - d[i],  sum_{j<i} inc[j] = phi_l[i] - phi_l[0],
//   phi_m[i] = phi_m[0] + mult (phi_l[i] - phi_l[0]) - C[i],
//   C[i]     = sum_{j<i} trunc(k_corr d_f[j])            (all mod 2^32),
// and addition mod 2^32 is associative, so a parallel prefix sum of the
// same integers gives the sequential loop's bits.  One block takes a
// stream; its four warps, one on each SM sub-partition, take roles and
// hand tiles of kTile samples to each other through a ring of kSlots
// tiles in shared memory, with mbarriers:
//   * warp 1, producer: theta and the zero flags of tile t (atan2f, the
//     clip at pll.py:247-248, round half even), the flags packed as one
//     32-bit mask a group of 32 samples (__ballot_sync);
//   * warp 0, lane 0, walker: the chain alone over tile t.  A group of 32
//     steps starts with its theta in 16-byte loads (eight) and its mask,
//     and writes d[i] 16 bytes at a time; a group whose mask is 0 (every
//     group of a live signal) runs with no select on the chain, a group
//     with a zero runs a copy that has one.  No conversion but the chain's
//     I2F and F2I, no err, no phi_m, no trigonometry; one wait a tile.
//     The rest of warp 0 idles, so the walker's sub-partition runs
//     it alone;
//   * warps 2-3, consumers: tile t-1.  d_f, err and trunc(k_corr d_f) from
//     d[i] and the mask; C[i] as a two-warp wrapping prefix sum carried
//     from tile to tile; phi_m[i] as above, out = (cosf, sinf)(float(
//     phi_m) to_f); out and err written coalesced.
// The exit state is the walker's (phi_l, fk) and phi_m from the scan's
// total.  For a fractional multiplier (no receiver uses one) phi_m is a
// float recurrence with a wrap and cannot be scanned: the walker also
// records fk, and lane 0 of warp 2 walks phi_m from (fk, err) one tile
// behind the walker, its own chain.
//
// Numerics: phases are uint32 (signed overflow is undefined in C++) and
// are reinterpreted as int32 only for the int->float converts;
// __float2int_rz is the truncating convert of .astype(int32),
// __float2int_rn/rintf the round half even of jnp.round; both saturate as
// XLA's converts do.  Every product and sum is __fmul_rn/__fadd_rn so
// nvcc cannot contract it into an FMA: the plain PyTorch twin
// (ops/pll.py) rounds each operation on its own, and so does this.  Any
// N: 0, shorter than a tile, a short last tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 512;              // samples a ring slot holds
constexpr int kSlots = 4;               // ring depth, in tiles
constexpr int kGroup = 32;              // samples a zero mask covers
constexpr int kGroups = kTile / kGroup;
constexpr int kBatch = 8;               // producer groups loaded together
constexpr int kThreads = 128;           // walker, producer, 2 consumers
constexpr int kConsumerThreads = 64;
constexpr int kConsumerBarrier = 1;     // named barrier of the consumers

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

struct Slot {
  int32_t th[kTile];        // theta, producer -> walker, consumers
  uint32_t d[kTile];        // the walk's d, walker -> consumers
  float fk[kTile];          // fractional mult: fk, then phi_m
  uint32_t zmask[kGroups];  // bit i of word g: x[32 g + i] == 0
};

struct Ring {
  Slot slot[kSlots];
  uint64_t full_th[kSlots];  // producer (32 arrivals) -> walker
  uint64_t full_d[kSlots];   // walker (1) -> consumers
  uint64_t empty[kSlots];    // consumers (64) -> producer
  uint32_t tot[2][2];        // per-warp prefix totals, by tile parity
  uint32_t end_phi_l;
  float end_fk;
  uint32_t end_carry;
  float end_phi_mf;
};

__device__ __forceinline__ float i2f(uint32_t v) {
  return __int2float_rn(static_cast<int32_t>(v));
}

__device__ __forceinline__ float wrap_pi(float p, float two_pi) {
  // p - 2 pi * round_half_even(p / 2 pi), each operation rounded alone
  return __fsub_rn(p, __fmul_rn(two_pi, rintf(__fdiv_rn(p, two_pi))));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the completion of the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(kConsumerBarrier),
               "n"(kConsumerThreads)
               : "memory");
}

__device__ __forceinline__ bool is_zero(const Slot& sl, int i) {
  return (sl.zmask[i / kGroup] >> (i % kGroup)) & 1u;
}

__device__ __forceinline__ float d_float(const Slot& sl, int i) {
  return is_zero(sl, i) ? 0.f : i2f(sl.d[i]);
}

// a - b, opaque to the compiler's reassociation (see step)
__device__ __forceinline__ uint32_t sub_u32(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("sub.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// One step of the chain; returns its d.  phi_l lags the loop's phase by
// the last step's increment inc, so that d = (theta - phi_l) - inc takes
// one subtraction after inc is known (written as phi_l += inc first, the
// compiler puts two on the chain).
__device__ __forceinline__ uint32_t step(int32_t theta, bool zero,
                                         uint32_t& phi_l, uint32_t& inc,
                                         float& fk, const Consts& c) {
  const uint32_t d = sub_u32(static_cast<uint32_t>(theta) - phi_l, inc);
  phi_l += inc;
  const float d_f = zero ? 0.f : i2f(d);
  inc = static_cast<uint32_t>(
      __float2int_rz(__fadd_rn(fk, __fmul_rn(c.k_ab, d_f))));
  fk = fminf(fmaxf(__fadd_rn(fk, __fmul_rn(c.k_b, d_f)), c.fmin_k),
             c.fmax_k);
  return d;
}

// The walker over one full group of kGroup samples, theta already in
// registers; kZeros: the group's mask m has a bit set.
template <bool kIntMult, bool kZeros>
__device__ __forceinline__ void walk_group(Slot& sl, int g, uint32_t m,
                                           const int4 (&th)[kGroup / 4],
                                           uint32_t& phi_l, uint32_t& inc,
                                           float& fk, const Consts& c) {
  uint4* d4 = reinterpret_cast<uint4*>(sl.d + g * kGroup);
  float4* f4 = reinterpret_cast<float4*>(sl.fk + g * kGroup);
#pragma unroll
  for (int q = 0; q < kGroup / 4; ++q) {
    const int32_t tv[4] = {th[q].x, th[q].y, th[q].z, th[q].w};
    uint32_t dv[4];
    float fv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fv[j] = fk;
      dv[j] = step(tv[j], kZeros && ((m >> (4 * q + j)) & 1u), phi_l, inc,
                   fk, c);
    }
    d4[q] = make_uint4(dv[0], dv[1], dv[2], dv[3]);
    if (!kIntMult) f4[q] = make_float4(fv[0], fv[1], fv[2], fv[3]);
  }
}

// theta and the zero mask of group g, 16 bytes a load
__device__ __forceinline__ uint32_t load_group(const Slot& sl, int g,
                                               int4 (&th)[kGroup / 4]) {
  const int4* th4 = reinterpret_cast<const int4*>(sl.th + g * kGroup);
#pragma unroll
  for (int q = 0; q < kGroup / 4; ++q) th[q] = th4[q];
  return sl.zmask[g];
}

template <bool kIntMult>
__global__ void __launch_bounds__(kThreads)
pll_phase_kernel(const float2* __restrict__ x, int64_t n,
                 const float* __restrict__ state_in, Consts c,
                 float2* __restrict__ out, float* __restrict__ err,
                 float* __restrict__ state_out) {
  __shared__ __align__(16) Ring ring;
  // block b runs row b: its stream, its state and its outputs
  const int64_t row = blockIdx.x;
  x += row * n;
  out += row * n;
  err += row * n;
  state_in += 3 * row;
  state_out += 3 * row;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t tiles = (n + kTile - 1) / kTile;
  // the entry state, as every role derives it
  const uint32_t phi_l0 = static_cast<uint32_t>(
      __float2int_rn(__fmul_rn(state_in[0], c.to_i)));
  const float fk0 = i2f(static_cast<uint32_t>(
      __float2int_rn(__fmul_rn(state_in[2], c.to_i))));
  const float phi_mf0 = wrap_pi(state_in[1], c.two_pi);
  const uint32_t phi_m0 = static_cast<uint32_t>(
      __float2int_rn(__fmul_rn(phi_mf0, c.to_i)));

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&ring.full_th[s], 32);
      mbar_init(&ring.full_d[s], 1);
      mbar_init(&ring.empty[s], kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 0) {
    // ---- walker ----
    if (lane == 0) {
      uint32_t phi_l = phi_l0, inc = 0;
      float fk = fk0;
      for (int64_t t = 0; t < tiles; ++t) {
        const int s = static_cast<int>(t % kSlots);
        const int len = static_cast<int>(
            n - t * kTile < kTile ? n - t * kTile : kTile);
        Slot& sl = ring.slot[s];
        mbar_wait(&ring.full_th[s], static_cast<uint32_t>(t / kSlots) & 1u);
        const int full = len / kGroup;
        for (int g = 0; g < full; ++g) {
          int4 th[kGroup / 4];
          const uint32_t m = load_group(sl, g, th);
          if (m == 0)
            walk_group<kIntMult, false>(sl, g, 0u, th, phi_l, inc, fk, c);
          else
            walk_group<kIntMult, true>(sl, g, m, th, phi_l, inc, fk, c);
        }
        for (int i = full * kGroup; i < len; ++i) {
          if (!kIntMult) sl.fk[i] = fk;
          sl.d[i] = step(sl.th[i], is_zero(sl, i), phi_l, inc, fk, c);
        }
        mbar_arrive(&ring.full_d[s]);
      }
      ring.end_phi_l = phi_l + inc;
      ring.end_fk = fk;
    }
    __syncwarp();
  } else if (warp == 1) {
    // ---- producer: theta and zero masks, up to kSlots tiles ahead ----
    for (int64_t t = 0; t < tiles; ++t) {
      const int s = static_cast<int>(t % kSlots);
      const int64_t base = t * kTile;
      const int len = static_cast<int>(n - base < kTile ? n - base : kTile);
      if (t >= kSlots)
        mbar_wait(&ring.empty[s],
                  static_cast<uint32_t>(t / kSlots - 1) & 1u);
      Slot& sl = ring.slot[s];
      for (int g0 = 0; g0 * kGroup < len; g0 += kBatch) {
        float2 v[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int i = (g0 + k) * kGroup + lane;
          v[k] = i < len ? x[base + i] : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int i = (g0 + k) * kGroup + lane;
          const float th = fminf(fmaxf(__fmul_rn(atan2f(v[k].y, v[k].x),
                                                 c.to_i),
                                       -2147483648.0f),
                                 2147483392.0f);
          sl.th[i] = __float2int_rn(th);
          const uint32_t z =
              __ballot_sync(0xffffffffu, v[k].x == 0.f && v[k].y == 0.f);
          if (lane == 0) sl.zmask[g0 + k] = z;
        }
      }
      mbar_arrive(&ring.full_th[s]);
    }
  } else {
    // ---- consumers: out, err and phi_m one tile behind the walker ----
    const int cw = warp - 2;
    const int ct = threadIdx.x - 64;
    uint32_t carry = 0;        // C at the tile's first sample
    float phi_mf = phi_mf0;    // fractional mult, lane 0 of warp 2
    for (int64_t t = 0; t < tiles; ++t) {
      const int s = static_cast<int>(t % kSlots);
      const int64_t base = t * kTile;
      const int len = static_cast<int>(n - base < kTile ? n - base : kTile);
      Slot& sl = ring.slot[s];
      mbar_wait(&ring.full_d[s], static_cast<uint32_t>(t / kSlots) & 1u);
      if (kIntMult) {
        // warp cw takes [lo, hi); pass 1: the half's total of C's terms
        const int lo = cw * (kTile / 2);
        const int hi = len < lo + kTile / 2 ? len : lo + kTile / 2;
        uint32_t part = 0;
        for (int i = lo + lane; i < hi; i += 32)
          part += static_cast<uint32_t>(
              __float2int_rz(__fmul_rn(c.k_corr, d_float(sl, i))));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        if (lane == 0) ring.tot[t & 1][cw] = part;
        consumers_sync();
        const uint32_t t0 = ring.tot[t & 1][0], t1 = ring.tot[t & 1][1];
        uint32_t run = carry + (cw ? t0 : 0u);
        carry += t0 + t1;
        // pass 2: 32 samples at a time, an inclusive warp scan of C's
        // terms, then phi_m, out and err
        for (int g0 = lo; g0 < hi; g0 += 32) {
          const int i = g0 + lane;
          const bool ok = i < hi;
          const float d_f = ok ? d_float(sl, i) : 0.f;
          const uint32_t term = static_cast<uint32_t>(
              __float2int_rz(__fmul_rn(c.k_corr, d_f)));
          uint32_t incl = term;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += y;
          }
          if (ok) {
            const uint32_t phi_l = static_cast<uint32_t>(sl.th[i]) - sl.d[i];
            const uint32_t phi_m = phi_m0 + c.mult_i * (phi_l - phi_l0) -
                                   (run + incl - term);
            const float p = __fmul_rn(i2f(phi_m), c.to_f);
            out[base + i] = make_float2(cosf(p), sinf(p));
            err[base + i] = __fmul_rn(d_f, c.to_f);
          }
          run += __shfl_sync(0xffffffffu, incl, 31);
        }
      } else {
        if (cw == 0 && lane == 0) {
          for (int i = 0; i < len; ++i) {
            const float e = __fmul_rn(d_float(sl, i), c.to_f);
            const float p =
                __fadd_rn(__fadd_rn(phi_mf, __fmul_rn(sl.fk[i], c.k_fm)),
                          __fmul_rn(c.k_amb, e));
            sl.fk[i] = phi_mf;
            phi_mf = wrap_pi(p, c.two_pi);
          }
        }
        __syncwarp();
        consumers_sync();
        for (int i = ct; i < len; i += kConsumerThreads) {
          const float p = sl.fk[i];
          out[base + i] = make_float2(cosf(p), sinf(p));
          err[base + i] = __fmul_rn(d_float(sl, i), c.to_f);
        }
      }
      mbar_arrive(&ring.empty[s]);
    }
    if (ct == 0) {
      ring.end_carry = carry;
      ring.end_phi_mf = phi_mf;
    }
  }

  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t phi_l = ring.end_phi_l;
    state_out[0] = __fmul_rn(i2f(phi_l), c.to_f);
    state_out[1] =
        kIntMult ? __fmul_rn(i2f(phi_m0 + c.mult_i * (phi_l - phi_l0) -
                                 ring.end_carry),
                             c.to_f)
                 : ring.end_phi_mf;
    state_out[2] = __fmul_rn(ring.end_fk, c.to_f);
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

// K3 on a bank.  x: complex64 [rows, N] (interleaved float pairs, rows
// contiguous), state_in: float32 [rows, 3] radians; out: complex64
// [rows, N], err: float32 [rows, N], state_out: float32 [rows, 3].  One
// thread block a row.  int_mult != 0 selects the integer-multiplier chain
// (mult_i, k_corr).  Returns the cudaError_t of the launch.
int lr_pll_phase_rows(const void* x, int rows, long long n,
                      const void* state_in, float to_i, float to_f,
                      float two_pi, float k_ab, float k_amb, float k_fm,
                      float k_b, float fmin_k, float fmax_k, float k_corr,
                      int mult_i, int int_mult, void* out, void* err,
                      void* state_out, void* stream) {
  if (n < 0 || rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  Consts c{to_i, to_f, two_pi, k_ab, k_amb, k_fm, k_b, fmin_k, fmax_k,
           k_corr, static_cast<uint32_t>(mult_i)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* xp = static_cast<const float2*>(x);
  const float* sp = static_cast<const float*>(state_in);
  float2* op = static_cast<float2*>(out);
  float* ep = static_cast<float*>(err);
  float* so = static_cast<float*>(state_out);
  if (int_mult) {
    pll_phase_kernel<true><<<rows, kThreads, 0, s>>>(xp, n, sp, c, op, ep,
                                                     so);
  } else {
    pll_phase_kernel<false><<<rows, kThreads, 0, s>>>(xp, n, sp, c, op, ep,
                                                      so);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3 on one stream: x complex64 [N], state float32 [3]; the one-row form
// of lr_pll_phase_rows.
int lr_pll_phase(const void* x, long long n, const void* state_in,
                 float to_i, float to_f, float two_pi, float k_ab,
                 float k_amb, float k_fm, float k_b, float fmin_k,
                 float fmax_k, float k_corr, int mult_i, int int_mult,
                 void* out, void* err, void* state_out, void* stream) {
  return lr_pll_phase_rows(x, 1, n, state_in, to_i, to_f, two_pi, k_ab,
                           k_amb, k_fm, k_b, fmin_k, fmax_k, k_corr, mult_i,
                           int_mult, out, err, state_out, stream);
}

// The samples a ring slot of K3 holds (the consumers' scan tile).
int lr_pll_tile() { return kTile; }

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
