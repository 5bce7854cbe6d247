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
// the warm-up (its warm-up input is the zero padding).  Outputs are
// [C S, L]: segment g's L outputs are contiguous, so [C, S, L] -> [C, N]
// is a reshape.
//
// What bounds it on an H100: latency.  Each segment is a serial chain of
// W+L steps; the bytes (x read once, three floats a sample written) take
// a few percent of the time at 3.35 TB/s, and <= 4096 segments a row fill
// few SMs.  The chain that carries the state from one step to the next
// runs through the VCO v alone:
//   x * conj(v) -> atan2f -> f2, dl -> sinf/cosf(dl) -> v product ->
//   renorm -> v
// (the chain probe below times it: ~220 ns a step on an H100).  The
// multiplied oscillator m, the stores and the snapshot hang off that
// chain and never feed back into it.  The kernel before this one ran all
// of it in one thread a segment, in program order, loading x one sample a
// step from global memory: 2.1-2.6x the chain.
//
// Design: warp specialisation over shared-memory rings.  A block takes G
// segments (lane l of each role warp is segment blockIdx.x G + l) and
// walks them in stages of T steps; stage boundaries fall at W + j T, so
// step W (the snapshot) starts a stage and each output stage covers
// outputs [m T, m T + T) of its segments.
//   * Warp 0, the copy warp: lane l streams its segment's inputs into a
//     ring of P x-stages (full/empty mbarriers, G arrivals a phase).  A
//     segment's W+L inputs are contiguous in x, so a stage is one 1-D
//     cp.async.bulk a segment; the slot is shifted by one sample where x
//     is 8 bytes off 16 so that the copy lands aligned, and a sample left
//     over at either end is copied by a plain load.
//   * Warp 1, the walker: runs only the v chain, (vr, vi, fr) in
//     registers, x read from the ring one step ahead.  It writes each
//     step's err and f2 into a second ring ([T][G] float2: conflict-free)
//     and snapshots v and fr at step W.
//   * Warp 2, the oscillator: computes dm = mult f2 + alpha err and
//     sinf/cosf(dm), independent from step to step, U = 4 steps at a
//     time, then walks the short m chain (product, renorm), snapshots m
//     at step W, and writes o_r = m, o_i, o_e = err into an output stage
//     in shared memory (rows of T + 4 floats: float4 stores without bank
//     conflicts), which it stores with three 1-D bulk copies a segment
//     from its own lane (per-thread bulk groups: two output stages, the
//     older one read before it is written again).  Where L is not a
//     multiple of 4 the copies cannot be 16-byte aligned and it stores
//     with plain stores instead.
//   * Steps with no sample: segment 0's warm-up (the zero padding) and a
//     lane past the last segment.  Both are discarded, and segment 0's
//     state is put back to its carry at step W, which equals holding it:
//     no select on the chain.  Zeros there (kZeroWarm 1) send those lanes
//     down atan2f's 0/0 path while the warp's other lanes walk samples,
//     and the warp runs both (1.3-5 % of the scan's time at 2^16 and one
//     row); so they walk samples that exist instead (stage_base): segment
//     0 its row's first W, a lane past the last the last segment's.
// What binds it: the walker's chain.  The oscillator keeps up with room
// to spare and the copies run P stages ahead, so the walker never waits;
// its step takes ~1.17x the chain probe's (NVIDIA H100, the sweep below:
// PERF.md section 6).  The rest is the walker's own loop (its x load and
// err/f2 store, ~2 %; the code ptxas schedules around the chain) and a
// few hundred ns a stage at the stage boundaries, which T = 128 spreads
// over 128 steps.  G = 16 puts 264 rows of 8 segments on one block an SM
// (132 blocks); G = 8 doubles blocks up on an SM there and loses ~5 %.
// The constants are the sweep's winners by device time
// (scratch/scan_ab.py over the measurement build -DLR_SCAN_SWEEP, which
// also holds a register-pipelined one-thread variant, x prefetched as
// float4s, the m work of step i after the v work of step i + 1: ~2.0x
// the chain, in-order issue serialising the two).

// Rounding follows the plain PyTorch twin (_scan_reference), where each *
// and + is its own elementwise kernel: every product and sum is
// __fmul_rn/__fadd_rn/__fsub_rn so nvcc cannot contract it into an FMA;
// atan2f, sinf and cosf are the libdevice functions torch calls on the
// card; clamp keeps torch.clamp's NaN propagation.  No fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The shipped ring: segments a block, steps a stage, stages, whether the
// oscillator stores through shared memory with bulk copies (0) or
// straight to global memory (1), and whether steps with no sample walk
// zeros (1) or samples that exist (0; see stage_base).
constexpr int kG = 16, kT = 128, kP = 2, kStore = 0, kZeroWarm = 0;

constexpr int kU = 4;             // the oscillator's sincos unroll
constexpr int kRoleThreads = 96;  // copy, walker, oscillator warps
constexpr int kOutStages = 2;
constexpr int kMaxDevices = 64;

struct Loop {
  float alpha, beta, mult, fmin, fmax;
};

// The launch's geometry, the same for every segment.
struct Walk {
  int64_t n_row;        // samples a row (S L)
  uint64_t x8;          // x's address / 8 (the parity of a sample's address)
  int seg_per_row, s_count, lseg, warm;
  int stages, k0;       // stages, warm-up stages ceil(W / T)
  int aligned;          // outputs can be stored with 16-byte bulk copies
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

// One step of the v chain on sample (xr, xi): err and f2 = fr + beta err
// out, the state (vr, vi, fr) updated.
__device__ __forceinline__ void v_step(float xr, float xi, float& vr,
                                       float& vi, float& fr, const Loop& k,
                                       float& err, float& f2_) {
  const float pr = __fadd_rn(__fmul_rn(xr, vr), __fmul_rn(xi, vi));
  const float pi = __fsub_rn(__fmul_rn(xi, vr), __fmul_rn(xr, vi));
  err = atan2f(pi, pr);
  const float f2 = __fadd_rn(fr, __fmul_rn(k.beta, err));
  const float dl = __fadd_rn(f2, __fmul_rn(k.alpha, err));
  f2_ = f2;
  const float sl = sinf(dl), cl = cosf(dl);
  const float vr2 = __fsub_rn(__fmul_rn(vr, cl), __fmul_rn(vi, sl));
  const float vi2 = __fadd_rn(__fmul_rn(vr, sl), __fmul_rn(vi, cl));
  const float gv = renorm(vr2, vi2);
  vr = __fmul_rn(vr2, gv);
  vi = __fmul_rn(vi2, gv);
  fr = clamp_nan(f2, k.fmin, k.fmax);
}

// The m oscillator's increment mult f2 + alpha err, rounded as the twin.
__device__ __forceinline__ float m_inc(float err, float f2, const Loop& k) {
  return __fadd_rn(__fmul_rn(k.mult, f2), __fmul_rn(k.alpha, err));
}

// One step of the m chain given sin and cos of its increment.
__device__ __forceinline__ void m_step(float sm, float cm, float& mr,
                                       float& mi) {
  const float mr2 = __fsub_rn(__fmul_rn(mr, cm), __fmul_rn(mi, sm));
  const float mi2 = __fadd_rn(__fmul_rn(mr, sm), __fmul_rn(mi, cm));
  const float gm = renorm(mr2, mi2);
  mr = __fmul_rn(mr2, gm);
  mi = __fmul_rn(mi2, gm);
}

// ---- mbarriers and bulk copies (PTX) ------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

#ifdef LR_SCAN_SWEEP
constexpr uint64_t kHangNs = 4000000000ull;  // a wait this long is a fault

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
#endif

// Wait until the phase of parity `parity` of `bar` has completed (the
// measurement build traps after kHangNs).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
#ifdef LR_SCAN_SWEEP
  const uint64_t t0 = now_ns();
#endif
  while (!done) {
#ifdef LR_SCAN_SWEEP
    if (now_ns() - t0 > kHangNs) __trap();
#endif
    asm volatile(
        "{\n.reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// TMA bulk copy global -> shared of `bytes` (a multiple of 16, both
// addresses 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// TMA bulk copy shared -> global, in the thread's current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until all but the newest N bulk groups have read their source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Make this thread's shared-memory writes visible to its bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- the ring kernel ----------------------------------------------------

// Stage k covers walk steps [stage_start, stage_end): boundaries at
// W + j T, clipped to [0, W + L] (tests/test_torch_pll_overlap_ring.py
// ring_stages mirrors it).
template <int T>
__device__ __forceinline__ int stage_start(const Walk& w, int k) {
  const int s = w.warm + (k - w.k0) * T;
  return s > 0 ? s : 0;
}

template <int T>
__device__ __forceinline__ int stage_end(const Walk& w, int k) {
  const int e = w.warm + (k - w.k0 + 1) * T;
  return e < w.warm + w.lseg ? e : w.warm + w.lseg;
}

// Step i of segment g (row, sr) reads row-relative sample sr L - W + i:
// absolute index stage_base + i over x, for the stage starting at step s.
// Where that sample does not exist (segment 0's warm-up, a lane past the
// last segment) ZW = 1 walks zeros; ZW = 0 walks samples that exist
// instead (segment 0's warm-up: its row's first W samples; a lane past
// the last segment: the last segment's samples), so that no lane of the
// walker takes atan2f's 0/0 path while the others do not: those steps are
// discarded either way (segment 0's state is put back at step W).  The
// slot of a stage is shifted by o, the parity of its first sample's
// address in float2s, so that slot position and address agree in parity
// (tests/test_torch_pll_overlap_ring.py copy_plan mirrors it).
template <int ZW>
__device__ __forceinline__ int64_t stage_base(const Walk& w, int g, int s) {
  if (!ZW && g >= w.s_count) g = w.s_count - 1;
  const int row = g / w.seg_per_row, sr = g - row * w.seg_per_row;
  int64_t b = row * w.n_row;
  if (ZW || sr != 0 || s >= w.warm)
    b += static_cast<int64_t>(sr) * w.lseg - w.warm;
  return b;
}

template <int ZW>
__device__ __forceinline__ int slot_shift(const Walk& w, int g, int s) {
  return static_cast<int>(
      (w.x8 + static_cast<uint64_t>(stage_base<ZW>(w, g, s) + s)) & 1);
}

template <int G, int T, int P, int STORE, int ZW>
struct Ring {
  static constexpr int kXS = T + 2;   // float2s a segment's x slot
  static constexpr int kOS = T + 4;   // floats a segment's output row
  static constexpr size_t kBars = 128;
  static constexpr size_t kXBytes = size_t{P} * G * kXS * 8;
  static constexpr size_t kWBytes = size_t{P} * T * G * 8;
  static constexpr size_t kOBytes =
      STORE == 0 ? size_t{kOutStages} * 3 * G * kOS * 4 : 0;
  static constexpr size_t kSmem = kBars + kXBytes + kWBytes + kOBytes;
  static_assert(4 * P * 8 <= kBars, "barriers");
  static_assert(T % kU == 0 && T % 4 == 0, "T");
  static_assert(G >= 1 && G <= 32, "G");
};

template <int G, int T, int P, int STORE, int ZW>
__global__ void __launch_bounds__(kRoleThreads)
    scan_ring_kernel(const float2* __restrict__ x, Walk w,
                     const float* __restrict__ init, Loop k,
                     float* __restrict__ o_r, float* __restrict__ o_i,
                     float* __restrict__ o_e, float* __restrict__ snap,
                     float* __restrict__ exit_state) {
  using R = Ring<G, T, P, STORE, ZW>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* xfull = reinterpret_cast<uint64_t*>(smem);
  uint64_t* xempty = xfull + P;
  uint64_t* wfull = xempty + P;
  uint64_t* wempty = wfull + P;
  float2* xring = reinterpret_cast<float2*>(smem + R::kBars);
  float2* wring = reinterpret_cast<float2*>(smem + R::kBars + R::kXBytes);
  float* oring =
      reinterpret_cast<float*>(smem + R::kBars + R::kXBytes + R::kWBytes);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4 * P; ++i) mbar_init(xfull + i, G);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int role = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane >= G) return;
  const int g = blockIdx.x * G + lane;
  const bool valid = g < w.s_count;
  const int sr = g % w.seg_per_row;
  const int S = w.s_count;

  if (role == 0) {                                   // the copy warp
    // ZW: sr 0's warm-up is the zero padding, and a lane past the last
    // segment walks zeros
    const int zend =
        !ZW ? 0 : (!valid ? w.warm + w.lseg : (sr == 0 ? w.warm : 0));
    for (int st = 0; st < w.stages; ++st) {
      const int p = st % P;
      if (st >= P) mbar_wait(xempty + p, ((st / P) - 1) & 1);
      const int s = stage_start<T>(w, st), e = stage_end<T>(w, st);
      const int o = slot_shift<ZW>(w, g, s);
      float2* slot = xring + (p * G + lane) * R::kXS + o - s;  // [step]
      int i = s;
      for (; i < e && i < zend; ++i) slot[i] = make_float2(0.f, 0.f);
      uint32_t bytes = 0;
      if (i < e) {
        int64_t a0 = stage_base<ZW>(w, g, s) + i, a1 = a0 + (e - i);
        int j0 = i;
        if ((w.x8 + static_cast<uint64_t>(a0)) & 1) {   // 8 bytes off 16
          slot[j0++] = x[a0++];
        }
        const int64_t nb = (a1 - a0) & ~int64_t{1};
        if (a1 - a0 > nb) slot[j0 + nb] = x[a1 - 1];
        bytes = static_cast<uint32_t>(nb * 8);
        mbar_arrive_tx(xfull + p, bytes);
        if (bytes) bulk_load(slot + j0, x + a0, bytes, xfull + p);
      } else {
        mbar_arrive_tx(xfull + p, 0);
      }
    }
    return;
  }

  if (role == 1) {                                   // the walker
    float vr = init[g < S ? g : 0], vi = init[S + (g < S ? g : 0)],
          fr = init[4 * S + (g < S ? g : 0)];
    const float vr0 = vr, vi0 = vi, fr0 = fr;
    for (int st = 0; st < w.stages; ++st) {
      const int p = st % P;
      const uint32_t ph = (st / P) & 1;
      if (st == w.k0) {
        if (sr == 0) {
          vr = vr0;
          vi = vi0;
          fr = fr0;
        }
        if (valid) {
          snap[g] = vr;
          snap[S + g] = vi;
          snap[4 * S + g] = fr;
        }
      }
      const int s = stage_start<T>(w, st), n = stage_end<T>(w, st) - s;
      const float2* xs =
          xring + (p * G + lane) * R::kXS + slot_shift<ZW>(w, g, s);
      float2* ws = wring + p * T * G + lane;
      mbar_wait(xfull + p, ph);
      if (st >= P) mbar_wait(wempty + p, ph ^ 1);
      float2 xv = xs[0];
#pragma unroll 2
      for (int t = 0; t < n; ++t) {
        const float2 xn = xs[t + 1];
        float err, f2;
        v_step(xv.x, xv.y, vr, vi, fr, k, err, f2);
        ws[t * G] = make_float2(err, f2);
        xv = xn;
      }
      mbar_arrive(xempty + p);
      mbar_arrive(wfull + p);
    }
    if (valid) {
      exit_state[g] = vr;
      exit_state[S + g] = vi;
      exit_state[4 * S + g] = fr;
    }
    return;
  }

  // the oscillator
  float mr = init[2 * S + (g < S ? g : 0)], mi = init[3 * S + (g < S ? g : 0)];
  const float mr0 = mr, mi0 = mi;
  const int64_t orow = static_cast<int64_t>(g) * w.lseg;
  for (int st = 0; st < w.stages; ++st) {
    const int p = st % P;
    const uint32_t ph = (st / P) & 1;
    if (st == w.k0) {
      if (sr == 0) {
        mr = mr0;
        mi = mi0;
      }
      if (valid) {
        snap[2 * S + g] = mr;
        snap[3 * S + g] = mi;
      }
    }
    const int n = stage_end<T>(w, st) - stage_start<T>(w, st);
    const float2* ws = wring + p * T * G + lane;
    const bool out = st >= w.k0 && valid;
    const int m = st - w.k0;                          // output stage
    float* os = oring + ((m & 1) * 3 * G + lane) * R::kOS;
    float* go_r = o_r + orow + static_cast<int64_t>(m) * T;
    float* go_i = o_i + orow + static_cast<int64_t>(m) * T;
    float* go_e = o_e + orow + static_cast<int64_t>(m) * T;
    if (STORE == 0 && out && m >= kOutStages) bulk_wait_read<kOutStages - 1>();
    mbar_wait(wfull + p, ph);
    int t = 0;
    for (; t + kU <= n; t += kU) {
      float2 wv[kU];
      float sm[kU], cm[kU], vr_[kU], vi_[kU], ve_[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) wv[u] = ws[(t + u) * G];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float dm = m_inc(wv[u].x, wv[u].y, k);
        sm[u] = sinf(dm);
        cm[u] = cosf(dm);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        vr_[u] = mr;
        vi_[u] = mi;
        ve_[u] = wv[u].x;
        m_step(sm[u], cm[u], mr, mi);
      }
      if (out) {
        const float4 a = make_float4(vr_[0], vr_[1], vr_[2], vr_[3]);
        const float4 b = make_float4(vi_[0], vi_[1], vi_[2], vi_[3]);
        const float4 c = make_float4(ve_[0], ve_[1], ve_[2], ve_[3]);
        if (STORE == 0) {
          *reinterpret_cast<float4*>(os + t) = a;
          *reinterpret_cast<float4*>(os + G * R::kOS + t) = b;
          *reinterpret_cast<float4*>(os + 2 * G * R::kOS + t) = c;
        } else if (w.aligned) {
          *reinterpret_cast<float4*>(go_r + t) = a;
          *reinterpret_cast<float4*>(go_i + t) = b;
          *reinterpret_cast<float4*>(go_e + t) = c;
        } else {
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            go_r[t + u] = vr_[u];
            go_i[t + u] = vi_[u];
            go_e[t + u] = ve_[u];
          }
        }
      }
    }
    for (; t < n; ++t) {
      const float2 wv = ws[t * G];
      const float dm = m_inc(wv.x, wv.y, k);
      const float sm = sinf(dm), cm = cosf(dm);
      if (out) {
        if (STORE == 0) {
          os[t] = mr;
          os[G * R::kOS + t] = mi;
          os[2 * G * R::kOS + t] = wv.x;
        } else {
          go_r[t] = mr;
          go_i[t] = mi;
          go_e[t] = wv.x;
        }
      }
      m_step(sm, cm, mr, mi);
    }
    mbar_arrive(wempty + p);
    if (STORE == 0 && out) {
      if (w.aligned) {
        fence_proxy_async();
        bulk_store(go_r, os, n * 4);
        bulk_store(go_i, os + G * R::kOS, n * 4);
        bulk_store(go_e, os + 2 * G * R::kOS, n * 4);
      } else {
        for (int j = 0; j < n; ++j) {
          go_r[j] = os[j];
          go_i[j] = os[G * R::kOS + j];
          go_e[j] = os[2 * G * R::kOS + j];
        }
      }
      bulk_commit();
    }
  }
  if (STORE == 0) bulk_wait_all();
  if (valid) {
    exit_state[2 * S + g] = mr;
    exit_state[3 * S + g] = mi;
  }
}

int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess ? dev : -1;
}

// Raise the instance's dynamic shared memory limit, once a device.
template <int G, int T, int P, int STORE, int ZW>
cudaError_t ring_ready(int dev) {
  static bool done[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        scan_ring_kernel<G, T, P, STORE, ZW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Ring<G, T, P, STORE, ZW>::kSmem));
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  return cudaSuccess;
}

Walk make_walk(const void* x, int rows, int seg_per_row, int lseg, int warm,
               const void* o_r, const void* o_i, const void* o_e, int t) {
  Walk w;
  w.n_row = static_cast<int64_t>(seg_per_row) * lseg;
  w.x8 = reinterpret_cast<uintptr_t>(x) >> 3;
  w.seg_per_row = seg_per_row;
  w.s_count = rows * seg_per_row;
  w.lseg = lseg;
  w.warm = warm;
  w.k0 = (warm + t - 1) / t;
  w.stages = w.k0 + (lseg + t - 1) / t;
  w.aligned = lseg % 4 == 0 &&
              ((reinterpret_cast<uintptr_t>(o_r) |
                reinterpret_cast<uintptr_t>(o_i) |
                reinterpret_cast<uintptr_t>(o_e)) & 15) == 0;
  return w;
}

template <int G, int T, int P, int STORE, int ZW>
int launch_ring(const void* x, int rows, int seg_per_row, int lseg, int warm,
                const void* init, Loop k, void* o_r, void* o_i, void* o_e,
                void* snap, void* exit_state, cudaStream_t stream) {
  const cudaError_t e = ring_ready<G, T, P, STORE, ZW>(current_device());
  if (e != cudaSuccess) return static_cast<int>(e);
  const Walk w =
      make_walk(x, rows, seg_per_row, lseg, warm, o_r, o_i, o_e, T);
  const int blocks = (w.s_count + G - 1) / G;
  scan_ring_kernel<G, T, P, STORE, ZW>
      <<<blocks, kRoleThreads, Ring<G, T, P, STORE, ZW>::kSmem, stream>>>(
          static_cast<const float2*>(x), w, static_cast<const float*>(init),
          k, static_cast<float*>(o_r), static_cast<float*>(o_i),
          static_cast<float*>(o_e), static_cast<float*>(snap),
          static_cast<float*>(exit_state));
  return static_cast<int>(cudaGetLastError());
}

#ifdef LR_SCAN_SWEEP
// The register-pipelined one-thread variant, measured beside the rings
// and not shipped: one thread a segment (blocks of 32), x prefetched as
// float4s eight steps ahead, the m work of step i issued after the v work
// of step i + 1, outputs stored straight from registers.  Segment 0 walks
// its row's first W samples in the warm-up (any finite input: its state
// is put back at step W) and so reads nothing outside its row.
struct PipeState {
  float vr, vi, mr, mi, fr;
};

template <bool kOut>
__device__ __forceinline__ void pipe_range(const float2* __restrict__ xp,
                                           int n, PipeState& s, const Loop& k,
                                           float* go_r, float* go_i,
                                           float* go_e) {
  // (err, f2) of the step whose m work is still to do
  float perr = 0.f, pf2 = 0.f;
  auto m_work = [&](float err, float f2, int at) {
    const float dm = m_inc(err, f2, k);
    const float sm = sinf(dm), cm = cosf(dm);
    if (kOut) {
      go_r[at] = s.mr;
      go_i[at] = s.mi;
      go_e[at] = err;
    }
    m_step(sm, cm, s.mr, s.mi);
  };
  // step t's v work, then step t - 1's m work
  auto step = [&](float xr, float xi, int t) {
    float err, f2;
    v_step(xr, xi, s.vr, s.vi, s.fr, k, err, f2);
    if (t > 0) m_work(perr, pf2, t - 1);
    perr = err;
    pf2 = f2;
  };
  if (n == 0) return;
  // the first step alone (and a second one where x is 8 bytes off 16)
  step(xp[0].x, xp[0].y, 0);
  int t = 1;
  if (t < n && (reinterpret_cast<uintptr_t>(xp + t) & 15)) {
    step(xp[t].x, xp[t].y, t);
    ++t;
  }
  const int blocks = (n - t) / 8;
  const float4* xq = reinterpret_cast<const float4*>(xp + t);
  float4 cur[4], nxt[4];
  if (blocks > 0)
#pragma unroll
    for (int j = 0; j < 4; ++j) cur[j] = xq[j];
  for (int b = 0; b < blocks; ++b) {
    if (b + 1 < blocks)
#pragma unroll
      for (int j = 0; j < 4; ++j) nxt[j] = xq[4 * (b + 1) + j];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      step((u & 1) ? cur[u / 2].z : cur[u / 2].x,
           (u & 1) ? cur[u / 2].w : cur[u / 2].y, t + u);
#pragma unroll
    for (int j = 0; j < 4; ++j) cur[j] = nxt[j];
    t += 8;
  }
  for (; t < n; ++t) step(xp[t].x, xp[t].y, t);
  m_work(perr, pf2, n - 1);
}

__global__ void __launch_bounds__(32)
    scan_pipe_kernel(const float2* __restrict__ x, Walk w,
                     const float* __restrict__ init, Loop k,
                     float* __restrict__ o_r, float* __restrict__ o_i,
                     float* __restrict__ o_e, float* __restrict__ snap,
                     float* __restrict__ exit_state) {
  const int g = blockIdx.x * 32 + threadIdx.x;
  const int S = w.s_count;
  if (g >= S) return;
  const int row = g / w.seg_per_row, sr = g - row * w.seg_per_row;
  PipeState s{init[g], init[S + g], init[2 * S + g], init[3 * S + g],
              init[4 * S + g]};
  const PipeState s0 = s;
  const float2* xr = x + row * w.n_row;
  const float2* warm_x =
      sr == 0 ? xr : xr + static_cast<int64_t>(sr) * w.lseg - w.warm;
  pipe_range<false>(warm_x, w.warm, s, k, nullptr, nullptr, nullptr);
  if (sr == 0) s = s0;
  snap[g] = s.vr;
  snap[S + g] = s.vi;
  snap[2 * S + g] = s.mr;
  snap[3 * S + g] = s.mi;
  snap[4 * S + g] = s.fr;
  const int64_t orow = static_cast<int64_t>(g) * w.lseg;
  pipe_range<true>(xr + static_cast<int64_t>(sr) * w.lseg, w.lseg, s, k,
                   o_r + orow, o_i + orow, o_e + orow);
  exit_state[g] = s.vr;
  exit_state[S + g] = s.vi;
  exit_state[2 * S + g] = s.mr;
  exit_state[3 * S + g] = s.mi;
  exit_state[4 * S + g] = s.fr;
}
#endif  // LR_SCAN_SWEEP

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

bool bad_shape(int rows, int seg_per_row, int lseg, int warm) {
  return rows < 1 || seg_per_row < 1 || lseg < 1 || warm < 0 ||
         warm > lseg ||
         static_cast<long long>(rows) * seg_per_row > (1LL << 30) ||
         static_cast<long long>(warm) + lseg > (1LL << 30);
}

}  // namespace

extern "C" {

// x: complex64 [C, S*L] (interleaved float pairs, rows contiguous, 8-byte
// aligned); init: float32 [5, C*S] (vr, vi, mr, mi, fr; column c S + s is
// row c's segment s); the loop constants alpha, beta, fmin, fmax and
// mult; o_r, o_i, o_e: float32 [C*S, L]; snap (the state entering step W)
// and exit_state: float32 [5, C*S].  Returns the cudaError_t of the
// launch.
int lr_pll_overlap_scan(const void* x, int rows, int seg_per_row, int lseg,
                        int warm, const void* init, float alpha, float beta,
                        float fmin, float fmax, float mult, void* o_r,
                        void* o_i, void* o_e, void* snap, void* exit_state,
                        void* stream) {
  if (bad_shape(rows, seg_per_row, lseg, warm))
    return static_cast<int>(cudaErrorInvalidValue);
  const Loop k{alpha, beta, mult, fmin, fmax};
  return launch_ring<kG, kT, kP, kStore, kZeroWarm>(
      x, rows, seg_per_row, lseg, warm, init, k, o_r, o_i, o_e, snap,
      exit_state, static_cast<cudaStream_t>(stream));
}

// The shipped instance: segments a block, steps a stage, stages, store
// placement (0 bulk from shared memory, 1 straight to global memory),
// zero warm-up (1) or existing samples (0).
void lr_pll_overlap_ring(int* out5) {
  out5[0] = kG;
  out5[1] = kT;
  out5[2] = kP;
  out5[3] = kStore;
  out5[4] = kZeroWarm;
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

#ifdef LR_SCAN_SWEEP
// The measurement build's instances: (G, T, P, store, zero warm-up).
#define LR_SCAN_POINTS(X)                                              \
  X(8, 64, 2, 0, 1) X(16, 64, 2, 0, 1) X(32, 64, 2, 0, 1)              \
  X(16, 128, 2, 0, 1) X(32, 16, 2, 0, 0) X(8, 32, 2, 0, 0)             \
  X(16, 32, 2, 0, 0) X(32, 32, 2, 0, 0) X(32, 32, 4, 0, 0)             \
  X(8, 64, 2, 0, 0) X(16, 64, 2, 0, 0) X(16, 64, 4, 0, 0)              \
  X(32, 64, 2, 0, 0) X(8, 128, 2, 0, 0) X(16, 128, 2, 0, 0)            \
  X(16, 128, 4, 0, 0) X(16, 256, 2, 0, 0) X(16, 64, 2, 1, 0)           \
  X(16, 128, 2, 1, 0) X(32, 128, 2, 1, 0)

// Number of instances; lr_scan_sweep_point(i, out5) writes instance i's
// (G, T, P, store, zero warm-up).
int lr_scan_sweep_count() {
  int n = 0;
#define LR_COUNT(G, T, P, S, Z) ++n;
  LR_SCAN_POINTS(LR_COUNT)
#undef LR_COUNT
  return n;
}

void lr_scan_sweep_point(int i, int* out5) {
  int j = 0;
  out5[0] = out5[1] = out5[2] = out5[3] = out5[4] = -1;
#define LR_POINT(G, T, P, S, Z) \
  if (j++ == i) {               \
    out5[0] = G;                \
    out5[1] = T;                \
    out5[2] = P;                \
    out5[3] = S;                \
    out5[4] = Z;                \
  }
  LR_SCAN_POINTS(LR_POINT)
#undef LR_POINT
}

// Launch sweep instance i (as lr_pll_overlap_scan), or the pipelined
// one-thread variant for i == -1.
int lr_scan_sweep(int i, const void* x, int rows, int seg_per_row, int lseg,
                  int warm, const void* init, float alpha, float beta,
                  float fmin, float fmax, float mult, void* o_r, void* o_i,
                  void* o_e, void* snap, void* exit_state, void* stream) {
  if (bad_shape(rows, seg_per_row, lseg, warm))
    return static_cast<int>(cudaErrorInvalidValue);
  const Loop k{alpha, beta, mult, fmin, fmax};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (i == -1) {
    const Walk w = make_walk(x, rows, seg_per_row, lseg, warm, o_r, o_i,
                             o_e, 1);
    scan_pipe_kernel<<<(w.s_count + 31) / 32, 32, 0, s>>>(
        static_cast<const float2*>(x), w, static_cast<const float*>(init),
        k, static_cast<float*>(o_r), static_cast<float*>(o_i),
        static_cast<float*>(o_e), static_cast<float*>(snap),
        static_cast<float*>(exit_state));
    return static_cast<int>(cudaGetLastError());
  }
  int j = 0;
#define LR_LAUNCH(G, T, P, S, Z)                                        \
  if (j++ == i)                                                         \
    return launch_ring<G, T, P, S, Z>(x, rows, seg_per_row, lseg, warm, \
                                      init, k, o_r, o_i, o_e, snap,     \
                                      exit_state, s);
  LR_SCAN_POINTS(LR_LAUNCH)
#undef LR_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif  // LR_SCAN_SWEEP

const char* lr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
