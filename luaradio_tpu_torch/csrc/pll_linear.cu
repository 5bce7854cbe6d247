// The PLL's linear tier (ops/pll_linear.py pll_linear) for Hopper
// (sm_90a): one launch a chunk of x complex64 [R, n], every row solved.
//
// Replaces no TPU kernel: the JAX package's pll_linear
// (luaradio_tpu/ops/pll_linear.py) is stock XLA and reaches no
// pallas_call.  It replaces the port's stock-torch body of the same
// function (pll_linear_reference: ~170 torch launches a chunk, the atan2,
// the unwrap, two cumsums, two blocked complex-GEMM recurrences, the
// guards and the output phasors as ~60 passes over [R, n]).
//
// Computes, for each row, what the twin computes from the same
// definitions (float32 data, the host's float32 loop constants):
//   theta[n] = atan2 x[n];  inc[n] = wrap(theta[n] - theta[n-1]) (n >= 1)
//   c1 = sum inc / max(n - 1, 1);  d0 = wrap(theta[0] - phi_l)
//   tau[n] = d0 + sum_{1 <= k <= n} (inc[k] - c1)
//   z_k[-1] = z0_k (f0 - c1),  z_k[n] = lam_k z_k[n-1] + w_k tau[n]   (k < 2)
//   err[n] = tau[n] - Re(vp_0 z_0[n-1] + vp_1 z_1[n-1])
//   fnew[n] = c1 + Re(vf_0 z_0[n-1] + vf_1 z_1[n-1]) + beta err[n]
//   valid = all |err| < 15/16 pi, fmin <= fnew <= fmax, |tau| < 512
//   out[n] = e^{j(phi_m - mult phi_l)} xhat[n]^mult
//            e^{j(-mult err[n] + alpha (1 - mult) sum_{k<n} err[k])}
//   the new state (phi_l, phi_m, freq) from the last sample by phasors,
// and pll_hybrid's coherence gate, |sum x[n] conj x[n-1]| > 0.05 sum |x|^2.
// The sums of tau and err and the two recurrences run in float64
// registers: walked in float32 the recurrences lose ~2x the twin's own
// rounding (its blocked products), which at a slow loop's near-equal
// eigenvalues already reaches ~1e-5 of out.
//
// What bounds it: bytes, at 20 B a sample (x read, out and err written:
// 153 MB, 0.046 ms at 3.35 TB/s for [117, 65 536]); the kernel moves ~36
// (x read twice, the increments written and read back through err's
// buffer) against ~200 instructions, and a row's tiles are solved in
// order, so what it does about both:
//   * A block walks a segment of one row in tiles of kThreads x kU
//     samples, each thread kU consecutive ones.  Tiles are staged through
//     shared memory by cp.async (each thread's run padded to kU + 1
//     slots, so the runs fall in different banks), the next tile's copies
//     in flight while one is solved, so the card reads and writes
//     consecutive samples.
//   * Pass 1 sums the increments (c1), the lag-1 products and the power,
//     and writes each increment into err's buffer.  The last pass reads
//     them back (no second atan2): the detrended phase as a block-wide
//     prefix sum, each complex recurrence as a block-wide scan of the
//     threads' kU-step aggregates with the powers lam^(kU d) (warp
//     shuffles, then the warps' ends), then each thread walks its kU
//     samples from its entering value: err, the guards, the output
//     phasor (the SFU's sine and cosine after a two-part 2 pi reduction).
//     Carries (tau, z_0, z_1, the err prefix) pass from tile to tile in
//     registers.
//   * The grid follows the shape (ops/pll_linear.py plan): a block a row
//     where the rows fill half the card or more; otherwise a row is cut
//     into segments of whole tiles, one block each, launched
//     cooperatively so that all are resident.  Then a middle pass walks
//     each segment from zero carries, a grid barrier later each block
//     combines the segments before its own in double (each segment's
//     carries are affine in its entering carries, with coefficients
//     lam^L, sum lam^i, sum sum lam^i from the host), and the last pass
//     starts from its exact entering carries.
// The loop constants come from the wrapper as float32 (the twin's
// complex64 roundings of the host's complex128 eigen decomposition); the
// powers and the segment coefficients are built here in double.

#include <cuda_runtime.h>

#include <complex>
#include <cstdint>

#ifndef LR_PLL_LIN_THREADS
#define LR_PLL_LIN_THREADS 512
#endif

namespace {

constexpr int kThreads = LR_PLL_LIN_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kU = 8;                 // consecutive samples a thread
constexpr long long kTile = static_cast<long long>(kThreads) * kU;
constexpr int kPart = 8;              // doubles of a segment's partials
constexpr int kSlots = kThreads * (kU + 1);  // a tile staged, padded
// a tile's staging in dynamic shared memory: x (then out) as float2 and
// the increments (then err) as float, each thread's kU samples in kU + 1
// slots so that the threads' runs fall in different banks; two of them,
// the next tile's copies in flight while this one is solved
constexpr int kStageBytes = kSlots * 12;
constexpr int kSmemBytes = 2 * kStageBytes;
constexpr float kTwoPi = 6.28318530717958647692f;
static_assert(kThreads % 32 == 0 && kThreads >= 64 && kWarps <= 32,
              "a block of 2-32 warps");

struct Params {
  const float2* x;        // [R, n]
  float2* out;            // [R, n]
  float* err;             // [R, n]
  float* state;           // [3, R]: phi_l, phi_m, freq
  unsigned char* flags;   // [2, R]: valid, coherent
  const float* p0;        // phi_l, phi_m, freq: element r at r * stride
  const float* m0;
  const float* f0;
  long long sp0, sm0, sf0;
  double* part;           // [2, R, segs, kPart] (segs > 1)
  unsigned long long* bar;  // [2]: arrivals, generation (segs > 1)
  long long n, seg_len;
  int rows, segs, mult;
  float alpha, beta, fmin, fmax, margin, a1m, am1;
  float2 z0c[2];
  double2 lam[2], win[2], vp[2], vf[2];
  double2 pj[2][kU];      // lam^j, j < kU
  double2 pu[2][32];      // lam^(kU (i + 1))
  double2 pw[2][32];      // lam^(32 kU (i + 1)): a warp's span
  double2 lam_l[2], g_l[2], h_l[2];  // a full segment's coefficients
};

struct Smem {
  double tau[kWarps];
  double e[kWarps];
  double2 z[2][kWarps];
  double2 pu[2][32];
  double red[4][kWarps];
  double carry[2];
  double2 zc[2];
  float c1;
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ double2 dmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a b + c
__device__ __forceinline__ double2 dmad(double2 a, double2 b, double2 c) {
  return make_double2(a.x * b.x - a.y * b.y + c.x,
                      a.x * b.y + a.y * b.x + c.y);
}

// w t + c for a real t
__device__ __forceinline__ double2 dmadr(double2 w, double t, double2 c) {
  return make_double2(w.x * t + c.x, w.y * t + c.y);
}

__device__ __forceinline__ double2 shfl_up2(double2 v, int d) {
  return make_double2(__shfl_up_sync(0xffffffffu, v.x, d),
                      __shfl_up_sync(0xffffffffu, v.y, d));
}

__device__ __forceinline__ float wrapf(float a) {
  return a - kTwoPi * rintf(a / kTwoPi);
}

__device__ __forceinline__ float2 rot(float a) {
  float s, c;
  sincosf(a, &s, &c);
  return make_float2(c, s);
}

// e^{ja} through the SFU after reducing a to [-pi, pi] (two-part 2 pi):
// within 4e-7 of sincosf's, for the output phasors
__device__ __forceinline__ float2 rot_fast(float a) {
  const float k = rintf(a * 0.159154943091895336f);
  float r = fmaf(-k, 6.28318548202514648f, a);
  r = fmaf(-k, -1.74845553e-7f, r);
  float s, c;
  __sincosf(r, &s, &c);
  return make_float2(c, s);
}

// v / max(|v|, 1e-30), and 1 where |v| is 0 (or NaN)
__device__ __forceinline__ float2 unit(float2 v) {
  float r = rhypotf(v.x, v.y);
  if (!(r <= 3.402823466e38f)) return make_float2(1.f, 0.f);
  r = fminf(r, 1e30f);
  return make_float2(v.x * r, v.y * r);
}

// Exclusive prefix of v over the block (threads in order); *total gets
// the block's sum.  sw: kWarps doubles no other scan of the same tile
// uses.
__device__ double block_excl(double v, double* sw, double* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  double inc = v;
  for (int d = 1; d < 32; d <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += o;
  }
  double ex = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) ex = 0.0;
  if (lane == 31) sw[w] = inc;
  __syncthreads();
  if (w == 0) {
    double s = lane < kWarps ? sw[lane] : 0.0;
    for (int d = 1; d < kWarps; d <<= 1) {
      const double o = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += o;
    }
    if (lane < kWarps) sw[lane] = s;
  }
  __syncthreads();
  *total = sw[kWarps - 1];
  return w > 0 ? sw[w - 1] + ex : ex;
}

// The two recurrences over the block: a[k] is the thread's kU-step
// aggregate (thread 0's walked from carry[k]); enter[k] gets the value
// entering the thread's first sample and carry[k] the value after the
// tile's last.
__device__ void block_zscan(const Params& g, Smem& sm, double2 (&a)[2],
                            double2 (&enter)[2], double2 (&carry)[2]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    for (int d = 1; d < 32; d <<= 1) {
      const double2 o = shfl_up2(a[k], d);
      if (lane >= d) a[k] = dmad(g.pu[k][d - 1], o, a[k]);
    }
    if (lane == 31) sm.z[k][w] = a[k];
  }
  __syncthreads();
  if (w == 0) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      double2 s = lane < kWarps ? sm.z[k][lane] : make_double2(0.0, 0.0);
      for (int d = 1; d < kWarps; d <<= 1) {
        const double2 o = shfl_up2(s, d);
        if (lane >= d) s = dmad(g.pw[k][d - 1], o, s);
      }
      if (lane < kWarps) sm.z[k][lane] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const double2 e = w > 0 ? sm.z[k][w - 1] : make_double2(0.0, 0.0);
    const double2 end = dmad(sm.pu[k][lane], e, a[k]);
    const double2 prev = shfl_up2(end, 1);
    enter[k] = lane > 0 ? prev : (w > 0 ? e : carry[k]);
    carry[k] = sm.z[k][kWarps - 1];
  }
}

// Sum over the block of four doubles; thread 0 gets the sums.
__device__ void block_sum4(Smem& sm, double (&v)[4]) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    for (int d = 16; d > 0; d >>= 1)
      v[i] += __shfl_xor_sync(0xffffffffu, v[i], d);
    if (lane == 0) sm.red[i][w] = v[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) {
      double s = 0.0;
      for (int j = 0; j < kWarps; ++j) s += sm.red[i][j];
      v[i] = s;
    }
  }
  __syncthreads();
}

// All blocks of the grid meet (segs > 1: the launch is cooperative, so
// every block is resident).  The last to arrive resets the count and
// moves the generation on; the others wait for the generation to move.
__device__ void grid_barrier(unsigned long long* bar,
                             unsigned long long blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned long long* gen = bar + 1;
    const unsigned long long mine = *gen;
    __threadfence();
    if (atomicAdd(bar, 1ull) == blocks - 1) {
      atomicExch(bar, 0ull);
      __threadfence();
      atomicAdd(bar + 1, 1ull);
    } else {
      while (*gen == mine) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 or 8 bytes from device to shared memory, zeros where bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for every group of this thread but the newest.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// A tile's staging: buffer i of the two.
struct Stage {
  unsigned char* base;
  __device__ float2* xs(int i) const {
    return reinterpret_cast<float2*>(base + i * kStageBytes);
  }
  __device__ float* ds(int i) const {
    return reinterpret_cast<float*>(base + i * kStageBytes +
                                    kSlots * sizeof(float2));
  }
};

// Slot of a tile's element e in the staging: thread t's samples e = kU t
// + j at (kU + 1) t + j.
__device__ __forceinline__ int slot(int e) {
  return e / kU * (kU + 1) + e % kU;
}

// Copies the tile of a row from t0 into staging buffer i, zeros past hi:
// x where kX, the increments inc where kD; each thread the elements
// t + kThreads i, so the card reads consecutive samples.
template <bool kX, bool kD>
__device__ __forceinline__ void stage_tile(const Stage& st, int i,
                                           const float2* xr, const float* inc,
                                           long long t0, long long hi) {
#pragma unroll
  for (int k = 0; k < kU; ++k) {
    const int e = threadIdx.x + kThreads * k;
    const bool in = t0 + e < hi;
    const long long n = in ? t0 + e : 0;
    if (kX) cp_async8(st.xs(i) + slot(e), xr + n, in ? 8 : 0);
    if (kD) cp_async4(st.ds(i) + slot(e), inc + n, in ? 4 : 0);
  }
}

// Pass 1 over samples [lo, hi) of a row: the increments' sum, the lag-1
// products' sum (re, im) and the power, to thread 0; each sample's
// wrapped increment (0 at n = 0) into inc[n] for the passes after.  Tiles
// are staged through shared memory (the next in flight while one is
// solved), so that the card reads and writes consecutive samples.
__device__ void pass_sums(Smem& sm, const Stage& st, const float2* xr,
                          float* inc, long long lo, long long hi,
                          double (&acc)[4]) {
  const int t = threadIdx.x;
  acc[0] = acc[1] = acc[2] = acc[3] = 0.0;
  stage_tile<true, false>(st, 0, xr, inc, lo, hi);
  cp_async_commit();
  // thread 0's sample before the tile
  float2 before = t == 0 && lo >= 1 ? xr[lo - 1] : make_float2(0.f, 0.f);
  int i = 0;
  for (long long t0 = lo; t0 < hi; t0 += kTile, i ^= 1) {
    const long long next = t0 + kTile;
    if (next < hi) stage_tile<true, false>(st, i ^ 1, xr, inc, next, hi);
    cp_async_commit();
    const float2 after =
        t == 0 && next < hi ? xr[next - 1] : make_float2(0.f, 0.f);
    cp_async_wait_prior();
    __syncthreads();
    const float2* xs = st.xs(i);
    float* ds = st.ds(i);
    float2 v[kU + 1];
    v[0] = t > 0 ? xs[(kU + 1) * t - 2] : before;
#pragma unroll
    for (int j = 0; j < kU; ++j) v[j + 1] = xs[(kU + 1) * t + j];
    const long long b = t0 + static_cast<long long>(t) * kU;
    float thp = atan2f(v[0].y, v[0].x);
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      const long long n = b + j;
      const float th = atan2f(v[j + 1].y, v[j + 1].x);
      const float d = n >= 1 && n < hi ? wrapf(th - thp) : 0.f;
      ds[(kU + 1) * t + j] = d;
      if (n < hi) {
        s[3] += v[j + 1].x * v[j + 1].x + v[j + 1].y * v[j + 1].y;
        if (n >= 1) {
          const float2 c = cmul(v[j + 1], make_float2(v[j].x, -v[j].y));
          s[0] += d;
          s[1] += c.x;
          s[2] += c.y;
        }
      }
      thp = th;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] += static_cast<double>(s[k]);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const int e = t + kThreads * k;
      if (t0 + e < hi) inc[t0 + e] = ds[slot(e)];
    }
    before = after;
  }
  block_sum4(sm, acc);
}

// Passes 2 and 3 over samples [lo, hi) of a row from the carries (tau,
// z, the err prefix s), which end as the carries after hi.  Each tile's
// increments (and, for the outputs, x) are staged through shared memory,
// the next tile's in flight while one is solved; kOut: out and err leave
// the same way (err over the increments), the guards are checked into
// *bad, and the new state written where the row ends.
template <bool kOut>
__device__ void pass_walk(const Params& g, Smem& sm, const Stage& st,
                          int row, long long lo, long long hi, float c1,
                          double& tau_c, double2 (&z_c)[2], double& s_c,
                          float2 base, bool* bad) {
  const int t = threadIdx.x;
  const float2* xr = g.x + static_cast<long long>(row) * g.n;
  float* er = g.err + static_cast<long long>(row) * g.n;
  stage_tile<kOut, true>(st, 0, xr, er, lo, hi);
  cp_async_commit();
  int buf = 0;
  for (long long t0 = lo; t0 < hi; t0 += kTile, buf ^= 1) {
    if (t0 + kTile < hi)
      stage_tile<kOut, true>(st, buf ^ 1, xr, er, t0 + kTile, hi);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    float2* xs = st.xs(buf);
    float* ds = st.ds(buf);
    const long long b = t0 + static_cast<long long>(t) * kU;
    double tau[kU];
    double tl = 0.0;
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      const long long n = b + j;
      if (n >= 1 && n < hi)
        tl += static_cast<double>(ds[(kU + 1) * t + j] - c1);
      tau[j] = tl;
    }
    double ttot;
    const double t_in = tau_c + block_excl(tl, sm.tau, &ttot);
    tau_c += ttot;
#pragma unroll
    for (int j = 0; j < kU; ++j) tau[j] += t_in;
    // the thread's kU steps from zero: w sum_j lam^(kU-1-j) tau_j (thread
    // 0's from the carry)
    double2 a[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      double2 sp = make_double2(0.0, 0.0);
#pragma unroll
      for (int j = 0; j < kU; ++j)
        sp = dmadr(g.pj[k][kU - 1 - j], tau[j], sp);
      a[k] = dmul(g.win[k], sp);
      if (t == 0) a[k] = dmad(g.pu[k][0], z_c[k], a[k]);
    }
    double2 z[2];
    block_zscan(g, sm, a, z, z_c);
    float e[kU];
    double el = 0.0;
    float fn_last = 0.f;
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      const long long n = b + j;
      const double ph = dmul(g.vp[0], z[0]).x + dmul(g.vp[1], z[1]).x;
      const double fh = dmul(g.vf[0], z[0]).x + dmul(g.vf[1], z[1]).x;
      const float ej = static_cast<float>(tau[j] - ph);
      const float fn = static_cast<float>(c1 + fh + g.beta * ej);
      if (kOut && n < hi) {
        const float tj = static_cast<float>(tau[j]);
        *bad = *bad || !(fabsf(ej) < g.margin) || !(fn <= g.fmax) ||
               !(fn >= g.fmin) || !(fabsf(tj) < 512.f);
      }
      if (n == g.n - 1) fn_last = fn;
#pragma unroll
      for (int k = 0; k < 2; ++k)
        z[k] = dmad(g.lam[k], z[k], dmadr(g.win[k], tau[j],
                                          make_double2(0.0, 0.0)));
      e[j] = n < hi ? ej : 0.f;
      el += e[j];
    }
    double etot;
    double s = s_c + block_excl(el, sm.e, &etot);
    s_c += etot;
    if (!kOut) continue;
#pragma unroll
    for (int j = 0; j < kU; ++j) {
      const long long n = b + j;
      const float small = -static_cast<float>(g.mult) * e[j] +
                          g.a1m * static_cast<float>(s);
      const float2 xh = unit(xs[(kU + 1) * t + j]);
      float2 pw = xh;
      for (int m = 1; m < g.mult; ++m) pw = cmul(pw, xh);
      const float2 o = cmul(cmul(base, pw), rot_fast(small));
      xs[(kU + 1) * t + j] = o;
      ds[(kU + 1) * t + j] = e[j];
      if (n == g.n - 1) {
        const float2 vco = cmul(xh, rot(fn_last + g.am1 * e[j]));
        const float2 osc = cmul(
            o, rot(static_cast<float>(g.mult) * fn_last + g.alpha * e[j]));
        g.state[row] = atan2f(vco.y, vco.x);
        g.state[g.rows + row] = atan2f(osc.y, osc.x);
        g.state[2 * g.rows + row] =
            fn_last != fn_last ? fn_last
                               : fminf(fmaxf(fn_last, g.fmin), g.fmax);
      }
      s += e[j];
    }
    __syncthreads();
    float2* orow = g.out + static_cast<long long>(row) * g.n;
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const int e2 = t + kThreads * k;
      if (t0 + e2 < hi) {
        orow[t0 + e2] = xs[slot(e2)];
        er[t0 + e2] = ds[slot(e2)];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) pll_linear_kernel(Params g) {
  __shared__ Smem sm;
  extern __shared__ __align__(16) unsigned char stage[];
  const Stage st{stage};
  const int row = blockIdx.x / g.segs, seg = blockIdx.x % g.segs;
  const long long lo = seg * g.seg_len;
  const long long hi = lo + g.seg_len < g.n ? lo + g.seg_len : g.n;
  const float2* xr = g.x + static_cast<long long>(row) * g.n;
  const long long blocks = static_cast<long long>(g.rows) * g.segs;
  if (threadIdx.x < 64) {
    const int k = threadIdx.x >> 5, i = threadIdx.x & 31;
    sm.pu[k][i] = g.pu[k][i];
  }

  double acc[4];
  pass_sums(sm, st, xr, g.err + static_cast<long long>(row) * g.n, lo, hi,
            acc);
  if (g.segs > 1) {
    double* mine =
        g.part + (static_cast<long long>(row) * g.segs + seg) * kPart;
    if (threadIdx.x == 0)
      for (int i = 0; i < 4; ++i) mine[i] = acc[i];
    grid_barrier(g.bar, blocks);
    if (threadIdx.x == 0) {
      const double* p = g.part + static_cast<long long>(row) * g.segs * kPart;
      for (int i = 0; i < 4; ++i) acc[i] = 0.0;
      for (int s = 0; s < g.segs; ++s)
        for (int i = 0; i < 4; ++i) acc[i] += __ldcg(p + s * kPart + i);
    }
  }
  if (threadIdx.x == 0) {
    const float c1 = static_cast<float>(acc[0]) /
                     static_cast<float>(g.n - 1 > 1 ? g.n - 1 : 1);
    sm.c1 = c1;
    if (seg == 0) {
      const float cm = hypotf(static_cast<float>(acc[1]),
                              static_cast<float>(acc[2]));
      g.flags[row] = 1;
      g.flags[g.rows + row] =
          cm > 0.05f * fmaxf(static_cast<float>(acc[3]), 1e-30f) ? 1 : 0;
    }
  }
  __syncthreads();
  const float c1 = sm.c1;
  const float p0 = g.p0[row * g.sp0], m0 = g.m0[row * g.sm0];
  const float f0 = g.f0[row * g.sf0];
  const float2 x0 = xr[0];
  // the row's entering carries: tau[0] = d0, z_k[-1] = z0_k (f0 - c1)
  double tau_c = wrapf(atan2f(x0.y, x0.x) - p0), s_c = 0.0;
  double2 z_c[2];
  for (int k = 0; k < 2; ++k)
    z_c[k] = make_double2(g.z0c[k].x * (f0 - c1), g.z0c[k].y * (f0 - c1));

  if (g.segs > 1) {
    double t2 = 0.0, s2 = 0.0;
    double2 z2[2] = {make_double2(0.0, 0.0), make_double2(0.0, 0.0)};
    pass_walk<false>(g, sm, st, row, lo, hi, c1, t2, z2, s2,
                     make_float2(0.f, 0.f), nullptr);
    double* agg =
        g.part + (blocks + static_cast<long long>(row) * g.segs + seg) * kPart;
    if (threadIdx.x == 0) {
      agg[0] = t2;
      agg[1] = z2[0].x;
      agg[2] = z2[0].y;
      agg[3] = z2[1].x;
      agg[4] = z2[1].y;
      agg[5] = s2;
    }
    grid_barrier(g.bar, blocks);
    if (threadIdx.x == 0) {
      // the carries entering this segment: the row's entering carries
      // through every segment before it, each of L = seg_len samples
      // (pass_walk from zero carries gave each one's own part)
      const double L = static_cast<double>(g.seg_len);
      const double* p =
          g.part + (blocks + static_cast<long long>(row) * g.segs) * kPart;
      for (int q = 0; q < seg; ++q) {
        const double* a = p + q * kPart;
        double ds = L * tau_c + __ldcg(a + 5);
        double2 zn[2];
        for (int k = 0; k < 2; ++k) {
          // sum err = L tau + E - Re vp (z G + w tau H)
          const double2 zgh = dmad(z_c[k], g.g_l[k],
                                   dmul(dmadr(g.win[k], tau_c,
                                              make_double2(0.0, 0.0)),
                                        g.h_l[k]));
          ds -= dmul(g.vp[k], zgh).x;
          // z' = lam^L z + w tau G + Z
          const double2 zl = dmad(
              g.lam_l[k], z_c[k],
              make_double2(__ldcg(a + 1 + 2 * k), __ldcg(a + 2 + 2 * k)));
          zn[k] = dmad(dmadr(g.win[k], tau_c, make_double2(0.0, 0.0)),
                       g.g_l[k], zl);
        }
        s_c += ds;
        tau_c += __ldcg(a);
        z_c[0] = zn[0];
        z_c[1] = zn[1];
      }
      sm.carry[0] = tau_c;
      sm.carry[1] = s_c;
      sm.zc[0] = z_c[0];
      sm.zc[1] = z_c[1];
    }
    __syncthreads();
    tau_c = sm.carry[0];
    s_c = sm.carry[1];
    z_c[0] = sm.zc[0];
    z_c[1] = sm.zc[1];
  }

  bool bad = false;
  pass_walk<true>(g, sm, st, row, lo, hi, c1, tau_c, z_c, s_c,
                  rot(m0 - static_cast<float>(g.mult) * p0), &bad);
  if (__syncthreads_or(bad) && threadIdx.x == 0) g.flags[row] = 0;
}

}  // namespace

extern "C" {

// One chunk of R rows of n samples: x complex64 [R, n]; the state leaves
// float32, element r of each at p0[r sp0] (a stride 0 shares one value);
// writes out complex64 [R, n], err float32 [R, n], state float32 [3, R]
// and flags uint8 [2, R], on ``stream`` of card ``device``.  segs and
// seg_len (a whole number of tiles where segs > 1) from ops/pll_linear.py
// plan(); part float64 [2 R segs kPart] and bar uint64 [2] (zero before
// the first launch; each launch leaves them so) only where segs > 1.  k:
// float32 alpha, beta, fmin, fmax, margin, alpha (1 - mult), alpha - 1,
// then (re, im) of lam_0, lam_1, w_0, w_1, z0_0, z0_1, vp_0, vp_1, vf_0,
// vf_1.  Returns the cudaError_t of the launch.
int lr_pll_linear(const void* x, void* out, void* err, void* state,
                  void* flags, const void* p0, long long sp0, const void* m0,
                  long long sm0, const void* f0, long long sf0, void* part,
                  void* bar, long long n, long long seg_len, int rows,
                  int segs, int mult, const float* k, int device,
                  void* stream) {
  if (n < 1 || rows < 1 || segs < 1 || mult < 1 ||
      (segs > 1 && seg_len % kTile != 0) || seg_len * segs < n)
    return static_cast<int>(cudaErrorInvalidValue);
  Params g;
  g.x = static_cast<const float2*>(x);
  g.out = static_cast<float2*>(out);
  g.err = static_cast<float*>(err);
  g.state = static_cast<float*>(state);
  g.flags = static_cast<unsigned char*>(flags);
  g.p0 = static_cast<const float*>(p0);
  g.m0 = static_cast<const float*>(m0);
  g.f0 = static_cast<const float*>(f0);
  g.sp0 = sp0;
  g.sm0 = sm0;
  g.sf0 = sf0;
  g.part = static_cast<double*>(part);
  g.bar = static_cast<unsigned long long*>(bar);
  g.n = n;
  g.seg_len = seg_len;
  g.rows = rows;
  g.segs = segs;
  g.mult = mult;
  g.alpha = k[0];
  g.beta = k[1];
  g.fmin = k[2];
  g.fmax = k[3];
  g.margin = k[4];
  g.a1m = k[5];
  g.am1 = k[6];
  const auto pair = [k](int i, int j) {
    return make_double2(k[7 + 4 * i + 2 * j], k[8 + 4 * i + 2 * j]);
  };
  for (int j = 0; j < 2; ++j) {
    g.lam[j] = pair(0, j);
    g.win[j] = pair(1, j);
    g.z0c[j] = make_float2(k[15 + 2 * j], k[16 + 2 * j]);
    g.vp[j] = pair(3, j);
    g.vf[j] = pair(4, j);
  }
  using cd = std::complex<double>;
  for (int j = 0; j < 2; ++j) {
    const cd lam(g.lam[j].x, g.lam[j].y);
    cd step = 1.0, p = 1.0;
    for (int i = 0; i < kU; ++i) {
      g.pj[j][i] = make_double2(step.real(), step.imag());
      step *= lam;
    }
    for (int i = 0; i < 32; ++i) {
      p *= step;
      g.pu[j][i] = make_double2(p.real(), p.imag());
    }
    const cd warp = p;  // lam^(32 kU)
    p = 1.0;
    for (int i = 0; i < 32; ++i) {
      p *= warp;
      g.pw[j][i] = make_double2(p.real(), p.imag());
    }
    // a full segment's coefficients: lam^L, sum_{i<L} lam^i and
    // sum_{i<L} sum_{m<i} lam^m
    cd pl = 1.0, gs = 0.0, hs = 0.0;
    for (long long i = 0; segs > 1 && i < seg_len; ++i) {
      hs += gs;
      gs += pl;
      pl *= lam;
    }
    g.lam_l[j] = make_double2(pl.real(), pl.imag());
    g.g_l[j] = make_double2(gs.real(), gs.imag());
    g.h_l[j] = make_double2(hs.real(), hs.imag());
  }
  // launch on ``device`` (the tensors' card), the caller's current card
  // restored after
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  static bool allowed[64] = {};
  if (device < 0 || device >= 64) {
    e = cudaErrorInvalidDevice;
  } else if (!allowed[device]) {
    e = cudaFuncSetAttribute(pll_linear_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    allowed[device] = e == cudaSuccess;
  }
  const unsigned grid = static_cast<unsigned>(rows) * segs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (e != cudaSuccess) {
  } else if (segs > 1) {
    void* args[] = {&g};
    e = cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(pll_linear_kernel), dim3(grid),
        dim3(kThreads), args, kSmemBytes, s);
  } else {
    pll_linear_kernel<<<grid, kThreads, kSmemBytes, s>>>(g);
    e = cudaGetLastError();
  }
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (e == cudaSuccess) e = back;
  }
  return static_cast<int>(e);
}

// Samples a tile covers (kThreads x kU): a segment's length is a multiple.
int lr_pll_linear_tile() { return static_cast<int>(kTile); }

const char* lr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
