// Frequency discriminator + decimating FIR for the WBFM mono receiver, one
// pass over the samples, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   K1  luaradio_tpu/ops/wbfm_pallas.py:180 make_wbfm_pallas / _kernel
//       (interleaved float32 I/Q, the flagship step's wire)
//   K2  luaradio_tpu/ops/wbfm_pallas.py:335 make_disc_fir_pallas /
//       _planar_kernel (re/im planes of a graph's complex stream)
//
// Both compute, per channel c, over the window w = [carry (K samples) | x
// (T samples)]:
//   m[i] = atan2(Im, Re)(w[i+1] * conj(w[i])) * inv_gain,   0 <= i < K-1+T
//   y[j] = sum_{q<K} h[K-1-q] * m[j*D + q],                 0 <= j < T/D
// i.e. the discriminator followed by the decimating FIR (deemphasis folded
// into h), with m kept in shared memory: one read of each sample and one
// write of each output reach device memory.
//
// What bounds each shape on an H100 (3.35 TB/s; 67 TFLOP/s fp32; mma.sync
// TF32 measured at ~320 TFLOP/s):
//   * the flagship step (8 x 4 194 304, K 640, D 8): 285 MB, 0.085 ms of
//     bytes, against 5.4 GFLOP of FIR (0.080 ms at the full fp32 rate,
//     ~3x that at the share of issue slots a CUDA-core FIR leaves for
//     FMAs) and an atan2f a sample, whose divide has a branchy slow path:
//     ~116 instructions a sample with the conj-multiply, the split and
//     the stores, issued one sample after another in a thread.  Measured
//     (scratch/wbfm_ab.py): the discriminator half alone ~0.23 ms, the FIR
//     half alone ~0.21-0.25 ms, the two together ~0.40 ms;
//   * a graph chunk (1 x 52 430, K 512, D 5): a few microseconds of work,
//     so the chain of latencies in one block (loads, the chunks'
//     discriminators, the FIR, the store) and the launch bind.
// Design:
//   * The FIR runs on the tensor cores as a 3xTF32 product
//     (mma.sync.m16n8k8): with m_p[n] = m[nD+p] (polyphase, kept in
//     shared memory) and g_p[r] = h[K-1-(rD+p)], a warp tile of 16 rows x
//     8 nt columns of outputs y[j0 + 8nt a + b] = sum_p sum_s
//     m_p[j0 + 8nt a + s] G_p[s, b], where G_p[s, b] = g_p[s - b] is a
//     Toeplitz band read straight from a zero-padded tap row (the
//     fragment of column block nt at k-step ks is the one of block 0 at
//     ks - nt, so a window of nt fragments slides along a row in
//     registers), and A[a, s] = m_p[j0 + 8nt a + s] is a Hankel window
//     read by ldmatrix.  Both operands are split x = hi + lo, hi = tf32(x)
//     (round to nearest even), and hi*hi + hi*lo + lo*hi is accumulated in
//     fp32 (lo*lo dropped: ~2^-22 relative), so the FIR keeps the 2e-5
//     tolerance that plain TF32 (~2^-11) misses.  m is split once, when
//     the discriminator writes it.  The band costs (R + 8nt - 1)/R more
//     MACs than the direct sum (20 % at K 640, D 8, nt 2).  fp32 CUDA
//     cores alone would only tie the byte bound; this is a Hopper choice,
//     not the TPU's bf16 MXU band carried over.
//   * Persistent blocks (two a SM on the flagship step) each walk a strip
//     of consecutive output tiles of one channel.  m lives in a ring of
//     polyphase rows in shared memory, la+1 chunks deep; each chunk adds
//     tile*D new m values and the next tile finds its K-1 halo there, so
//     the halo is computed once a strip and each sample is loaded once.
//   * The samples arrive in stages (two or more) by TMA: one bulk copy
//     (cp.async.bulk, completing on an mbarrier) moves a chunk's 16-byte
//     aligned sample pairs; 8-byte cp.async take the carry and an
//     unpaired head or tail, so an input 8 bytes off a 16-byte boundary
//     runs too.  K2's planes from a contiguous complex64 tensor are
//     interleaved with step 2, like K1's wire, and take the same path;
//     other strides take plain loads.
//   * One __syncthreads a chunk: in iteration q the discriminator of
//     chunk q and the FIR of tile q-la (whose chunks are all in the ring)
//     run in the same stretch, and the partial sums of a tile's k-step
//     groups are double-buffered and reduced, in a fixed order, one
//     iteration later.
//   * The tile (256 outputs with 16-wide warp tiles where the chunk has
//     work for two such tiles a SM, else 128 with 8-wide ones; 64 only
//     where those do not fit) and the strips come from (C, T, K, D) on the
//     host (ops/wbfm.py plan), so that a short chunk still spreads over
//     the SMs (82 blocks at the graph chunk, where 164 blocks of 64
//     outputs were slower: each strip recomputes its K-1 halo); shapes
//     whose two copies of the ring and taps do not fit take a compact
//     plan (one float32 copy, split in registers when a fragment is
//     loaded).
//   * The ring rows are XOR-swizzled per warp-tile width so ldmatrix
//     reads are free of bank conflicts, and a row stride of 4 mod 32
//     floats spreads the discriminator's writes.
//   * The conj-multiply uses __fmul_rn/__fadd_rn/__fsub_rn: an FMA
//     contraction there changes the last ulp of Re/Im, and near the +-pi
//     branch cut that flips m by a full turn (wbfm_pallas.py:27-29).
//     atan2f keeps the IEEE signed-zero rules.
//   * Any T with T % D == 0 runs in the kernel (the last tile is masked).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 227 * 1024;

// Complex samples of one stream: re at re[c*row + i*step], im likewise.
struct Stream {
  const float* re;
  const float* im;
  int64_t row;
  int64_t step;
};

// The launch's geometry, derived on the host from (t, k, d) and the plan
// (tile, tiles per strip, nt, stages); ops/wbfm.py _geometry mirrors it.
struct Geometry {
  int t, k, d, n_out;
  int tile;             // outputs per tile, a multiple of 64
  int tiles_per_strip;  // consecutive tiles one block walks
  int nt;               // 8-output mma columns a warp tile spans
  int r;                // taps per polyphase row, ceil(k / d)
  int ksp;              // mma k-steps per row, ceil((r + 8 nt - 1) / 8)
  int wt;               // outputs of a warp tile, 128 nt
  int nm;               // warp tiles per output tile
  int nkg;              // k-step groups per warp tile (kWarps / nm)
  int la;               // chunks a tile's window spans
  int ring;             // ring columns, (la + 1) * tile
  int rs;               // ring row stride in floats, ring + 4
  int gs;               // tap row length, 8 ksp + 8 nt
  int ss;               // stage length in samples, tile * d + 4
  int stages;           // sample stages in flight, 2 to kMaxStages
  int compact;          // 1: ring and taps kept as float32 only
  float inv_gain;
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

Geometry make_geometry(int t, int k, int d, int tile, int tiles_per_strip,
                       int nt, int stages, int compact, float inv_gain) {
  Geometry g{};
  g.t = t;
  g.k = k;
  g.d = d;
  g.n_out = t / d;
  g.tile = tile;
  g.tiles_per_strip = tiles_per_strip;
  g.nt = nt;
  g.r = ceil_div(k, d);
  g.ksp = ceil_div(g.r + 8 * nt - 1, 8);
  g.wt = 128 * nt;
  g.nm = tile >= g.wt ? tile / g.wt : 1;
  g.nkg = kWarps / g.nm;
  // a tile's window: its outputs' columns plus the taps' reach; a tile
  // narrower than a warp tile leaves the warp tile's other rows reading
  // whatever the ring holds there, and discards them
  g.la = ceil_div(min(tile, g.nm * g.wt) + 8 * g.ksp, tile);
  g.ring = (g.la + 1) * tile;
  g.rs = g.ring + 4;
  g.gs = 8 * g.ksp + 8 * nt;
  g.ss = tile * d + 4;
  g.stages = stages;
  g.compact = compact;
  g.inv_gain = inv_gain;
  return g;
}

// mbarriers (8 bytes each, padded to 32), then the sample stages, the m
// ring (hi, lo; one float32 copy when compact), the tap rows (likewise)
// and the warps' partial sums (two buffers)
size_t smem_bytes(const Geometry& g) {
  const size_t copies = g.compact ? 1 : 2;
  return sizeof(float) *
         (8 + 2 * static_cast<size_t>(g.stages) * g.ss +
          copies * g.d * g.rs + copies * g.d * g.gs +
          2 * static_cast<size_t>(kWarps) * g.wt);
}

// tf32(v): 10-bit mantissa, round to nearest even (the low 13 bits of the
// float32 cleared); the mma reads such a value exactly.
__device__ __forceinline__ float tf32_rne(float v) {
  uint32_t u = __float_as_uint(v);
  u = (u + 0xFFFu + ((u >> 13) & 1u)) & 0xFFFFE000u;
  return __uint_as_float(u);
}

// column -> float offset in a ring row.  An ldmatrix reads 8 rows of 4
// floats whose columns are 8 nt apart; XORing the bank-quad bits (2-4)
// with higher column bits puts those 8 rows on 8 distinct bank quads.
template <int kNT>
__device__ __forceinline__ int swz(int col) {
  if (kNT == 1) return col ^ (((col >> 5) & 1) << 2);
  return col ^ (((col >> 4) & 7) << 2);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// arrive (the one expected arrival) and expect `bytes` of bulk copies
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One TMA bulk copy global -> shared of `bytes` (a multiple of 16, both
// addresses 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n - 2 committed groups of this thread are in flight
// (the chunks after the one about to be read)
__device__ __forceinline__ void cp_async_wait_stages(int n) {
  switch (n) {
    case 2: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_tf32(float (&acc)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Window sample s of channel c (s < k: the carry, else x[s - k]).
__device__ __forceinline__ const float* sample_re(const Stream& carry,
                                                  const Stream& x, int c,
                                                  int64_t s, int k) {
  return s < k ? carry.re + c * carry.row + s * carry.step
               : x.re + c * x.row + (s - k) * x.step;
}

__device__ __forceinline__ float2 load_sample(const Stream& carry,
                                              const Stream& x, int c,
                                              int64_t s, int k) {
  const float* pr = sample_re(carry, x, c, s, k);
  const float* pi = s < k ? carry.im + c * carry.row + s * carry.step
                          : x.im + c * x.row + (s - k) * x.step;
  return make_float2(*pr, *pi);
}

// One k-step's tap fragment (hi, lo): B[k][n] of the Toeplitz band.
struct BFrag {
  uint32_t h0, h1, l0, l1;
};

// v = hi + lo, both tf32 (as the mma reads them)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_rne(v);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32_rne(__fsub_rn(v, h)));
}

// kMode: 0 the kernel; 1 discriminator only (loads, atan2, ring writes; no
// FIR, no output); 2 FIR only (no loads and no discriminator: the ring
// holds whatever it holds).  1 and 2 exist to time the two halves and are
// built only with -DLR_WBFM_PARTS, into a library of their own.
// kCompact keeps one float32 copy of the ring and the taps and splits
// each operand into hi and lo when it loads a fragment: half the shared
// memory, for the shapes that do not fit otherwise, at the cost of the
// splits in the FIR loop.  Both round alike, so the results agree.
template <bool kInterleaved, int kNT, int kMode, bool kCompact>
__global__ void __launch_bounds__(kThreads, 2)
disc_fir_kernel(Stream carry, Stream x, const float* __restrict__ taps,
                float* __restrict__ out, Geometry g) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float2* stages = reinterpret_cast<float2*>(smem + 8);
  constexpr int kCopies = kCompact ? 1 : 2;
  float* ring_hi = smem + 8 + 2 * g.stages * g.ss;  // m itself when compact
  float* ring_lo = ring_hi + g.d * g.rs;
  float* g_hi = ring_hi + kCopies * g.d * g.rs;     // taps when compact
  float* g_lo = g_hi + g.d * g.gs;
  float* red = g_hi + kCopies * g.d * g.gs;

  const int c = blockIdx.y;
  const int tile0 = blockIdx.x * g.tiles_per_strip;
  const int n_tiles = (g.n_out + g.tile - 1) / g.tile;
  const int ntiles = min(g.tiles_per_strip, n_tiles - tile0);
  if (ntiles <= 0) return;
  const int ts = g.tile * g.d;                     // m values a chunk
  const int64_t m0 = static_cast<int64_t>(tile0) * ts;
  const int64_t m_total = static_cast<int64_t>(g.k) - 1 + g.t;
  const int64_t w_total = static_cast<int64_t>(g.k) + g.t;
  const int n_chunks = ntiles + g.la - 1;
  // parity of the window index whose x sample sits on a 16-byte boundary
  const int par =
      kInterleaved
          ? static_cast<int>(
                ((reinterpret_cast<uintptr_t>(x.re + c * x.row) >> 3) -
                 static_cast<uintptr_t>(g.k)) & 1)
          : 0;

  if (kInterleaved && threadIdx.x == 0) {
    for (int i = 0; i < g.stages; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // chunk q: window samples [s_lo, s_hi), sample s at stage[s - sb], with
  // sb chosen so that a 16-byte aligned x sample lands 16-byte aligned
  auto chunk_bounds = [&](int q, int64_t& s_lo, int64_t& s_hi, int64_t& sb) {
    s_lo = m0 + static_cast<int64_t>(q) * ts;
    s_hi = min(s_lo + ts + 1, w_total);
    sb = s_lo - ((s_lo + par) & 1);
  };
  // Start chunk q's loads.  Interleaved: the aligned pairs of x samples
  // by one TMA bulk copy (thread 0, completing on the stage's mbarrier),
  // the carry and an unpaired head or tail by 8-byte cp.async (one
  // commit group a chunk, also when empty); both are complete after the
  // chunk's waits and the __syncthreads that follows them.  Other
  // strides: plain loads.
  auto issue = [&](int q) {
    if (kMode == 2) return;
    if (q >= n_chunks) {
      if (kInterleaved) cp_async_commit();
      return;
    }
    int64_t s_lo, s_hi, sb;
    chunk_bounds(q, s_lo, s_hi, sb);
    float2* st = stages + (q % g.stages) * g.ss;
    if (!kInterleaved) {
      for (int64_t s = s_lo + threadIdx.x; s < s_hi; s += kThreads)
        st[s - sb] = load_sample(carry, x, c, s, g.k);
      return;
    }
    const int64_t xs0 = max(s_lo, static_cast<int64_t>(g.k));
    int64_t a0 = xs0 < s_hi ? xs0 + ((xs0 + par) & 1) : s_hi;
    if (a0 > s_hi) a0 = s_hi;
    const int64_t n_pairs = (s_hi - a0) / 2;
    const int64_t a1 = a0 + 2 * n_pairs;
    // plain: [s_lo, xs0) (carry), [xs0, a0) (head), [a1, s_hi) (tail)
    const int n_carry = static_cast<int>(min(xs0, s_hi) - s_lo);
    const int n_head = static_cast<int>(a0 - min(xs0, s_hi));
    const int n_plain = max(n_carry, 0) + n_head + static_cast<int>(s_hi - a1);
    for (int u = threadIdx.x; u < n_plain; u += kThreads) {
      int64_t s;
      if (u < max(n_carry, 0) + n_head) s = s_lo + u;
      else s = a1 + (u - max(n_carry, 0) - n_head);
      cp_async8(st + (s - sb), sample_re(carry, x, c, s, g.k));
    }
    cp_async_commit();
    if (threadIdx.x == 0) {
      const uint32_t bytes = static_cast<uint32_t>(n_pairs * 16);
      mbar_arrive_tx(bars + q % g.stages, bytes);
      if (bytes) {
        // the generic-proxy reads of this stage are ordered before the
        // copy by the last __syncthreads; make them visible to the copy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_load(st + (a0 - sb), x.re + c * x.row + (a0 - g.k) * 2, bytes,
                  bars + q % g.stages);
      }
    }
  };

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int mt = warp / g.nkg, kg = warp % g.nkg;
  // this warp's k-steps [f_begin, f_end) of the D * ksp of a warp tile
  // (row p = f / ksp, k-step ks = f % ksp), an even share for any D
  const int ks_total = g.d * g.ksp;
  const int f_begin = kg * ks_total / g.nkg;
  const int f_end = (kg + 1) * ks_total / g.nkg;
  // ldmatrix: lane L gives the row address of matrix L/8, row L%8:
  // A rows a = L%8 (+8 for matrices 1, 3), columns 0-3 (+4 for 2, 3)
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = mt * g.wt + 8 * kNT * a_row + ((lane >> 4) << 2);
  const int b_off = 8 * kNT + (lane & 3) - (lane >> 2);   // pad + t - g
  const uint32_t hi_base = smem_addr(ring_hi), lo_base = smem_addr(ring_lo);
  const int64_t out_row = static_cast<int64_t>(c) * g.n_out;

  // The pipeline, one __syncthreads a chunk.  Iteration q: wait for
  // chunk q's samples; barrier; start chunk q+stages-1's loads (into the
  // stage read in iteration q-1); reduce tile q-1-la (its partial sums
  // were written in iteration q-1); the discriminator of chunk q into its
  // ring slot; the FIR of tile q-la, whose chunks were all written before
  // the barrier.  With no barrier between them, warps in the
  // discriminator (ALU) and warps in the FIR (tensor cores, shared
  // memory) overlap.  The ring holds la+1 chunks and the partial sums are
  // double-buffered, so nothing is read while it is written.
  // the first chunks' loads start before the taps are read, so that the
  // two global-memory latencies overlap (they bound a short strip)
  for (int q = 0; q + 1 < g.stages; ++q) issue(q);
  // taps: g[p][xx + 8 nt] = h[K-1-(xx*D+p)] for 0 <= xx < R, zero around
  for (int i = threadIdx.x; i < g.d * g.gs; i += kThreads) {
    const int p = i / g.gs, xx = i % g.gs - 8 * kNT;
    const int q = xx * g.d + p;
    const float v = (xx >= 0 && xx < g.r && q < g.k) ? taps[g.k - 1 - q] : 0.f;
    if (kCompact) {
      g_hi[i] = v;
    } else {
      const float hi = tf32_rne(v);
      g_hi[i] = hi;
      g_lo[i] = tf32_rne(__fsub_rn(v, hi));
    }
  }
  for (int q = 0; q < n_chunks + 2; ++q) {
    if (kInterleaved && kMode != 2 && q < n_chunks) {
      cp_async_wait_stages(g.stages);
      mbar_wait(bars + q % g.stages, (q / g.stages) & 1);
    }
    __syncthreads();
    issue(q + g.stages - 1);

    const int ir = q - 1 - g.la;
    if (kMode != 1 && ir >= 0 && ir < ntiles) {
      // reduce the k-step groups of tile ir in a fixed order and store it
      const float* rb = red + ((q - 1) & 1) * kWarps * g.wt;
      const int64_t j0 = static_cast<int64_t>(tile0 + ir) * g.tile;
      for (int o = threadIdx.x; o < g.tile; o += kThreads) {
        const int t_m = o / g.wt, within = o % g.wt;
        const float* rp = rb + t_m * g.nkg * g.wt + within;
        float y = rp[0];
        for (int u = 1; u < g.nkg; ++u) y = __fadd_rn(y, rp[u * g.wt]);
        const int64_t j = j0 + o;
        if (j < g.n_out) out[out_row + j] = y;
      }
    }

    if (kMode != 2 && q < n_chunks) {
      // discriminator over chunk q: m[m0 + q*ts + r], r < ts, into ring
      // columns q*tile + r / D (mod ring) of row r % D
      int64_t s_lo, s_hi, sb;
      chunk_bounds(q, s_lo, s_hi, sb);
      const float2* st = stages + (q % g.stages) * g.ss + (s_lo - sb);
      const int col0 = (q % (g.la + 1)) * g.tile;
      const int step_col = kThreads / g.d, step_ph = kThreads % g.d;
      int ph = threadIdx.x % g.d, col = threadIdx.x / g.d;
#pragma unroll 4
      for (int r = threadIdx.x; r < ts; r += kThreads) {
        float m = 0.f;
        if (s_lo + r < m_total) {
          const float2 p = st[r], n = st[r + 1];
          const float tre = __fadd_rn(__fmul_rn(n.x, p.x), __fmul_rn(n.y, p.y));
          const float tim = __fsub_rn(__fmul_rn(n.y, p.x), __fmul_rn(n.x, p.y));
          m = __fmul_rn(atan2f(tim, tre), g.inv_gain);
        }
        const int o = ph * g.rs + swz<kNT>(col0 + col);
        if (kCompact) {
          ring_hi[o] = m;
        } else {
          const float hi = tf32_rne(m);
          ring_hi[o] = hi;
          ring_lo[o] = tf32_rne(__fsub_rn(m, hi));
        }
        col += step_col;
        ph += step_ph;
        if (ph >= g.d) {
          ph -= g.d;
          ++col;
        }
      }
    }

    const int i = q - g.la;
    if (kMode == 1 || i < 0 || i >= ntiles) continue;

    // FIR of tile i: this warp's tile mt (16 rows x 8 kNT columns of
    // outputs) over its rows of k-steps.  The tap fragment of column
    // block nt at k-step ks is the one of block 0 at ks - nt (Toeplitz),
    // so a window of kNT fragments slides along a row.  The next k-step's
    // fragments are loaded before this k-step's mmas are issued; three
    // accumulators keep the products' chains apart.
    float acc_hh[kNT][4], acc_lh[kNT][4], acc_hl[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc_hh[nt][u] = acc_lh[nt][u] = acc_hl[nt][u] = 0.f;
    int col0 = (i % (g.la + 1)) * g.tile + a_col;   // this lane's A column
    if (col0 >= g.ring) col0 -= g.ring;
    for (int f = f_begin; f < f_end;) {
      // one row's stretch of this warp's k-steps: [ks0, ks1) of row pp
      const int pp = f / g.ksp, ks0 = f % g.ksp;
      const int ks1 = min(g.ksp, ks0 + (f_end - f));
      f += ks1 - ks0;
      const float* gh = g_hi + pp * g.gs + b_off;
      const float* gl = g_lo + pp * g.gs + b_off;
      const uint32_t rh = hi_base + 4u * static_cast<uint32_t>(pp * g.rs);
      const uint32_t rl = lo_base + 4u * static_cast<uint32_t>(pp * g.rs);
      auto bfrag = [&](int u) {
        BFrag b;
        if (kCompact) {
          split(gh[8 * u], b.h0, b.l0);
          split(gh[8 * u + 4], b.h1, b.l1);
        } else {
          b = BFrag{__float_as_uint(gh[8 * u]), __float_as_uint(gh[8 * u + 4]),
                    __float_as_uint(gl[8 * u]), __float_as_uint(gl[8 * u + 4])};
        }
        return b;
      };
      auto afrag = [&](int col, uint32_t (&ah)[4], uint32_t (&al)[4]) {
        const uint32_t off = 4u * static_cast<uint32_t>(swz<kNT>(col));
        ldmatrix_x4(rh + off, ah);
        if (kCompact) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            split(__uint_as_float(ah[u]), ah[u], al[u]);
        } else {
          ldmatrix_x4(rl + off, al);
        }
      };
      BFrag bw[kNT];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) bw[nt] = bfrag(ks0 - nt);
      int col = col0 + 8 * ks0;
      if (col >= g.ring) col -= g.ring;
      uint32_t ah[4], al[4];
      afrag(col, ah, al);
      for (int ks = ks0; ks < ks1; ++ks) {
        const bool more = ks + 1 < ks1;
        uint32_t nh[4], nl[4];
        BFrag nb;
        if (more) {
          col += 8;
          if (col >= g.ring) col -= g.ring;
          afrag(col, nh, nl);
          nb = bfrag(ks + 1);
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          mma_tf32(acc_lh[nt], al, bw[nt].h0, bw[nt].h1);
          mma_tf32(acc_hl[nt], ah, bw[nt].l0, bw[nt].l1);
          mma_tf32(acc_hh[nt], ah, bw[nt].h0, bw[nt].h1);
        }
        if (more) {
#pragma unroll
          for (int nt = kNT - 1; nt > 0; --nt) bw[nt] = bw[nt - 1];
          bw[0] = nb;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            ah[u] = nh[u];
            al[u] = nl[u];
          }
        }
      }
    }
    // C fragment of column block nt: rows gq, gq + 8, columns 8 nt + 2 tq
    // (+1) -> outputs 8 kNT row + 8 nt + 2 tq (+1)
    const int gq = lane >> 2, tq = lane & 3;
    float* w = red + (q & 1) * kWarps * g.wt + warp * g.wt;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int o0 = 8 * kNT * gq + 8 * nt + 2 * tq;
      const int o1 = o0 + 64 * kNT;
      float y[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        y[u] = __fadd_rn(acc_hh[nt][u], __fadd_rn(acc_lh[nt][u], acc_hl[nt][u]));
      *reinterpret_cast<float2*>(w + o0) = make_float2(y[0], y[1]);
      *reinterpret_cast<float2*>(w + o1) = make_float2(y[2], y[3]);
    }
  }
}

// Allow the kernel at least `smem` bytes of dynamic shared memory and
// prefer the largest shared-memory carveout, so that the planned blocks
// fit on an SM.  The attributes are set only when the size grows: they
// are not stream-ordered calls.
template <bool kInterleaved, int kNT, int kMode, bool kCompact>
cudaError_t ensure_smem(size_t smem) {
  static size_t allowed = 0;
  if (smem <= allowed) return cudaSuccess;
  auto kernel = disc_fir_kernel<kInterleaved, kNT, kMode, kCompact>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxShared));
  if (e == cudaSuccess) allowed = smem;
  return e;
}

bool bad_plan(int c, int t, int k, int d, int tile, int tiles_per_strip,
              int nt, int stages, int compact) {
  if (c <= 0 || t <= 0 || k <= 0 || d <= 0 || t % d || c > 65535 ||
      tile < 64 || tile % 64 || tiles_per_strip < 1 || stages < 2 ||
      stages > kMaxStages || (nt != 1 && nt != 2) ||
      (compact && nt != 1))
    return true;
  const int wt = 128 * nt;
  return tile > wt && (tile % wt || kWarps % (tile / wt));
}

template <bool kInterleaved, int kNT, int kMode, bool kCompact>
int launch_nt(const Stream& carry, const Stream& x, const float* taps,
              float* out, const Geometry& g, int c, cudaStream_t stream) {
  const size_t smem = smem_bytes(g);
  const cudaError_t e = ensure_smem<kInterleaved, kNT, kMode, kCompact>(smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(ceil_div(ceil_div(g.n_out, g.tile), g.tiles_per_strip), c);
  disc_fir_kernel<kInterleaved, kNT, kMode, kCompact>
      <<<grid, kThreads, smem, stream>>>(carry, x, taps, out, g);
  return static_cast<int>(cudaGetLastError());
}

// The plan as ops/wbfm.py passes it.
struct PlanArgs {
  int tile, tiles_per_strip, nt, stages, compact;
};

template <bool kInterleaved, int kMode>
int launch(const Stream& carry, const Stream& x, const float* taps,
           float* out, int c, int t, int k, int d, float inv_gain,
           const PlanArgs& pa, cudaStream_t stream) {
  if (bad_plan(c, t, k, d, pa.tile, pa.tiles_per_strip, pa.nt, pa.stages,
               pa.compact))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = make_geometry(t, k, d, pa.tile, pa.tiles_per_strip,
                                   pa.nt, pa.stages, pa.compact, inv_gain);
  if (smem_bytes(g) > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (pa.compact)
    return launch_nt<kInterleaved, 1, kMode, true>(carry, x, taps, out, g, c,
                                                   stream);
  if (pa.nt == 1)
    return launch_nt<kInterleaved, 1, kMode, false>(carry, x, taps, out, g, c,
                                                    stream);
  return launch_nt<kInterleaved, 2, kMode, false>(carry, x, taps, out, g, c,
                                                  stream);
}

// Measurement probe, not a port of anything: a kernel that does nothing,
// whose launch-to-completion time is the floor under any launch.
__global__ void empty_kernel() {}

Stream interleaved(const void* p, int64_t len) {
  const float* f = static_cast<const float*>(p);
  return Stream{f, f + 1, 2 * len, 2};
}

}  // namespace

extern "C" {

#ifndef LR_WBFM_PARTS

// K1.  carry: complex64 [C, K] (interleaved float pairs), x: float32
// [C, 2T] interleaved I/Q, taps: float32 [K], out: float32 [C, T/D];
// tile, tiles_per_strip, nt, stages and compact from ops/wbfm.py plan().
// Returns the cudaError_t of the launch.
int lr_wbfm_mono(const void* carry, const void* x, const void* taps,
                 void* out, int c, int t, int k, int d, float inv_gain,
                 int tile, int tiles_per_strip, int nt, int stages,
                 int compact, void* stream) {
  return launch<true, 0>(interleaved(carry, k), interleaved(x, t),
                         static_cast<const float*>(taps),
                         static_cast<float*>(out), c, t, k, d, inv_gain,
                         PlanArgs{tile, tiles_per_strip, nt, stages, compact},
                         static_cast<cudaStream_t>(stream));
}

// K2.  Planes given by base pointer, row stride and element step (in
// floats): carry re/im [C, K], x re/im [C, T]; out float32 [C, T/D].
// Planes interleaved with step 2 (a contiguous complex64 tensor) take the
// TMA path, any other layout plain loads.
int lr_disc_fir(const void* carry_re, const void* carry_im,
                long long carry_row, long long carry_step, const void* re,
                const void* im, long long x_row, long long x_step,
                const void* taps, void* out, int c, int t, int k, int d,
                float inv_gain, int tile, int tiles_per_strip, int nt,
                int stages, int compact, void* stream) {
  const float* cre = static_cast<const float*>(carry_re);
  const float* cim = static_cast<const float*>(carry_im);
  const float* xre = static_cast<const float*>(re);
  const float* xim = static_cast<const float*>(im);
  Stream cs{cre, cim, carry_row, carry_step};
  Stream xs{xre, xim, x_row, x_step};
  const float* h = static_cast<const float*>(taps);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PlanArgs pa{tile, tiles_per_strip, nt, stages, compact};
  const bool vec = carry_step == 2 && x_step == 2 && cim == cre + 1 &&
                   xim == xre + 1 &&
                   (reinterpret_cast<uintptr_t>(cre) & 7) == 0 &&
                   (reinterpret_cast<uintptr_t>(xre) & 7) == 0 &&
                   carry_row % 2 == 0 && x_row % 2 == 0;
  return vec ? launch<true, 0>(cs, xs, h, o, c, t, k, d, inv_gain, pa, s)
             : launch<false, 0>(cs, xs, h, o, c, t, k, d, inv_gain, pa, s);
}

// Shared memory a block takes (ops/wbfm.py smem_bytes mirrors it).
long long lr_disc_fir_smem(int k, int d, int tile, int nt, int stages,
                           int compact) {
  return static_cast<long long>(smem_bytes(
      make_geometry(d, k, d, tile, 1, nt, stages, compact, 1.f)));
}

// Blocks of the K1 kernel that fit on one SM under this plan (the CUDA
// occupancy calculator), or a negative cudaError_t.
int lr_disc_fir_occupancy(int k, int d, int tile, int nt, int stages,
                          int compact) {
  const size_t smem = smem_bytes(
      make_geometry(d, k, d, tile, 1, nt, stages, compact, 1.f));
  cudaError_t e = cudaSuccess;
  int n = 0;
  auto query = [&](auto kernel, cudaError_t allowed) {
    e = allowed;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                        smem);
  };
  if (compact)
    query(disc_fir_kernel<true, 1, 0, true>,
          ensure_smem<true, 1, 0, true>(smem));
  else if (nt == 1)
    query(disc_fir_kernel<true, 1, 0, false>,
          ensure_smem<true, 1, 0, false>(smem));
  else
    query(disc_fir_kernel<true, 2, 0, false>,
          ensure_smem<true, 2, 0, false>(smem));
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

// The empty probe kernel, one block of 32 threads.
int lr_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

#else  // LR_WBFM_PARTS

// Measurement build (-DLR_WBFM_PARTS): K1 with mode 1 (discriminator
// alone) or 2 (FIR alone); the output is not the audio.
int lr_wbfm_mono_part(const void* carry, const void* x, const void* taps,
                      void* out, int c, int t, int k, int d, float inv_gain,
                      int tile, int tiles_per_strip, int nt, int stages,
                      int compact, int mode, void* stream) {
  const Stream cs = interleaved(carry, k), xs = interleaved(x, t);
  const float* h = static_cast<const float*>(taps);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PlanArgs pa{tile, tiles_per_strip, nt, stages, compact};
  if (mode == 1)
    return launch<true, 1>(cs, xs, h, o, c, t, k, d, inv_gain, pa, s);
  if (mode == 2)
    return launch<true, 2>(cs, xs, h, o, c, t, k, d, inv_gain, pa, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

#endif  // LR_WBFM_PARTS

const char* lr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
