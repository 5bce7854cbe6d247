// The roofline probes of the measurement harness, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX system's roofline
// harness (bench_roofline.py at the repo root):
//   R1  measure_hbm_copy(double_buffered=False) -> kern (:93), the serial
//       body: per grid step one tile copied in (start(); wait()) and
//       written out, the write-back running beside the next step;
//   R2  measure_hbm_copy(double_buffered=True) -> kern (:72), a 2-slot ring
//       of async copies: the load of tile i+1 in flight while tile i is
//       written out;
//   R3  measure_vpu_atan2 -> kern (:155): per column tile of `tile`
//       samples, atan2(first half, second half).
//
// What they compute:
//   R1, R2: out = x, for x float32 [C, 2T] contiguous (a flat copy of
//           C * 2T floats);
//   R3:     for x float32 [C, 2T] and each column tile j of `tile` columns,
//           out[c, j h + i] = atan2f(x[c, j tile + i], x[c, j tile + h + i])
//           with h = tile / 2, 0 <= i < h: out float32 [C, T].
//
// What bounds them on an H100: bytes.  R1/R2 move 2 x C * 2T * 4 bytes
// (536.9 MB at [8, 2^23]: 0.160 ms at 3.35 TB/s) and compute nothing.  R3
// reads C * 2T * 4 bytes and writes C * T * 4 (402.7 MB at [8, 2^23]:
// 0.120 ms) against one atan2f a sample (2^25 of them, ~0.015 ms at the
// 67 TFLOP/s fp32 rate even at 30 operations each).
//
// Design of the copies.  The TPU tile, [8, 2^15] float32 = 1 MiB, does
// not fit in an SM's 227 KB of shared memory, so the copies stage flat
// slabs of the row-major array.  Both are one kernel, copy_ring_kernel:
//   * Persistent CTAs: the grid is a fixed number of CTAs an SM (the
//     occupancy and SM count queried once a device and cached).  A CTA's
//     first slab is blockIdx.x; it claims each later one from a counter
//     in device memory (atomicAdd) once its ring can take it, so a CTA
//     on a faster SM takes more slabs.  Dealt round robin instead, the CTAs of one launch ended up
//     to 1.6x apart (%globaltimer trace at [8, 2^23]), and a launch is as
//     slow as its slowest CTA; the first port of R1, one CTA a slab, left
//     that balance to the hardware but paid for 8 192 CTAs.
//   * The counters stay at zero between launches: the last CTA to finish
//     (a second counter counts them) resets both, so a launch needs no
//     memset (2.7 us of device time a launch when measured); only a new
//     pair is zeroed first (ops/roofline.py keeps a pair per stream and
//     per graph capture, whose launches run one after another).
//   * A ring of kStages stages of kStage bytes in dynamic shared memory.
//     Stage j % kStages holds the CTA's j-th slab (its number beside it in
//     slab_of, -1 when the loader has no more).  Its "full" mbarrier
//     completes when the TMA bulk load has landed (complete_tx; the
//     waiters' parity is (j / kStages) & 1); its "empty" mbarrier when the
//     store of the slab before has read it (the loader waits for that
//     stage's previous use, parity (j / kStages - 1) & 1).
//   * Warp specialisation: lane 0 of warp 0 claims and loads (at most
//     kAhead loads in flight: before load j it waits for load j - kAhead
//     to land); lane 0 of warp 1 waits on "full", issues the bulk store
//     in a bulk group of its own, and once cp.async.bulk.wait_group.read
//     shows that all but its newest kLag = kStages - kAhead - 1 stores
//     have read their stages, hands the oldest one back.  So no load waits
//     behind a store's read of shared memory: the first port of R2 drove
//     both from one thread, which could not issue load j + 1 until store
//     j - 1 had read its stage, and blocked on load j before it issued
//     store j.
//   * R1 is the ring with kAhead = 1: a CTA issues the load of slab j + 1
//     only after slab j's load has landed, the TPU body's start(); wait(),
//     while stores of earlier slabs may still be in flight, as Pallas
//     writes an output block back during the next grid step.  R2 keeps
//     kAhead = kStages - 1 >= 2 loads in flight ahead of its stores: the
//     TPU's 2-slot ring, deeper.
//   * An L2 evict-first policy (createpolicy ... L2::evict_first) on both
//     bulk copies where the instance asks for it: the data is never read
//     again (it moved no point of the sweep by more than its noise).
//   * A tail that is not a multiple of 16 bytes (at most three floats, at
//     the array's end) is copied by plain loads and stores; the copies
//     need a 16-byte aligned start (the wrapper checks it).
//   * The constants (kR1*, kR2* below) are the winners of a sweep by
//     device time at [8, 2^23] beside copy_ (scratch/roofline_ab.py over
//     the measurement build -DLR_ROOFLINE_SWEEP, which instantiates every
//     point; PERF.md).  What bounds them is the card's HBM rate, as
//     copy_'s: their CTAs copy at ~3.1 TB/s between the first load and
//     the last store; the fill and drain of the pipeline around that
//     costs a few microseconds a launch.
//   Given a trace buffer, the ring records %globaltimer at four points a
//   slab, and the CTA: load issued, load landed, store issued, store read
//   (ops/roofline.py ring_overlap reads the overlap from them).
//
// R3: a thread takes four consecutive outputs of one half tile (float4
// loads of both halves and a float4 store, coalesced) when the half tile
// is a multiple of four, else one; a grid-stride loop of CTAs of 256
// threads.  CUDA atan2f keeps IEEE signed zeros and infinities (the TPU
// kernel's polynomial _atan2 is a workaround the port does not carry).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// The shipped rings: stage KiB, stages, CTAs an SM, L2 evict-first hint,
// slabs claimed from a counter (else dealt round robin).
constexpr int kR1StageKiB = 32, kR1Stages = 3, kR1CtasPerSm = 2;
constexpr bool kR1EvictFirst = true, kR1Dynamic = true;
constexpr int kR2StageKiB = 16, kR2Stages = 4, kR2CtasPerSm = 1;
constexpr bool kR2EvictFirst = true, kR2Dynamic = true;

constexpr int kRingThreads = 64;          // warp 0 loads, warp 1 stores
constexpr int kAtanThreads = 256;
constexpr int kMaxDevices = 64;
#ifdef LR_ROOFLINE_SWEEP
constexpr uint64_t kHangNs = 4000000000ull;  // a wait this long is a fault
#endif

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
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

__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
      "selp.u32 %0, 1, 0, P1;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
#ifdef LR_ROOFLINE_SWEEP
  const uint64_t t0 = now_ns();
  while (!mbar_try(bar, parity))
    if (now_ns() - t0 > kHangNs) __trap();
#else
  while (!mbar_try(bar, parity)) {
  }
#endif
}

template <bool kEvictFirst>
__device__ __forceinline__ uint64_t l2_policy() {
  uint64_t p = 0;
  if constexpr (kEvictFirst)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(p));
  return p;
}

// TMA bulk copy global -> shared of `bytes` (a multiple of 16, both
// addresses 16-byte aligned), completing on `bar`.
template <bool kEvictFirst>
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          uint64_t policy) {
  if constexpr (kEvictFirst)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
        "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

// TMA bulk copy shared -> global, in the thread's current bulk group.
template <bool kEvictFirst>
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes, uint64_t policy) {
  if constexpr (kEvictFirst)
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint "
        "[%0], [%1], %2, %3;\n" ::"l"(dst),
        "r"(smem_addr(src)), "r"(bytes), "l"(policy)
        : "memory");
  else
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            dst),
        "r"(smem_addr(src)), "r"(bytes)
        : "memory");
}

// Close the thread's bulk group (an empty one where nothing was issued).
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until all but the newest N bulk groups have read their source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Bytes of slab s that the bulk copies move (a multiple of 16), for an
// array of `nbytes`.
template <int64_t kStage>
__device__ __forceinline__ uint32_t slab_bytes(int64_t s, int64_t nbytes) {
  const int64_t left = nbytes - s * kStage;
  return static_cast<uint32_t>((left < kStage ? left : kStage) &
                               ~int64_t{15});
}

// The last few bytes past the last multiple of 16 (floats, so 0-12).
__device__ __forceinline__ void copy_tail(const char* src, char* dst,
                                          int64_t nbytes) {
  const int64_t start = nbytes & ~int64_t{15};
  for (int64_t b = start; b < nbytes; b += 4)
    *reinterpret_cast<float*>(dst + b) =
        *reinterpret_cast<const float*>(src + b);
}

// R1 (kAhead 1) and R2 (kAhead kStages - 1): persistent CTAs over a ring
// of kStages stages of kStageKiB KiB.  A CTA's first slab is blockIdx.x.
// kDynamic: each later one is gridDim.x + a claim from the counter
// claims[0] (zero at launch) by atomicAdd, made once the ring can take
// the slab, and the last CTA to finish (claims[1] counts them) puts both
// counters back to zero; else its j-th slab is blockIdx.x + j *
// gridDim.x.  The loader writes each stage's slab beside it (-1: no
// more) before it arrives on "full".
// trace (or null): 5 uint64 a slab, at slab s: [load issued, load landed,
// store issued, store read, the CTA].
template <int kStageKiB, int kStages, int kAhead, bool kEvictFirst,
          bool kDynamic>
__global__ void __launch_bounds__(kRingThreads)
    copy_ring_kernel(const char* __restrict__ src, char* __restrict__ dst,
                     int64_t nbytes, int64_t n_slabs,
                     unsigned long long* __restrict__ claims,
                     unsigned long long* __restrict__ trace) {
  constexpr int64_t kStage = int64_t{kStageKiB} * 1024;
  constexpr int kLag = kStages - kAhead - 1;   // stores left reading
  static_assert(kAhead >= 1 && kLag >= 0, "a ring needs a stage a store");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ int64_t slab_of[kStages];
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(full + i);
      mbar_init(empty + i);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x % 32) return;
  const uint64_t policy = l2_policy<kEvictFirst>();

  if (threadIdx.x == 0) {                      // the loader
    int64_t s = blockIdx.x;                    // the CTA's first slab
    for (int64_t j = 0;; ++j) {
      const int stage = static_cast<int>(j % kStages);
      if (j >= kStages)                        // the stage's last store read
        mbar_wait(empty + stage, static_cast<uint32_t>((j / kStages - 1) & 1));
      if (j >= kAhead) {                       // at most kAhead in flight
        const int64_t i = j - kAhead;
        mbar_wait(full + i % kStages, static_cast<uint32_t>((i / kStages) & 1));
      }
      if (j > 0 && kDynamic)                   // claim the next slab
        s = gridDim.x + static_cast<int64_t>(atomicAdd(claims, 1ull));
      else if (j > 0)
        s += gridDim.x;
      if (s >= n_slabs) {                      // no more: tell the storer
        slab_of[stage] = -1;
        mbar_arrive_tx(full + stage, 0);
        return;
      }
      const uint32_t bytes = slab_bytes<kStage>(s, nbytes);
      if (trace) {
        trace[5 * s] = now_ns();
        trace[5 * s + 4] = blockIdx.x;
      }
      slab_of[stage] = s;
      mbar_arrive_tx(full + stage, bytes);
      if (bytes)
        bulk_load<kEvictFirst>(smem + stage * kStage, src + s * kStage, bytes,
                               full + stage, policy);
    }
  }

  // the storer: lane 0 of warp 1
  if (blockIdx.x == 0) copy_tail(src, dst, nbytes);
  auto read = [&](int64_t i) {                 // store i has read its stage
    const int64_t s = slab_of[i % kStages];
    if (trace && slab_bytes<kStage>(s, nbytes)) trace[5 * s + 3] = now_ns();
  };
  int64_t j = 0;
  for (;; ++j) {
    const int stage = static_cast<int>(j % kStages);
    mbar_wait(full + stage, static_cast<uint32_t>((j / kStages) & 1));
    const int64_t s = slab_of[stage];
    if (s < 0) break;
    if (trace) trace[5 * s + 1] = now_ns();
    const uint32_t bytes = slab_bytes<kStage>(s, nbytes);
    if (bytes) {
      if (trace) trace[5 * s + 2] = now_ns();
      bulk_store<kEvictFirst>(dst + s * kStage, smem + stage * kStage, bytes,
                              policy);
    }
    bulk_commit();
    bulk_wait_read<kLag>();
    if (j >= kLag) {                           // hand store j - kLag's back
      read(j - kLag);
      mbar_arrive(empty + (j - kLag) % kStages);
    }
  }
  // Every claim of this CTA came before its loader's end, which the
  // storer has seen: the last CTA here finds no claim still to come.
  if (kDynamic && atomicAdd(claims + 1, 1ull) == gridDim.x - 1) {
    atomicExch(claims, 0ull);
    atomicExch(claims + 1, 0ull);
  }
  bulk_wait_read<0>();
  for (int64_t i = j > kLag ? j - kLag : 0; i < j; ++i) read(i);
}

// R3.  x float32 [c, 2t] rows contiguous, out float32 [c, t]; V outputs a
// thread (4 where h % 4 == 0).
template <int V>
__global__ void __launch_bounds__(kAtanThreads)
    atan2_halves_kernel(const float* __restrict__ x, float* __restrict__ out,
                        int64_t c, int64_t t, int64_t h) {
  const int64_t groups = c * t / V;
  for (int64_t g = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       g < groups; g += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t o = g * V;                 // flat output index
    const int64_t row = o / t, col = o - row * t;
    const int64_t tile = col / h, i = col - tile * h;
    const float* y = x + row * 2 * t + tile * 2 * h + i;
    const float* xx = y + h;
    if constexpr (V == 4) {
      const float4 a = *reinterpret_cast<const float4*>(y);
      const float4 b = *reinterpret_cast<const float4*>(xx);
      *reinterpret_cast<float4*>(out + o) =
          make_float4(atan2f(a.x, b.x), atan2f(a.y, b.y), atan2f(a.z, b.z),
                      atan2f(a.w, b.w));
    } else {
      out[o] = atan2f(*y, *xx);
    }
  }
}

int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess ? dev : -1;
}

// The SMs of device `dev`, queried once (0 where the query fails).
int sm_count(int dev) {
  static int cached[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return 0;
  if (cached[dev] == 0 &&
      cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    cached[dev] = 0;
  return cached[dev];
}

// CTAs of a ring instance an SM of device `dev` holds by its shared
// memory, queried once a device (the dynamic shared memory limit raised
// first); -1 where the query fails.
template <int kStageKiB, int kStages, int kAhead, bool kEvictFirst,
          bool kDynamic>
int ring_fit(int dev) {
  static int cached[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return -1;
  if (cached[dev] == 0) {
    auto kern =
        copy_ring_kernel<kStageKiB, kStages, kAhead, kEvictFirst, kDynamic>;
    const int smem = kStages * kStageKiB * 1024;
    int per_sm = 0;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kern, kRingThreads, smem) != cudaSuccess)
      return -1;
    cached[dev] = per_sm > 0 ? per_sm : -1;
  }
  return cached[dev];
}

// Launch a ring instance at `ctas_per_sm` CTAs an SM (capped at the
// slabs); cudaErrorInvalidConfiguration where the SM does not hold them.
// claims: 16 bytes of device memory for the two counters (kDynamic), zero
// unless `zero_claims`, which zeroes them first.
template <int kStageKiB, int kStages, int kAhead, bool kEvictFirst,
          bool kDynamic>
int launch_ring(const void* src, void* dst, int64_t nbytes, int ctas_per_sm,
                void* claims, int zero_claims, void* trace,
                cudaStream_t stream) {
  const int dev = current_device();
  const int fit =
      ring_fit<kStageKiB, kStages, kAhead, kEvictFirst, kDynamic>(dev);
  if (fit < 1 || ctas_per_sm < 1 || ctas_per_sm > fit)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (kDynamic && !claims) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t stage = int64_t{kStageKiB} * 1024;
  const int64_t n_slabs = (nbytes + stage - 1) / stage;
  int64_t grid = int64_t{ctas_per_sm} * sm_count(dev);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (grid > n_slabs) grid = n_slabs;
  if (kDynamic && zero_claims) {
    const cudaError_t e = cudaMemsetAsync(claims, 0, 16, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  copy_ring_kernel<kStageKiB, kStages, kAhead, kEvictFirst, kDynamic>
      <<<static_cast<unsigned>(grid), kRingThreads, kStages * stage,
         stream>>>(static_cast<const char*>(src), static_cast<char*>(dst),
                   nbytes, n_slabs,
                   static_cast<unsigned long long*>(claims),
                   static_cast<unsigned long long*>(trace));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// R1 (double_buffered 0) or R2 (1): dst = src, `nbytes` (a multiple of
// 4), both 16-byte aligned.  claims: 8 bytes of device memory for the
// slab counter (the launch zeroes them).  trace: null, or 5 uint64 per
// slab of the kernel's stage (kR1StageKiB or kR2StageKiB KiB).  Returns
// the cudaError_t of the launch.
int lr_hbm_copy(const void* src, void* dst, long long nbytes,
                int double_buffered, void* claims, int zero_claims,
                void* trace, void* stream) {
  if (nbytes < 0 || nbytes % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (nbytes == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!double_buffered)
    return launch_ring<kR1StageKiB, kR1Stages, 1, kR1EvictFirst, kR1Dynamic>(
        src, dst, nbytes, kR1CtasPerSm, claims, zero_claims, trace, s);
  return launch_ring<kR2StageKiB, kR2Stages, kR2Stages - 1, kR2EvictFirst,
                     kR2Dynamic>(src, dst, nbytes, kR2CtasPerSm, claims,
                                 zero_claims, trace, s);
}

// The id of the capture `stream` is in (cudaStreamGetCaptureInfo), 0 where
// it is not capturing.
unsigned long long lr_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                               &id) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive)
    return 0;
  return id;
}

// R2's grid on the current device: the persistent CTAs it launches on an
// array of at least that many slabs; -1 where the queries fail.
int lr_hbm_copy_ring_ctas() {
  const int dev = current_device();
  const int fit = ring_fit<kR2StageKiB, kR2Stages, kR2Stages - 1,
                           kR2EvictFirst, kR2Dynamic>(dev);
  if (fit < kR2CtasPerSm || sm_count(dev) < 1) return -1;
  return kR2CtasPerSm * sm_count(dev);
}

// R3.  x float32 [c, 2t], out float32 [c, t], tile even and dividing 2t;
// x and out 16-byte aligned.  Returns the cudaError_t of the launch.
int lr_atan2_halves(const void* x, void* out, long long c, long long t,
                    long long tile, void* stream) {
  if (c < 0 || t < 0 || tile < 2 || tile % 2 || (2 * t) % tile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (c * t == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t h = tile / 2;
  const bool vec = h % 4 == 0;
  const int64_t groups = c * t / (vec ? 4 : 1);
  int64_t blocks = (groups + kAtanThreads - 1) / kAtanThreads;
  const int sms = sm_count(current_device());
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 132) * 16;
  if (blocks > cap) blocks = cap;
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  if (vec)
    atan2_halves_kernel<4><<<static_cast<unsigned>(blocks), kAtanThreads, 0,
                             s>>>(xp, op, c, t, h);
  else
    atan2_halves_kernel<1><<<static_cast<unsigned>(blocks), kAtanThreads, 0,
                             s>>>(xp, op, c, t, h);
  return static_cast<int>(cudaGetLastError());
}

#ifdef LR_ROOFLINE_SWEEP
// The measurement build's instances: (stage KiB, stages, loads ahead, L2
// hint, dynamic claims).
#define LR_RING_POINT(X, S, N, P) \
  X(S, N, P, 0, 0) X(S, N, P, 1, 0) X(S, N, P, 0, 1) X(S, N, P, 1, 1)
#define LR_RING_POINTS(X)                                                   \
  LR_RING_POINT(X, 8, 4, 1) LR_RING_POINT(X, 8, 4, 3)                       \
  LR_RING_POINT(X, 8, 8, 7) LR_RING_POINT(X, 16, 2, 1)                      \
  LR_RING_POINT(X, 16, 3, 1) LR_RING_POINT(X, 16, 3, 2)                     \
  LR_RING_POINT(X, 16, 4, 1) LR_RING_POINT(X, 16, 4, 3)                     \
  LR_RING_POINT(X, 16, 6, 1) LR_RING_POINT(X, 16, 6, 5)                     \
  LR_RING_POINT(X, 32, 2, 1) LR_RING_POINT(X, 32, 3, 1)                     \
  LR_RING_POINT(X, 32, 3, 2) LR_RING_POINT(X, 32, 4, 1)                     \
  LR_RING_POINT(X, 32, 4, 3) LR_RING_POINT(X, 32, 6, 1)                     \
  LR_RING_POINT(X, 32, 6, 5) LR_RING_POINT(X, 64, 2, 1)                     \
  LR_RING_POINT(X, 64, 3, 1) LR_RING_POINT(X, 64, 3, 2)

// The copy by one instance of the ring at `ctas_per_sm` CTAs an SM;
// cudaErrorInvalidValue where the build has no such instance.
int lr_hbm_copy_variant(const void* src, void* dst, long long nbytes,
                        int stage_kib, int stages, int ahead, int evict_first,
                        int dynamic, int ctas_per_sm, void* claims,
                        int zero_claims, void* trace, void* stream) {
  if (nbytes < 0 || nbytes % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (nbytes == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LR_RING_CASE(S, N, P, H, D)                                      \
  if (stage_kib == S && stages == N && ahead == P && evict_first == H && \
      dynamic == D)                                                      \
    return launch_ring<S, N, P, (H) != 0, (D) != 0>(                     \
        src, dst, nbytes, ctas_per_sm, claims, zero_claims, trace, s);
  LR_RING_POINTS(LR_RING_CASE)
#undef LR_RING_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// CTAs of an instance an SM holds on the current device; 0 where the
// build has no such instance, -1 where the query fails.
int lr_hbm_copy_variant_fit(int stage_kib, int stages, int ahead,
                            int evict_first, int dynamic) {
  const int dev = current_device();
#define LR_RING_FIT(S, N, P, H, D)                                       \
  if (stage_kib == S && stages == N && ahead == P && evict_first == H && \
      dynamic == D)                                                      \
    return ring_fit<S, N, P, (H) != 0, (D) != 0>(dev);
  LR_RING_POINTS(LR_RING_FIT)
#undef LR_RING_FIT
  return 0;
}

// The instances of the build, 5 ints each (stage KiB, stages, loads
// ahead, hint, dynamic), into `out` (room for `cap` of them); returns
// their number.
int lr_hbm_copy_variants(int* out, int cap) {
  int n = 0;
#define LR_RING_LIST(S, N, P, H, D)                                    \
  if (n < cap) {                                                       \
    const int v[5] = {S, N, P, H, D};                                  \
    for (int i = 0; i < 5; ++i) out[5 * n + i] = v[i];                 \
  }                                                                    \
  ++n;
  LR_RING_POINTS(LR_RING_LIST)
#undef LR_RING_LIST
  return n;
}
#endif  // LR_ROOFLINE_SWEEP

const char* lr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
