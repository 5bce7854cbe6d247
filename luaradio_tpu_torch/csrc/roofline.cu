// The roofline probes of the measurement harness, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX system's roofline
// harness (bench_roofline.py at the repo root):
//   R1  measure_hbm_copy(double_buffered=False) -> kern (:93), the serial
//       body: one tile copied in, waited for, written out, per grid step;
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
// Design.  The TPU tile, [8, 2^15] float32 = 1 MiB, does not fit in an
// SM's 227 KB of shared memory, so the copies stage flat slabs of kSlab =
// 32 KiB (8 192 floats) of the row-major array:
//   * R1, serial: one CTA a slab.  Thread 0 loads it into shared memory by
//     one TMA bulk copy (cp.async.bulk, completing on an mbarrier), waits,
//     stores it back by one bulk copy (cp.async.bulk ... bulk_group) and
//     waits for the store to have read shared memory before the CTA ends:
//     one copy in flight a CTA.  Six CTAs fit an SM by shared memory.
//   * R2, double-buffered: persistent CTAs (as many as fit on the card at
//     once, by the occupancy calculator), each walking slabs blockIdx.x,
//     blockIdx.x + gridDim.x, ... through a 2-stage ring.  Iteration j:
//     wait until the store of slab j-1 has read its stage; start the load
//     of slab j+1 into that stage; wait for the load of slab j; start the
//     store of slab j.  So the load of slab j+1 is in flight while slab
//     j's store runs, and slab j's load while slab j-1's store runs: the
//     overlap the TPU body's 2-slot ring makes.  Given a trace buffer, the
//     kernel records %globaltimer at each of those four points a slab,
//     from which the probe shows the overlap (ops/roofline.py
//     ring_overlap).
//   * A tail that is not a multiple of 16 bytes (at most three floats, at
//     the array's end) is copied by plain loads and stores; both copies
//     need a 16-byte aligned start (the wrapper checks it).
//   * R3: a thread takes four consecutive outputs of one half tile
//     (float4 loads of both halves and a float4 store, coalesced) when the
//     half tile is a multiple of four, else one; a grid-stride loop of
//     CTAs of 256 threads.  CUDA atan2f keeps IEEE signed zeros and
//     infinities (the TPU kernel's polynomial _atan2 is a workaround the
//     port does not carry).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSlab = 32 * 1024;          // bytes a stage holds
constexpr int kCopyThreads = 32;          // one warp: thread 0 drives TMA
constexpr int kAtanThreads = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
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
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until all but the newest N bulk groups have read their source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// Bytes of slab s that the bulk copies move (a multiple of 16), for an
// array of `nbytes`.
__device__ __forceinline__ uint32_t slab_bytes(int64_t s, int64_t nbytes) {
  const int64_t left = nbytes - s * kSlab;
  return static_cast<uint32_t>((left < kSlab ? left : kSlab) & ~int64_t{15});
}

// The last few bytes past the last multiple of 16 (floats, so 0-12).
__device__ __forceinline__ void copy_tail(const char* src, char* dst,
                                          int64_t nbytes) {
  const int64_t start = nbytes & ~int64_t{15};
  for (int64_t b = start; b < nbytes; b += 4)
    *reinterpret_cast<float*>(dst + b) =
        *reinterpret_cast<const float*>(src + b);
}

// R1: one slab a CTA, one copy in flight.
__global__ void __launch_bounds__(kCopyThreads)
    copy_serial_kernel(const char* __restrict__ src, char* __restrict__ dst,
                       int64_t nbytes, int64_t n_slabs) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int64_t s = blockIdx.x;
  if (threadIdx.x != 0) return;
  if (s == n_slabs - 1) copy_tail(src, dst, nbytes);
  const uint32_t bytes = slab_bytes(s, nbytes);
  if (bytes == 0) return;
  mbar_init(&bar);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  mbar_arrive_tx(&bar, bytes);
  bulk_load(smem, src + s * kSlab, bytes, &bar);
  mbar_wait(&bar, 0);
  fence_async_smem();
  bulk_store(dst + s * kSlab, smem, bytes);
  bulk_wait_read<0>();
}

// R2: persistent CTAs over a 2-stage ring.  trace (or null): 4 uint64 a
// slab, at slab s: [load issued, load landed, store issued, store read].
__global__ void __launch_bounds__(kCopyThreads)
    copy_ring_kernel(const char* __restrict__ src, char* __restrict__ dst,
                     int64_t nbytes, int64_t n_slabs,
                     unsigned long long* __restrict__ trace) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[2];
  if (threadIdx.x != 0) return;
  if (blockIdx.x == 0) copy_tail(src, dst, nbytes);
  const int64_t first = blockIdx.x, step = gridDim.x;
  if (first >= n_slabs) return;
  mbar_init(bars);
  mbar_init(bars + 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  auto load = [&](int64_t j) {             // j: this CTA's j-th slab
    const int64_t s = first + j * step;
    const uint32_t bytes = slab_bytes(s, nbytes);
    uint64_t* bar = bars + (j & 1);
    if (trace) trace[4 * s] = now_ns();
    mbar_arrive_tx(bar, bytes);
    if (bytes) bulk_load(smem + (j & 1) * kSlab, src + s * kSlab, bytes, bar);
  };
  const int64_t mine = (n_slabs - first + step - 1) / step;
  load(0);
  int64_t prev = -1;                         // slab of the store in flight
  for (int64_t j = 0; j < mine; ++j) {
    const int64_t s = first + j * step;
    if (j + 1 < mine) {
      bulk_wait_read<0>();                   // store j-1 has read stage
      if (trace && prev >= 0) trace[4 * prev + 3] = now_ns();
      prev = -1;
      load(j + 1);
    }
    mbar_wait(bars + (j & 1), static_cast<uint32_t>((j >> 1) & 1));
    if (trace) trace[4 * s + 1] = now_ns();
    const uint32_t bytes = slab_bytes(s, nbytes);
    if (bytes) {
      fence_async_smem();
      if (trace) trace[4 * s + 2] = now_ns();
      bulk_store(dst + s * kSlab, smem + (j & 1) * kSlab, bytes);
      prev = s;
    }
  }
  bulk_wait_read<0>();
  if (trace && prev >= 0) trace[4 * prev + 3] = now_ns();
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

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return n;
}

}  // namespace

extern "C" {

// R1 (double_buffered 0) or R2 (1): dst = src, `nbytes` (a multiple of
// 4), both 16-byte aligned.  trace: null, or 4 uint64 per 32 KiB slab
// (R2 only).  Returns the cudaError_t of the launch.
int lr_hbm_copy(const void* src, void* dst, long long nbytes,
                int double_buffered, void* trace, void* stream) {
  if (nbytes < 0 || nbytes % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (nbytes == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n_slabs = (nbytes + kSlab - 1) / kSlab;
  const char* sp = static_cast<const char*>(src);
  char* dp = static_cast<char*>(dst);
  if (!double_buffered) {
    copy_serial_kernel<<<static_cast<unsigned>(n_slabs), kCopyThreads, kSlab,
                         s>>>(sp, dp, nbytes, n_slabs);
    return static_cast<int>(cudaGetLastError());
  }
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(
        copy_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        2 * kSlab);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set = true;
  }
  int per_sm = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, copy_ring_kernel, kCopyThreads, 2 * kSlab);
  if (e != cudaSuccess) return static_cast<int>(e);
  int64_t grid = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sm_count();
  if (grid < 1) grid = 1;
  if (grid > n_slabs) grid = n_slabs;
  copy_ring_kernel<<<static_cast<unsigned>(grid), kCopyThreads, 2 * kSlab,
                     s>>>(sp, dp, nbytes, n_slabs,
                          static_cast<unsigned long long*>(trace));
  return static_cast<int>(cudaGetLastError());
}

// R2's grid: the persistent CTAs the card holds at once.
int lr_hbm_copy_ring_ctas() {
  int per_sm = 0;
  cudaFuncSetAttribute(copy_ring_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * kSlab);
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, copy_ring_kernel, kCopyThreads, 2 * kSlab) != cudaSuccess)
    return -1;
  return per_sm * sm_count();
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
  const int64_t cap = static_cast<int64_t>(sm_count() > 0 ? sm_count() : 132)
                      * 16;
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

const char* lr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
