// Host emulation of the CUDA subset csrc/pll_overlap.cu and
// csrc/wbfm_proto.cu use, for scratch/scan_emu.py and
// scratch/wbfm_proto_emu.py: each CUDA thread is a std::thread and blocks run
// one after another; mbarriers (arrival counts, transaction bytes,
// phases) and TMA bulk copies are emulated (a bulk load lands after a
// random delay, from a thread of its own; misaligned bulk copies throw).
// __fmul_rn and friends round each operation (no contraction); the
// transcendental functions are the host libm's, so the emulation agrees
// bit for bit only with another host build, not with the card.
#pragma once
#include <cmath>
#include <cstdint>
#include <cstddef>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <mutex>
#include <condition_variable>
#include <map>
#include <vector>
#include <functional>
#include <random>
#include <chrono>
#include <barrier>
#include <stdexcept>
#include <memory>
#include <atomic>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __align__(x) __attribute__((aligned(x)))
#define __shared__
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3v { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3v threadIdx, blockIdx, blockDim, gridDim;
inline thread_local unsigned char* lr_smem_ptr;
inline std::barrier<>* lr_block_barrier;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101,
       cudaErrorInvalidConfiguration = 9, cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
       cudaDevAttrMultiProcessorCount = 16 };
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __int2float_rn(int a) { return (float)a; }
inline long long clock64() { return 0; }
inline void __trap() { throw std::runtime_error("trap"); }
inline void __syncthreads() { lr_block_barrier->arrive_and_wait(); }
using std::isnan;
using std::isinf;
using std::signbit;
struct dim3 { unsigned x = 1, y = 1, z = 1; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu"; }
// the SMs the launches see: LR_EMU_SMS (default 2)
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
  const char* e = std::getenv("LR_EMU_SMS"); *v = e ? std::atoi(e) : 2; return 0;
}
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 4; return 0;
}
template <class T> inline T __ldg(const T* p) { return *p; }
inline float fast_rcp(float v) { return 1.0f / v; }

// ---- bf16 (round to nearest even, as __float2bfloat16_rn) ----
struct __nv_bfloat16 { uint16_t v; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u; std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.v << 16; float f; std::memcpy(&f, &u, 4); return f;
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.v; }
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline float __low2float(__nv_bfloat162 v) { return __bfloat162float(v.x); }
inline float __high2float(__nv_bfloat162 v) { return __bfloat162float(v.y); }

// ---- warps: each CUDA thread a std::thread, a warp's 32 meet at a barrier ----
struct EmuWarp { std::barrier<> bar{32}; uint64_t slot[32]; };
inline std::vector<std::unique_ptr<EmuWarp>>* lr_warps;
inline std::unique_ptr<std::barrier<>> lr_named;
inline std::mutex lr_named_mu;
inline void __syncwarp(unsigned = 0xffffffffu) {
  (*lr_warps)[threadIdx.x / 32]->bar.arrive_and_wait();
}
template <class T> inline T lr_shfl(T v, int src) {
  EmuWarp& w = *(*lr_warps)[threadIdx.x / 32];
  uint64_t bits = 0; std::memcpy(&bits, &v, sizeof(T));
  w.slot[threadIdx.x % 32] = bits;
  w.bar.arrive_and_wait();
  uint64_t got = w.slot[src];
  w.bar.arrive_and_wait();
  T r; std::memcpy(&r, &got, sizeof(T)); return r;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) { return lr_shfl(v, src & 31); }
template <class T> inline T __shfl_xor_sync(unsigned, T v, int mask) {
  return lr_shfl(v, (threadIdx.x % 32) ^ mask);
}
template <class T> inline T __shfl_up_sync(unsigned, T v, int delta) {
  const int lane = threadIdx.x % 32;
  T got = lr_shfl(v, lane >= delta ? lane - delta : lane);
  return got;
}
// bar.sync 1, n among the block's consumers (n threads)
inline void bar_consumers(int n) {
  {
    std::lock_guard<std::mutex> g(lr_named_mu);
    if (!lr_named) lr_named = std::make_unique<std::barrier<>>(n);
  }
  lr_named->arrive_and_wait();
}
inline std::mutex lr_atomic_mu;
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  std::lock_guard<std::mutex> g(lr_atomic_mu); unsigned long long o = *p; *p = o + v; return o;
}
inline unsigned long long atomicExch(unsigned long long* p, unsigned long long v) {
  std::lock_guard<std::mutex> g(lr_atomic_mu); unsigned long long o = *p; *p = v; return o;
}
// atan2f's fast path is libdevice's: here every pair declines it, so the
// caller takes atan2f (the host libm's)
inline float atan2_fast_path(float, float, bool& ok) { ok = false; return 0.0f; }
// the tensor-core band is not emulated: a run that reaches it fails
inline void ldmatrix_x4(uint32_t, uint32_t (&)[4]) { throw std::runtime_error("ldmatrix not emulated"); }
inline void mma_bf16(float (&)[4], const uint32_t (&)[4], uint32_t, uint32_t) {
  throw std::runtime_error("mma not emulated");
}

// ---- mbarriers ----
struct EmuBar { uint32_t count = 0, pending = 0; int64_t tx = 0; uint64_t done = 0; };
inline std::mutex lr_mu;
inline std::condition_variable lr_cv;
inline std::map<uint64_t*, EmuBar> lr_bars;
inline uint32_t smem_addr(const void* p) { return (uint32_t)(uintptr_t)p; }
inline void lr_check(EmuBar& b) {
  if (b.pending == 0 && b.tx == 0) { b.done++; b.pending = b.count; lr_cv.notify_all(); }
}
inline void mbar_init(uint64_t* bar, uint32_t count) {
  std::lock_guard<std::mutex> g(lr_mu);
  lr_bars[bar] = EmuBar{count, count, 0, 0};
}
inline void lr_arrive(uint64_t* bar, int64_t tx) {
  std::lock_guard<std::mutex> g(lr_mu);
  EmuBar& b = lr_bars.at(bar);
  if (b.pending == 0) throw std::runtime_error("arrive on a completed phase");
  b.tx += tx; b.pending--; lr_check(b);
}
inline void mbar_arrive(uint64_t* bar) { lr_arrive(bar, 0); }
inline void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) { lr_arrive(bar, bytes); }
inline bool mbar_test(uint64_t* bar, uint32_t parity) {
  std::lock_guard<std::mutex> g(lr_mu);
  return (lr_bars.at(bar).done & 1) != parity;
}
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
inline uint64_t now_ns() {
  return (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
      std::chrono::steady_clock::now().time_since_epoch()).count();
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  std::unique_lock<std::mutex> g(lr_mu);
  auto ok = [&] { return (lr_bars.at(bar).done & 1) != parity; };
  if (!lr_cv.wait_for(g, std::chrono::seconds(20), ok)) throw std::runtime_error("hang");
}
inline std::mt19937& lr_rng() { thread_local std::mt19937 r(std::hash<std::thread::id>()(std::this_thread::get_id())); return r; }
inline void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  if (((uintptr_t)dst | (uintptr_t)src | bytes) & 15) throw std::runtime_error("bulk load misaligned");
  std::thread([=] {
    std::this_thread::sleep_for(std::chrono::microseconds(lr_rng()() % 50));
    std::memcpy(dst, src, bytes);
    std::lock_guard<std::mutex> g(lr_mu);
    EmuBar& b = lr_bars.at(bar); b.tx -= bytes; lr_check(b);
  }).detach();
}
inline void bulk_store(void* dst, const void* src, uint32_t bytes) {
  if (((uintptr_t)dst | (uintptr_t)src | bytes) & 15) throw std::runtime_error("bulk store misaligned");
  std::memcpy(dst, src, bytes);
}
inline void bulk_commit() {}
template <int N> inline void bulk_wait_read() {}
inline void bulk_wait_all() {}
inline void fence_proxy_async() {}

template <class F>
void lr_launch(F fn, dim3 grid, int block, size_t smem, cudaStream_t) {
  for (unsigned by = 0; by < grid.y; ++by)
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    std::vector<unsigned char> buf(smem + 256);
    unsigned char* base = (unsigned char*)(((uintptr_t)buf.data() + 127) & ~(uintptr_t)127);
    std::barrier<> bar(block);
    lr_block_barrier = &bar;
    std::vector<std::unique_ptr<EmuWarp>> warps;
    for (int w = 0; w < (block + 31) / 32; ++w) warps.push_back(std::make_unique<EmuWarp>());
    lr_warps = &warps;
    lr_named.reset();
    std::vector<std::thread> ts;
    std::exception_ptr err;
    std::mutex em;
    for (int t = 0; t < block; ++t)
      ts.emplace_back([&, t] {
        threadIdx.x = t; blockIdx.x = bx; blockIdx.y = by; blockDim.x = block;
        gridDim.x = grid.x; gridDim.y = grid.y;
        lr_smem_ptr = base;
        try { fn(); } catch (...) { std::lock_guard<std::mutex> g(em); err = std::current_exception(); }
      });
    for (auto& th : ts) th.join();
    // let straggling bulk loads land before the buffer goes
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
    if (err) std::rethrow_exception(err);
  }
}
template <class F>
void lr_launch(F fn, long long grid, int block, size_t smem, cudaStream_t s) {
  lr_launch(fn, dim3((unsigned)grid), block, smem, s);
}
