// Host emulation of the CUDA subset csrc/pll_overlap.cu uses, for
// scratch/scan_emu.py: each CUDA thread is a std::thread and blocks run
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
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
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
       cudaErrorInvalidConfiguration = 9, cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __int2float_rn(int a) { return (float)a; }
inline long long clock64() { return 0; }
inline void __trap() { throw std::runtime_error("trap"); }
inline void __syncthreads() { lr_block_barrier->arrive_and_wait(); }
using std::isnan;
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu"; }

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
void lr_launch(F fn, long long grid, int block, size_t smem, cudaStream_t) {
  for (long long b = 0; b < grid; ++b) {
    std::vector<unsigned char> buf(smem + 256);
    unsigned char* base = (unsigned char*)(((uintptr_t)buf.data() + 127) & ~(uintptr_t)127);
    std::barrier<> bar(block);
    lr_block_barrier = &bar;
    std::vector<std::thread> ts;
    std::exception_ptr err;
    std::mutex em;
    for (int t = 0; t < block; ++t)
      ts.emplace_back([&, t] {
        threadIdx.x = t; blockIdx.x = (unsigned)b; blockDim.x = block; gridDim.x = (unsigned)grid;
        lr_smem_ptr = base;
        try { fn(); } catch (...) { std::lock_guard<std::mutex> g(em); err = std::current_exception(); }
      });
    for (auto& th : ts) th.join();
    // let straggling bulk loads land before the buffer goes
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
    if (err) std::rethrow_exception(err);
  }
}
