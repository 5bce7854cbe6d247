// Critically sampled polyphase filter-bank (PFB) channelizer for Hopper
// (sm_90a): one launch a chunk, each input sample read once from device
// memory and each channel sample written once.
//
// Replaces no TPU kernel: the JAX package's ChannelizerBlock
// (luaradio_tpu/blocks/signal/channelizer.py) is stock XLA and reaches no
// pallas_call.  It replaces the port's stock-torch body of the same block
// (ops/channelizer.py channelize_reference: a cat, a flipped copy, q
// strided complex multiply-add passes and a length-C ifft, ~55 launches
// moving ~5.7 GB for the 131 MB of the band's chunk), which took 2.66 ms a
// chunk of C 100, q 16, 8 192 000 samples on an H100.
//
// Computes, for each of R rows (a leading batch) over the window
// xin = [state (K = C q samples) | x (n samples)]:
//   v_p[m]    = sum_{j<q} g[p][j] xin[(m + j + 1) C - p],   p < C, m < n / C
//   y[c][m]   = sum_{p<C} e^{+2 pi i c p / C} v_p[m]  (unnormalised inverse DFT)
//   new_state = xin[n, n + K)
// with g the block's branch taps [C, q] (g[p][j] = h[(q-1-j) C + p] of the
// C q-tap prototype h): the block's docstring's
//   y_c[m] = sum_p e^{+2 pi i c p / C} v_p[m],
//   v_p[m] = sum_q' h[q'C + p] x[(m - q') C - p].
//
// What bounds it: 16 bytes a sample (the complex64 read and the complex64
// written), 131 MB or 0.039 ms at 3.35 TB/s for the band's chunk, against
// ~4 q + 4 (a + b) + 6 operations a sample here (C = a b), ~150 at the
// band's shape, 0.019 ms at the card's 67 TFLOP/s of fp32.  So the design
// keeps every intermediate on chip and the card's memory busy:
//   * Persistent blocks walk tiles of T output times of one row, all C
//     branches at once.  A tile's window is (T + q - 1) C consecutive
//     samples of xin, copied into shared memory by 8-byte cp.async (any
//     alignment, any C); the first q - 1 tiles of a chunk read the part
//     below x from the state, so no concatenated copy is made.  The next
//     tile's window is in flight while this tile computes (two buffers);
//     the q - 1 rows two tiles share come again from L2.
//   * The branch FIRs run from shared memory, each thread U = 8
//     consecutive times of one branch (q + 7 window reads for 8 q
//     products, the window rows in a ring of registers); the taps sit in
//     shared memory tap-major, so a warp's branches read consecutive
//     words.
//   * The length-C DFT is C = a b with a <= b <= 16, the divisor pair
//     nearest sqrt C (100 = 10 x 10, 64 = 8 x 8; a = 1 for a C with no
//     useful factor): b DFTs of length a in place over the branch sums, a
//     twiddle e^{2 pi i c1 p2 / C}, then a DFTs of length b, each thread
//     one small DFT of one time with the roots in registers, the pairs
//     n and R - n folded so each costs half the products.
//   * Each channel's outputs of a tile leave as one contiguous run of
//     y[r][c][.], a warp storing 32 consecutive times.
// Roots, twiddles and taps come from the wrapper as float32 tables built
// in float64 (ops/channelizer.py tables); all arithmetic is float32 on
// the CUDA cores.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kU = 8;         // consecutive times a FIR thread computes
constexpr int kSmemMax = 227 * 1024;

struct Args {
  const float2* state;  // [R or 1, K]
  long long state_row;  // K, or 0 for one state shared by every row
  const float2* x;      // [R, n]
  long long n;
  const float* branch;  // [C, q]
  const float2* tw;     // a roots | b roots | a b twiddles (c1 b + p2)
  float2* new_state;    // [R, K]
  float2* out;          // [R, C, m]
  long long m, tiles_per_row;
  int rows, c, q, a, b, tile, log_tile;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 8 bytes from device to shared memory, the last (8 - bytes) filled with
// zeros (bytes 0: all zeros).
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

// Copies tile ``tile``'s window xin[m0 C + 1, m0 C + 1 + (T + q - 1) C)
// of its row into w, zeros past the row's end.
__device__ __forceinline__ void load_window(float2* w, const Args& g,
                                            long long tile) {
  const long long r = tile / g.tiles_per_row;
  const long long m0 = (tile - r * g.tiles_per_row) << g.log_tile;
  const long long k = static_cast<long long>(g.c) * g.q;
  const int len = (g.tile + g.q - 1) * g.c;
  const long long base = m0 * g.c + 1;
  const float2* st = g.state + r * g.state_row;
  const float2* xr = g.x + r * g.n;
  if (base >= k && base - k + len <= g.n) {
    // the window lies inside x: all but a chunk's first and last tiles
    const float2* src = xr + (base - k);
    for (int i = threadIdx.x; i < len; i += kThreads)
      cp_async8(w + i, src + i, 8);
    return;
  }
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const long long idx = base + i;
    const float2* src = g.x;
    int bytes = 8;
    if (idx < k)
      src = st + idx;
    else if (idx - k < g.n)
      src = xr + (idx - k);
    else
      bytes = 0;
    cp_async8(w + i, src, bytes);
  }
}

// Branch sums of one tile: v[p][t] = sum_j taps[j][p] w[(t + j) C + C-1-p].
// A thread takes U consecutive times t0 + u of one branch; its U window
// samples sit in a ring, slot (u + j) mod U holding w's row t0 + u + j at
// tap j, so with the taps unrolled by U every slot index is a constant and
// each tap costs one window read, one tap read and 2 U multiply-adds.
__device__ __forceinline__ void branch_fir(const float2* w, float2* v,
                                           const float* taps, int c, int q,
                                           int tile) {
  const int ts = tile + 1;
  const int jobs = c * (tile / kU);
  for (int job = threadIdx.x; job < jobs; job += kThreads) {
    const int tg = job / c;
    const int p = job - tg * c;
    const int t0 = tg * kU;
    const float2* col = w + (t0 * c + c - 1 - p);
    float2 s[kU], acc[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      s[u] = col[u * c];
      acc[u] = make_float2(0.f, 0.f);
    }
    for (int j0 = 0; j0 < q; j0 += kU) {
#pragma unroll
      for (int jj = 0; jj < kU; ++jj) {
        const int j = j0 + jj;
        if (j < q) {
          const float h = taps[j * c + p];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            acc[u].x = fmaf(h, s[(u + jj) % kU].x, acc[u].x);
            acc[u].y = fmaf(h, s[(u + jj) % kU].y, acc[u].y);
          }
          // row t0 + j is done with: its slot takes row t0 + j + U
          if (j + 1 < q) s[jj] = col[(j + kU) * c];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) v[p * ts + t0 + u] = acc[u];
  }
}

// Output k of the length-R DFT sum_n in[n] root[k n mod R], root[i] =
// e^{+2 pi i i / R}; the pairs n, R - n folded (root[k (R-n)] is the
// conjugate of root[k n]) into their sums s and differences d.
template <int R>
__device__ __forceinline__ float2 dft_out(const float2 (&in)[R],
                                          const float2 (&s)[R],
                                          const float2 (&d)[R],
                                          const float2 (&root)[R], int k) {
  float2 acc = in[0];
  if (R % 2 == 0) {
    const float sign = (k & 1) ? -1.f : 1.f;
    acc.x = fmaf(sign, in[R / 2].x, acc.x);
    acc.y = fmaf(sign, in[R / 2].y, acc.y);
  }
#pragma unroll
  for (int n = 1; 2 * n < R; ++n) {
    const float2 w = root[(k * n) % R];
    acc.x = fmaf(s[n].x, w.x, acc.x);
    acc.x = fmaf(-d[n].y, w.y, acc.x);
    acc.y = fmaf(s[n].y, w.x, acc.y);
    acc.y = fmaf(d[n].x, w.y, acc.y);
  }
  return acc;
}

template <int R>
__device__ __forceinline__ void fold(const float2 (&in)[R], float2 (&s)[R],
                                     float2 (&d)[R]) {
#pragma unroll
  for (int n = 1; 2 * n < R; ++n) {
    s[n] = make_float2(in[n].x + in[R - n].x, in[n].y + in[R - n].y);
    d[n] = make_float2(in[n].x - in[R - n].x, in[n].y - in[R - n].y);
  }
}

// Stage 1, radix A = a: for each time t and p2 < b, the length-a DFT over
// p1 of v[b p1 + p2][t], times e^{2 pi i c1 p2 / C}, back in place at
// v[b c1 + p2][t].
template <int A>
__device__ void stage1(float2* v, const float2* tw, int b, int tile,
                       int log_tile) {
  float2 root[A];
#pragma unroll
  for (int i = 0; i < A; ++i) root[i] = tw[i];
  const float2* twid = tw + A + b;
  const int ts = tile + 1;
  const int jobs = b << log_tile;
  for (int job = threadIdx.x; job < jobs; job += kThreads) {
    const int t = job & (tile - 1);
    const int p2 = job >> log_tile;
    float2 in[A], s[A], d[A];
#pragma unroll
    for (int p1 = 0; p1 < A; ++p1) in[p1] = v[(b * p1 + p2) * ts + t];
    fold<A>(in, s, d);
#pragma unroll
    for (int c1 = 0; c1 < A; ++c1) {
      float2 z = dft_out<A>(in, s, d, root, c1);
      if (c1 > 0) {
        const float2 w = twid[c1 * b + p2];
        z = make_float2(fmaf(z.x, w.x, -z.y * w.y),
                        fmaf(z.x, w.y, z.y * w.x));
      }
      v[(b * c1 + p2) * ts + t] = z;
    }
  }
}

// Stage 2, radix B = b: for each time t < valid and c1 < a, the length-b
// DFT over p2 of v[b c1 + p2][t] is channel c1 + a c2, stored at
// out[c1 + a c2][m0 + t].
template <int B>
__device__ void stage2(const float2* v, const float2* tw, float2* out,
                       long long m, long long m0, int valid, int a,
                       int tile, int log_tile) {
  float2 root[B];
#pragma unroll
  for (int i = 0; i < B; ++i) root[i] = tw[a + i];
  const int ts = tile + 1;
  const int jobs = a << log_tile;
  for (int job = threadIdx.x; job < jobs; job += kThreads) {
    const int t = job & (tile - 1);
    const int c1 = job >> log_tile;
    if (t >= valid) continue;
    float2 in[B], s[B], d[B];
#pragma unroll
    for (int p2 = 0; p2 < B; ++p2) in[p2] = v[(B * c1 + p2) * ts + t];
    fold<B>(in, s, d);
    float2* o = out + m0 + t;
#pragma unroll
    for (int c2 = 0; c2 < B; ++c2)
      o[(c1 + static_cast<long long>(a) * c2) * m] =
          dft_out<B>(in, s, d, root, c2);
  }
}

#define LR_RADICES(X)                                                   \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) \
      X(14) X(15) X(16)

__global__ void __launch_bounds__(kThreads, 2) pfb_kernel(Args g) {
  // shared memory, as ops/channelizer.py smem_bytes counts it: two
  // windows of (T + q - 1) C samples, the branch sums [C][T + 1], the
  // roots and twiddles, the taps [q][C]
  extern __shared__ __align__(128) unsigned char smem[];
  const int c = g.c, q = g.q, tile = g.tile;
  const int len = (tile + q - 1) * c;
  float2* w0 = reinterpret_cast<float2*>(smem);
  float2* w1 = w0 + len;
  float2* v = w1 + len;
  float2* tw = v + c * (tile + 1);
  float* taps = reinterpret_cast<float*>(tw + g.a + g.b + g.a * g.b);

  for (int i = threadIdx.x; i < q * c; i += kThreads) {
    const int j = i / c;
    taps[i] = g.branch[(i - j * c) * q + j];
  }
  for (int i = threadIdx.x; i < g.a + g.b + g.a * g.b; i += kThreads)
    tw[i] = g.tw[i];

  // the new state, xin[n, n + K) of every row
  const long long k = static_cast<long long>(c) * q;
  const long long states = g.rows * k;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < states; i += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = i / k;
    const long long idx = g.n + (i - r * k);
    g.new_state[i] = idx < k ? g.state[r * g.state_row + idx]
                             : g.x[r * g.n + (idx - k)];
  }

  const long long tiles = g.rows * g.tiles_per_row;
  long long tile_id = blockIdx.x;
  if (tile_id < tiles) load_window(w0, g, tile_id);
  cp_async_commit();
  for (int buf = 0; tile_id < tiles; tile_id += gridDim.x, buf ^= 1) {
    const long long next = tile_id + gridDim.x;
    if (next < tiles) load_window(buf ? w0 : w1, g, next);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();
    branch_fir(buf ? w1 : w0, v, taps, c, q, tile);
    __syncthreads();
    switch (g.a) {
#define LR_STAGE1(R) \
  case R:            \
    if (R > 1) stage1<R>(v, tw, g.b, tile, g.log_tile); \
    break;
      LR_RADICES(LR_STAGE1)
#undef LR_STAGE1
    }
    __syncthreads();
    const long long r = tile_id / g.tiles_per_row;
    const long long m0 = (tile_id - r * g.tiles_per_row) << g.log_tile;
    const int valid = static_cast<int>(min(static_cast<long long>(tile),
                                           g.m - m0));
    float2* out = g.out + r * c * g.m;
    switch (g.b) {
#define LR_STAGE2(R)                                                     \
  case R:                                                                \
    stage2<R>(v, tw, out, g.m, m0, valid, g.a, tile, g.log_tile);        \
    break;
      LR_RADICES(LR_STAGE2)
#undef LR_STAGE2
    }
  }
}

#undef LR_RADICES

}  // namespace

extern "C" {

// One chunk: state complex64 [R or 1, C q] (state_row C q or 0), x
// complex64 [R, n], branch float32 [C, q], tw complex64 [a + b + a b]
// (ops/channelizer.py tables); writes new_state complex64 [R, C q] and out
// complex64 [R, C, n / C], on the current stream of card ``device``.  a,
// b, tile (a power of two, at least kU), grid and smem (the block's shared
// memory in bytes) from ops/channelizer.py plan(), which has checked the
// shape.  Returns the cudaError_t of the launch.
int lr_channelize(const void* state, long long state_row, const void* x,
                  long long n, const void* branch, const void* tw,
                  void* new_state, void* out, int rows, int c, int q, int a,
                  int b, int tile, int grid, int smem, int device,
                  void* stream) {
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  int log_tile = 0;
  while ((1 << log_tile) < tile) ++log_tile;
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
    e = cudaFuncSetAttribute(pfb_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
    allowed[device] = e == cudaSuccess;
  }
  Args g;
  g.state = static_cast<const float2*>(state);
  g.state_row = state_row;
  g.x = static_cast<const float2*>(x);
  g.n = n;
  g.branch = static_cast<const float*>(branch);
  g.tw = static_cast<const float2*>(tw);
  g.new_state = static_cast<float2*>(new_state);
  g.out = static_cast<float2*>(out);
  g.m = n / c;
  g.tiles_per_row = (g.m + tile - 1) / tile;
  g.rows = rows;
  g.c = c;
  g.q = q;
  g.a = a;
  g.b = b;
  g.tile = tile;
  g.log_tile = log_tile;
  if (e == cudaSuccess) {
    pfb_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        g);
    e = cudaGetLastError();
  }
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (e == cudaSuccess) e = back;
  }
  return static_cast<int>(e);
}

const char* lr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
