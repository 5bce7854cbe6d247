// The windowed gather S8 for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of scratch/pallas_dma_test.py (`_kernel`
// :13, pallas_call :43): per grid step i, a DMA of a `head`-float halo
// (the carry at i = 0, else the `head` floats before the tile) and a DMA
// of the tile's 2 * tile floats into one VMEM window, written out whole.
//
// What it computes: for x float32 [C, 2 tile NT] and carry float32
// [C, head], with W = head + 2 tile,
//
//   out[c, i W : (i + 1) W] = [carry | x][c, 2 tile i : 2 tile i + W],
//
// out float32 [C, NT W]: cat([carry, x], 1).unfold(1, W, 2 tile).
//
// What bounds it on an H100: bytes.  It reads C (head + 2 tile NT) floats
// and writes C NT W: at the flagship's size (C = 8, 2 tile NT = 2^23,
// head 512, tile 8192) 545.3 MB, 0.163 ms at 3.35 TB/s; it computes
// nothing.
//
// Design.  The TPU's two DMAs a step exist to fill a VMEM window; on
// Hopper the window is just an index map, so the kernel is one coalesced
// gather (csrc/window.cuh, shared with S4's dma_only stage): float4 a
// thread where the halo, the hop and the rows keep 16-byte alignment,
// a grid-stride loop over the outputs.  The halo of window i is the tail
// of window i-1's tile, so the L2 serves it.

#include "window.cuh"

extern "C" {

// x float32 [rows, xw], carry float32 [rows, head] (any pointer when
// head is 0), out float32 [rows, nwin * ow]: out[c, w ow + j] =
// [carry | x][c, w step + j].  Returns the cudaError_t of the launch.
int lr_window_gather(const void* x, long long xw, const void* carry,
                     long long head, long long step, long long ow,
                     long long nwin, long long rows, void* out,
                     void* stream) {
  return lr_window::launch_gather(
      static_cast<const float*>(x), xw, static_cast<const float*>(carry),
      head, step, ow, nwin, rows, static_cast<float*>(out),
      static_cast<cudaStream_t>(stream));
}

const char* lr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
