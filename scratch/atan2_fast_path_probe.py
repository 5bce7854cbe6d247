#!/usr/bin/env python3
"""atan2f's branch-free fast path (csrc/wbfm_proto.cu atan2_fast_path)
against libdevice atan2f on the card, pair by pair: the source is built
with a probe kernel of its own (nvcc into .ab_old/, no sweep build), then
on 2^24 random pairs whose magnitudes span 2^-140 to 2^120 and on 2^22
normal pairs every result the fast path claims (ok) is compared with
atan2f's bit for bit; the counts and the first pairs that differ are
printed.

    python3 scratch/atan2_fast_path_probe.py
"""

import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from luaradio_tpu_torch.ops import cudabuild  # noqa: E402

SRC = r'''
#include "wbfm_proto.cu"
namespace {
__global__ void probe(const float* y, const float* x, float* ref, float* got,
                      int* ok, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    bool k = true;
    got[i] = atan2_fast_path(y[i], x[i], k);
    ok[i] = k;
    ref[i] = atan2f(y[i], x[i]);
  }
}
}
extern "C" int lr_probe(const void* y, const void* x, void* ref, void* got,
                        void* ok, int n) {
  probe<<<1024, 256>>>((const float*)y, (const float*)x, (float*)ref,
                       (float*)got, (int*)ok, n);
  return (int)cudaDeviceSynchronize();
}
'''


def main():
    out = os.path.join(ROOT, ".ab_old")
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, "atan2_probe.cu"), os.path.join(
        out, "libatan2_probe.so")
    with open(cu, "w") as f:
        f.write(SRC)
    subprocess.run([cudabuild.nvcc(), *cudabuild.NVCC_FLAGS, "-I",
                    str(cudabuild.CSRC), "-o", so, cu], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.lr_probe.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    n = 1 << 24
    mag = torch.rand(2, n, generator=g, device=dev) * 260 - 140
    sign = torch.randint(0, 2, (2, n), generator=g, device=dev) * 2 - 1
    wide = (sign * torch.exp2(mag) * (1 + torch.rand(2, n, generator=g,
                                                     device=dev))).float()
    unit = torch.randn(2, 1 << 22, generator=g, device=dev)
    for name, (y, x) in (("wide", wide), ("normal", unit)):
        y, x = y.contiguous(), x.contiguous()
        ref, got = torch.empty_like(y), torch.empty_like(y)
        ok = torch.empty(y.shape, dtype=torch.int32, device=dev)
        rc = lib.lr_probe(y.data_ptr(), x.data_ptr(), ref.data_ptr(),
                          got.data_ptr(), ok.data_ptr(), y.numel())
        assert rc == 0, rc
        claimed = ok.bool()
        bad = claimed & ~((ref == got) & (torch.signbit(ref) ==
                                          torch.signbit(got)))
        bad &= ~(torch.isnan(ref) & torch.isnan(got))
        idx = torch.nonzero(bad).flatten()[:12].tolist()
        print(f"{name}: {int(claimed.sum())} of {y.numel()} claimed, "
              f"{int(bad.sum())} differ", flush=True)
        for i in idx:
            print(f"  y {float(y[i])!r} x {float(x[i])!r} atan2f "
                  f"{float(ref[i])!r} fast {float(got[i])!r}", flush=True)


if __name__ == "__main__":
    main()
