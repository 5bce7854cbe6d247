#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (luaradio_tpu_torch) once on a CUDA card.

    python3 chip_smoke.py [--profile PATH]

Needs one CUDA card and the CUDA toolkit (nvcc): the kernels are built from
csrc/ on first use.  Phases, each printed with the elapsed seconds:

1. device: the card's name and power limit (nvidia-smi) and count;
2. build: nvcc builds every kernel source;
3. K1 / K2: each kernel at the flagship's full width (8 channels x 4 194 304
   samples, D = 8, K = 640) and on a ragged chunk, held against its plain
   PyTorch twin (2e-5 * scale on the audio; the discriminator output,
   probed with a unit-impulse filter, wrap-aware), timed with CUDA events
   (median of 25) beside the twin, a conv1d yardstick and the bound; K2
   also at the chunk shape the README graph gives it (K = 512, D = 5);
4. flagship: chained steps of the flagship receiver at full width (K1);
5. graph: the README receiver graph (IQ file -> Tuner -> WBFM mono ->
   Downsampler -> WAV) over a synthetic 4 s FM capture with a 3 kHz tone,
   for the f32 and the u8 wire, and again with the K2 rule on; the tone
   must come out within 50 Hz, and the K2 audio must match the default;
6. the kernels line and the final status line.

Launch counts are zeroed just before the flagship and the K2 graph run and
read just after: each kernel must have run on its path.  Any failure
raises (non-zero exit); a hang ends the run with a traceback after 900 s.
``--profile PATH`` also writes a torch.profiler table of one graph run to
PATH.
"""

from __future__ import annotations

import faulthandler
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch

from luaradio_tpu_torch import (CompositeBlock, DownsamplerBlock,
                                IQFileSource, TunerBlock, WAVFileSink,
                                WBFMMonoDemodulator)
from luaradio_tpu_torch.ops import cudabuild, wbfm
from luaradio_tpu_torch.ops.complexutil import (complex_to_wire,
                                                wire_to_complex)
from luaradio_tpu_torch.ops.fir import _conv_real
from luaradio_tpu_torch.parallel.flagship import (INV_GAIN,
                                                  make_wbfm_mono_step,
                                                  wbfm_mono_taps)

T0 = time.monotonic()
#: a hang ends the run with a traceback after this many seconds; a whole
#: run, build included, takes well under a minute on the card
HANG_S = 240
#: H100 SXM data sheet: HBM rate, and fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
#: operations per discriminator output: 4 mul, 2 add, atan2 (as 1), scale
DISC_OPS = 8
C, T, D = 8, 1 << 22, 8
T_RAGGED = 3 * (1 << 14) + 8 * 37
RATE = 1102500
TONE = 3e3
REPS = 25


def log(phase: str, msg: str):
    print(f"[{time.monotonic() - T0:7.1f} s] {phase}: {msg}", flush=True)


def median_ms(fn, reps: int = REPS) -> float:
    """Median of per-launch CUDA-event times after a warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def fm_like(gen, c, t, dev, step_std=0.4):
    """Unit phasors with a random-walk phase plus noise, made on the card
    from a seeded generator; step_std=None draws uniform steps in
    [-pi, pi), which puts samples next to the atan2 branch cut."""
    if step_std is None:
        steps = (torch.rand((c, t), generator=gen, device=dev,
                            dtype=torch.float64) * 2 - 1) * np.pi
    else:
        steps = torch.randn((c, t), generator=gen, device=dev,
                            dtype=torch.float64) * step_std
    ph = torch.remainder(torch.cumsum(steps, dim=-1), 2 * np.pi)
    z = torch.polar(torch.ones_like(ph), ph)
    noise = torch.randn((c, t), generator=gen, device=dev,
                        dtype=torch.complex128) * 0.05
    return (z + noise).to(torch.complex64)


def wrap_err(a, b, period):
    d = torch.remainder(a.double() - b.double() + period / 2, period)
    return (d - period / 2).abs().max().item()


def compare(name, run, twin, cases, taps):
    """Hold a kernel against its twin on each (label, x, carry) case;
    returns the largest absolute error."""
    errs = []
    for label, x, carry in cases:
        got, exp = run(carry, x, taps), twin(carry, x, taps)
        torch.cuda.synchronize()
        if got.shape != exp.shape or not torch.isfinite(got).all():
            raise AssertionError(f"{name}: bad output {tuple(got.shape)}")
        scale = max(1.0, exp.abs().max().item())
        err = (got - exp).abs().max().item()
        if err > 2e-5 * scale:
            raise AssertionError(f"{name} {label}: |kernel - twin| = {err}"
                                 f" > 2e-5 * {scale}")
        errs.append(err)
        log(name, f"{label} {tuple(x.shape)}: max |kernel - twin| "
                  f"{err:.3g} (limit 2e-5 * {scale:.3g})")
    return max(errs)


def probe_discriminator(name, run, probe):
    """A unit impulse at tap 0 with D = 1 makes the kernel's output the
    discriminator itself, y[j] = m[K-1+j]: compare it wrap-aware."""
    px, pcarry, pm = probe
    delta = torch.zeros(128, device=pm.device)
    delta[0] = 1.0
    werr = wrap_err(run(pcarry, px, delta, 1), pm, 2 * np.pi * INV_GAIN)
    if werr > 2e-6:
        raise AssertionError(f"{name}: discriminator off by {werr}")
    log(name, f"discriminator on a branch-cut signal {tuple(pm.shape)}: "
              f"wrap-aware max error {werr:.3g} (limit 2e-6)")


def measure(name, run, twin, x, carry, taps, d):
    """Time kernel, twin and the conv1d yardstick at one shape, beside
    the bound of the kernel's work there."""
    c, k = carry.shape
    t = x.shape[-1] // (2 if x.dtype == torch.float32 else 1)
    ms = median_ms(lambda: run(carry, x, taps))
    plain_ms = median_ms(lambda: twin(carry, x, taps))
    w = torch.cat([carry, _as_complex(x)], dim=-1)
    m = wbfm.discriminate(w.real, w.imag, INV_GAIN)
    del w
    library_ms = median_ms(lambda: _conv_real(m, taps, d))
    n_out = c * (t // d)
    nbytes = c * t * 8 + c * k * 8 + n_out * 4
    if name == "wbfm_mono":
        nbytes += c * k * 8                       # the new carry
    ops = n_out * 2 * k + c * (k - 1 + t) * DISC_OPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    log(name, f"[{c} x {t}, K={k}, D={d}] {ms:.4f} ms per launch (median "
              f"of {REPS}); twin {plain_ms:.4f} ms; conv1d of m "
              f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms "
              f"({nbytes / 1e6:.1f} MB at 3.35 TB/s, {ops / 1e9:.3f} Gop "
              f"at 67 TFLOP/s fp32, H100 SXM data sheet); "
              f"{c * t / ms / 1e6:.3f} G complex samples/s")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def _as_complex(x):
    return x if x.dtype == torch.complex64 else wire_to_complex(x)


def _k1(c, x, h, d=D):
    return wbfm.wbfm_mono(c, x, h, d, INV_GAIN)[1]


def _k1_twin(c, x, h, d=D):
    return wbfm.wbfm_mono_reference(c, x, h, d, INV_GAIN)[1]


def _k2(c, x, h, d=D):
    return wbfm.disc_fir(c, x, h, d, INV_GAIN)


def _k2_twin(c, x, h, d=D):
    return wbfm.disc_fir_reference(c, x, h, d, INV_GAIN)


def phase_kernels(dev, gen):
    """K1 and K2 at the flagship's full width and on a ragged chunk.
    Returns the K1 entry (its main path is the flagship step), K2's error
    and the full-width wire for the flagship phase."""
    taps = torch.from_numpy(wbfm_mono_taps()).to(dev)
    k = taps.shape[0]
    z = fm_like(gen, C, T + k, dev)
    carry, xc = z[:, :k].contiguous(), z[:, k:].contiguous()
    zr = fm_like(gen, C, T_RAGGED + k, dev)
    rcarry, rxc = zr[:, :k].contiguous(), zr[:, k:].contiguous()
    zp = fm_like(gen, 2, 1 << 20, dev, step_std=None)
    pcarry, pxc = zp[:, :128].contiguous(), zp[:, 128:].contiguous()
    pm = wbfm.discriminate(zp.real, zp.imag, INV_GAIN)[:, 127:]

    k1 = {"name": "wbfm_mono", "route": "cuda",
          "source": "luaradio_tpu_torch/csrc/wbfm.cu",
          "replaces": "luaradio_tpu/ops/wbfm_pallas.py:180"}
    k1["max_abs_err"] = compare(
        "wbfm_mono", _k1, _k1_twin,
        [("full width", complex_to_wire(xc), carry),
         ("ragged", complex_to_wire(rxc), rcarry)], taps)
    probe_discriminator("wbfm_mono", _k1, (complex_to_wire(pxc), pcarry, pm))
    k1.update(measure("wbfm_mono", _k1, _k1_twin, complex_to_wire(xc), carry, taps,
                      D))
    k2_err = compare("disc_fir", _k2, _k2_twin,
                     [("full width", xc, carry), ("ragged", rxc, rcarry)],
                     taps)
    probe_discriminator("disc_fir", _k2, (pxc, pcarry, pm))
    measure("disc_fir", _k2, _k2_twin, xc, carry, taps, D)
    return k1, k2_err, complex_to_wire(xc)


def k2_graph_shape(dev, gen, path):
    """K2 at the shape the README graph gives it: build the graph with the
    K2 rule on and read the fused block's taps and chunk."""
    from luaradio_tpu_torch.blocks.signal.modem import \
        DiscriminatorDecimatingFIRBlock
    from luaradio_tpu_torch.core.composite import Graph
    os.environ["LUARADIO_TPU_FORCE_WBFM_KERNEL"] = "1"
    try:
        g = Graph(readme_graph(path, "f32le", os.devnull), device=dev)
    finally:
        del os.environ["LUARADIO_TPU_FORCE_WBFM_KERNEL"]
    for b in g.order:
        b.cleanup()
    blk = next(b for b in g.order
               if isinstance(b, DiscriminatorDecimatingFIRBlock))
    t, k, d = g.in_chunk[id(blk)], len(blk.taps), blk.decimation
    z = fm_like(gen, 1, t + k, dev)
    carry, x = z[:, :k].contiguous(), z[:, k:].contiguous()
    err = compare("disc_fir", lambda c, xx, h: _k2(c, xx, h, d),
                  lambda c, xx, h: _k2_twin(c, xx, h, d),
                  [("graph chunk", x, carry)], blk._taps)
    entry = {"name": "disc_fir", "route": "cuda",
             "source": "luaradio_tpu_torch/csrc/wbfm.cu",
             "replaces": "luaradio_tpu/ops/wbfm_pallas.py:335",
             "max_abs_err": err}
    entry.update(measure("disc_fir", lambda c, xx, h: _k2(c, xx, h, d),
                         lambda c, xx, h: _k2_twin(c, xx, h, d), x, carry,
                         blk._taps, d))
    return entry


def phase_flagship(dev, x, steps=5):
    step, init = make_wbfm_mono_step(device=dev)
    state = init(C)
    taps = torch.from_numpy(wbfm_mono_taps()).to(dev)
    twin_state = init(C)
    step(state, x)                                   # warm-up
    state = init(C)
    torch.cuda.synchronize()
    wbfm.wbfm_mono.launches = 0
    wbfm.disc_fir.launches = 0
    t0 = time.monotonic()
    for _ in range(steps):
        state, audio = step(state, x)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = wbfm.wbfm_mono.launches
    if launches != steps:
        raise AssertionError(f"flagship: K1 launched {launches} times in "
                             f"{steps} steps")
    for _ in range(steps):
        twin_state, ref = wbfm.wbfm_mono_reference(twin_state[0], x, taps,
                                                   D, INV_GAIN)
        twin_state = (twin_state,)
    err = (audio - ref).abs().max().item()
    if audio.shape != (C, T // D) or not torch.isfinite(audio).all() \
            or err > 2e-5 * max(1.0, ref.abs().max().item()):
        raise AssertionError(f"flagship: audio off the twin chain by {err}")
    log("flagship", f"{steps} chained steps of {C} x {T} samples: "
                    f"{C * T * steps / dt / 1e9:.3f} G complex samples/s "
                    f"(host clock, synchronized); K1 launches {launches}; "
                    f"last step vs twin chain {err:.3g}")
    return launches


def write_capture(tmp):
    """~4 s of an FM station 250 kHz above the tuning (the README
    receiver's offset), modulated by a 3 kHz tone, as f32 and u8 I/Q."""
    rng = np.random.default_rng(7)
    n = 4 * RATE
    t = np.arange(n) / RATE
    ph = 2 * np.pi * np.cumsum(250e3 + 50e3 * np.cos(2 * np.pi * TONE * t)
                               ) / RATE
    z = 0.7 * np.exp(1j * ph) + 0.02 * (rng.standard_normal(n)
                                        + 1j * rng.standard_normal(n))
    f = z.astype(np.complex64).view(np.float32)
    paths = {"f32le": os.path.join(tmp, "c.f32.iq"),
             "u8": os.path.join(tmp, "c.u8.iq")}
    f.tofile(paths["f32le"])
    np.clip(np.round(f * 127.5 + 127.5), 0, 255).astype(np.uint8).tofile(
        paths["u8"])
    return paths, n


def readme_graph(path, fmt, wav):
    top = CompositeBlock()
    top.connect(IQFileSource(path, fmt, RATE),
                TunerBlock(-250e3, 200e3, 5), WBFMMonoDemodulator(),
                DownsamplerBlock(5), WAVFileSink(wav, 1))
    return top


def run_graph(path, fmt, wav, threaded=False):
    top = readme_graph(path, fmt, wav)
    t0 = time.monotonic()
    if threaded:
        top.start()
        top.wait(timeout=60)
    else:
        top.run()
    dt = time.monotonic() - t0
    with wave.open(wav) as w:
        rate = w.getframerate()
        a = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    return a, rate, dt


def tone_peak(a, rate):
    a = a[len(a) // 4:].astype(np.float64)
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    return (np.argmax(spec[1:]) + 1) * rate / len(a)


def phase_graph(tmp, profile, dev, gen):
    paths, n = write_capture(tmp)
    log("graph", f"capture: {n} samples at {RATE} S/s, f32 and u8 I/Q")
    k2 = k2_graph_shape(dev, gen, paths["f32le"])
    run_graph(paths["u8"], "u8", os.path.join(tmp, "warm.wav"))  # warm-up
    audio = {}
    for fmt in ("f32le", "u8"):
        a, rate, dt = run_graph(paths[fmt], fmt,
                                os.path.join(tmp, f"{fmt}.wav"))
        peak = tone_peak(a, rate)
        if abs(peak - TONE) > 50:
            raise AssertionError(f"graph {fmt}: peak at {peak} Hz")
        audio[fmt] = a
        log("graph", f"{fmt} wire, default graph: {len(a)} audio samples "
                     f"at {rate} Hz, tone peak {peak:.1f} Hz, "
                     f"{n / dt / 1e6:.2f} M complex samples/s end to end")
    os.environ["LUARADIO_TPU_FORCE_WBFM_KERNEL"] = "1"
    try:
        wbfm.wbfm_mono.launches = 0
        wbfm.disc_fir.launches = 0
        a, rate, dt = run_graph(paths["f32le"], "f32le",
                                os.path.join(tmp, "k2.wav"), threaded=True)
        launches = wbfm.disc_fir.launches
    finally:
        del os.environ["LUARADIO_TPU_FORCE_WBFM_KERNEL"]
    peak = tone_peak(a, rate)
    diff = int(np.max(np.abs(a.astype(np.int32) - audio["f32le"])))
    if launches == 0 or abs(peak - TONE) > 50 or \
            a.shape != audio["f32le"].shape or diff > 1:
        raise AssertionError(f"graph K2: launches {launches}, peak {peak}, "
                             f"max |K2 - default| {diff} LSB")
    log("graph", f"f32 wire, K2 rule on (start/wait): tone peak "
                 f"{peak:.1f} Hz, max |K2 - default| {diff} LSB of 16 bit, "
                 f"K2 launches {launches}, {n / dt / 1e6:.2f} M complex "
                 f"samples/s end to end")
    if profile:
        profile_graph(paths["f32le"], os.path.join(tmp, "p.wav"), profile)
    k2["launches"] = launches
    return k2


def profile_graph(path, wav, out):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        _, _, wall = run_graph(path, "f32le", wav)
    events = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    dev_us = sum(getattr(e, key) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    table = events.table(sort_by=key, row_limit=25)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(table)
    log("profile", f"graph f32 under torch.profiler: run {wall:.4f} s "
                   f"(profiler overhead included), device time "
                   f"{dev_us / 1e3:.3f} ms ({100 * dev_us / 1e6 / wall:.1f}"
                   f" % of the profiled run); table in {out}")


def profile_path(argv):
    if "--profile" not in argv:
        return None
    i = argv.index("--profile")
    if i + 1 >= len(argv):
        raise SystemExit("chip_smoke: --profile needs an output path")
    return argv[i + 1]


def main(argv):
    faulthandler.dump_traceback_later(HANG_S, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log("device", f"{name} x {count}; torch {torch.__version__}, CUDA "
                  f"{torch.version.cuda}")

    t0 = time.monotonic()
    built = cudabuild.build()
    for src, (secs, out) in built.items():
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        log("build", f"csrc/{src}.cu in {secs:.2f} s: {'; '.join(regs)}")
    log("build", f"all kernels ready in {time.monotonic() - t0:.2f} s")

    gen = torch.Generator(device=dev).manual_seed(1234)
    k1, k2_err, x_wire = phase_kernels(dev, gen)
    k1["launches"] = phase_flagship(dev, x_wire)
    del x_wire
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        k2 = phase_graph(tmp, profile_path(argv), dev, gen)
    k2["max_abs_err"] = max(k2["max_abs_err"], k2_err)
    entries = [k1, k2]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys}
                                  for e in entries]}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
