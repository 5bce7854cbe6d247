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
6. K3: the sequential PLL kernel held against its twin over 8 192
   samples (noise, carrier, zeros + carrier; multipliers 1, 2, 2.5) and
   at the stereo graph's chunk;
7. stereo: rx_wbfm's default stereo receiver through the port's CLI
   (cli.main, in this process) over an 8 s capture at 1 102 500 S/s (0.5 s
   of noise, then a stereo multiplex with L a 1 kHz and R a 400 Hz tone
   at ~30 dB SNR); the WAV must have 2 channels and the expected length,
   and L+R must carry both tones within 50 Hz at SNR > 1e4 over the
   second half; then the same graph by hand with the vector pilot, which
   must separate L and R by the JAX package's app-level margin (each
   channel's tone > 3x the other's);
8. K3 timed at the graph's chunk and at one 8 s stream at the IF rate
   (1 764 000 samples), beside its twin, its byte bound and the floor of
   its dependency chain (a probe kernel that runs only the chain); the
   overlap-and-discard tier, which plans nothing for the graph's chunk,
   timed once on a chunk it plans for;
9. the kernels line and the final status line.

Launch counts are zeroed just before the flagship, the K2 graph run and
the stereo CLI run and read just after: each kernel must have run on its
path.  Any failure raises (non-zero exit); a hang ends the run with a
traceback after 240 s.  ``--profile PATH`` also writes a torch.profiler
table of one mono graph run to PATH and of the stereo run to
PATH.stereo.txt.
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
                                WBFMMonoDemodulator, WBFMStereoDemodulator)
from luaradio_tpu_torch import cli
from luaradio_tpu_torch.blocks.signal import carrier
from luaradio_tpu_torch.ops import cudabuild, pll, wbfm
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
#: K3: bytes a sample (8 in, 8 out, 4 err), operations a sample (atan2,
#: scale, clip, round; the chain's 14; cos and sin), the span held
#: against the twin, the stereo capture's length and its tones
PLL_BYTES, PLL_OPS = 20, 22
PLL_SPAN = 8192
STEREO_S, NOISE_S = 8, 0.5
TONE_L, TONE_R = 1000.0, 400.0


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
        profile_run(lambda: run_graph(paths["f32le"], "f32le",
                                      os.path.join(tmp, "p.wav")),
                    profile, "graph f32")
    k2["launches"] = launches
    return k2


def pll_cases(gen, dev, n=PLL_SPAN):
    """The three inputs of the JAX package's kernel test
    (test_pll_overlap.py:155-198) at n samples, made on the card."""
    t = torch.arange(n, device=dev, dtype=torch.float64)
    carrier_ = 0.7 * torch.polar(torch.ones_like(t),
                                 2 * np.pi * 0.21 * t + 0.9)
    noise = torch.randn(n, generator=gen, device=dev, dtype=torch.complex128)
    zc = carrier_.clone()
    zc[:n // 4] = 0
    return {"noise": noise.to(torch.complex64),
            "carrier": carrier_.to(torch.complex64),
            "zeros+carrier": zc.to(torch.complex64)}


def stereo_pll_params():
    """alpha, beta, fmin, fmax of the stereo demodulator's PLL at the IF
    rate (PLLBlock(100, 19e3 - 50, 19e3 + 50, multiplier=2))."""
    blk = carrier.PLLBlock(100.0, 19e3 - 50, 19e3 + 50, multiplier=2)
    blk.input_rate = RATE / 5
    blk.initialize()
    return blk._alpha, blk._beta, blk._freq_min, blk._freq_max


def compare_pll(label, x, state, params, mult):
    """K3 against its twin on one input: out and err (err modulo 2 pi)
    and the state.  They round every operation alike and call the same
    atan2f/cosf/sinf, so they are expected to agree exactly; the limit is
    1e-5.  Returns the largest error."""
    got = pll.pll_phase(x, state, *params, mult)
    exp = pll.pll_phase_reference(x, state, *params, mult)
    torch.cuda.synchronize()
    if not all(torch.isfinite(torch.view_as_real(g) if g.is_complex()
                              else g).all() for g in got):
        raise AssertionError(f"pll_phase {label}: non-finite output")
    errs = [(got[0] - exp[0]).abs().max().item(),
            wrap_err(got[1], exp[1], 2 * np.pi),
            wrap_err(got[2][:2], exp[2][:2], 2 * np.pi),
            (got[2][2] - exp[2][2]).abs().item()]
    if max(errs) > 1e-5:
        raise AssertionError(f"pll_phase {label}: |kernel - twin| (out, "
                             f"err, phases, freq) = {errs} > 1e-5")
    return max(errs)


def phase_pll_hold(dev, gen):
    """K3 against its twin over PLL_SPAN samples: three inputs x three
    multipliers, the stereo PLL's constants."""
    params = stereo_pll_params()
    state = torch.tensor([0.3, -0.5, float(params[2])], device=dev)
    worst = 0.0
    for name, x in pll_cases(gen, dev).items():
        for mult in (1.0, 2.0, 2.5):
            err = compare_pll(f"{name} x{mult}", x, state, params, mult)
            worst = max(worst, err)
            log("K3", f"{name}, multiplier {mult}, {x.shape[0]} samples: "
                      f"max |kernel - twin| {err:.3g} (limit 1e-5)")
    return worst


def write_stereo_capture(tmp):
    """STEREO_S seconds at RATE, f32le: NOISE_S s of complex Gaussian
    noise (a receiver tuned before the station comes up), then the stereo
    multiplex of test_applications.py:95-113 at baseband (L a 1 kHz, R a
    400 Hz tone, pilot 0.1 cos 19 kHz, 75 kHz deviation) with the noise
    going on under it at ~30 dB SNR."""
    rng = np.random.default_rng(11)
    n = STEREO_S * RATE
    n0 = int(NOISE_S * RATE)
    t = np.arange(n - n0) / RATE
    left = 0.4 * np.sin(2 * np.pi * TONE_L * t)
    right = 0.4 * np.sin(2 * np.pi * TONE_R * t)
    mpx = (left + right) + 0.1 * np.cos(2 * np.pi * 19e3 * t) \
        + (left - right) * np.cos(2 * np.pi * 38e3 * t)
    del left, right, t
    z = np.empty(n, np.complex64)
    z[:n0] = 0
    z[n0:] = np.exp(1j * 2 * np.pi * 75e3 * np.cumsum(mpx) / RATE)
    del mpx
    z += (rng.standard_normal(n, np.float32)
          + 1j * rng.standard_normal(n, np.float32)) * np.float32(
              np.sqrt(0.5e-3))
    path = os.path.join(tmp, "stereo.f32.iq")
    z.view(np.float32).tofile(path)
    return path, n


def tone_snr(a, rate, tone):
    """(frequency of the largest bin within 200 Hz of ``tone``, its power
    over the median bin) over the second half of ``a``."""
    a = a[len(a) // 2:].astype(np.float64)
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a)))) ** 2
    f = np.arange(len(spec)) * rate / len(a)
    win = np.nonzero(np.abs(f - tone) <= 200)[0]
    k = win[np.argmax(spec[win])]
    return f[k], spec[k] / (np.median(spec) + 1e-30)


def separation_db(pcm, rate):
    """Each channel's own tone over the other's, in dB (amplitude
    spectrum peaks, as test_applications.py:132-140), second half."""
    def peak(ch, tone):
        a = pcm[len(pcm) // 2:, ch].astype(np.float64)
        spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        idx = int(round(tone * len(a) / rate))
        return spec[max(0, idx - 2):idx + 3].max()
    return (20 * np.log10(peak(0, TONE_L) / peak(0, TONE_R)),
            20 * np.log10(peak(1, TONE_R) / peak(1, TONE_L)))


def read_wav(path):
    with wave.open(path) as w:
        rate, nch = w.getframerate(), w.getnchannels()
        pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    return pcm.reshape(-1, nch), rate


def record_pll_chunks():
    """Wrap PLLBlock.process to record (chunk length, tier) of every chunk
    a PLL runs; returns the list and a function that unwraps it."""
    seen, process = [], carrier.PLLBlock.process

    def recording(self, state, x):
        before = dict(self.tier_counts)
        out = process(self, state, x)
        seen.append((x.shape[-1], [k for k in self.tier_counts
                                   if self.tier_counts[k] != before[k]]))
        return out
    carrier.PLLBlock.process = recording

    def restore():
        carrier.PLLBlock.process = process
    return seen, restore


def run_stereo_cli(path, wav):
    t0 = time.monotonic()
    rc = cli.main(["-a", "rx_wbfm", "-i", f"iqfile:{path},rate={RATE}",
                   "-o", f"wavfile:{wav}", "100e6"])
    return rc, time.monotonic() - t0


def phase_stereo(tmp, profile):
    """rx_wbfm's default stereo receiver through the CLI, then the vector
    pilot graph by hand.  Returns (K3 launches, the PLL's chunk length)."""
    path, n = write_stereo_capture(tmp)
    log("stereo", f"capture: {n} samples ({STEREO_S} s) at {RATE} S/s, "
                  f"f32le, {os.path.getsize(path) / 1e6:.1f} MB; noise "
                  f"for the first {NOISE_S} s")
    run_stereo_cli(path, os.path.join(tmp, "warm.wav"))     # warm-up
    wav = os.path.join(tmp, "stereo.wav")
    seen, restore = record_pll_chunks()
    try:
        pll.pll_phase.launches = 0
        rc, dt = run_stereo_cli(path, wav)
        torch.cuda.synchronize()
        launches = pll.pll_phase.launches
    finally:
        restore()
    pcm, rate = read_wav(wav)
    want = n // 25
    tiers = [t[0] for _, t in seen]
    if rc != 0 or launches < 1 or pcm.shape != (want, 2):
        raise AssertionError(f"stereo CLI: rc {rc}, K3 launches "
                             f"{launches}, WAV {pcm.shape} (want "
                             f"({want}, 2))")
    mono = pcm[:, 0].astype(np.float64) + pcm[:, 1]
    for tone in (TONE_L, TONE_R):
        f, snr = tone_snr(mono, rate, tone)
        if abs(f - tone) > 50 or snr <= 1e4:
            raise AssertionError(f"stereo CLI: L+R tone {tone} Hz found at "
                                 f"{f:.1f} Hz with SNR {snr:.3g}")
        log("stereo", f"L+R carries {tone:.0f} Hz at {f:.1f} Hz, SNR "
                      f"{snr:.3g} (limits 50 Hz, 1e4)")
    sep = separation_db(pcm, rate)
    log("stereo", f"CLI rx_wbfm (PLL pilot): {pcm.shape[0]} frames x 2 at "
                  f"{rate} Hz in {dt:.3f} s, {n / dt / 1e6:.2f} M complex "
                  f"samples/s end to end; K3 launches {launches} over "
                  f"{len(seen)} PLL chunks of {seen[0][0]} samples "
                  f"(tiers: linear {tiers.count(1)}, overlap "
                  f"{tiers.count(2)}, sequential {tiers.count(3)}); L/R "
                  f"separation {sep[0]:.1f} / {sep[1]:.1f} dB (not held: "
                  f"the doubled carrier's phase depends on the lock history)")
    if launches != tiers.count(3):
        raise AssertionError(f"stereo CLI: {launches} K3 launches for "
                             f"{tiers.count(3)} sequential chunks")
    if profile:
        profile_run(lambda: run_stereo_cli(path, os.path.join(tmp, "p.wav")),
                    f"{profile}.stereo.txt", "stereo CLI")

    vwav = os.path.join(tmp, "vector.wav")
    top = CompositeBlock()
    demod = WBFMStereoDemodulator(pilot="vector")
    l_ds, r_ds = DownsamplerBlock(5), DownsamplerBlock(5)
    sink = WAVFileSink(vwav, 2)
    top.connect(IQFileSource(path, "f32le", RATE),
                TunerBlock(0, 200e3, 5), demod)
    top.connect(demod, "left", l_ds, "in")
    top.connect(demod, "right", r_ds, "in")
    top.connect(l_ds, "out", sink, "in1")
    top.connect(r_ds, "out", sink, "in2")
    t0 = time.monotonic()
    top.run()
    vdt = time.monotonic() - t0
    vpcm, _ = read_wav(vwav)
    vsep = separation_db(vpcm, rate)
    if vpcm.shape != (want, 2) or min(vsep) <= 20 * np.log10(3):
        raise AssertionError(f"stereo vector pilot: WAV {vpcm.shape}, "
                             f"separation {vsep} dB (limit "
                             f"{20 * np.log10(3):.2f} dB, 3x)")
    log("stereo", f"vector-pilot graph: L/R separation {vsep[0]:.1f} / "
                  f"{vsep[1]:.1f} dB (limit {20 * np.log10(3):.2f} dB each, "
                  f"3x), {n / vdt / 1e6:.2f} M complex samples/s end to end")
    return launches, seen[0][0]


def phase_pll_time(dev, gen, chunk):
    """K3 timed at the stereo graph's chunk and at one 8 s stream at the
    IF rate, beside its twin (at the chunk), its byte bound and the floor
    of its dependency chain."""
    params = stereo_pll_params()
    state = torch.tensor([0.0, 0.0, float(params[2])], device=dev)
    x = fm_like(gen, 1, chunk, dev)[0].contiguous()
    err = compare_pll(f"graph chunk {chunk}", x, state, params, 2.0)
    steps = 1 << 20
    pll.chain_probe(1024, dev)                               # warm-up
    probe_ms, cycles = pll.chain_probe(steps, dev)
    ns_step = probe_ms * 1e6 / steps
    log("K3", f"chain probe: {steps} dependent steps in {probe_ms:.3f} ms, "
              f"{ns_step:.3f} ns and {cycles / steps:.2f} SM cycles a step")
    overlap_time(dev, gen, params, chunk)
    entry = None
    for n in (chunk, STEREO_S * RATE // 5):
        xs = x if n == chunk else fm_like(gen, 1, n, dev)[0].contiguous()
        ms = median_ms(lambda: pll.pll_phase(xs, state, *params, 2.0),
                       reps=REPS if n == chunk else 5)
        t_bytes = n * PLL_BYTES / HBM_BYTES_PER_S
        t_ops = n * PLL_OPS / FP32_FLOP_PER_S
        bound_ms = 1e3 * max(t_bytes, t_ops)
        floor_ms = n * ns_step / 1e6
        plain = ""
        if n == chunk:
            t0 = time.monotonic()
            pll.pll_phase_reference(xs, state, *params, 2.0)
            torch.cuda.synchronize()
            plain_ms = (time.monotonic() - t0) * 1e3
            plain = f"; twin {plain_ms:.1f} ms (host clock, one run)"
            entry = {"name": "pll_phase", "route": "cuda",
                     "source": "luaradio_tpu_torch/csrc/pll.cu",
                     "replaces": "luaradio_tpu/ops/pll.py:226",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms,
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "library_ms": None, "chain_floor_ms": floor_ms}
        log("K3", f"[{n} samples] {ms:.4f} ms per launch (median of "
                  f"{REPS if n == chunk else 5}), {n / ms / 1e3:.2f} M "
                  f"samples/s; bound {bound_ms:.6f} ms "
                  f"({n * PLL_BYTES / 1e6:.2f} MB at 3.35 TB/s); chain floor {floor_ms:.4f} ms "
                  f"({ns_step:.3f} ns a step x {n}); {ms / floor_ms:.2f}x "
                  f"the floor{plain}")
    return entry


def overlap_time(dev, gen, params, chunk):
    """The overlap-and-discard tier (not on the stereo path: it plans no
    segments for the graph's chunk) timed once on a chunk it plans for:
    2^16 samples of a noisy 19 kHz pilot at the IF rate, cold start."""
    from luaradio_tpu_torch.ops.pll_overlap import (plan_overlap,
                                                    pll_overlap_discard)
    if plan_overlap(chunk, float(params[0])) is not None:
        raise AssertionError(f"overlap tier plans for the {chunk}-sample "
                             f"graph chunk")
    n = 1 << 16
    lseg, warm = plan_overlap(n, float(params[0]))
    t = torch.arange(n, device=dev, dtype=torch.float64)
    x = (torch.polar(torch.ones_like(t), 2 * np.pi * 19e3 / (RATE / 5) * t)
         + 0.3 * torch.randn(n, generator=gen, device=dev,
                             dtype=torch.complex128)).to(torch.complex64)
    state = (0.0, 0.0, float(params[2]))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ok = bool(pll_overlap_discard(x, state, *params, 2, lseg, warm)[0])
    ms = (time.monotonic() - t0) * 1e3
    log("overlap", f"no plan for the graph's chunk of {chunk}; on {n} "
                   f"samples: {n // lseg} segments of {lseg} after {warm} "
                   f"warm-up steps, {ms:.1f} ms (host clock, one run, "
                   f"{warm + lseg} steps of [{n // lseg}] tensors), "
                   f"valid {ok}")


def profile_run(run, out, what):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    events = prof.key_averages()
    key = ("self_device_time_total"
           if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    dev_us = sum(getattr(e, key) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    table = events.table(sort_by=key, row_limit=30)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(table)
    log("profile", f"{what} under torch.profiler: run {wall:.4f} s "
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
    profile = profile_path(argv)
    with tempfile.TemporaryDirectory() as tmp:
        k2 = phase_graph(tmp, profile, dev, gen)
    k2["max_abs_err"] = max(k2["max_abs_err"], k2_err)
    k3_err = phase_pll_hold(dev, gen)
    with tempfile.TemporaryDirectory() as tmp:
        k3_launches, chunk = phase_stereo(tmp, profile)
    k3 = phase_pll_time(dev, gen, chunk)
    k3["launches"] = k3_launches
    k3["max_abs_err"] = max(k3["max_abs_err"], k3_err)
    entries = [k1, k2, k3]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys + tuple(
        x for x in e if x not in keys)} for e in entries]}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
