#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (luaradio_tpu_torch) once on a CUDA card.

    python3 chip_smoke.py [--profile PATH]

Needs one CUDA card and the CUDA toolkit (nvcc): the kernels are built from
csrc/ on first use.  Phases, each printed with the elapsed seconds:

1. device: the card's name and power limit (nvidia-smi) and count;
2. build: nvcc builds every kernel source and the measurement build of
   K1's halves, all at once, and cc the host wire conversions
   (native/src/format_conv.c);
2a. roofline: the roofline probes (csrc/roofline.cu) at [8, 2^23]
   float32: the HBM copies R1 (one load in flight a CTA) and R2 (loads
   kept in flight ahead of the stores), persistent rings of TMA bulk
   copies, held bit-equal to their twin and input there, on a ragged
   shape and on the shapes that reach their schedule's edges (fewer
   slabs than CTAs, a slab count no multiple of the grid, a partial last
   slab, byte counts no multiple of 16, one slab, a tail alone); R3
   (atan2 of each 2^15-column tile's halves) within 4.8e-7 rad of its
   twin, also on every pairing of signed zeros, infinities, NaN and
   extremes; each timed as a launch (CUDA events around one call) and
   as device time (CUDA-graph replay) beside its twin, its library call
   (copy_, torch.atan2) and its bound; R2's ring traced (%globaltimer)
   for the share of its loads' time a store was in flight; then
   benchmarks/bench_roofline.py once (copies and atan2 timed back to
   back), whose launches of R1-R3 are counted and whose object is
   printed;
2b. probes: the last three Pallas sites' kernels, each held against its
   twin on the card: the windowed gather S8 (csrc/window.cu) bit-equal at
   the script's shape [8, 2^16] and the flagship's [8, 2^23] (head 512,
   tile 8192) and on two ragged shapes, the PLL ablations S7
   (csrc/pll_ablate.cu) over 4096 samples for its four variants within
   1e-6, the flagship taken apart S4 (csrc/wbfm_proto.cu, a persistent
   ring) at its entry point's [8, 2^22] for every variant (the script's
   five, every other precision, the four stages: dma_only, deint_only
   and no_fir bit-equal, the FIR stages within 2e-5 * scale), at
   PROBE_S4_SHAPES and at the ring's S4_EDGES, the library's plan equal
   to the Python mirror's at each; then their entry points
   (benchmarks/dma_window.py, pll_ablate.py, wbfm_proto.py) once, launches counted, records printed and checked
   (S8 OK, S4's fp32 and split variants within 2e-5 of K1), their times,
   S7's chain floors and S8's library call read into the kernels line
   beside S4's twin timed at [8, 2^22], S4's and K1's device times, S4's
   issue-slot bound from the SASS of its discriminator loop, and S8's
   bound at R2's rate (both timed back to back by dma_window, so at R2's
   device rate);
3. K1 / K2: each kernel at the flagship's full width (8 channels x 4 194 304
   samples, D = 8, K = 640), on a ragged chunk, on an input 8 bytes off a
   16-byte boundary and under a compact plan (K = 16 384), held against
   its plain PyTorch twin (2e-5 * scale on the audio; the discriminator
   output, probed with a unit-impulse filter, wrap-aware), timed with CUDA
   events (median of 25) beside the twin, a conv1d yardstick and the
   bound; K1 also split into its discriminator and FIR halves (a
   measurement build of csrc/wbfm.cu); the planner's shared memory held
   against the built kernel's; K2 also at
   the chunk shape the README graph gives it (K = 512, D = 5), where its
   device time (CUDA-graph replay) stands beside an empty kernel's launch
   floor;
4. flagship: chained steps of the flagship receiver at full width (K1);
5. graph: the README receiver graph (IQ file -> Tuner -> WBFM mono ->
   Downsampler -> WAV) over a synthetic 4 s FM capture with a 3 kHz tone,
   for the f32 and the u8 wire, and again with the K2 rule on; the tone
   must come out within 50 Hz, and the K2 audio must match the default;
6. K3: the sequential PLL kernel held against its twin over 8 192
   samples (noise, carrier, zeros + carrier; multipliers 1, 2, 2.5), at
   the edges of its tile (N = 0, 1, tile - 1, tile, tile + 1,
   3 tile + 5), over two chained calls and at the stereo graph's chunk;
7. stereo: rx_wbfm's default stereo receiver through the port's CLI
   (cli.main, in this process) over an 8 s capture at 1 102 500 S/s (0.5 s
   of noise, then a stereo multiplex with L a 1 kHz and R a 400 Hz tone
   at ~30 dB SNR); the WAV must have 2 channels and the expected length,
   and L+R must carry both tones within 50 Hz at SNR > 1e4 over the
   second half; then the same graph by hand with the vector pilot, which
   must separate L and R by the JAX package's app-level margin (each
   channel's tone > 3x the other's);
8. K3 timed at the graph's chunk and at one 8 s stream at the IF rate
   (1 764 000 samples), per launch and as device time (CUDA-graph
   replay), beside its twin, its byte bound and the floor of its
   dependency chain (a probe kernel that runs only the chain), each time
   also as a ratio to that floor;
9. overlap: the overlap-and-discard scan's path, run after phase 7: the
   stereo graph with the PLL pilot at a chunk size that gives the PLL
   40 960 samples (5 segments of 8192), where the tier runs, with the L+R
   tones checked as in phase 7; the scan kernel held against its twin on
   each chunk the path gave it (valid flags equal, outputs within 1e-6);
   the graph run again with the twin in the kernel's place, whose L-R
   (the part the PLL demodulates) must match within 2 LSB.  Then the
   kernel held against its twin on a 2^16-sample chunk, timed there
   beside the twin, K3 and its own launch alone (a launch, and device
   time by CUDA-graph replay), whose device time a step stands beside a
   probe of the step's dependent chain;
10. am: rx_am --synchronous through the CLI over an 8 s AM capture (0.5 s
    of noise, then a carrier at the tuned frequency modulated 50 % by a
    1 kHz tone at ~30 dB SNR), where K3 must launch (multiplier 1, the
    AM loop's constants) and is held against its twin on every chunk it
    took; the WAV must have the expected length and the tone within 50 Hz
    at an amplitude margin > 10 over every bin but its harmonics (the
    slow AGC clips the audio after the noise); then rx_am's envelope
    receiver with the same check; K3 timed at the AM path's chunk;
11. analog: rx_nbfm (5 kHz deviation, 700 Hz tone), rx_ssb usb and lsb
    (a tone 1.2 kHz above the carrier: usb passes it, lsb keeps less than
    1/20 of its power), rx_raw with a tune offset (against the float64
    host translation, 1e-5) and iq_converter u8 -> f32 (equal to the host
    conversion), each through the CLI over 4 s;
12. bench graphs: bench.py's two graph shapes on the port (built by
    benchmarks/bench.py),
    UniformRandomSource -> WBFMMonoDemodulator -> Downsampler(8) ->
    BenchmarkSink at 2^22-sample chunks, and the same chain fed by a
    4 Mi-sample repeating u8 IQFileSource, streamed and device-resident,
    each for ~3 s; the resident run must make no host-to-device copy and
    give the streamed run's audio exactly over its first 3 chunks;
13. digital: rx_rds through the CLI over an 8 s capture at 1 102 500
    S/s (0.5 s of noise, then broadcast FM at 75 kHz deviation carrying
    the multiplex of tests/core/test_receivers.py with random RDS groups
    whose types lie outside 0, 2 and 4, ~30 dB SNR), where K3 must launch
    (multiplier 3: K3's third path) and is held against its twin on every
    chunk it took, the overlap scan against its twin on every chunk it
    ran, and 80 % of the groups sent after 1.5 s must come out as raw
    packets with none that was not sent; K3 timed at the RDS path's chunk
    beside phase 8's chain floor; then rx_pocsag and rx_ax25 at 1 102 500
    S/s and rx_ert --protocols=scm at 2 359 296 S/s through the CLI, each
    message equal to the one sent, and BPSK31Receiver as a graph at
    8000 S/s, whose text must come out;
13a. channelizer: the polyphase channelizer kernel
    (csrc/channelizer.cu) at the band cell's chunk ([1, 8 192 000], C
    100, q 16) and the bank-mono chunk ([1, 1 048 576], C 64, q 8), held
    against its twin (the stock path) over chained chunks (full, ragged,
    shorter than C q) and a batch of 3 rows (new states equal, channels
    within 2e-6 of their full scale); timed back to back, as device
    time (CUDA-graph replay) and a launch beside the twin and its bound;
13b. pll-linear: the PLL's linear tier as one kernel
    (csrc/pll_linear.cu) held against its twin on the card: three chunks
    of the AM band cell's graph ([117, 65 536] at multiplier 1; one
    launch a PLL chunk, the twin never on the card, every row leaving the
    linear tier), a locked stereo pilot ([1, 52 430] at multiplier 2, the
    row cut in segments) and 8 RDS pilots ([8, 65 536] at multiplier 3),
    two chained chunks each: flags equal on every row, out within 1e-5,
    err and the new state within 1e-5 + 2^-22 max|tau| (or out and err
    within those limits of a float64 walk of the same loop and nearer it
    than the twin, where the twin's float32 rounding nears them); timed
    (device by torch.profiler, back to back, a launch) beside the twin
    and its bound (20 B a sample at 3.35 TB/s);
14. bank-mono: the channelizer bank at full width, a 2 s capture at
    16 384 000 S/s (8 WBFM stations with their own tones on channel bins
    over both halves of the span, ~30 dB SNR in a channel) -> ChannelizerBlock
    (64, 8) -> WBFMMonoDemodulator -> Downsampler(8) in chunks of 64 x
    16 384 (examples/wideband_channelizer_bank.py at 64 channels), the
    channelizer kernel launched once a chunk (the kernels line's
    ``channelize`` launches; no chunk on the stock path): each
    tone within 50 Hz on its row, its tone bin > 100x the quiet rows'
    median there; again under the K2 rule, where K2 must launch once a
    chunk on all 64 rows, match its twin on the path's first chunk and
    give the default run's audio within 2e-5 * scale;
15. bank-stereo: 64 IQ files at 256 000 S/s, 2 s each (0.25 s of noise;
    8 rows then carry the stereo multiplex with L and R tones of their
    own) through BankSource -> WBFMStereoDemodulator (PLL pilot) with
    run(channels=64): K3 must launch with more than one row a launch and
    at most once a chunk, every row of every launch must equal its
    one-row launch bit for bit and the twin holds 4 rows of the first;
    each station's L+R carries its tones at SNR > 1e4; three station rows
    and two noise rows equal the single-stream graph on their files;
    then the same graph at the chunk where the overlap tier plans, the
    scan's banked launches held the same way;
16. K3 and the scan timed batched on 1, 8, 64, 132 and 264 rows at those
    chunks (device time), beside one row and their chain floors;
17. bank-classes: WBFMMonoBank, WBFMStereoBank and RDSBank at 64 channels
    over 4 chunks of 2^17 samples, each row within 2e-4 * scale of the
    port's block chain run banked on the same rows, each timed;
18. bank-host: a BankSource of 8 POCSAG captures at 1 102 500 S/s (4
    carry their own message) through Tuner -> POCSAGReceiver with
    run(channels=8): each row decodes what it carries, the noise rows
    nothing;
18a. bank-pinned: a BankSource of 64 u8 IQ files (random bytes of
    unequal length: 6 chunks of 2^18 samples a row and a short one)
    through the Runner with run(channels=64), the pump held back until
    the read-ahead has read 4 chunks; every wire chunk must be staged in
    a pinned block (Feed.pinned_chunks, BankSource.wire_reads), and the
    converted rows must equal the same graph's on the host route bit for
    bit;
19. blocks: every row of the reference block benchmark (bench_blocks.py
    :150-310, the port's list in benchmarks/bench_blocks.py) timed through
    the Runner by that module at its chunk (2^22, its overrides), the two IIR rows and
    the five back-to-back FFT FIRs also with optimize=False; the noise-fed
    PLL row must launch K3 and the acquiring row the overlap scan, and
    each block new in the slice (IIR of order 2 and 4, the FFT FIR's
    three signatures, the FM, PAM and QAM modulators, the squelch,
    interleave, deinterleave, nop, the real and raw file sources) is held
    against the same graph on the CPU; each PLL row's first K3 launch and
    first overlap scan, recorded on the row's 2^22-sample inputs, against
    their twins, K3 timed alone on the noise-fed row's (CUDA events,
    beside its bound and chain floor) and the scan's launch alone on the
    acquiring row's (a launch and device time, ns a step beside the chain
    probe at the row's constants);
20. fir-fft: fir_fft and the direct cuDNN FIR timed for a 129-tap real
    FIR on [64, 65 536] and [1, 2^22];
21. roundtrip: the FM self test module on the card (tone within 50 Hz),
    its demodulator under the K2 rule (K2 launches, its twin on the first
    chunk, the audio within 2e-5 * scale of the default); the SSB
    modulator module on a 1.2 kHz WAV, usb and lsb, into rx_ssb usb
    through the CLI (usb passes the tone, lsb keeps < 1/20 of its power);
    real, raw, WAV and JSON files through the new sources and sinks;
22. eager: the README graph in eager mode writes the fused run's WAV byte
    for byte, and Runner(trace=True) records the four span names;
23. newton: pll_newton_scan with K3 as its fallback on a phase-step input
    (some segments converge, some fall back): K3 launches and the result
    equals the same call with K3's twin within 1e-5;
24. io-wire: every SDR driver's wire type (u8, s8, the five s16 scales)
    over all of its codes: device_ingest on the card equal to read()'s
    host conversion bit for bit;
25. live: the port's rtlsdr_wbfm_mono, rtlsdr_am_synchronous (K3 at
    multiplier 1) and rtlsdr_rds (K3 at multiplier 3) example modules on
    the card, fed by an in-process fake librtlsdr paced at 1 102 500
    complex samples/s with the graph, am and rds phases' captures (4, 4
    and 8 s; u8 wire) into a fake libpulse-simple (DISPLAY set) or the
    RDS JSON: the tone within 50 Hz or the RDS groups held as in phase
    13, no ring overflow or dropped sample, the source on the wire path,
    K3's launches counted (at least one on the two PLL paths), the wall
    time within 1.25x the capture, the card's busy share (torch.profiler,
    device activity);
26. net: the README mono receiver fed over loopback TCP and a UNIX
    socket by NetworkClientSource and NetworkServerSource (u8 and
    f32le, sent unpaced), each audio equal to the IQ file's bit for bit;
    rx_wbfm --mono into -o networkserver (equal to -o realfile) and
    rx_rds into -o networkclient,format=json (equal to phase 13's
    packets) through the CLI;
27. plot-tx: the gnuplot spectrum and waterfall sinks fed from the card
    through a fake gnuplot on PATH (the peak on the tone's bin), and
    HackRFSink fed by the FM modulator through a fake TX library (the s8
    wire equal to the host conversion);
28. time: time sharding on the one card (parallel/mesh.py): the README
    graph over the graph phase's captures (f32 and u8 wire) on a
    ("time",) mesh of 4, audio within 1e-5 of the serial run and the
    tone within 50 Hz; bench.py's random graph at 2^22-sample chunks in
    8 shards beside the serial run (complex samples/s, host clock; the
    card's busy share, torch.profiler); the bench u8 file graph from its
    resident ring in 8 shards, equal to the serial resident run within
    1e-5; the RDS receiver (vector pilot) over the rds phase's capture in
    4 shards, its packets equal to its serial run's and its late groups
    to the rds phase's; WBFMMonoBank at 64 channels on a (64, 4)
    ("channel", "time") mesh within 2e-4 * scale of its one-card run;
    K1, K2 and K3 must launch 0 times over the phase;
29. multihost: two processes of this script (``--multihost-worker``) on
    the card joined over gloo, each holding two of a ("time",) mesh's 4
    shards: the README graph over both captures, the per-process blocks
    reassembled within 1e-5 of the serial run; then the bank-host
    graph's 8 POCSAG rows on a process-spanning ("channel",) mesh, 4 a
    process, each row's messages as sent; joined with a hard limit;
30. embed: cc builds native/src/embed.c and the port's lifecycle program
    (luaradio_tpu_torch/utils/embed.py), which runs a graph on the card
    through the C API (errors, start, running, wait, stopped, stop), its
    output equal to the Python run's;
31. entries: the port's measurement entry points (benchmarks/): bench
    (its four rows at 3 s each, every row run, K1 launched), bench_scaling
    up to 8 shards (each mesh's bank audio within 1e-6 of one shard's),
    bench_realtime paced for 8 s (ok), the bench_multihost scenarios the
    multihost phase does not run (resident ring, bit bank, RDS bank,
    overhead; each against its serial run), entry() against the same
    step on the CPU and dryrun_multichip(8), and the examples
    iqfile_converter, iqfile_wbfm_stereo, channel_bank_pod and
    wideband_channelizer_bank against the same modules on the CPU;
32. the kernels line (K1, K2, K3, the scan, the channelizer, the linear
    tier, R1, R2, R3, S4, S7, S8) and the final status line.

Launch counts are zeroed just before the flagship, the K2 graph run, the
stereo CLI run, the overlap path run, the rx_am --synchronous run, the
rx_rds run, the bank-mono K2 run, the two bank-stereo runs, each block
row, the FM round trip under the K2 rule, the newton call and each paced
live example, the time phase (where each must stay at 0), the
bench_roofline run (R1-R3), the three probes' entry points (S4, S7, S8)
and the port's bench run (K1), and read just after: each kernel must have run on its path.  Any failure
raises (non-zero exit); a hang ends the run with a traceback after 480 s.
``--profile PATH`` also writes a torch.profiler table of one mono graph
run to PATH, of the stereo run to PATH.stereo.txt, of the rx_am
--synchronous run to PATH.am.txt, of 50 chunks of each bench graph to
PATH.bench_<row>.txt, of the rx_rds run to PATH.rds.txt and of the
bank-mono and bank-stereo runs to PATH.bank_mono.txt and
PATH.bank_stereo.txt.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import faulthandler
import io
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import wave

import numpy as np
import torch

from luaradio_tpu_torch import (VARICODE, BankSource, BenchmarkSink,
                                BPSK31Receiver, ChannelizerBlock,
                                ComplexFloat32, CompositeBlock, DelayBlock,
                                DownsamplerBlock, FrequencyDiscriminatorBlock,
                                HilbertTransformBlock, HostSourceBlock, Input,
                                IQFileSource, LowpassFilterBlock,
                                MultiplyConjugateBlock, Output,
                                PilotRecoveryBlock, POCSAGReceiver,
                                RootRaisedCosineFilterBlock, RtlSdrSource,
                                SinkBlock, TunerBlock, WAVFileSink,
                                WBFMMonoDemodulator, WBFMStereoDemodulator)
import luaradio_tpu_torch as lr
from luaradio_tpu_torch import cli
from luaradio_tpu_torch.blocks.protocol import ax25 as ax25_proto
from luaradio_tpu_torch.blocks.sinks import audio
from luaradio_tpu_torch.blocks.protocol import ert as ert_proto
from luaradio_tpu_torch.blocks.protocol import pocsag as pocsag_proto
from luaradio_tpu_torch.blocks.protocol import rds as rds_proto
from luaradio_tpu_torch.benchmarks import bench as pbench
from luaradio_tpu_torch.benchmarks import bench_blocks as pblocks
from luaradio_tpu_torch.benchmarks import bench_roofline as proofline
from luaradio_tpu_torch.benchmarks import dma_window as pbench_dma
from luaradio_tpu_torch.benchmarks import pll_ablate as pbench_pll
from luaradio_tpu_torch.benchmarks import wbfm_proto as pbench_s4
from luaradio_tpu_torch.blocks.signal import carrier
from luaradio_tpu_torch.core import runtime as runtime_mod
from luaradio_tpu_torch.core.ingest import Feed
from luaradio_tpu_torch.core.runtime import Runner
from luaradio_tpu_torch.ops import (channelizer, cudabuild, pll, pll_ablate,
                                   pll_linear, pll_overlap, roofline, wbfm,
                                   wbfm_proto, window)
from luaradio_tpu_torch.ops.complexutil import (complex_to_wire,
                                                wire_to_complex)
from luaradio_tpu_torch.ops.fir import _conv_real
from luaradio_tpu_torch.parallel.flagship import (INV_GAIN,
                                                  make_wbfm_mono_step,
                                                  wbfm_mono_taps)
from luaradio_tpu_torch.parallel.mesh import Mesh
from luaradio_tpu_torch.parallel.rds import RDSBank
from luaradio_tpu_torch.parallel.wbfm import WBFMMonoBank, WBFMStereoBank
from luaradio_tpu_torch.types import number_to_bits
from luaradio_tpu_torch.utils import format as format_utils
from luaradio_tpu_torch.utils import native
from luaradio_tpu_torch.utils.network import NetworkClient, NetworkServer

T0 = time.monotonic()
#: a hang ends the run with a traceback after this many seconds; a whole
#: run, build included, takes about four minutes on the card (five with
#: --profile)
HANG_S = 480
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
#: the overlap scan's operations a step and segment (atan2, two sin and
#: two cos as one each; 30 products and sums; clamp)
OVERLAP_OPS = 36
PLL_SPAN = 8192
STEREO_S, NOISE_S = 8, 0.5
#: the graph chunk (samples at the source) that gives the stereo PLL
#: 40 960-sample chunks, which plan_overlap splits into segments
OVERLAP_CHUNK = 204800
TONE_L, TONE_R = 1000.0, 400.0
AM_S, AM_TONE, NBFM_TONE, SSB_TONE = 8, 1000.0, 700.0, 1200.0
ANALOG_S = 4
#: bench.py's graph rows: a 2^22-sample chunk at 256 kS/s, a 4 Mi-sample
#: u8 capture for the file rows, and the seconds each row runs
BENCH_CHUNK, BENCH_FILE, BENCH_S = 1 << 22, 4 << 20, 3.0
#: the digital phase: the RDS capture's seconds, the RDS bit rate, and
#: the ERT capture's rate (36 x 65 536: whole samples a chip)
DIGITAL_S, RDS_BAUD, ERT_RATE = 8, 1187.5, 2359296
#: the bank phases: the wideband capture's rate and seconds, the bank's
#: channels (BASELINE.json's fifth configuration) and the channel bins
#: of its stations, over both halves of the span
BANK_RATE, BANK_S, BANK_C = 16384000, 2, 64
BANK_STATIONS = (3, 11, 19, 27, 36, 44, 52, 60)
#: the stereo bank: rate, seconds, the noise before the stations, the
#: chunk (and so the PLL's chunk), the station rows; the rows K3 and the
#: scan are timed on; the bank classes' chunk and chunks
ST_RATE, ST_S, ST_NOISE, ST_CHUNK = 256000, 2, 0.25, 64000
#: the stereo bank's chunk where the overlap tier plans (8 segments of
#: 8192): its banked path
ST_SCAN_CHUNK = 65536
ST_STATIONS = (2, 9, 17, 25, 33, 41, 49, 57)
BATCH_ROWS = (1, 8, 64, 132, 264)
CLASS_CHUNK, CLASS_CHUNKS = 1 << 17, 4
#: the blocks phase: bench_blocks.py's chunk (benchmarks/bench_blocks.py
#: holds its overrides), its file sources' samples, the seconds each row
#: is timed; the chunk and chunks over which each new block is held
#: against the CPU (the FM modulator at its CPU test's 8192: a float32
#: cumsum's rounding grows with the chunk); the newton phase's samples
BLOCK_CHUNK, BLOCK_FILE, ROW_S = 1 << 22, 4 << 20, 0.3
HOLD_CHUNK, HOLD_CHUNKS = 1 << 18, 2
NEWTON_N = 1 << 16
#: the live phase: the mono and AM captures' seconds (the RDS capture is
#: DIGITAL_S), and the limit on a paced run's wall time over the
#: capture's length
LIVE_S, LIVE_SLACK = 4, 1.25
#: the net phase: the limit on any socket wait or thread join
NET_TIMEOUT = 60.0
#: the plot-tx phase: the plot's rate, PSD size and the tone's bin (6
#: kHz); the transmit rate and chunk
PLOT_RATE, PLOT_N, PLOT_BIN = 48000.0, 1024, 128
TX_RATE, TX_CHUNK = 2e6, 1 << 16


def log(phase: str, msg: str):
    print(f"[{time.monotonic() - T0:7.1f} s] {phase}: {msg}", flush=True)


def graph_ms(fn, n: int = 20, reps: int = 10) -> float:
    """Device time of one call: ``n`` calls captured in a CUDA graph and
    replayed ``reps`` times, median replay over ``n``.  Unlike median_ms
    it counts no host time between launches, which at a small shape is
    most of a launch's wall time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


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
    k1.update(k1_halves(complex_to_wire(xc), carry, taps, k1["ms"]))
    k1["max_abs_err"] = max(k1["max_abs_err"], compare(
        "wbfm_mono", _k1, _k1_twin,
        [("8 bytes off 16", misaligned(complex_to_wire(xc[:, :1 << 20])),
          carry)], taps))
    k2_err = compare("disc_fir", _k2, _k2_twin,
                     [("full width", xc, carry), ("ragged", rxc, rcarry)],
                     taps)
    k2_err = max(k2_err, compact_case(dev, gen))
    check_plans([(C, T, k, D), (C, T_RAGGED, k, D), (1, 52430, 512, 5),
                 (2, 1 << 16, 16384, 16)])
    probe_discriminator("disc_fir", _k2, (pxc, pcarry, pm))
    measure("disc_fir", _k2, _k2_twin, xc, carry, taps, D)
    return k1, k2_err, complex_to_wire(xc)


def misaligned(x):
    """x copied to a tensor that starts 8 bytes off a 16-byte boundary
    (the loader's scalar head and tail)."""
    flat = torch.empty(x.numel() + 2, dtype=x.dtype, device=x.device)
    y = flat[2:].view(x.shape)
    y.copy_(x)
    if y.data_ptr() % 16 != 8:
        raise AssertionError("misaligned copy is aligned")
    return y


def k1_halves(x, carry, taps, ms):
    """K1's time split into its discriminator and its FIR (the
    measurement build of csrc/wbfm.cu, wbfm.k1_half; their output is not
    the audio and they count no launch)."""
    c, t = x.shape[0], x.shape[1] // 2
    p = wbfm.plan(c, t, taps.shape[0], D)
    disc_ms = median_ms(lambda: wbfm.k1_half(carry, x, taps, D, INV_GAIN, p,
                                             1))
    fir_ms = median_ms(lambda: wbfm.k1_half(carry, x, taps, D, INV_GAIN, p,
                                            2))
    log("wbfm_mono", f"halves under {p}: discriminator alone {disc_ms:.4f} "
                     f"ms, FIR alone {fir_ms:.4f} ms, both {ms:.4f} ms")
    return {"disc_ms": disc_ms, "fir_ms": fir_ms}


def compact_case(dev, gen):
    """K2 under a compact plan (16 384 taps at D = 16: one float32 copy of
    the m ring and the taps), held against the twin."""
    k, d, t = 16384, 16, 1 << 16
    p = wbfm.plan(2, t, k, d)
    if not p.compact:
        raise AssertionError(f"plan for K={k}, D={d} is not compact: {p}")
    taps = torch.from_numpy((np.hanning(k) / (k / 2)).astype(np.float32)
                            ).to(dev)
    z = fm_like(gen, 2, t + k, dev)
    return compare("disc_fir", lambda c, x, h: _k2(c, x, h, d),
                   lambda c, x, h: _k2_twin(c, x, h, d),
                   [(f"compact plan K={k} D={d}", z[:, k:].contiguous(),
                     z[:, :k].contiguous())], taps)


def check_plans(shapes):
    """The planner's shared memory against the built kernel's, and the
    blocks an SM takes under each plan."""
    for c, t, k, d in shapes:
        p = wbfm.plan(c, t, k, d)
        built = wbfm.kernel_smem_bytes(k, d, p)
        if built != p.smem:
            raise AssertionError(f"plan {p}: kernel needs {built} bytes of "
                                 f"shared memory, the planner says {p.smem}")
        log("plan", f"[{c} x {t}, K={k}, D={d}] {p}: {p.strips * c} blocks, "
                    f"{wbfm.occupancy(k, d, p)} a SM")


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
    run = lambda c, xx, h: _k2(c, xx, h, d)  # noqa: E731
    entry.update(measure("disc_fir", run,
                         lambda c, xx, h: _k2_twin(c, xx, h, d), x, carry,
                         blk._taps, d))
    entry["device_ms"] = graph_ms(lambda: run(carry, x, blk._taps))
    entry["launch_floor_ms"] = median_ms(lambda: wbfm.empty_launch(dev))
    entry["launch_floor_device_ms"] = graph_ms(lambda: wbfm.empty_launch(dev))
    log("disc_fir", f"graph chunk [1 x {t}]: {entry['ms']:.4f} ms a launch, "
                    f"{entry['device_ms']:.4f} ms device time (CUDA-graph "
                    f"replay); empty kernel {entry['launch_floor_ms']:.4f} ms "
                    f"a launch, {entry['launch_floor_device_ms']:.4f} ms "
                    f"device time; {wbfm.plan(1, t, k, d)}")
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


def pll_diff(label, got, exp):
    """|a - b| of two K3 results (out, err modulo 2 pi, the phases modulo
    2 pi, the frequency), after checking shapes and finiteness."""
    if got[0].shape != exp[0].shape or got[1].shape != exp[1].shape:
        raise AssertionError(f"pll_phase {label}: shapes "
                             f"{[tuple(g.shape) for g in got]} vs "
                             f"{[tuple(e.shape) for e in exp]}")
    if not all(torch.isfinite(torch.view_as_real(g) if g.is_complex()
                              else g).all() for g in got):
        raise AssertionError(f"pll_phase {label}: non-finite output")
    n = got[0].numel()
    return [(got[0] - exp[0]).abs().max().item() if n else 0.0,
            wrap_err(got[1], exp[1], 2 * np.pi) if n else 0.0,
            wrap_err(got[2][:2], exp[2][:2], 2 * np.pi),
            (got[2][2] - exp[2][2]).abs().item()]


def compare_pll(label, x, state, params, mult):
    """K3 against its twin on one input: out and err (err modulo 2 pi)
    and the state.  They round every operation alike and call the same
    atan2f/cosf/sinf, so they are expected to agree exactly; the limit is
    1e-5.  Returns the largest error."""
    got = pll.pll_phase(x, state, *params, mult)
    exp = pll.pll_phase_reference(x, state, *params, mult)
    torch.cuda.synchronize()
    errs = pll_diff(label, got, exp)
    if max(errs) > 1e-5:
        raise AssertionError(f"pll_phase {label}: |kernel - twin| (out, "
                             f"err, phases, freq) = {errs} > 1e-5")
    return max(errs)


def phase_pll_hold(dev, gen):
    """K3 against its twin over PLL_SPAN samples: three inputs x three
    multipliers, the stereo PLL's constants.  Then at the edges of the
    kernel's tile (N = 0, 1, tile - 1, tile, tile + 1, 3 tile + 5), and
    over two chained calls."""
    params = stereo_pll_params()
    state = torch.tensor([0.3, -0.5, float(params[2])], device=dev)
    worst = 0.0
    for name, x in pll_cases(gen, dev).items():
        for mult in (1.0, 2.0, 2.5):
            err = compare_pll(f"{name} x{mult}", x, state, params, mult)
            worst = max(worst, err)
            log("K3", f"{name}, multiplier {mult}, {x.shape[0]} samples: "
                      f"max |kernel - twin| {err:.3g} (limit 1e-5)")
    tile = pll.kernel_tile()
    if tile != pll.TILE:
        raise AssertionError(f"pll_phase: the built kernel's tile {tile} is "
                             f"not ops/pll.py's TILE {pll.TILE}")
    edges = (0, 1, tile - 1, tile, tile + 1, 3 * tile + 5)
    edge = 0.0
    for n in edges:
        for name, x in pll_cases(gen, dev, n).items():
            for mult in (1.0, 2.0, 2.5):
                edge = max(edge, compare_pll(f"{name} x{mult} N={n}", x,
                                             state, params, mult))
    log("K3", f"tile edges N = {edges} (tile {tile}), three inputs x "
              f"multipliers 1, 2, 2.5: max |kernel - twin| {edge:.3g} "
              f"(limit 1e-5)")
    return max(worst, edge, hold_pll_chained(dev, gen, params, state, tile))


def hold_pll_chained(dev, gen, params, state, tile):
    """K3 over two chained calls (3 tile + 5 samples split at tile + 7,
    the state passed on) against its twin's two chained calls (limit
    1e-5, 0 expected).  Against one call over the concatenation they
    depart through the state, which crosses calls as float32 radians in
    both: held at the twin's float64-oracle tolerances (err and phases
    1e-3, out 5e-2, frequency 1e-5; tests/test_torch_pll_split.py)."""
    worst = apart = 0.0
    cut = tile + 7
    for name, x in pll_cases(gen, dev, 3 * tile + 5).items():
        for mult in (1.0, 2.0, 2.5):
            runs = {}
            for fn in (pll.pll_phase, pll.pll_phase_reference):
                s, outs, errs = state, [], []
                for xc in (x[:cut], x[cut:]):
                    o, e, s = fn(xc.contiguous(), s, *params, mult)
                    outs.append(o)
                    errs.append(e)
                runs[fn] = (torch.cat(outs), torch.cat(errs), s)
            label = f"chained {name} x{mult}"
            errs = pll_diff(label, runs[pll.pll_phase],
                            runs[pll.pll_phase_reference])
            if max(errs) > 1e-5:
                raise AssertionError(f"pll_phase {label}: |kernel - twin| "
                                     f"{errs} > 1e-5")
            worst = max(worst, *errs)
            d = pll_diff(label, runs[pll.pll_phase],
                         pll.pll_phase(x, state, *params, mult))
            if d[0] >= 5e-2 or max(d[1], d[2]) >= 1e-3 or d[3] >= 1e-5:
                raise AssertionError(f"pll_phase {label}: two calls vs one "
                                     f"{d}")
            apart = max(apart, *d)
    log("K3", f"two chained calls (split at {cut} of {3 * tile + 5}): max "
              f"|kernel - twin| {worst:.3g} (limit 1e-5); against one call "
              f"{apart:.3g} (the radian state's rounding)")
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


def record_pll_chunks(scanned=None, kernel=None):
    """Wrap PLLBlock.process to record (chunk length, tier) of every chunk
    a PLL runs; returns the list and a function that unwraps it.  Given a
    list ``scanned``, also appends (x, state, params) of every chunk on
    which ``kernel`` (default: the overlap scan kernel) launched, copied
    as the chunk entered the block: the inputs the path gave the
    kernel."""
    seen, process = [], carrier.PLLBlock.process
    kernel = kernel or pll_overlap.pll_overlap_discard

    def recording(self, state, x):
        before = dict(self.tier_counts)
        if scanned is not None:
            n0 = kernel.launches
            copy = (x.clone(), tuple(torch.as_tensor(v).clone()
                                     for v in state))
        out = process(self, state, x)
        seen.append((x.shape[-1], [k for k in self.tier_counts
                                   if self.tier_counts[k] != before[k]]))
        if scanned is not None and kernel.launches > n0:
            scanned.append(copy + ((self._alpha, self._beta,
                                    self._freq_min, self._freq_max,
                                    int(self.multiplier)),))
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
    pilot graph by hand, then the overlap tier's path.  Returns (K3
    launches, the PLL's chunk length, phase_overlap_path's result)."""
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
    top = stereo_graph(path, vwav, pilot="vector")
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
    return launches, seen[0][0], phase_overlap_path(path, n, rate, want)


def stereo_graph(path, wav, pilot="pll"):
    """rx_wbfm's stereo receiver built by hand: IQ file -> Tuner ->
    WBFMStereoDemodulator -> two Downsamplers -> stereo WAV."""
    top = CompositeBlock()
    demod = WBFMStereoDemodulator(pilot=pilot)
    l_ds, r_ds = DownsamplerBlock(5), DownsamplerBlock(5)
    sink = WAVFileSink(wav, 2)
    top.connect(IQFileSource(path, "f32le", RATE),
                TunerBlock(0, 200e3, 5), demod)
    top.connect(demod, "left", l_ds, "in")
    top.connect(demod, "right", r_ds, "in")
    top.connect(l_ds, "out", sink, "in1")
    top.connect(r_ds, "out", sink, "in2")
    return top


def phase_overlap_path(path, n, rate, want):
    """The overlap tier's path: the PLL-pilot stereo graph at a chunk size
    that gives the PLL 40 960 samples, which plan_overlap splits into 5
    segments of 8192; the noise and acquisition chunks fail the linear
    tier and take the overlap scan.  Then the scan kernel held against its
    twin on the very chunks the path gave it, and the graph run again with
    the twin in the kernel's place, whose L-R (which the PLL's doubled
    pilot demodulates; L+R does not pass through it) must match.  Returns
    (the scan kernel's launches, its largest error)."""
    tmp = os.path.dirname(path)
    wav = os.path.join(tmp, "overlap.wav")
    stereo_graph(path, os.path.join(tmp, "warm2.wav")).run(
        chunk_size=OVERLAP_CHUNK, max_chunks=2)                  # warm-up
    scanned = []
    seen, restore = record_pll_chunks(scanned)
    try:
        pll_overlap.pll_overlap_discard.launches = 0
        pll.pll_phase.launches = 0
        t0 = time.monotonic()
        stereo_graph(path, wav).run(chunk_size=OVERLAP_CHUNK)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        launches = pll_overlap.pll_overlap_discard.launches
        k3 = pll.pll_phase.launches
    finally:
        restore()
    tiers = [t[0] for _, t in seen]
    pcm, _ = read_wav(wav)
    if launches < 1 or pcm.shape != (want, 2) or seen[0][0] % 8192 \
            or len(scanned) != launches:
        raise AssertionError(f"overlap path: {launches} scan launches over "
                             f"PLL chunks of {seen[0][0]} ({len(scanned)} "
                             f"recorded), WAV {pcm.shape}")
    mono = pcm[:, 0].astype(np.float64) + pcm[:, 1]
    for tone in (TONE_L, TONE_R):
        f, snr = tone_snr(mono, rate, tone)
        if abs(f - tone) > 50 or snr <= 1e4:
            raise AssertionError(f"overlap path: L+R tone {tone} Hz found "
                                 f"at {f:.1f} Hz with SNR {snr:.3g}")
    log("overlap", f"path: PLL-pilot stereo graph at chunk_size "
                   f"{OVERLAP_CHUNK}, {len(seen)} PLL chunks of {seen[0][0]}"
                   f" (tiers: linear {tiers.count(1)}, overlap "
                   f"{tiers.count(2)}, sequential {tiers.count(3)}); scan "
                   f"launches {launches}, K3 launches {k3}; L+R tones held; "
                   f"{n / dt / 1e6:.2f} M complex samples/s end to end")
    err = max(hold_overlap(f"path chunk {i}", x, state, params)[0]
              for i, (x, state, params) in enumerate(scanned))
    twin_wav = os.path.join(tmp, "overlap_twin.wav")
    kernel = pll_overlap.pll_overlap_discard
    twin_seen, restore = record_pll_chunks()
    pll_overlap.pll_overlap_discard = \
        pll_overlap.pll_overlap_discard_reference
    try:
        t0 = time.monotonic()
        stereo_graph(path, twin_wav).run(chunk_size=OVERLAP_CHUNK)
        twin_dt = time.monotonic() - t0
    finally:
        pll_overlap.pll_overlap_discard = kernel
        restore()
    tpcm, _ = read_wav(twin_wav)
    side = pcm[:, 0].astype(np.int32) - pcm[:, 1]
    twin_side = tpcm[:, 0].astype(np.int32) - tpcm[:, 1]
    d_side = int(np.abs(side - twin_side).max())
    twin_tiers = [t[0] for _, t in twin_seen]
    if tpcm.shape != pcm.shape or twin_tiers != tiers or d_side > 2:
        raise AssertionError(f"overlap path: twin-run graph tiers "
                             f"{twin_tiers} vs {tiers}, WAV {tpcm.shape}, "
                             f"max |L-R - twin's L-R| {d_side} LSB (limit "
                             f"2)")
    log("overlap", f"path with the twin in the scan's place: the same "
                   f"tiers; L-R (rms {side.std():.1f} LSB) off the twin "
                   f"run's by at most {d_side} LSB (limit 2, 0 expected); "
                   f"twin-run graph {twin_dt:.1f} s against {dt:.1f} s")
    return launches, err


def hold_overlap(label, x, state, params):
    """The overlap scan kernel against its twin on one chunk, as
    pll_hybrid calls it (the chunk's plan_overlap plan).  They round
    every operation alike and call the same atan2f/sinf/cosf, so valid
    flags must be equal and outputs and state agree within 1e-6 (0
    expected).  Returns the largest error and the twin's time (host
    clock, one run, in ms)."""
    n = x.shape[-1]
    lseg, warm = pll_overlap.plan_overlap(n, float(params[0]))
    got = pll_overlap.pll_overlap_discard(x, state, *params, lseg, warm)
    t0 = time.monotonic()
    exp = pll_overlap.pll_overlap_discard_reference(x, state, *params,
                                                    lseg, warm)
    torch.cuda.synchronize()
    plain_ms = (time.monotonic() - t0) * 1e3
    errs = [(got[2] - exp[2]).abs().max().item(),
            (got[3] - exp[3]).abs().max().item(),
            max(abs(float(a) - float(b)) for a, b in zip(got[1], exp[1]))]
    if bool(got[0]) != bool(exp[0]) or max(errs) > 1e-6:
        raise AssertionError(f"overlap {label}: valid {bool(got[0])} vs "
                             f"{bool(exp[0])}, |kernel - twin| (out, err, "
                             f"state) = {errs} > 1e-6")
    log("overlap", f"{label} [{n} samples, {n // lseg} segments of {lseg} "
                   f"after {warm} warm-up steps]: valid {bool(got[0])} "
                   f"(twin {bool(exp[0])}); max |kernel - twin| (out, err, "
                   f"state) {errs[0]:.3g} / {errs[1]:.3g} / {errs[2]:.3g} "
                   f"(limit 1e-6); twin {plain_ms:.1f} ms")
    return max(errs), plain_ms


def phase_pll_time(dev, gen, chunk):
    """K3 timed at the stereo graph's chunk and at one 8 s stream at the
    IF rate, per launch and as device time (CUDA-graph replay), beside its
    twin (at the chunk), its byte bound and the floor of its dependency
    chain, measured in this run."""
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
    entry = None
    for n in (chunk, STEREO_S * RATE // 5):
        xs = x if n == chunk else fm_like(gen, 1, n, dev)[0].contiguous()

        def run():
            pll.pll_phase(xs, state, *params, 2.0)
        ms = median_ms(run, reps=REPS if n == chunk else 5)
        dev_ms = graph_ms(run, *((20, 10) if n == chunk else (3, 3)))
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
                     "library_ms": None, "chain_floor_ms": floor_ms,
                     "floor_ratio": ms / floor_ms, "graph_ms": dev_ms,
                     "graph_floor_ratio": dev_ms / floor_ms,
                     "chain_ns_per_step": ns_step}
        else:
            t0 = time.monotonic()
            pll.pll_phase_reference(xs, state, *params, 2.0)
            plain_ms = (time.monotonic() - t0) * 1e3
            plain = f"; twin {plain_ms:.1f} ms (host clock, one run)"
            entry[f"at_{n}"] = {"ms": ms, "graph_ms": dev_ms,
                                "chain_floor_ms": floor_ms,
                                "floor_ratio": ms / floor_ms,
                                "graph_floor_ratio": dev_ms / floor_ms,
                                "bound_ms": bound_ms, "plain_ms": plain_ms}
        log("K3", f"[{n} samples] {ms:.4f} ms per launch (median of "
                  f"{REPS if n == chunk else 5}), device {dev_ms:.4f} ms "
                  f"(CUDA-graph replay), {n / ms / 1e3:.2f} M "
                  f"samples/s; bound {bound_ms:.6f} ms "
                  f"({n * PLL_BYTES / 1e6:.2f} MB at 3.35 TB/s); chain floor {floor_ms:.4f} ms "
                  f"({ns_step:.3f} ns a step x {n}); {ms / floor_ms:.3f}x "
                  f"the floor a launch, {dev_ms / floor_ms:.3f}x device"
                  f"{plain}")
    # a fractional multiplier (no receiver uses one): the phi_m walk
    ms = median_ms(lambda: pll.pll_phase(x, state, *params, 2.5))
    t0 = time.monotonic()
    pll.pll_phase_reference(x, state, *params, 2.5)
    plain_ms = (time.monotonic() - t0) * 1e3
    entry["mult_2_5"] = {"ms": ms, "plain_ms": plain_ms}
    log("K3", f"[{chunk} samples, multiplier 2.5] {ms:.4f} ms per launch "
              f"(median of {REPS}); twin {plain_ms:.1f} ms (host clock, "
              f"one run)")
    return entry


def phase_overlap_hold(dev, gen, chunk):
    """The overlap-and-discard scan kernel against its twin on 2^16
    samples of a noisy 19 kHz pilot at the IF rate, cold start (a chunk
    plan_overlap plans for: 8 segments of 8192 after 1585 warm-up steps).
    They round every operation alike and call the same atan2f/sinf/cosf,
    so valid flags must be equal and outputs and state agree within 1e-6
    (0 expected).  Then kernel, twin and K3 timed on the same chunk, and
    the scan's launch alone (without the torch set-up and chaining
    around it), a launch and device time (CUDA-graph replay), the device
    time for its time a serial step.  The byte and operation bound
    does not bind: each segment is a chain of W+L dependent steps.
    Returns the kernels-line entry."""
    params = stereo_pll_params()
    if plan_overlap_for(chunk, params) is not None:
        raise AssertionError(f"overlap tier plans for the {chunk}-sample "
                             f"graph chunk")
    n = 1 << 16
    lseg, warm = plan_overlap_for(n, params)
    t = torch.arange(n, device=dev, dtype=torch.float64)
    x = (torch.polar(torch.ones_like(t), 2 * np.pi * 19e3 / (RATE / 5) * t)
         + 0.3 * torch.randn(n, generator=gen, device=dev,
                             dtype=torch.complex128)).to(torch.complex64)
    state = (0.0, 0.0, float(params[2]))
    err, plain_ms = hold_overlap("2^16 chunk", x, state, (*params, 2))
    ms = median_ms(lambda: pll_overlap.pll_overlap_discard(
        x, state, *params, 2, lseg, warm), reps=5)
    kstate = torch.tensor(state, device=dev)
    k3_ms = median_ms(lambda: pll.pll_phase(x, kstate, *params, 2.0), reps=5)
    t0 = time.monotonic()
    pll.pll_phase_reference(x, kstate, *params, 2.0)
    k3_plain_ms = (time.monotonic() - t0) * 1e3
    s = n // lseg
    steps = warm + lseg
    xb = x[None]                             # the scan's [rows, N] form
    init = pll_overlap._initial_states(xb, state, s, lseg, warm)
    consts = tuple(float(np.float32(v)) for v in (*params, 2))
    scan_launch_ms = median_ms(lambda: pll_overlap._scan_kernel(
        xb, init, consts, lseg, warm), reps=5)
    scan_ms = graph_ms(lambda: pll_overlap._scan_kernel(
        xb, init, consts, lseg, warm), 5, 3)
    nbytes = n * 8 + 5 * s * 4 + 3 * n * 4 + 10 * s * 4
    ops = steps * s * OVERLAP_OPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    scan_ns = scan_ms * 1e6 / steps
    pll_overlap.chain_probe(64, dev, *params)                # warm-up
    probe_steps = 1 << 14
    probe_ms, cycles = pll_overlap.chain_probe(probe_steps, dev, *params)
    probe_ns = probe_ms * 1e6 / probe_steps
    log("overlap", f"2^16 chunk: kernel {ms:.3f} ms (median of 5, the torch "
                   f"set-up and chaining included), twin {plain_ms:.1f} ms "
                   f"(host clock, one run), K3 on the same chunk "
                   f"{k3_ms:.3f} ms (median of 5; its twin "
                   f"{k3_plain_ms:.1f} ms, one run); the scan's launch alone "
                   f"{scan_launch_ms:.3f} ms a launch, {scan_ms:.4f} ms "
                   f"device, {steps} serial steps a segment, "
                   f"{scan_ns:.1f} ns a step (device)")
    log("overlap", f"chain probe (the step's dependent chain through the "
                   f"VCO, one thread): {probe_ns:.1f} ns and "
                   f"{cycles / probe_steps:.0f} SM cycles a step; the scan's "
                   f"{scan_ns:.1f} ns a step is {scan_ns / probe_ns:.2f}x it")
    return {"name": "pll_overlap_discard", "route": "cuda",
            "source": "luaradio_tpu_torch/csrc/pll_overlap.cu",
            "replaces": "luaradio_tpu/ops/pll_overlap.py:74 (lax.scan)",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "bound_binds": False,
            "k3_same_chunk_ms": k3_ms, "k3_same_chunk_plain_ms": k3_plain_ms,
            "scan_ms": scan_ms, "scan_launch_ms": scan_launch_ms,
            "ring": pll_overlap.shipped_ring(),
            "serial_steps": steps, "ns_per_step": scan_ns,
            "chain_floor_ns_per_step": probe_ns,
            "floor_ratio": scan_ns / probe_ns}


def plan_overlap_for(n, params):
    return pll_overlap.plan_overlap(n, float(params[0]))


def noisy(z, n0, seed):
    """z with its first n0 samples zeroed and complex Gaussian noise at
    ~30 dB under a unit carrier added throughout (a receiver tuned before
    the station comes up), as complex64."""
    rng = np.random.default_rng(seed)
    z = z.astype(np.complex64)
    z[:n0] = 0
    n = len(z)
    z += (rng.standard_normal(n, np.float32)
          + 1j * rng.standard_normal(n, np.float32)) * np.float32(
              np.sqrt(0.5e-3))
    return z


def write_iq(tmp, name, z):
    path = os.path.join(tmp, name)
    z.view(np.float32).tofile(path)
    return path


def tone_margin(a, rate, tone, harmonics=False):
    """The JAX demodulator tests' measure (test_demodulators.py:15-27), on
    the second half of ``a``: (frequency of the largest bin within 50 Hz
    of ``tone``, that bin's amplitude over the strongest bin elsewhere,
    DC and +-20 bins around the tone left out).  ``harmonics`` also leaves
    out +-20 bins around each multiple of the tone: rx_am's slow AGC
    (3 s) winds its gain up on the noise before the station and clips the
    audio for seconds after, which puts the tone's odd harmonics above
    the noise."""
    a = a[len(a) // 2:].astype(np.float64)
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    f = np.arange(len(spec)) * rate / len(a)
    win = np.nonzero(np.abs(f - tone) <= 50)[0]
    k = win[np.argmax(spec[win])]
    peak = spec[k]
    spec = spec.copy()
    for h in range(1, int(f[-1] // f[k]) + 1 if harmonics else 2):
        spec[max(0, h * k - 20):h * k + 21] = 0
    spec[:5] = 0
    return f[k], peak / (spec.max() + 1e-12)


def run_cli(argv, dev):
    t0 = time.monotonic()
    rc = cli.main(argv, device=dev)
    torch.cuda.synchronize()
    return rc, time.monotonic() - t0


def hold_audio(label, wav, want, rate_want, tone, harmonics=False):
    """The WAV's length and rate, and ``tone`` within 50 Hz of its peak at
    an amplitude margin over every other bin (tone_margin) above 10.
    Returns the peak, the margin and the share of samples at full
    scale."""
    pcm, rate = read_wav(wav)
    if pcm.shape != (want, 1) or rate != rate_want:
        raise AssertionError(f"{label}: WAV {pcm.shape} at {rate} Hz (want "
                             f"({want}, 1) at {rate_want} Hz)")
    f, m = tone_margin(pcm[:, 0], rate, tone, harmonics)
    if abs(f - tone) > 50 or m <= 10:
        raise AssertionError(f"{label}: {tone:.0f} Hz tone found at "
                             f"{f:.1f} Hz, margin {m:.3g} (limits 50 Hz, "
                             f"10)")
    clipped = float(np.mean(np.abs(pcm[len(pcm) // 2:, 0].astype(np.int32))
                            >= 32767))
    return f, m, clipped


def am_pll_params():
    """alpha, beta, fmin, fmax of rx_am --synchronous's PLL at its IF rate
    (PLLBlock(1000, ifreq - 100, ifreq + 100), ifreq 0 for an iqfile
    input: the station sits at the tuned frequency)."""
    blk = carrier.PLLBlock(1000.0, -100.0, 100.0)
    blk.input_rate = RATE / 5
    blk.initialize()
    return blk._alpha, blk._beta, blk._freq_min, blk._freq_max


def am_capture(seconds):
    """``seconds`` at RATE: NOISE_S s of noise, then a carrier at 0 Hz
    modulated 50 % by AM_TONE at ~30 dB SNR (complex64)."""
    n, n0 = seconds * RATE, int(NOISE_S * RATE)
    t = np.arange(n) / RATE
    z = (1 + 0.5 * np.sin(2 * np.pi * AM_TONE * t)) * np.exp(1j * 0.7)
    return noisy(z, n0, 12)


def phase_am(tmp, dev, profile):
    """rx_am --synchronous through the CLI over an AM capture (0.5 s of
    noise, then a carrier at the tuned frequency modulated 50 % by a
    1 kHz tone at ~30 dB SNR): K3 must launch (its count zeroed just
    before the run), and it is held against its twin on every chunk it
    took, recorded as each entered the PLL.  Then rx_am's envelope
    receiver on the same capture.  Returns the K3 record of the path."""
    n = AM_S * RATE
    path = write_iq(tmp, "am.f32.iq", am_capture(AM_S))
    log("am", f"capture: {n} samples ({AM_S} s) at {RATE} S/s, f32le; "
              f"noise for the first {NOISE_S} s, then AM 50 % by "
              f"{AM_TONE:.0f} Hz at ~30 dB SNR")
    argv = ["-a", "rx_am", "-i", f"iqfile:{path},rate={RATE}", "-o"]
    run_cli(argv + [f"wavfile:{os.path.join(tmp, 'w.wav')}", "0",
                    "--synchronous"], dev)                      # warm-up
    wav = os.path.join(tmp, "am_sync.wav")
    taken = []
    seen, restore = record_pll_chunks(taken, pll.pll_phase)
    try:
        pll.pll_phase.launches = 0
        rc, dt = run_cli(argv + [f"wavfile:{wav}", "0", "--synchronous"],
                         dev)
        launches = pll.pll_phase.launches
    finally:
        restore()
    tiers = [t_[0] for _, t_ in seen]
    if rc != 0 or launches < 1 or launches != tiers.count(3) \
            or len(taken) != launches:
        raise AssertionError(f"rx_am --synchronous: rc {rc}, K3 launches "
                             f"{launches} over tiers {tiers} ({len(taken)} "
                             f"recorded)")
    f, m, clip = hold_audio("rx_am --synchronous", wav, n // 25, 44100,
                            AM_TONE, harmonics=True)
    chunk = seen[0][0]
    log("am", f"CLI rx_am --synchronous: {n / dt / 1e6:.2f} M complex "
              f"samples/s end to end ({dt:.3f} s); K3 launches {launches} "
              f"over {len(seen)} PLL chunks of {chunk} samples (tiers: "
              f"linear {tiers.count(1)}, overlap {tiers.count(2)}, "
              f"sequential {tiers.count(3)}); tone at {f:.1f} Hz, margin "
              f"{m:.3g} over all but its harmonics (limits 50 Hz, 10); "
              f"{100 * clip:.0f} % of the second half at full scale (the "
              f"slow AGC's gain, wound up on the noise)")
    err = 0.0
    for i, (x, state, p) in enumerate(taken):
        e = compare_pll(f"am chunk {i}", x, torch.stack(state).to(dev),
                        p[:4], float(p[4]))
        err = max(err, e)
    log("K3", f"on the {len(taken)} chunks rx_am --synchronous gave it "
              f"(multiplier 1): max |kernel - twin| {err:.3g} (limit 1e-5)")
    if profile:
        pwav = os.path.join(tmp, "p.wav")
        profile_run(lambda: run_cli(argv + [f"wavfile:{pwav}", "0",
                                            "--synchronous"], dev),
                    f"{profile}.am.txt", "rx_am --synchronous")
    rc, edt = run_cli(argv + [f"wavfile:{os.path.join(tmp, 'am.wav')}",
                              "0"], dev)
    if rc != 0:
        raise AssertionError(f"rx_am: rc {rc}")
    f, m, clip = hold_audio("rx_am", os.path.join(tmp, "am.wav"), n // 25,
                            44100, AM_TONE, harmonics=True)
    log("am", f"CLI rx_am (envelope): {n / edt / 1e6:.2f} M complex "
              f"samples/s end to end ({edt:.3f} s); tone at {f:.1f} Hz, "
              f"margin {m:.3g} over all but its harmonics (limits 50 Hz, "
              f"10); {100 * clip:.0f} % of the second half at full scale")
    return {"launches": launches, "chunk": chunk, "max_abs_err": err,
            "x": taken[0][0], "state": torch.stack(taken[0][1]).to(dev),
            "sync_sps": n / dt, "envelope_sps": n / edt}


def time_k3_am(am, dev):
    """K3 at the AM path's PLL chunk (multiplier 1, the AM loop's
    constants), on the first chunk the path gave it: a launch, device
    time (CUDA-graph replay), the twin (host clock, one run) and the
    bound."""
    params = am_pll_params()
    x, state = am["x"].contiguous(), am["state"]
    n = x.shape[0]

    def run():
        pll.pll_phase(x, state, *params, 1.0)
    ms = median_ms(run)
    dev_ms = graph_ms(run)
    t0 = time.monotonic()
    pll.pll_phase_reference(x, state, *params, 1.0)
    torch.cuda.synchronize()
    plain_ms = (time.monotonic() - t0) * 1e3
    t_bytes = n * PLL_BYTES / HBM_BYTES_PER_S
    t_ops = n * PLL_OPS / FP32_FLOP_PER_S
    rec = {"launches": am["launches"], "chunk": n, "ms": ms,
           "graph_ms": dev_ms, "plain_ms": plain_ms,
           "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "max_abs_err": am["max_abs_err"]}
    log("K3", f"AM path chunk [{n} samples, multiplier 1]: {ms:.4f} ms a "
              f"launch (median of {REPS}), device {dev_ms:.4f} ms "
              f"(CUDA-graph replay); twin {plain_ms:.1f} ms (host clock, "
              f"one run); bound {rec['bound_ms']:.6f} ms ({rec['bound_by']})")
    return rec


def phase_analog(tmp, dev):
    """rx_nbfm, rx_ssb (usb, lsb), rx_raw with a tune offset and
    iq_converter through the CLI on the card, each over a capture of
    ANALOG_S s with 0.5 s of noise first, each held by its own check."""
    n, n0 = ANALOG_S * RATE, int(NOISE_S * RATE)
    t = np.arange(n) / RATE
    nbfm = noisy(np.exp(2j * np.pi * 5e3 * np.cumsum(
        np.sin(2 * np.pi * NBFM_TONE * t)) / RATE), n0, 13)
    usb = noisy(0.5 * np.exp(2j * np.pi * SSB_TONE * t), n0, 14)
    del t
    paths = {"nbfm": write_iq(tmp, "nbfm.f32.iq", nbfm),
             "usb": write_iq(tmp, "usb.f32.iq", usb)}
    del usb
    sps = {}

    def audio(app, cap, out, *args):
        rc, dt = run_cli(["-a", app, "-i", f"iqfile:{cap},rate={RATE}",
                          "-o", f"wavfile:{out}", "0", *args], dev)
        if rc != 0:
            raise AssertionError(f"{app}: rc {rc}")
        return n / dt

    audio("rx_nbfm", paths["nbfm"], os.path.join(tmp, "w.wav"))  # warm-up
    wav = os.path.join(tmp, "nbfm.wav")
    sps["rx_nbfm"] = audio("rx_nbfm", paths["nbfm"], wav)
    f, m, _ = hold_audio("rx_nbfm", wav, n // 25, 44100, NBFM_TONE)
    log("analog", f"CLI rx_nbfm (5 kHz deviation, {NBFM_TONE:.0f} Hz): "
                  f"tone at {f:.1f} Hz, margin {m:.3g} (limits 50 Hz, 10); "
                  f"{sps['rx_nbfm'] / 1e6:.2f} M complex samples/s")
    power = {}
    for sb in ("usb", "lsb"):
        wav = os.path.join(tmp, f"{sb}.wav")
        sps[f"rx_ssb {sb}"] = audio("rx_ssb", paths["usb"], wav, sb)
        pcm, _ = read_wav(wav)
        power[sb] = float(np.mean(pcm[len(pcm) // 2:, 0].astype(
            np.float64) ** 2))
    f, m, _ = hold_audio("rx_ssb usb", os.path.join(tmp, "usb.wav"),
                         n // 25, 44100, SSB_TONE)
    if power["lsb"] * 20 >= power["usb"]:
        raise AssertionError(f"rx_ssb: lsb keeps {power['lsb']:.3g} of the "
                             f"usb tone's power {power['usb']:.3g}")
    log("analog", f"CLI rx_ssb on a tone {SSB_TONE:.0f} Hz above the "
                  f"carrier: usb passes it at {f:.1f} Hz, margin {m:.3g}; "
                  f"lsb keeps 1/{power['usb'] / power['lsb']:.0f} of its "
                  f"power (limit 1/20); {sps['rx_ssb usb'] / 1e6:.2f} / "
                  f"{sps['rx_ssb lsb'] / 1e6:.2f} M complex samples/s")

    out = os.path.join(tmp, "raw.iq")
    rc, dt = run_cli(["-a", "rx_raw", "-i", f"iqfile:{paths['nbfm']}",
                      "-o", f"iqfile:{out}", "100e6", str(RATE),
                      "--tune-offset", "-25e3"], dev)
    got = np.fromfile(out, np.complex64)
    host = nbfm * np.exp(-2j * np.pi * 25e3 * np.arange(n) / RATE)
    err = float(np.max(np.abs(got - host))) if got.shape == host.shape \
        else np.inf
    if rc != 0 or err > 1e-5:
        raise AssertionError(f"rx_raw: rc {rc}, {got.shape} samples, max "
                             f"|out - host translation| {err}")
    sps["rx_raw"] = n / dt
    log("analog", f"CLI rx_raw --tune-offset -25e3: max |out - host "
                  f"translation (float64)| {err:.3g} (limit 1e-5); "
                  f"{n / dt / 1e6:.2f} M complex samples/s")
    del nbfm, host, got

    u8 = os.path.join(tmp, "nbfm.u8.iq")
    wire = np.fromfile(paths["nbfm"], np.float32)
    np.clip(np.round(wire * 127.5 + 127.5), 0, 255).astype(np.uint8).tofile(
        u8)
    del wire
    out = os.path.join(tmp, "conv.f32.iq")
    rc, dt = run_cli(["-a", "iq_converter", "-i", f"iqfile:{u8},u8,"
                      f"rate={RATE}", "-o", f"iqfile:{out},f32le"], dev)
    with open(u8, "rb") as fh:
        host = format_utils.bytes_to_complex(fh.read(),
                                             format_utils.get_format("u8"))
    got = np.fromfile(out, np.complex64)
    if rc != 0 or not np.array_equal(got, host):
        raise AssertionError(f"iq_converter: rc {rc}, output {got.shape} "
                             f"not the host conversion {host.shape}")
    sps["iq_converter"] = n / dt
    log("analog", f"CLI iq_converter u8 -> f32le: equal to the host "
                  f"conversion; {n / dt / 1e6:.2f} M complex samples/s")
    return sps


class _Collect(SinkBlock):
    """A sink that keeps what it is given, on the host: arrays, or (a
    bank's host tail calls it once per channel, in channel order) a
    channel's list of objects."""

    def __init__(self):
        super().__init__()
        self.got = []
        self.add_type_signature([Input("in", lambda t: True)], [])

    def process(self, x):
        self.got.append(list(x) if isinstance(x, list) else np.array(x))


def bench_run(make_top, dev, secs=BENCH_S, mesh=None):
    """One of bench.py's graph rows on the card (on ``mesh``, if given):
    ``make_top(sink)`` builds it (benchmarks/bench.py's graphs); warm
    up, time 16 chunks, then run for about ``secs``.  Returns (complex
    samples/s, chunks, the runner's host-to-device copies)."""
    def make():
        return Runner(make_top(BenchmarkSink()), chunk_size=BENCH_CHUNK,
                      mesh=mesh, device=dev)
    make().run(max_chunks=2)                                    # warm-up
    t0 = time.monotonic()
    make().run(max_chunks=16)
    k = max(16, int(secs / max((time.monotonic() - t0) / 16, 1e-4)))
    runner = make()
    t0 = time.monotonic()
    runner.run(max_chunks=k)
    dt = time.monotonic() - t0
    return k * BENCH_CHUNK / dt, k, runner.h2d_copies


def phase_bench_graphs(tmp, dev, smi, profile):
    """The shapes of bench.py's two graph rows on the port, built by
    benchmarks/bench.py: UniformRandomSource(ComplexFloat32, 256e3) ->
    WBFMMonoDemodulator -> DownsamplerBlock(8) at 2^22-sample chunks, and
    the same chain fed by a 4 Mi-sample repeating u8 IQFileSource,
    streamed and device-resident.  The resident run must make no
    host-to-device copy, and over the first chunks its audio must equal
    the streamed run's exactly."""
    path = pbench.write_u8_file(os.path.join(tmp, "bench.u8.iq"),
                                BENCH_FILE)

    def ring(resident):
        return lambda sink: pbench.file_graph(path, sink, resident)
    rows = {}
    for name, make in (("random", pbench.runner_graph),
                       ("file streamed", ring(False)),
                       ("file resident", ring(True))):
        sps, k, copies = bench_run(make, dev)
        want = 0 if name != "file streamed" else k
        if copies != want:
            raise AssertionError(f"bench {name}: {copies} host-to-device "
                                 f"copies over {k} chunks (want {want})")
        rows[name] = sps
        log("bench", f"{name}: {sps / 1e6:.1f} M complex samples/s over {k} "
                     f"chunks of {BENCH_CHUNK}; {copies} host-to-device "
                     f"copies; {smi}")
        if profile:
            profile_run(lambda: Runner(
                make(BenchmarkSink()), chunk_size=BENCH_CHUNK,
                device=dev).run(max_chunks=50),
                f"{profile}.bench_{name.replace(' ', '_')}.txt",
                f"bench {name}, 50 chunks")
    audio = {}
    for resident in (False, True):
        sink = _Collect()
        Runner(ring(resident)(sink), chunk_size=BENCH_CHUNK,
               device=dev).run(max_chunks=3)
        audio[resident] = np.concatenate(sink.got)
    if audio[True].shape != (3 * BENCH_CHUNK // 8,) \
            or not np.array_equal(audio[True], audio[False]):
        raise AssertionError(f"bench: resident audio {audio[True].shape} is "
                             f"not the streamed run's "
                             f"{audio[False].shape} exactly")
    log("bench", f"resident and streamed audio equal over 3 chunks "
                 f"({audio[True].shape[0]} samples)")
    return rows


# -- the digital receivers ---------------------------------------------------

def rds_group_bits(blocks4):
    """Four 16-bit words -> the 104 bits of an RDS group, each word with
    its check word and offset (the RDS Standard's encoder, from the
    port's generator polynomial and offset words)."""
    return np.concatenate([number_to_bits(
        (data << 10) | (rds_proto._poly_mod(data << 10, 26)
                        ^ rds_proto.RDS_OFFSET_WORDS[name]), 26)
        for name, data in zip("ABCD", blocks4)])


def manchester_diff(bits):
    """Differential-encode, then Manchester-encode (1 -> 10, 0 -> 01)."""
    diff = np.bitwise_xor.accumulate(np.asarray(bits, np.uint8))
    chips = np.empty(2 * len(diff), np.uint8)
    chips[0::2], chips[1::2] = diff, 1 - diff
    return chips


def write_rds_capture(tmp):
    """DIGITAL_S seconds at RATE, f32le: NOISE_S s of noise, then
    broadcast FM at 75 kHz peak deviation of the multiplex of
    tests/core/test_receivers.py:84-93 (0.2 * an 800 Hz tone, 0.1 * the
    19 kHz pilot, 0.06 * the coded BPSK on 57 kHz) at ~30 dB SNR,
    carrying random RDS groups whose group types lie outside 0, 2 and 4
    (each decodes as a raw packet).  Returns (path, samples, [(start in
    seconds, group)])."""
    rng = np.random.default_rng(21)
    n, n0 = DIGITAL_S * RATE, int(NOISE_S * RATE)
    count = int((DIGITAL_S - NOISE_S) * RDS_BAUD / 104)
    codes = rng.choice([c for c in range(16) if c not in (0, 2, 4)], count)
    groups = [(int(rng.integers(0, 1 << 16)),
               (int(c) << 12) | int(rng.integers(0, 1 << 11)),
               int(rng.integers(0, 1 << 16)), int(rng.integers(0, 1 << 16)))
              for c in codes]
    chips = manchester_diff(np.concatenate([rds_group_bits(g)
                                            for g in groups]))
    t = np.arange(n - n0) / RATE
    k = np.minimum((t * 2 * RDS_BAUD).astype(np.int64), len(chips) - 1)
    mpx = (0.2 * np.sin(2 * np.pi * 800.0 * t)
           + 0.1 * np.cos(2 * np.pi * 19e3 * t)
           + 0.06 * (2.0 * chips[k] - 1.0) * np.cos(2 * np.pi * 57e3 * t))
    del t, k
    z = np.zeros(n, np.complex64)
    z[n0:] = np.exp(2j * np.pi * 75e3 / 0.36 / RATE * np.cumsum(mpx))
    del mpx
    path = write_iq(tmp, "rds.f32.iq", noisy(z, n0, 21))
    return path, n, [(NOISE_S + 104 * i / RDS_BAUD, g)
                     for i, g in enumerate(groups)]


def rds_pll_params():
    """alpha, beta, fmin, fmax of rx_rds's pilot PLL at its IF rate
    (PLLBlock(1500, 19e3 - 100, 19e3 + 100, multiplier=3); the tuner
    decimates 1 102 500 S/s by 4)."""
    blk = carrier.PLLBlock(1500.0, 19e3 - 100, 19e3 + 100, multiplier=3)
    blk.input_rate = RATE / 4
    blk.initialize()
    return blk._alpha, blk._beta, blk._freq_min, blk._freq_max


def read_json_lines(path):
    with open(path) as fh:
        return [json.loads(ln) for ln in fh.read().splitlines()]


def phase_rds(tmp, dev, profile=None):
    """rx_rds through the CLI over DIGITAL_S s (NOISE_S s of noise
    first): K3 must launch (multiplier 3; its count zeroed just before
    the run) and is held against its twin on every chunk it took; the
    overlap scan, where it ran, against its twin on its chunks.  Of the
    groups sent after 1.5 s, 80 % must come out as raw packets, and no
    packet may carry a group that was not sent.  Returns the K3 record
    of the path (with the first chunk K3 took, for timing)."""
    path, n, sent = write_rds_capture(tmp)
    log("rds", f"capture: {n} samples ({DIGITAL_S} s) at {RATE} S/s, "
               f"f32le; noise for the first {NOISE_S} s, then FM at 75 kHz "
               f"with {len(sent)} RDS groups at ~30 dB SNR")
    argv = ["-a", "rx_rds", "-i", f"iqfile:{path},rate={RATE}", "-o"]
    run_cli(argv + [f"json:{os.path.join(tmp, 'warm.json')}", "0"], dev)
    out = os.path.join(tmp, "rds.json")
    taken, scanned = [], []
    seen, restore_k3 = record_pll_chunks(taken, pll.pll_phase)
    _, restore_scan = record_pll_chunks(scanned)
    try:
        pll.pll_phase.launches = 0
        pll_overlap.pll_overlap_discard.launches = 0
        rc, dt = run_cli(argv + [f"json:{out}", "0"], dev)
        launches = pll.pll_phase.launches
        scans = pll_overlap.pll_overlap_discard.launches
    finally:
        restore_scan()
        restore_k3()
    tiers = [t_[0] for _, t_ in seen]
    if rc != 0 or launches < 1 or launches != tiers.count(3) \
            or len(taken) != launches or len(scanned) != scans:
        raise AssertionError(f"rx_rds: rc {rc}, K3 launches {launches} "
                             f"over tiers {tiers} ({len(taken)} recorded), "
                             f"scan launches {scans} ({len(scanned)} "
                             f"recorded)")
    packets = read_json_lines(out)
    found, late = hold_rds_packets("rx_rds", packets, sent)
    chunk = seen[0][0]
    log("rds", f"CLI rx_rds: {n / dt / 1e6:.2f} M complex samples/s end "
               f"to end ({dt:.3f} s); {len(packets)} packets, {found} of "
               f"the {late} groups sent after 1.5 s (limit 80 %), "
               f"none unsent; K3 launches {launches}, overlap scan "
               f"launches {scans} over {len(seen)} PLL chunks of {chunk} "
               f"samples (tiers: linear {tiers.count(1)}, overlap "
               f"{tiers.count(2)}, sequential {tiers.count(3)})")
    err = 0.0
    for i, (x, state, p) in enumerate(taken):
        err = max(err, compare_pll(f"rds chunk {i}", x,
                                   torch.stack(state).to(dev), p[:4],
                                   float(p[4])))
    log("K3", f"on the {len(taken)} chunks rx_rds gave it (multiplier 3): "
              f"max |kernel - twin| {err:.3g} (limit 1e-5)")
    scan_err = max((hold_overlap(f"rds chunk {i}", x, state, p)[0]
                    for i, (x, state, p) in enumerate(scanned)),
                   default=0.0)
    if profile:
        pout = os.path.join(tmp, "p.json")
        profile_run(lambda: run_cli(argv + [f"json:{pout}", "0"], dev),
                    f"{profile}.rds.txt", "rx_rds")
    return {"launches": launches, "chunk": chunk, "max_abs_err": err,
            "x": taken[0][0], "state": torch.stack(taken[0][1]).to(dev),
            "sps": n / dt, "tiers": [tiers.count(k) for k in (1, 2, 3)],
            "overlap_launches": scans, "overlap_err": scan_err,
            "packets": packets}


def hold_rds_packets(label, packets, sent):
    """80 % of the groups sent after 1.5 s must come out as raw packets,
    and no packet may carry a group that was not sent.  Returns (found,
    groups sent after 1.5 s)."""
    groups = {g for _, g in sent}
    got = [tuple(p["data"].get("frame", ())) for p in packets]
    stray = [p for p, g in zip(packets, got)
             if p["data"].get("type") != "raw" or g not in groups]
    late = [g for start, g in sent if start >= 1.5]
    found = len(set(late) & set(got))
    if stray or found < 0.8 * len(late):
        raise AssertionError(f"{label}: {found} of the {len(late)} groups "
                             f"sent after 1.5 s decoded (limit 80 %); "
                             f"{len(stray)} packets not sent: {stray[:3]}")
    return found, len(late)


def time_k3_rds(rds, dev, ns_step):
    """K3 at the RDS path's PLL chunk (multiplier 3, the RDS loop's
    constants), on the first chunk the path gave it: a launch, device
    time (CUDA-graph replay), the twin (host clock, one run), the bound
    and the floor of the walker's dependency chain (phase 8's probe)."""
    params = rds_pll_params()
    x, state = rds["x"].contiguous(), rds["state"]
    n = x.shape[0]

    def run():
        pll.pll_phase(x, state, *params, 3.0)
    ms = median_ms(run)
    dev_ms = graph_ms(run)
    t0 = time.monotonic()
    pll.pll_phase_reference(x, state, *params, 3.0)
    torch.cuda.synchronize()
    plain_ms = (time.monotonic() - t0) * 1e3
    t_bytes = n * PLL_BYTES / HBM_BYTES_PER_S
    t_ops = n * PLL_OPS / FP32_FLOP_PER_S
    floor_ms = n * ns_step / 1e6
    rec = {"launches": rds["launches"], "chunk": n, "ms": ms,
           "graph_ms": dev_ms, "plain_ms": plain_ms,
           "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "chain_floor_ms": floor_ms, "floor_ratio": ms / floor_ms,
           "graph_floor_ratio": dev_ms / floor_ms,
           "max_abs_err": rds["max_abs_err"]}
    log("K3", f"RDS path chunk [{n} samples, multiplier 3]: {ms:.4f} ms a "
              f"launch (median of {REPS}), device {dev_ms:.4f} ms "
              f"(CUDA-graph replay); twin {plain_ms:.1f} ms (host clock, "
              f"one run); bound {rec['bound_ms']:.6f} ms "
              f"({rec['bound_by']}); chain floor {floor_ms:.4f} ms "
              f"({ns_step:.3f} ns a step x {n}): {ms / floor_ms:.3f}x a "
              f"launch, {dev_ms / floor_ms:.3f}x device")
    return rec


def pocsag_bits(address, func, text):
    """A POCSAG transmission: the 576-bit preamble, a batch with the
    address codeword at its frame and the 7-bit text after it, then an
    idle batch (tests/core/test_receivers.py make_pocsag_iq)."""
    text_bits = [(ord(ch) >> i) & 1 for ch in text + chr(0x17)
                 for i in range(7)]
    text_bits += [1] * (-len(text_bits) % 20)
    words = [int("".join(map(str, text_bits[i:i + 20])), 2)
             for i in range(0, len(text_bits), 20)]

    def codeword(msg21):
        w31 = (msg21 << 10) | pocsag_proto._bch_mod(msg21 << 10, 31)
        return (w31 << 1) | (bin(w31).count("1") & 1)
    batch, placed = [], False
    for j in range(16):
        if not placed and j >> 1 == address & 0x7:
            batch.append(codeword(((address >> 3) << 2) | func))
            placed = True
        elif placed and words:
            batch.append(codeword((1 << 20) | words.pop(0)))
        else:
            batch.append(pocsag_proto.POCSAG_IDLE_CODEWORD)
    bits = [np.asarray([1, 0] * 288, np.uint8)]
    for cws in (batch, [pocsag_proto.POCSAG_IDLE_CODEWORD] * 16):
        bits += [number_to_bits(pocsag_proto.POCSAG_FRAME_SYNC_CODEWORD, 32)]
        bits += [number_to_bits(cw, 32) for cw in cws]
    return np.concatenate(bits)


def fsk(symbols, baud, rate, freq_of):
    """Phase-continuous FSK at ``rate``: symbol k lasts from k/baud s on
    at frequency freq_of(symbol); complex64 unit phasors."""
    n = int(len(symbols) * rate / baud)
    k = np.minimum((np.arange(n) * baud / rate).astype(np.int64),
                   len(symbols) - 1)
    return np.exp(2j * np.pi * np.cumsum(freq_of(symbols[k])) / rate)


def ax25_bits(addresses, control, pid, payload):
    """An AX.25 frame between 30 HDLC flags each side, bit-stuffed
    (tests/blocks/test_protocol.py ax25_encode, hdlc_stuff)."""
    raw = []
    for i, (call, ssid) in enumerate(addresses):
        raw += [ord(ch) << 1 for ch in call.ljust(6)]
        raw.append((ssid << 1) | (i == len(addresses) - 1))
    raw += [control, pid, *payload]
    bits = np.asarray([(b >> i) & 1 for b in raw for i in range(8)],
                      np.uint8)
    fcs = ax25_proto._crc16_x25(bits)
    bits = np.concatenate([bits, [(fcs >> i) & 1 for i in range(16)]])
    stuffed, ones = [], 0
    for b in bits:
        stuffed.append(int(b))
        ones = ones + 1 if b else 0
        if ones == 5:
            stuffed.append(0)
            ones = 0
    flag = np.asarray([0, 1, 1, 1, 1, 1, 1, 0], np.uint8)
    return np.concatenate([np.tile(flag, 30), stuffed, np.tile(flag, 30)])


def scm_capture():
    """An OOK Manchester SCM burst at ERT_RATE (tests/core/
    test_receivers.py make_scm_iq): (iq, ert id, consumption)."""
    ert_id, consumption = 0x1C0FFEE, 424242
    msg = np.concatenate([
        number_to_bits(ert_id >> 24, 2), number_to_bits(0, 1),
        number_to_bits(2, 2), number_to_bits(4, 4), number_to_bits(1, 2),
        number_to_bits(consumption, 24),
        number_to_bits(ert_id & 0xFFFFFF, 24)])
    crc = 0
    for i in np.flatnonzero(msg):
        crc ^= ert_proto._scm_code.syndromes[int(i)]
    frame = np.concatenate([ert_proto.SCMFramerBlock.SCM_PREAMBLE, msg,
                            number_to_bits(crc, 16)])
    chips = np.empty(2 * len(frame))
    chips[0::2], chips[1::2] = frame, 1 - frame
    env = np.concatenate([np.zeros(40000),
                          np.repeat(chips, ERT_RATE // 32768),
                          np.zeros(60000)])
    iq = env * np.exp(2j * np.pi * 0.11 * np.arange(len(env)))
    return iq.astype(np.complex64), ert_id, consumption


def bpsk31_capture(text):
    """Differential BPSK31 at 8000 S/s, 0 = a phase reversal
    (tests/core/test_receivers.py make_bpsk31_iq)."""
    bits = [0] * 32
    for ch in text:
        bits += [int(c) for c in VARICODE[ord(ch)]] + [0, 0]
    bits += [0] * 32
    sym = np.cumprod(np.where(np.asarray(bits) == 0, -1.0, 1.0))
    return np.concatenate([np.repeat(sym, 256),
                           np.zeros(8192)]).astype(np.complex64)


def phase_digital_others(tmp, dev):
    """rx_pocsag, rx_ax25 (at RATE, which the CLI's tuner decimates to
    its 12.5 kHz IF) and rx_ert --protocols=scm (at ERT_RATE) through the
    CLI on the card, each message checked field by field; then
    BPSK31Receiver as a graph on the card at 8000 S/s, whose text must
    come out.  Returns each CLI run's complex samples/s."""
    address, func, text = 0x12342, 2, "HI"
    pocsag_iq = fsk(pocsag_bits(address, func, text), 1200, RATE,
                    lambda b: np.where(b == 1, -4500.0, 4500.0))
    nrzi = np.bitwise_xor.accumulate(
        1 - ax25_bits([("NOCALL", 0x60), ("TPU", 0x61)], 0x03, 0xF0,
                      b"hello from tpu radio"))
    audio = np.sin(np.angle(fsk(nrzi, 1200, RATE, lambda s: np.where(
        s == 0, 1200.0, 2200.0))))
    ax25_iq = np.exp(2j * np.pi * 3e3 * np.cumsum(audio) / RATE)
    del audio
    scm_iq, ert_id, consumption = scm_capture()
    runs = {
        "rx_pocsag": (pocsag_iq, RATE, ["0"], lambda r: (
            r["address"], r["func"], r["alphanumeric"]),
            (address, func, text)),
        "rx_ax25": (ax25_iq, RATE, ["0"], lambda r: (
            r["addresses"][0]["callsign"],
            r["addresses"][1]["callsign"].rstrip(), r["payload"]),
            ("NOCALL", "TPU", "hello from tpu radio")),
        "rx_ert": (scm_iq, ERT_RATE, ["--protocols=scm"], lambda r: (
            r["ert_id"], r["consumption"]), (ert_id, consumption)),
    }
    sps = {}
    for app, (iq, rate, args, fields, want) in runs.items():
        pad = np.zeros(int(0.05 * rate), np.complex64)
        path = write_iq(tmp, f"{app}.f32.iq", noisy(
            np.concatenate([pad, iq.astype(np.complex64), pad]), 0,
            len(app)))
        argv = ["-a", app, "-i", f"iqfile:{path},rate={rate}", "-o"]
        run_cli(argv + [f"json:{os.path.join(tmp, 'warm.json')}", *args],
                dev)
        out = os.path.join(tmp, f"{app}.json")
        rc, dt = run_cli(argv + [f"json:{out}", *args], dev)
        recs = read_json_lines(out)
        if rc != 0 or not recs or fields(recs[0]) != want:
            raise AssertionError(f"{app}: rc {rc}, decoded "
                                 f"{[fields(r) for r in recs]} (want "
                                 f"{want})")
        n = os.path.getsize(path) // 8
        sps[app] = n / dt
        log("digital", f"CLI {app}: {len(recs)} message(s), the first "
                       f"{want} as sent; {n} samples at {rate} S/s, "
                       f"{n / dt / 1e6:.2f} M complex samples/s end to end")
    text = "cq cq de tpu"
    path = write_iq(tmp, "bpsk31.f32.iq", bpsk31_capture(text))
    sink = _Collect()
    top = CompositeBlock()
    top.connect(IQFileSource(path, "f32le", 8000.0), BPSK31Receiver(), sink)
    Runner(top, chunk_size=1 << 15, device=dev).run()
    decoded = bytes(int(v) for a in sink.got for v in a).decode(
        errors="replace")
    if text not in decoded:
        raise AssertionError(f"BPSK31Receiver: decoded {decoded!r}, "
                             f"{text!r} not in it")
    log("digital", f"BPSK31Receiver graph at 8000 S/s: {decoded!r}")
    return sps


# -- the bank phases ------------------------------------------------------


class _ArraySource(HostSourceBlock):
    """Samples of type ``t`` from a host array, ``n`` at a time."""

    def __init__(self, data, rate, t=ComplexFloat32):
        super().__init__()
        self.data, self.rate, self.pos = data, rate, 0
        self.add_type_signature([], [Output("out", t)])

    def read(self, n):
        if self.pos >= len(self.data):
            return None
        chunk = self.data[self.pos:self.pos + n]
        self.pos += len(chunk)
        return chunk


def _rows(sink):
    return np.concatenate(sink.got, axis=-1)


def _record(module, name, calls, keep=None):
    """Put a wrapper in place of ``module.name``, a kernel's private
    launch function (every call launches; the wrappers that count
    launches call it through the module), which appends (inputs,
    outputs) of every call, cloned, or of the first ``keep`` calls;
    returns a function that puts the original back."""
    fn = getattr(module, name)

    def recording(*args):
        if keep is not None and len(calls) >= keep:
            return fn(*args)
        ins = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args)
        out = fn(*args)
        calls.append((ins, _clone(out)))
        return out
    setattr(module, name, recording)

    def restore():
        setattr(module, name, fn)
    return restore


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    return tuple(_clone(v) for v in out)


def write_wideband_capture(tmp, dev):
    """BANK_S s at BANK_RATE, f32le, made on the card in float64: WBFM
    stations (75 kHz deviation, each its own tone between 500 Hz and
    4 kHz) on the channel bins BANK_STATIONS, over both halves of the
    span, and complex Gaussian noise ~30 dB under a station within its
    channel.  Returns (path, samples, {bin: tone})."""
    n = int(BANK_S * BANK_RATE)
    gen = torch.Generator(device=dev).manual_seed(64)
    t = torch.arange(n, device=dev, dtype=torch.float64) / BANK_RATE
    z = torch.randn(n, generator=gen, device=dev, dtype=torch.complex128) \
        * np.sqrt(1e-3 * BANK_C)
    tones = {}
    for k, b in enumerate(BANK_STATIONS):
        tones[b] = 500.0 + 500.0 * k
        fc = (b if b < BANK_C // 2 else b - BANK_C) * BANK_RATE / BANK_C
        # a tone-modulated FM phase in closed form: 2 pi fc t + (75 kHz /
        # tone) sin(2 pi tone t)
        ph = 2 * np.pi * fc * t + 75e3 / tones[b] * torch.sin(
            2 * np.pi * tones[b] * t)
        z += torch.polar(torch.ones_like(ph), ph)
        del ph
    del t
    path = os.path.join(tmp, "wideband.f32.iq")
    z.to(torch.complex64).cpu().numpy().view(np.float32).tofile(path)
    del z
    torch.cuda.empty_cache()
    return path, n, tones


def bank_mono_graph(path):
    """examples/wideband_channelizer_bank.py at BANK_C channels: IQ file
    -> ChannelizerBlock(64, 8) -> WBFMMonoDemodulator -> Downsampler(8)
    -> a sink of the [64, T] audio."""
    top, sink = CompositeBlock(), _Collect()
    top.connect(IQFileSource(path, "f32le", BANK_RATE),
                ChannelizerBlock(BANK_C, taps_per_branch=8),
                WBFMMonoDemodulator(), DownsamplerBlock(8), sink)
    return top, sink


def run_bank_mono(path, dev):
    top, sink = bank_mono_graph(path)
    t0 = time.monotonic()
    Runner(top, chunk_size=BANK_C * 16384, device=dev).run()
    return _rows(sink), time.monotonic() - t0


def tone_bin_power(a, rate, tone):
    """Power of the largest bin within 50 Hz of ``tone`` over the second
    half of each row of ``a`` [R, T] (Hann window), and that bin's
    frequency."""
    a = a[..., a.shape[-1] // 2:].astype(np.float64)
    spec = np.abs(np.fft.rfft(a * np.hanning(a.shape[-1]), axis=-1)) ** 2
    f = np.arange(spec.shape[-1]) * rate / a.shape[-1]
    win = np.nonzero(np.abs(f - tone) <= 50)[0]
    k = win[np.argmax(spec[..., win], axis=-1)]
    return np.take_along_axis(spec, np.atleast_1d(k)[..., None], -1)[..., 0], \
        f[k]


#: the channelizer phase's shapes, (rows, samples, C, q): the band cell's
#: chunk and the bank-mono phase's
PFB_SHAPES = ((1, 8192000, 100, 16), (1, BANK_C * 16384, BANK_C, 8))


def back_to_back_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Time of one call: ``n`` calls back to back between two CUDA events,
    the median of ``reps`` such runs over ``n`` (the card's time where a
    call's work outlasts its host time, the host's where it does not)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def _pfb_branch(c, q, dev):
    blk = ChannelizerBlock(c, q)
    blk.device = dev
    blk.initialize()
    return blk._branch


def _pfb_gap(y, ry):
    """Largest deviation of y from ry over each channel's full scale."""
    scale = ry.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return ((y - ry).abs() / scale).max().item() if ry.numel() else 0.0


def _pfb_hold(label, state, x, branch):
    """One chunk through the kernel and its twin from the same state: the
    new states equal, every channel within 2e-6 of its full scale; both
    also against the twin in float64.  Returns (kernel's new state, the
    largest deviation over a channel's scale)."""
    n0 = channelizer.channelize.launches
    st, y = channelizer.channelize(state, x, branch)
    rst, ry = channelizer.channelize_reference(state, x, branch)
    _, fy = channelizer.channelize_reference(
        state.to(torch.complex128), x.to(torch.complex128), branch.double())
    torch.cuda.synchronize()
    if channelizer.channelize.launches != n0 + 1:
        raise AssertionError(f"channelizer {label}: no kernel launch")
    if y.shape != ry.shape or not torch.isfinite(torch.view_as_real(y)).all():
        raise AssertionError(f"channelizer {label}: output {tuple(y.shape)}")
    if not torch.equal(st, rst.contiguous()):
        raise AssertionError(f"channelizer {label}: new state differs")
    err = _pfb_gap(y, ry)
    if err > 2e-6:
        raise AssertionError(f"channelizer {label}: |kernel - twin| = "
                             f"{err:.3g} of a channel's full scale > 2e-6")
    log("channelizer", f"{label}: x {tuple(x.shape)} -> {tuple(y.shape)}, "
                       f"max |kernel - twin| {err:.3g} of the channel's "
                       f"full scale (limit 2e-6); against float64: kernel "
                       f"{_pfb_gap(y, fy):.3g}, twin {_pfb_gap(ry, fy):.3g}; "
                       f"new state equal")
    return st, err


def phase_channelizer(dev, gen, smi):
    """The polyphase channelizer kernel (csrc/channelizer.cu) at the band
    cell's chunk ([1, 8 192 000], C 100, q 16) and the bank-mono phase's
    ([1, 1 048 576], C 64, q 8), on complex white noise: held against its
    twin (the stock path) over chained chunks (full, ragged, shorter than
    C q, full) and on a batch of 3 rows, each also against the twin in
    float64.  Then
    timed: 20 launches back to back (median of 5), device time by
    CUDA-graph replay, and a launch (median of 25), beside the twin (the
    stock path, so also the library yardstick) and the bound (16 B a
    sample at 3.35 TB/s, or channelizer_work's operations at 67
    TFLOP/s).  Returns the kernel's entry for the kernels line."""
    rows_out, errs = [], []
    for rows, n, c, q in PFB_SHAPES:
        branch = _pfb_branch(c, q, dev)
        k = c * q
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        p = channelizer.plan(c, q, n // c, rows, sms)
        z = torch.randn(3 * n + n // 3, generator=gen, device=dev,
                        dtype=torch.complex64)
        st = torch.zeros(k, dtype=torch.complex64, device=dev)
        for label, x in ((f"C {c} q {q} chunk", z[:n]),
                         (f"C {c} q {q} ragged", z[n:n + c * 7 + 3]),
                         (f"C {c} q {q} short", z[n + c * 7 + 3:
                                                   n + c * 7 + 3 + k // 2]),
                         (f"C {c} q {q} chunk after", z[2 * n:3 * n])):
            st, err = _pfb_hold(label, st, x.contiguous(), branch)
            errs.append(err)
        xb = torch.randn((3, n // 8), generator=gen, device=dev,
                         dtype=torch.complex64)
        sb = torch.randn((3, k), generator=gen, device=dev,
                         dtype=torch.complex64)
        errs.append(_pfb_hold(f"C {c} q {q} batch", sb, xb, branch)[1])
        x = z[:n].contiguous()
        s0 = torch.zeros(k, dtype=torch.complex64, device=dev)
        run = lambda: channelizer.channelize(s0, x, branch)  # noqa: E731
        twin = lambda: channelizer.channelize_reference(  # noqa: E731
            s0, x, branch)
        ms = back_to_back_ms(run)
        dev_ms = graph_ms(run)
        launch_ms = median_ms(run)
        plain_ms = back_to_back_ms(twin)
        nbytes = 16.0 * rows * n
        ops = rows * n * (4.0 * q + 5.0 * math.log2(c) + 2.0)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
        bound_ms = 1e3 * max(t_bytes, t_ops)
        log("channelizer", f"[{rows} x {n}] C {c} q {q}, plan {p}: "
                           f"{ms:.4f} ms (20 back to back, median of 5; "
                           f"host-bound where a launch's host time is "
                           f"longer), device {dev_ms:.4f} ms (CUDA-graph "
                           f"replay), {launch_ms:.4f} ms a launch (median of "
                           f"{REPS}); twin (the stock path) {plain_ms:.4f} "
                           f"ms; bound {bound_ms:.4f} ms "
                           f"({nbytes / 1e6:.1f} MB at 3.35 TB/s, "
                           f"{ops / 1e9:.3f} Gop at 67 TFLOP/s): device "
                           f"{100 * bound_ms / dev_ms:.1f} % of it; {smi}")
        rows_out.append({"shape": [rows, n, c, q], "ms": ms,
                         "graph_ms": dev_ms,
                         "launch_ms": launch_ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms,
                         "bound_by": "bytes" if t_bytes >= t_ops
                         else "operations", "plan": p._asdict()})
    band = rows_out[0]
    return {"name": "channelize", "route": "cuda",
            "source": "luaradio_tpu_torch/csrc/channelizer.cu",
            "replaces": "none (the JAX ChannelizerBlock reaches no "
                        "pallas_call; the port's stock-torch body)",
            "max_abs_err": max(errs), "ms": band["ms"],
            "plain_ms": band["plain_ms"], "bound_ms": band["bound_ms"],
            "bound_by": band["bound_by"], "library_ms": band["plain_ms"],
            "shapes": rows_out}


#: the pll-linear phase's shapes: the AM band cell's chunk of channel
#: samples [117, 65 536] (multiplier 1), the stereo graph's pilot chunk
#: (multiplier 2; phase_stereo's chunk) and a bank of RDS pilots [8,
#: 65 536] (multiplier 3)
PLL_LIN_AM = (117, 65536)
PLL_LIN_PILOT = 52430
PLL_LIN_RDS = (8, 65536)


def _wrap_pi(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def _pll_lin_oracle(x, state, params):
    """The linear tier of x [R, N] in float64 beyond its float32 inputs:
    the twin's float32 unwrap (theta, wrapped increments less c1, d0),
    then the detrended phase summed, the two recurrences walked sample by
    sample (numpy, all rows at once) and the output phasors composed in
    float64 from the twin's complex64 constants.  Returns (tau, err, out)
    as float64 / complex128 arrays [R, N]."""
    rows, n = x.shape
    k = pll_linear._constants(*(float(v) for v in params[:4]),
                              int(params[4])).astype(np.float64)
    beta, a1m, mult = k[1], k[5], int(params[4])
    c = k[7:].reshape(5, 2, 2)
    lam, w, z0c, vp = (c[i, :, 0] + 1j * c[i, :, 1] for i in range(4))
    p0, m0, f0 = (torch.as_tensor(v, dtype=torch.float32, device=x.device)
                  .expand(rows) for v in state)
    th = torch.atan2(x.imag, x.real)
    inc = pll_linear._wrap(th[:, 1:] - th[:, :-1])
    c1 = (inc.double().sum(-1) / max(n - 1, 1)).float()
    d0 = pll_linear._wrap(th[:, 0] - p0)
    tau = (d0.double()[:, None] + torch.cat(
        [torch.zeros_like(d0.double())[:, None],
         torch.cumsum((inc - c1[:, None]).double(), -1)], -1)).cpu().numpy()
    z = z0c[None, :] * ((f0 - c1).double().cpu().numpy()[:, None])
    err = np.empty((rows, n))
    for i in range(n):
        err[:, i] = tau[:, i] - (vp[None, :] * z).real.sum(-1)
        z = lam[None, :] * z + w[None, :] * tau[:, i:i + 1]
    scum = np.concatenate([np.zeros((rows, 1)),
                           np.cumsum(err, -1)[:, :-1]], -1)
    xd = x.cpu().numpy().astype(np.complex128)
    mag = np.abs(xd)
    xh = np.where(mag > 0, xd / np.maximum(mag, 1e-30), 1.0)
    base = np.exp(1j * (m0.double() - mult * p0.double()).cpu().numpy())
    out = base[:, None] * xh ** mult * np.exp(1j * (-mult * err + a1m * scum))
    return tau, err, out


def _pll_lin_hold(label, x, state, params):
    """One chunk x [R, N] through the kernel (pll_linear_gated, one
    launch) and its twin (pll_linear_reference and coherence, stock torch)
    from the same state on the card: the guard and coherence flags equal
    on every row; each row's out within 1e-5 and its err within 1e-5 +
    2^-22 max|tau| of the twin's, or within those limits of a float64
    walk of the same loop (_pll_lin_oracle) and nearer it than the twin
    (where the twin's own float32 rounding takes it near or past the
    limits: the loop's acquisition, |tau| of 100 or more); the new state
    (phases modulo 2 pi) within the err limit of the twin's.  Returns the twin's new state (the next
    chunk's) and the largest deviations."""
    rows = x.shape[0]
    n0 = pll_linear.pll_linear.launches
    flags, st, out, err = pll_linear.pll_linear_gated(x, state, *params)
    valid, tst, tout, terr = pll_linear.pll_linear_reference(x, state,
                                                             *params)
    coh = pll_linear.coherence(x)
    torch.cuda.synchronize()
    if pll_linear.pll_linear.launches != n0 + 1:
        raise AssertionError(f"pll-linear {label}: "
                             f"{pll_linear.pll_linear.launches - n0} "
                             f"launches, not 1")
    if not torch.equal(flags[0], valid.reshape(-1)) \
            or not torch.equal(flags[1], coh):
        raise AssertionError(f"pll-linear {label}: flags {flags.tolist()}, "
                             f"twin {valid.tolist()} {coh.tolist()}")
    tau, oerr, oout = _pll_lin_oracle(x, state, params)
    tol = 1e-5 + 2.0 ** -22 * np.abs(tau).max(-1)

    def gaps(o, e):
        return (np.abs(o.cpu().numpy() - oout).max(-1),
                np.abs(e.cpu().numpy() - oerr).max(-1))
    d_out = (out - tout).abs().amax(-1).cpu().numpy()
    d_err = (err - terr).abs().amax(-1).cpu().numpy()
    d_st = torch.stack([_wrap_pi(st[0] - tst[0]).abs(),
                        _wrap_pi(st[1] - tst[1]).abs(),
                        (st[2] - tst[2]).abs()]).amax(0).cpu().numpy()
    k_out, k_err = gaps(out, err)
    t_out, t_err = gaps(tout, terr)
    near_twin = (d_out <= 1e-5) & (d_err <= tol)
    near_loop = (k_out <= 1e-5) & (k_err <= tol) & (k_out <= t_out) \
        & (k_err <= t_err)
    ok = (near_twin | near_loop) & (d_st <= tol)
    worst = {"out": float(d_out.max()), "err": float(d_err.max()),
             "state": float(d_st.max()),
             "loop_out": float(k_out.max()), "loop_err": float(k_err.max()),
             "twin_loop_out": float(t_out.max()),
             "twin_loop_err": float(t_err.max())}
    msg = (f"max |kernel - twin| out {worst['out']:.3g}, err "
           f"{worst['err']:.3g}, state {worst['state']:.3g}; against the "
           f"float64 loop: kernel out {worst['loop_out']:.3g}, err "
           f"{worst['loop_err']:.3g}, twin out {worst['twin_loop_out']:.3g}, "
           f"err {worst['twin_loop_err']:.3g}; limits out 1e-5, err "
           f"{tol.min():.3g}-{tol.max():.3g} (max|tau| "
           f"{np.abs(tau).max():.3g}); rows held to the loop, nearer it than "
           f"the twin: {int((~near_twin).sum())}")
    if not ok.all():
        raise AssertionError(f"pll-linear {label}: rows "
                             f"{np.nonzero(~ok)[0].tolist()} fail: {msg}")
    log("pll-linear", f"{label}: x {tuple(x.shape)}, valid "
                      f"{int(flags[0].sum())} of {rows}, coherent "
                      f"{int(flags[1].sum())}, as the twin; {msg}")
    return tst, worst


def _pll_lin_device_ms(fn, calls: int = 20) -> float:
    """The kernel's own device time a call: torch.profiler's sum of
    pll_linear_kernel over ``calls`` calls (a cut row's launch is
    cooperative, which a CUDA graph may not capture)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for evt in prof.key_averages():
        if "pll_linear_kernel" in evt.key:
            us += getattr(evt, "device_time_total",
                          getattr(evt, "cuda_time_total", 0.0))
            count += evt.count
    if count != calls:
        raise AssertionError(f"pll-linear: the profiler saw {count} kernel "
                             f"launches of {calls}")
    return us / 1e3 / calls


class _Drop(SinkBlock):
    """A sink that takes a bank's chunks and keeps nothing."""

    def __init__(self):
        super().__init__()
        self.add_type_signature([Input("in", lambda t: True)], [])

    def process(self, x):
        pass


def amband_pll_rows(tmp, dev, chunks=3, seed=2800000028):
    """The AM band cell's graph (radiobench/configs/amband117_rtlsdr.py:
    ring -> ChannelizerBlock(117, 16) -> AMSynchronousDemodulator) over a
    seeded capture of the band, ``chunks`` chunks of [117, 65 536]
    channel samples: every PLL chunk's input, state and loop constants as
    it entered the block, with the kernel's launches, the twin's calls on
    a CUDA tensor (must be 0) and the rows each chunk's tiers solved."""
    from pathlib import Path

    from radiobench import harness
    from radiobench.players import amband

    root = Path(__file__).resolve().parent / "radiobench"
    cfg = json.loads((root / "configs" / "amband117_rtlsdr.json").read_text())
    mix = json.loads((root / "traffic" / "amband_2p23.json").read_text())
    graph = harness.load_module(root / "configs" / "amband117_rtlsdr.py")
    c, m = PLL_LIN_AM
    n = amband.seamless_length(2 * c * m, cfg)
    path = os.path.join(tmp, "amband.u8")
    amband.capture(seed, n, cfg, mix["signal"], dev).cpu().numpy().tofile(
        path)
    top = graph.build(cfg, IQFileSource(path, "u8", cfg["rate"],
                                        repeat_on_eof=True, resident=True),
                      _Drop())
    seen, process = [], carrier.PLLBlock.process
    twin, twin_cuda = pll_linear.pll_linear_reference, [0]

    def recording(self, state, x):
        seen.append((x.clone(), tuple(torch.as_tensor(v).clone()
                                      for v in state),
                     (self._alpha, self._beta, self._freq_min,
                      self._freq_max, int(self.multiplier))))
        return process(self, state, x)

    def counted(x, *args):
        twin_cuda[0] += x.is_cuda
        return twin(x, *args)
    n0 = pll_linear.pll_linear.launches
    slow0 = pll_linear.pll_hybrid.scan_rows + pll_linear.pll_hybrid.k3_rows
    carrier.PLLBlock.process = recording
    pll_linear.pll_linear_reference = counted
    try:
        Runner(top, device=dev, chunk_size=c * m).run(max_chunks=chunks)
    finally:
        carrier.PLLBlock.process = process
        pll_linear.pll_linear_reference = twin
    return {"chunks": seen, "launches": pll_linear.pll_linear.launches - n0,
            "twin_cuda": twin_cuda[0],
            "slow_rows": pll_linear.pll_hybrid.scan_rows
            + pll_linear.pll_hybrid.k3_rows - slow0}


def _pilot_bank(rows, n, params, mult, gen, dev):
    """Locked pilots a row: tones at (fmin + fmax) / 2 / mult radians a
    sample with their own phase, amplitude and noise, and the state that
    has them locked (phi_l the tone's phase, freq its rate)."""
    w = float(params[2] + params[3]) / 2
    t = torch.arange(n, dtype=torch.float64, device=dev)
    ph = torch.rand(rows, 1, generator=gen, dtype=torch.float64,
                    device=dev) * 6.0 - 3.0
    amp = 0.05 + 0.1 * torch.rand(rows, 1, generator=gen,
                                  dtype=torch.float64, device=dev)
    noise = torch.randn((rows, n), generator=gen, dtype=torch.complex128,
                        device=dev)
    x = (amp * torch.exp(1j * (w * t + ph)) + 0.05 * amp * noise
         ).to(torch.complex64)
    state = (ph[:, 0].float(), (mult * ph[:, 0]).float(),
             torch.full((rows,), w, dtype=torch.float32, device=dev))
    return x, state


def phase_pll_linear(tmp, dev, gen, smi):
    """The PLL's linear tier as one kernel (csrc/pll_linear.cu), each of
    its shapes held against its twin on the card and timed: the AM band
    cell's own rows ([117, 65 536], multiplier 1, three chunks of the
    cell's graph run on the card, where the kernel must launch once a PLL
    chunk and the twin never run on a CUDA tensor, every row leaving the
    linear tier as before), the stereo pilot ([1, 52 430], multiplier 2,
    two chained chunks of a locked pilot; the row cut in segments) and a
    bank of 8 RDS pilots ([8, 65 536], multiplier 3, two chunks).  Timed:
    the kernel's device time (torch.profiler), 20 calls back to back, a
    launch, and the twin (stock torch: pll_linear_reference and
    coherence) back to back, beside the bound (20 B a sample, x read
    once and out and err written once, at 3.35 TB/s).  Returns the
    kernel's entry for the kernels line."""
    am = amband_pll_rows(tmp, dev)
    if am["launches"] != len(am["chunks"]) or am["twin_cuda"]:
        raise AssertionError(f"pll-linear: the AM band graph launched the "
                             f"kernel {am['launches']} times in "
                             f"{len(am['chunks'])} PLL chunks, the twin "
                             f"{am['twin_cuda']} times on the card")
    log("pll-linear", f"AM band graph: {len(am['chunks'])} PLL chunks, "
                      f"{am['launches']} kernel launches, the twin 0 times "
                      f"on the card; {am['slow_rows']} row-chunks left the "
                      f"linear tier")
    # (label, [(chunk, state or None: the twin's from the chunk before)],
    # the loop's constants and multiplier)
    groups = [("AM band", [(x, st) for x, st, _ in am["chunks"]],
               am["chunks"][0][2])]
    for label, (rows, n), params, mult in (
            ("stereo pilot", (1, PLL_LIN_PILOT), stereo_pll_params(), 2),
            ("RDS pilots", PLL_LIN_RDS, rds_pll_params(), 3)):
        x, st = _pilot_bank(rows, 2 * n, params, mult, gen, dev)
        groups.append((label, [(x[:, :n].contiguous(), st),
                               (x[:, n:].contiguous(), None)],
                       params + (mult,)))
    worst, shapes = {}, []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, chunks, params in groups:
        carried = None
        for i, (xc, st) in enumerate(chunks):
            carried, w = _pll_lin_hold(f"{label}, chunk {i}", xc,
                                       st if st is not None else carried,
                                       params)
            worst = {k: max(worst.get(k, 0.0), v) for k, v in w.items()}
        xc, st0 = chunks[0]
        rows, n = xc.shape
        run = lambda: pll_linear.pll_linear_gated(  # noqa: E731
            xc, st0, *params)

        def twin():
            pll_linear.pll_linear_reference(xc, st0, *params)
            pll_linear.coherence(xc)
        p = pll_linear.plan(rows, n, sms)
        dev_ms = _pll_lin_device_ms(run)
        ms = back_to_back_ms(run)
        launch_ms = median_ms(run)
        plain_ms = back_to_back_ms(twin)
        nbytes = 20.0 * rows * n
        bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        log("pll-linear", f"{label} [{rows} x {n}] multiplier {params[-1]}, "
                          f"plan {tuple(p)}: device {dev_ms:.4f} ms "
                          f"(torch.profiler, 20 calls), {ms:.4f} ms (20 back "
                          f"to back, median of 5), {launch_ms:.4f} ms a "
                          f"launch (median of {REPS}); twin (stock torch) "
                          f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
                          f"({nbytes / 1e6:.1f} MB at 3.35 TB/s): device "
                          f"{dev_ms / bound_ms:.2f}x it; {smi}")
        shapes.append({"shape": [rows, n, params[-1]], "device_ms": dev_ms,
                       "ms": ms, "launch_ms": launch_ms,
                       "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "plan": p._asdict()})
    band = shapes[0]
    return {"name": "pll_linear", "route": "cuda",
            "source": "luaradio_tpu_torch/csrc/pll_linear.cu",
            "replaces": "none (the JAX pll_linear reaches no pallas_call; "
                        "the port's stock-torch body)",
            "launches": am["launches"],
            "max_abs_err": max(worst["out"], worst["err"]), "gaps": worst,
            "ms": band["ms"], "plain_ms": band["plain_ms"],
            "bound_ms": band["bound_ms"], "bound_by": "bytes",
            "library_ms": band["plain_ms"], "shapes": shapes}


def phase_bank_mono(tmp, dev, profile=None):
    """The channelizer bank at full width: a BANK_S s capture at
    BANK_RATE through bank_mono_graph, chunks of 64 x 16 384.  Each
    station's tone within 50 Hz on its row, and its tone bin over 100x
    the median of the quiet rows' power in that bin (a quiet row's
    discriminator runs on noise alone, so its audio is loud and broad:
    the whole-band power does not separate the rows).  Then under the
    K2 rule, where K2 must launch once a chunk on all 64 rows, is held
    against its twin on the first chunk the path gave it and the audio
    must match the default run's within 2e-5 * scale.  Returns the K2
    record of the path."""
    path, n, tones = write_wideband_capture(tmp, dev)
    log("bank-mono", f"capture: {n} samples ({BANK_S} s) at {BANK_RATE} "
                     f"S/s, f32le, {os.path.getsize(path) / 1e6:.0f} MB; "
                     f"stations on bins {sorted(tones)}")
    top, _ = bank_mono_graph(path)
    Runner(top, chunk_size=BANK_C * 16384, device=dev).run(max_chunks=2)
    channelizer.channelize.launches = 0
    stock0 = ChannelizerBlock.stock_chunks
    audio, dt = run_bank_mono(path, dev)
    pfb_launches = channelizer.channelize.launches
    if pfb_launches != -(-n // (BANK_C * 16384)) \
            or ChannelizerBlock.stock_chunks != stock0:
        raise AssertionError(f"bank-mono: {pfb_launches} channelizer kernel "
                             f"launches over {-(-n // (BANK_C * 16384))} "
                             f"chunks, {ChannelizerBlock.stock_chunks - stock0}"
                             f" on the stock path")
    rate = BANK_RATE / BANK_C / 8
    quiet = [c for c in range(BANK_C) if c not in tones]
    if audio.shape != (BANK_C, n // BANK_C // 8) \
            or not np.isfinite(audio).all():
        raise AssertionError(f"bank-mono: audio {audio.shape}")
    least, off = np.inf, 0.0
    for b, tone in tones.items():
        p, f = tone_bin_power(audio[[b] + quiet], rate, tone)
        ratio = p[0] / np.median(p[1:])
        if abs(f[0] - tone) > 50 or ratio <= 100:
            raise AssertionError(f"bank-mono: bin {b}: {tone} Hz found at "
                                 f"{f[0]:.1f} Hz, tone bin {ratio:.3g}x the "
                                 f"quiet rows' median (limit 100)")
        least, off = min(least, ratio), max(off, abs(f[0] - tone))
    power = (audio[:, audio.shape[1] // 2:].astype(np.float64) ** 2).mean(-1)
    band = power[list(tones)] / np.median(power[quiet])
    log("bank-mono", f"{len(tones)} stations: each tone within {off:.1f} Hz "
                     f"(limit 50), tone bin >= {least:.3g}x the quiet rows' "
                     f"median (limit 100); whole-band audio power of the "
                     f"station rows over the quiet rows' median "
                     f"{band.min():.3g}-{band.max():.3g}x (not held); "
                     f"{pfb_launches} channelizer kernel launches, one a "
                     f"chunk; {n / dt / 1e6:.2f} M complex samples/s end to "
                     f"end")
    calls = []
    os.environ["LUARADIO_TPU_FORCE_WBFM_KERNEL"] = "1"
    top, _ = bank_mono_graph(path)
    Runner(top, chunk_size=BANK_C * 16384, device=dev).run(max_chunks=2)
    restore = _record(wbfm, "_launch_k2", calls)
    try:
        wbfm.disc_fir.launches = 0
        k2_audio, k2_dt = run_bank_mono(path, dev)
        launches = wbfm.disc_fir.launches
    finally:
        restore()
        del os.environ["LUARADIO_TPU_FORCE_WBFM_KERNEL"]
    chunks = -(-n // (BANK_C * 16384))
    shapes = {tuple(c[0][1].shape) for c in calls}
    if launches != chunks or shapes != {(BANK_C, 16384)}:
        raise AssertionError(f"bank-mono K2: {launches} launches over "
                             f"{chunks} chunks, shapes {shapes}")
    (carry, x, taps, d, inv_gain, _), _ = calls[0]
    err = compare("disc_fir", lambda c, xx, h: wbfm.disc_fir(
        c, xx, h, d, inv_gain), lambda c, xx, h: wbfm.disc_fir_reference(
        c, xx, h, d, inv_gain), [("bank-mono chunk 0", x, carry)], taps)
    timed = measure("disc_fir", lambda c, xx, h: wbfm.disc_fir(
        c, xx, h, d, inv_gain), lambda c, xx, h: wbfm.disc_fir_reference(
        c, xx, h, d, inv_gain), x, carry, taps, d)
    k2_dev_ms = graph_ms(lambda: wbfm.disc_fir(carry, x, taps, d, inv_gain))
    log("disc_fir", f"bank chunk: {k2_dev_ms:.4f} ms device time "
                    f"(CUDA-graph replay); "
                    f"{wbfm.plan(BANK_C, 16384, taps.shape[0], d)}")
    scale = max(1.0, float(np.abs(audio).max()))
    diff = float(np.abs(k2_audio - audio).max())
    if k2_audio.shape != audio.shape or diff > 2e-5 * scale:
        raise AssertionError(f"bank-mono K2: audio off the default run by "
                             f"{diff} (limit 2e-5 * {scale:.3g})")
    log("bank-mono", f"K2 rule: {launches} K2 launches over {chunks} "
                     f"chunks, each on [{BANK_C} x 16384]; audio within "
                     f"{diff:.3g} of the default run's (limit 2e-5 * "
                     f"{scale:.3g}); {n / k2_dt / 1e6:.2f} M complex "
                     f"samples/s end to end")
    if profile:
        profile_run(lambda: run_bank_mono(path, dev),
                    f"{profile}.bank_mono.txt", "bank-mono")
    return {"launches": launches, "chunks": chunks, "max_abs_err": err,
            **timed, "graph_ms": k2_dev_ms, "sps": n / dt,
            "k2_sps": n / k2_dt, "pfb_launches": pfb_launches}


def write_stereo_bank(tmp, dev):
    """BANK_C IQ files at ST_RATE, ST_S s each, made on the card: ST_NOISE
    s of noise, then on the rows ST_STATIONS the stereo multiplex of
    write_stereo_capture (L and R tones of their own) at ~30 dB SNR; the
    other rows stay noise.  Returns (paths, samples, {row: (L, R)})."""
    n, n0 = int(ST_S * ST_RATE), int(ST_NOISE * ST_RATE)
    gen = torch.Generator(device=dev).manual_seed(19)
    t = torch.arange(n - n0, device=dev, dtype=torch.float64) / ST_RATE
    tones, paths = {}, []
    for c in range(BANK_C):
        z = torch.randn(n, generator=gen, device=dev,
                        dtype=torch.complex128) * np.sqrt(1e-3)
        if c in ST_STATIONS:
            k = ST_STATIONS.index(c)
            tl_, tr_ = 600.0 + 200.0 * k, 1700.0 + 300.0 * k
            tones[c] = (tl_, tr_)
            left = 0.4 * torch.sin(2 * np.pi * tl_ * t)
            right = 0.4 * torch.sin(2 * np.pi * tr_ * t)
            mpx = (left + right) + 0.1 * torch.cos(2 * np.pi * 19e3 * t) \
                + (left - right) * torch.cos(2 * np.pi * 38e3 * t)
            ph = 2 * np.pi * 75e3 * torch.cumsum(mpx, 0) / ST_RATE + 0.7 * k
            z[n0:] += torch.polar(torch.ones_like(ph), ph)
        paths.append(os.path.join(tmp, f"bank{c:02d}.f32.iq"))
        z.to(torch.complex64).cpu().numpy().view(np.float32).tofile(
            paths[-1])
    return paths, n, tones


def stereo_bank_graph(paths):
    """BankSource of the files -> WBFMStereoDemodulator (PLL pilot) ->
    sinks on left and right (one file: the single-stream graph)."""
    top, left, right = CompositeBlock(), _Collect(), _Collect()
    demod = WBFMStereoDemodulator()
    srcs = [IQFileSource(p, "f32le", ST_RATE) for p in paths]
    top.connect(BankSource(srcs) if len(srcs) > 1 else srcs[0], demod)
    top.connect(demod, "left", left, "in")
    top.connect(demod, "right", right, "in")
    pll_block = next(b for b in demod._blocks
                     if isinstance(b, carrier.PLLBlock))
    return top, left, right, pll_block


def hold_bank_rows(label, calls, rows_of, row_of, twin, twin_rows=4):
    """Every row of every banked launch in ``calls`` (``rows_of(call)``
    rows, 0 for a one-stream launch) against a one-row launch of that
    row, bit for bit (``row_of(call, r)`` gives the launch's row r and
    the one-row launch's result); ``twin`` on ``twin_rows`` rows of the
    first launch of more than one row.  Returns (rows held, the twin's
    largest error, its time on those rows: host clock, one run, ms)."""
    held, twin_err, twin_ms = 0, 0.0, None
    for i, call in enumerate(calls):
        for r in range(rows_of(call)):
            got, one = row_of(call, r)
            if not all(torch.equal(u, v) for u, v in zip(got, one)):
                raise AssertionError(f"{label} launch {i} row {r}: not the "
                                     f"one-row launch's bits")
            held += 1
    first = next((c for c in calls if rows_of(c) > 1), None)
    if first is not None:
        t0 = time.monotonic()
        twin_err = twin(first, min(twin_rows, rows_of(first)))
        twin_ms = (time.monotonic() - t0) * 1e3
    return held, twin_err, twin_ms


def _k3_rows(call):
    x = call[0][1]
    return x.shape[0] if x.dim() == 2 else 0


def _k3_row(call, r):
    """K3's banked launch (pll._launch(lib, x [R, N], state [R, 3], k)):
    its row r and a one-row launch of that row."""
    (lib, x, st, k), out = call
    one = pll._launch(lib, x[r].contiguous(), st[r].contiguous(), k)
    return tuple(v[r] for v in out), one


def _k3_twin(call, rows):
    (lib, x, st, k), out = call
    errs = 0.0
    for r in range(rows):
        exp = pll._reference_row(x[r].contiguous(), st[r].contiguous(), k)
        errs = max(errs, *pll_diff("bank twin", tuple(v[r] for v in out),
                                   exp))
    if errs > 1e-5:
        raise AssertionError(f"pll_phase bank: |kernel - twin| {errs} > "
                             f"1e-5 on the first {rows} rows")
    return errs


def _scan_cols(out, lo, hi):
    """Segments lo..hi of a scan's result: rows of o_r, o_i, o_e [C S, L],
    columns of the snapshot and exit state [5, C S]."""
    return tuple(v[lo:hi] for v in out[:3]) + tuple(v[:, lo:hi]
                                                    for v in out[3:])


def _scan_rows(call):
    return call[0][0].shape[0]


def _scan_row(call, r):
    """The scan's banked launch (pll_overlap._scan_kernel(x [R, N],
    init [5, R S], ...)): row r's segment columns and a one-row launch of
    that row."""
    (x, init, consts, lseg, warm), out = call
    s = x.shape[1] // lseg
    one = pll_overlap._scan_kernel(
        x[r:r + 1].contiguous(), init[:, r * s:(r + 1) * s].contiguous(),
        consts, lseg, warm)
    return _scan_cols(out, r * s, (r + 1) * s), one


def _scan_twin(call, rows):
    """The plain scan (pll_overlap._scan_reference) on ``rows`` rows of
    one launch, as one batch: on the card each element rounds as in a
    one-row run, and one pass over the W+L steps costs what one row
    does."""
    (x, init, consts, lseg, warm), out = call
    s = x.shape[1] // lseg
    exp = pll_overlap._scan_reference(x[:rows].contiguous(),
                                      init[:, :rows * s].contiguous(),
                                      consts, lseg, warm)
    torch.cuda.synchronize()
    errs = max((u - v).abs().max().item()
               for u, v in zip(_scan_cols(out, 0, rows * s), exp))
    if errs > 1e-6:
        raise AssertionError(f"overlap bank: |kernel - plain scan| {errs} "
                             f"> 1e-6 on the first {rows} rows")
    return errs


def run_bank_stereo(paths, chunk, dev):
    """stereo_bank_graph over ``paths`` with run(channels=len(paths)) at
    ``chunk``, K3's and the scan's counts zeroed just before and read just
    after, every launch of either recorded (inputs and outputs) and each
    PLL chunk's tiers by row.  Returns the run's record."""
    k3, scan = pll.pll_phase, pll_overlap.pll_overlap_discard
    k3_calls, scan_calls, row_tiers = [], [], []
    restores = [_record(pll, "_launch", k3_calls),
                _record(pll_overlap, "_scan_kernel", scan_calls)]
    process = carrier.PLLBlock.process

    def recording(self, state, x):
        out = process(self, state, x)
        row_tiers.append(list(self.row_tiers))
        return out
    carrier.PLLBlock.process = recording
    top, left, right, _ = stereo_bank_graph(paths)
    try:
        k3.launches = k3.rows = scan.launches = scan.rows = 0
        t0 = time.monotonic()
        Runner(top, chunk_size=chunk, device=dev, channels=len(paths)).run()
        dt = time.monotonic() - t0
        counts = (k3.launches, k3.rows, scan.launches, scan.rows)
    finally:
        carrier.PLLBlock.process = process
        for r in restores:
            r()
    if len(k3_calls) != counts[0] or len(scan_calls) != counts[2]:
        raise AssertionError(f"bank-stereo: {counts} launches, "
                             f"{len(k3_calls)} and {len(scan_calls)} "
                             f"recorded")
    return {"k3_calls": k3_calls, "scan_calls": scan_calls,
            "launches": counts[0], "rows": counts[1],
            "scan_launches": counts[2], "scan_rows": counts[3],
            "tiers": ["".join("LOS"[t - 1] for t in col)
                      for col in zip(*row_tiers)],
            "chunks": len(row_tiers), "dt": dt,
            "left": _rows(left), "right": _rows(right)}


def hold_stereo_tones(label, run, tones):
    """L+R of each station row carries both its tones within 50 Hz at SNR
    > 1e4 over the second half."""
    for c, pair in tones.items():
        mono = run["left"][c].astype(np.float64) + run["right"][c]
        for tone in pair:
            f, snr = tone_snr(mono, ST_RATE, tone)
            if abs(f - tone) > 50 or snr <= 1e4:
                raise AssertionError(f"{label} row {c}: L+R tone {tone} Hz "
                                     f"at {f:.1f} Hz, SNR {snr:.3g}")


def phase_bank_stereo(tmp, dev, profile=None):
    """K3's banked path: write_stereo_bank through stereo_bank_graph with
    run(channels=64), chunks of ST_CHUNK, where the overlap tier does not
    plan.  K3 must launch with more than one row a launch and at most
    once a chunk; every row of every launch equals its one-row launch bit
    for bit, and the twin holds 4 rows of the first.  L+R carries both
    tones of each station row at SNR > 1e4; three station rows and two
    noise rows equal the single-stream graph on their file (L+R within
    2e-5 * scale, L-R within 2 LSB of 16 bits).  Then the overlap scan's
    banked path: the same graph at ST_SCAN_CHUNK, where the scan plans
    and takes the bandpassed noise (coherent at lag 1) and the
    acquisition; its launches held as K3's, and K3's where it ran.
    Returns the paths' record."""
    paths, n, tones = write_stereo_bank(tmp, dev)
    log("bank-stereo", f"{BANK_C} files of {n} samples ({ST_S} s) at "
                       f"{ST_RATE} S/s; noise for the first {ST_NOISE} s, "
                       f"stations on rows {sorted(tones)}")
    top, *_ = stereo_bank_graph(paths)
    Runner(top, chunk_size=ST_CHUNK, device=dev,
           channels=BANK_C).run(max_chunks=2)                    # warm-up
    run = run_bank_stereo(paths, ST_CHUNK, dev)
    l_, r_ = run["left"], run["right"]
    launches, rows, chunks = run["launches"], run["rows"], run["chunks"]
    if l_.shape != (BANK_C, n) or not np.isfinite(l_).all() \
            or launches < 1 or launches > chunks or rows <= launches:
        raise AssertionError(f"bank-stereo: left {l_.shape}; K3 {launches} "
                             f"launches of {rows} rows over {chunks} chunks")
    log("bank-stereo", f"run(channels={BANK_C}) at chunk {ST_CHUNK}: "
                       f"{BANK_C * n / run['dt'] / 1e6:.2f} M complex "
                       f"samples/s summed over the channels end to end "
                       f"({run['dt']:.3f} s); {chunks} PLL chunks; K3 "
                       f"{launches} launches carrying {rows} rows "
                       f"({rows / launches:.1f} a launch); overlap scan "
                       f"{run['scan_launches']} launches")
    log("bank-stereo", "tiers by row, chunk by chunk (L linear, O overlap, "
                       "S sequential): " + " ".join(
                           f"{c}:{t}" for c, t in enumerate(run["tiers"])))
    held, k3_twin, k3_twin_ms = hold_bank_rows(
        "pll_phase bank", run["k3_calls"], _k3_rows, _k3_row, _k3_twin)
    log("bank-stereo", f"K3: {held} rows of {launches} launches each equal "
                       f"to their one-row launch bit for bit; twin on 4 rows "
                       f"of the first: max |kernel - twin| {k3_twin:.3g} "
                       f"(limit 1e-5), {k3_twin_ms:.1f} ms (host clock)")
    hold_stereo_tones("bank-stereo", run, tones)
    quiet = [c for c in range(BANK_C) if c not in tones]
    singles = sorted(tones)[:3] + quiet[:2]
    worst = [0.0, 0.0]
    for c in singles:
        top1, l1, r1, _ = stereo_bank_graph([paths[c]])
        Runner(top1, chunk_size=ST_CHUNK, device=dev).run()
        l1, r1 = _rows(l1), _rows(r1)
        lpr, lmr = l1 + r1, l1 - r1
        scale = max(1.0, float(np.abs(lpr).max()))
        d_lpr = float(np.abs(l_[c] + r_[c] - lpr).max())
        d_lmr = float(np.abs(l_[c] - r_[c] - lmr).max())
        if d_lpr > 2e-5 * scale or d_lmr > 2 / 32768:
            raise AssertionError(f"bank-stereo row {c}: L+R off its single "
                                 f"run by {d_lpr}, L-R by {d_lmr}")
        worst = [max(worst[0], d_lpr), max(worst[1], d_lmr)]
    log("bank-stereo", f"L+R of each station row carries its two tones at "
                       f"SNR > 1e4; rows {singles} against the single-stream "
                       f"graph on their files: L+R within {worst[0]:.3g} "
                       f"(limit 2e-5 * scale), L-R within {worst[1]:.3g} "
                       f"(limit 2 LSB, {2 / 32768:.3g})")
    if profile:
        top, *_ = stereo_bank_graph(paths)
        profile_run(lambda: Runner(top, chunk_size=ST_CHUNK, device=dev,
                                   channels=BANK_C).run(),
                    f"{profile}.bank_stereo.txt", "bank-stereo")
    scan_run = run_bank_stereo(paths, ST_SCAN_CHUNK, dev)
    scans, scan_rows = scan_run["scan_launches"], scan_run["scan_rows"]
    if scans < 1 or scan_rows <= scans or scans > scan_run["chunks"]:
        raise AssertionError(f"bank-stereo at {ST_SCAN_CHUNK}: scan {scans}"
                             f" launches of {scan_rows} rows")
    hold_stereo_tones("bank-stereo overlap path", scan_run, tones)
    s_held, s_twin, s_twin_ms = hold_bank_rows(
        "overlap bank", scan_run["scan_calls"], _scan_rows, _scan_row,
        _scan_twin)
    k_held, k_twin, _ = hold_bank_rows(
        "pll_phase bank", scan_run["k3_calls"], _k3_rows, _k3_row, _k3_twin)
    log("bank-stereo", f"at chunk {ST_SCAN_CHUNK}: "
                       f"{BANK_C * n / scan_run['dt'] / 1e6:.2f} M complex "
                       f"samples/s; overlap scan {scans} launches carrying "
                       f"{scan_rows} rows ({scan_rows / scans:.1f} a "
                       f"launch), K3 {scan_run['launches']} carrying "
                       f"{scan_run['rows']}; scan: {s_held} rows equal to "
                       f"their one-row launch bit for bit, the plain scan on "
                       f"4 rows of the first {s_twin:.3g} off (limit 1e-6) "
                       f"in {s_twin_ms:.0f} ms (host clock); "
                       f"K3: {k_held} rows held likewise; L+R tones held")
    log("bank-stereo", "tiers by row at the overlap chunk: " + " ".join(
        f"{c}:{t}" for c, t in enumerate(scan_run["tiers"])))
    return {"launches": launches, "rows": rows, "chunk": ST_CHUNK,
            "scan_launches": scans, "scan_rows": scan_rows,
            "scan_chunk": ST_SCAN_CHUNK,
            "k3_at_scan_chunk": (scan_run["launches"], scan_run["rows"]),
            "max_abs_err": max(k3_twin, k_twin), "scan_err": s_twin,
            "twin_ms_4_rows": k3_twin_ms, "scan_plain_ms_4_rows": s_twin_ms,
            "sps": BANK_C * n / run["dt"],
            "scan_sps": BANK_C * n / scan_run["dt"]}


def phase_bank_timing(dev, gen, ns_step, scan_ns_step):
    """K3 and the overlap scan timed batched at the stereo bank's PLL
    chunks (K3 at ST_CHUNK, the scan at ST_SCAN_CHUNK, where it plans), C
    in BATCH_ROWS rows of a noisy 19 kHz pilot: device time (CUDA-graph
    replay), the ratio to one row, and each beside its chain floor (K3:
    phase 8's probe x N; the scan: its probe x the W+L steps of a
    segment) and the bound of the batch's bytes and operations.  Returns
    {C: record}."""
    blk = carrier.PLLBlock(100.0, 19e3 - 50, 19e3 + 50, multiplier=2)
    blk.input_rate = ST_RATE
    blk.initialize()
    params = (blk._alpha, blk._beta, blk._freq_min, blk._freq_max)
    n, n_scan = ST_CHUNK, ST_SCAN_CHUNK
    lseg, warm = pll_overlap.plan_overlap(n_scan, float(params[0]))
    consts = tuple(float(np.float32(v)) for v in (*params, 2))
    steps, seg = warm + lseg, n_scan // lseg
    out = {}
    for c in BATCH_ROWS:
        t = torch.arange(n_scan, device=dev, dtype=torch.float64)
        x = (torch.polar(torch.ones(c, n_scan, device=dev,
                                    dtype=torch.float64),
                         2 * np.pi * 19e3 / ST_RATE * t
                         + torch.rand(c, 1, generator=gen, device=dev,
                                      dtype=torch.float64) * 6.28)
             + 0.3 * torch.randn(c, n_scan, generator=gen, device=dev,
                                 dtype=torch.complex128)).to(
                                     torch.complex64).contiguous()
        xk = x[:, :n].contiguous()
        st = torch.tensor([[0.0, 0.0, float(params[2])]] * c, device=dev)
        k3_ms = graph_ms(lambda: pll.pll_phase(xk, st, *params, 2.0), 5, 3)
        leaves = tuple(st[:, i].contiguous() for i in range(3))
        init = pll_overlap._initial_states(x, leaves, seg, lseg, warm)
        scan_ms = graph_ms(lambda: pll_overlap._scan_kernel(
            x, init, consts, lseg, warm), 3, 3)
        k3_bound = 1e3 * max(c * n * PLL_BYTES / HBM_BYTES_PER_S,
                             c * n * PLL_OPS / FP32_FLOP_PER_S)
        scan_bytes = c * (n_scan * 8 + 5 * seg * 4 + 3 * n_scan * 4
                          + 10 * seg * 4)
        scan_bound = 1e3 * max(scan_bytes / HBM_BYTES_PER_S,
                               c * steps * seg * OVERLAP_OPS
                               / FP32_FLOP_PER_S)
        out[c] = {"k3_graph_ms": k3_ms, "scan_graph_ms": scan_ms,
                  "k3_bound_ms": k3_bound, "scan_bound_ms": scan_bound}
        del x, xk, init
    k3_floor, scan_floor = n * ns_step / 1e6, steps * scan_ns_step / 1e6
    for c, rec in out.items():
        rec["k3_ratio"] = rec["k3_graph_ms"] / out[1]["k3_graph_ms"]
        rec["scan_ratio"] = rec["scan_graph_ms"] / out[1]["scan_graph_ms"]
        rec["k3_floor_ratio"] = rec["k3_graph_ms"] / k3_floor
        rec["scan_floor_ratio"] = rec["scan_graph_ms"] / scan_floor
        log("bank-time", f"C = {c:3d} rows: K3 [{n}] {rec['k3_graph_ms']:.4f}"
                         f" ms device ({rec['k3_ratio']:.3f}x one row, "
                         f"{rec['k3_floor_ratio']:.3f}x its chain floor "
                         f"{k3_floor:.4f} ms; bound "
                         f"{rec['k3_bound_ms']:.5f} ms); scan [{n_scan}] "
                         f"{rec['scan_graph_ms']:.4f} ms device, {c * seg} "
                         f"segments of {lseg} after {warm} warm-up steps "
                         f"({rec['scan_ratio']:.3f}x one row, "
                         f"{rec['scan_floor_ratio']:.3f}x its chain floor "
                         f"{scan_floor:.4f} ms; bound "
                         f"{rec['scan_bound_ms']:.5f} ms)")
    return out


def bank_class_input(kind, dev, gen):
    """[BANK_C, CLASS_CHUNKS x CLASS_CHUNK] complex64 on the card: one
    broadcast-FM row (the stereo multiplex of write_stereo_capture at
    75 kHz deviation and 256 kS/s, or the RDS multiplex of
    tests/parallel/test_rds_bank.py at 228 kS/s) rotated by a random
    phase on each row, with noise ~40 dB under it."""
    n = CLASS_CHUNKS * CLASS_CHUNK
    rate = 228e3 if kind == "rds" else 256e3
    t = torch.arange(n, device=dev, dtype=torch.float64) / rate
    if kind == "rds":
        rng = np.random.default_rng(3)
        groups = [tuple(int(v) for v in rng.integers(0, 1 << 16, 4))
                  for _ in range(int(n / rate * RDS_BAUD / 104) + 1)]
        chips = torch.from_numpy(manchester_diff(np.concatenate(
            [rds_group_bits(g) for g in groups])).astype(np.float64)).to(dev)
        k = torch.clamp((t * 2 * RDS_BAUD).long(), max=len(chips) - 1)
        mpx = (0.2 * torch.sin(2 * np.pi * 800.0 * t)
               + 0.1 * torch.cos(2 * np.pi * 19e3 * t)
               + 0.06 * (2 * chips[k] - 1) * torch.cos(2 * np.pi * 57e3 * t))
        ph = 2 * np.pi * torch.cumsum(mpx, 0)
    else:
        left = 0.4 * torch.sin(2 * np.pi * 800.0 * t)
        right = 0.4 * torch.sin(2 * np.pi * 2100.0 * t)
        mpx = (left + right) + 0.1 * torch.cos(2 * np.pi * 19e3 * t) \
            + (left - right) * torch.cos(2 * np.pi * 38e3 * t)
        ph = 2 * np.pi * 75e3 * torch.cumsum(mpx, 0) / rate
    rot = torch.rand(BANK_C, 1, generator=gen, device=dev,
                     dtype=torch.float64) * 2 * np.pi
    x = torch.polar(torch.ones(BANK_C, n, device=dev, dtype=torch.float64),
                    ph + rot) + 0.01 * torch.randn(
        BANK_C, n, generator=gen, device=dev, dtype=torch.complex128)
    return x.to(torch.complex64), rate


def bank_class_chain(kind, rows, rate, dev):
    """The port's ordinary blocks for the class's receiver, run banked
    over ``rows`` (host arrays) with run(channels=64), optimize off: the
    WBFM demodulators (stereo with the vector pilot) -> Downsampler(8),
    or the RDS front end up to the RRC filter.  Returns [C, ...] (stereo:
    left and right joined on the last axis)."""
    top = CompositeBlock()
    src = BankSource([_ArraySource(r, rate) for r in rows])
    if kind == "rds":
        hilb, delay = HilbertTransformBlock(129), DelayBlock(64)
        mixer = MultiplyConjugateBlock()
        pilot = PilotRecoveryBlock(129, (18e3, 20e3), multiplier=3)
        sinks = [_Collect()]
        top.connect(src, FrequencyDiscriminatorBlock(1.25), hilb, delay)
        top.connect(hilb, pilot)
        top.connect(delay, "out", mixer, "in1")
        top.connect(pilot, "out", mixer, "in2")
        top.connect(mixer, LowpassFilterBlock(128, 4e3),
                    RootRaisedCosineFilterBlock(101, 1, RDS_BAUD), sinks[0])
    elif kind == "mono":
        sinks = [_Collect()]
        top.connect(src, WBFMMonoDemodulator(), DownsamplerBlock(8),
                    sinks[0])
    else:
        demod = WBFMStereoDemodulator(pilot="vector")
        sinks = [_Collect(), _Collect()]
        top.connect(src, demod)
        for port, sink in zip(("left", "right"), sinks):
            ds = DownsamplerBlock(8)
            top.connect(demod, port, ds, "in")
            top.connect(ds, "out", sink, "in")
    Runner(top, chunk_size=CLASS_CHUNK, optimize=False, device=dev,
           channels=len(rows)).run()
    return np.concatenate([_rows(s) for s in sinks], axis=-1)


def phase_bank_classes(dev, gen):
    """WBFMMonoBank, WBFMStereoBank and RDSBank at BANK_C channels over
    CLASS_CHUNKS chunks of CLASS_CHUNK samples: each row against the
    port's block chain run banked on the same rows (2e-4 * scale, the JAX
    package's bound for its classes against its block graph), and each
    class timed in complex samples/s summed over the channels (host clock
    around synchronized steps, after a warm-up step)."""
    classes = {"mono": WBFMMonoBank, "stereo": WBFMStereoBank,
               "rds": RDSBank}
    out = {}
    for kind, cls in classes.items():
        x, rate = bank_class_input(kind, dev, gen)
        bank = cls(None, if_rate=rate, device=dev) if kind == "rds" else \
            cls(None, if_rate=rate, decimation=8, device=dev)
        chunks = x.split(CLASS_CHUNK, dim=-1)
        state = bank.init_state(BANK_C)
        bank.step(state, chunks[0].contiguous())                 # warm-up
        state = bank.init_state(BANK_C)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ys = []
        for xc in chunks:
            state, y = bank.step(state, xc.contiguous())
            ys.append(torch.cat(y, -1) if kind == "stereo" else y)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        if kind == "stereo":
            half = [y.split(y.shape[-1] // 2, -1) for y in ys]
            got = torch.cat([torch.cat([h[0] for h in half], -1),
                             torch.cat([h[1] for h in half], -1)], -1)
        else:
            got = torch.cat(ys, -1)
        got = got.cpu().numpy()
        exp = bank_class_chain(kind, list(x.cpu().numpy()), rate, dev)
        scale = max(1.0, float(np.abs(exp).max()))
        err = float(np.abs(got - exp).max())
        if got.shape != exp.shape or err > 2e-4 * scale \
                or not np.isfinite(got).all() or np.abs(exp).max() < 1e-3:
            raise AssertionError(f"bank-classes {cls.__name__}: {got.shape} "
                                 f"vs {exp.shape}, max |class - chain| "
                                 f"{err} > 2e-4 * {scale:.3g}")
        sps = x.numel() / dt
        out[cls.__name__] = {"sps": sps, "max_abs_err": err}
        log("bank-classes", f"{cls.__name__} [{BANK_C} x {CLASS_CHUNK}] x "
                            f"{CLASS_CHUNKS} chunks at {rate:.0f} S/s: "
                            f"{sps / 1e9:.3f} G complex samples/s summed over "
                            f"the channels (host clock, synchronized); max "
                            f"|class - banked block chain| {err:.3g} (limit "
                            f"2e-4 * {scale:.3g})")
        del x, chunks, ys
    torch.cuda.empty_cache()
    return out


POCSAG_SENT = {0: (0x12342, 2, "HI"), 2: (0x0ABC1, 3, "BANK"),
               5: (0x1F003, 1, "ROW 5"), 7: (0x00420, 0, "CQ")}


def write_pocsag_rows(tmp):
    """The bank-host phase's 8 POCSAG captures at RATE, 1 s each: rows
    POCSAG_SENT carry their own message, one batch after the preamble;
    the others noise.  Returns their paths."""
    rows = []
    for c in range(8):
        z = np.zeros(RATE, np.complex64)
        if c in POCSAG_SENT:
            bits = pocsag_bits(*POCSAG_SENT[c])[:576 + 32 * 17]
            iq = fsk(bits, 1200, RATE, lambda b: np.where(b == 1, -4500.0,
                                                         4500.0))
            z[int(0.02 * RATE):int(0.02 * RATE) + len(iq)] = iq
        rows.append(write_iq(tmp, f"pocsag{c}.f32.iq", noisy(z, 0, 50 + c)))
    return rows


def phase_bank_host(tmp, dev):
    """The per-channel host fan-out: a BankSource of 8 POCSAG captures at
    RATE, 1 s each (rows POCSAG_SENT carry their own message, one batch
    after the preamble; the others noise), through the rx_pocsag graph by
    hand (Tuner -> POCSAGReceiver -> a sink) with run(channels=8): the
    framer and decoder run one clone a channel, and each row's decoded
    messages must be what was sent on it, none on the noise rows."""
    rows = write_pocsag_rows(tmp)
    top, sink = CompositeBlock(), _Collect()
    top.connect(BankSource([IQFileSource(p, "f32le", RATE) for p in rows]),
                TunerBlock(0, 12e3, round(RATE / 12.5e3)),
                POCSAGReceiver(1200), sink)
    t0 = time.monotonic()
    Runner(top, device=dev, channels=8).run()
    dt = time.monotonic() - t0
    got = [[(m.address, m.func, m.alphanumeric) for call in sink.got[c::8]
            for m in call] for c in range(8)]
    want = [[POCSAG_SENT[c]] if c in POCSAG_SENT else [] for c in range(8)]
    if len(sink.got) % 8 or got != want:
        raise AssertionError(f"bank-host: decoded {got}, sent {want}")
    log("bank-host", f"rx_pocsag graph, run(channels=8), {RATE} S/s x 1 s: "
                     f"each row's messages as sent ({sum(map(len, got))} on "
                     f"rows {sorted(POCSAG_SENT)}), none on the noise rows; "
                     f"{8 * RATE / dt / 1e6:.2f} M complex samples/s summed "
                     f"over the channels end to end")
    return 8 * RATE / dt


PIN_ROWS, PIN_CHUNK, PIN_CHUNKS = 64, 1 << 18, 6


def phase_bank_pinned(tmp, dev):
    """The wire feed's pinned staging on the card (core/ingest.py): a
    BankSource of PIN_ROWS u8 IQ files, random bytes made on the card,
    PIN_CHUNKS chunks of PIN_CHUNK samples a row and a short last one
    (the rows of unequal length, so the longer rows' items past the
    shortest's end must be zeroed), through MultiplyConstantBlock(1.0)
    with run(channels=PIN_ROWS).  The pump's first read waits until the
    read-ahead has read 4 chunks.  Every chunk handed to the copy must be
    a pinned host block, ``Feed.pinned_chunks`` and
    ``BankSource.wire_reads`` must count each, and the rows must equal
    the same graph's with the bank on the host route bit for bit.
    Returns the wire run's record."""
    gen = torch.Generator(device=dev).manual_seed(26)
    paths = []
    for r in range(PIN_ROWS):
        n = PIN_CHUNKS * PIN_CHUNK + 777 + 5 * r
        paths.append(os.path.join(tmp, f"row{r}.u8"))
        torch.randint(0, 256, (2 * n,), generator=gen, device=dev,
                      dtype=torch.uint8).cpu().numpy().tofile(paths[-1])
    n_min = PIN_CHUNKS * PIN_CHUNK + 777

    def run(wire):
        top, sink = CompositeBlock(), _Collect()
        bank = BankSource([IQFileSource(p, "u8", 1e6) for p in paths])
        if not wire:
            bank.device_ingest = lambda: None
        top.connect(bank, lr.MultiplyConstantBlock(1.0), sink)
        runner = Runner(top, chunk_size=PIN_CHUNK, device=dev,
                        channels=PIN_ROWS)
        (feed,) = runner.feeds
        if (feed.route, feed.pinned, feed.want) != (
                ("wire", True, PIN_CHUNK) if wire
                else ("host", False, PIN_CHUNK)):
            raise AssertionError(f"bank-pinned: feed {feed.route}, pinned "
                                 f"{feed.pinned}, want {feed.want}")
        staged, put_ms, tail = [], [], []
        put = runner._prefetch_put

        def spy(values):
            v = values[feed.keys[0]]
            staged.append(isinstance(v, torch.Tensor) and v.is_pinned())
            if len(staged) == PIN_CHUNKS + 1:   # the short chunk's tail
                tail.append(int(np.count_nonzero(
                    np.asarray(v)[..., 2 * (n_min % PIN_CHUNK):])))
            t0 = time.perf_counter()
            out = put(values)
            put_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        runner._prefetch_put = spy
        get, ahead = runtime_mod._Prefetcher.get, []

        def full_get(self):
            if not ahead:
                deadline = time.monotonic() + 60
                while len(staged) < 4 and self._thread.is_alive():
                    if time.monotonic() > deadline:
                        raise AssertionError(
                            f"bank-pinned: the read-ahead read "
                            f"{len(staged)} chunks in 60 s")
                    time.sleep(0.005)
                ahead.append(len(staged))
            return get(self)

        pinned0, reads0 = Feed.pinned_chunks, BankSource.wire_reads
        runtime_mod._Prefetcher.get = full_get
        try:
            t0 = time.monotonic()
            runner.run()
            dt = time.monotonic() - t0
        finally:
            runtime_mod._Prefetcher.get = get
        return (_rows(sink), staged, put_ms, ahead[0], dt, tail,
                Feed.pinned_chunks - pinned0, BankSource.wire_reads - reads0)

    run(True)       # warm-up: cuDNN, the allocators' first blocks
    rows, staged, put_ms, ahead, dt, tail, pinned, reads = run(True)
    host, hstaged, _, _, hdt, _, hpinned, hreads = run(False)
    chunks = PIN_CHUNKS + 1
    if len(staged) != chunks or not all(staged) or ahead < 4 \
            or pinned != chunks or reads != chunks or tail != [0]:
        raise AssertionError(f"bank-pinned: {len(staged)} chunks staged, "
                             f"{sum(staged)} pinned, {ahead} read ahead, "
                             f"{tail} nonzero items past the short chunk; "
                             f"Feed.pinned_chunks {pinned}, "
                             f"BankSource.wire_reads {reads} (want "
                             f"{chunks})")
    if any(hstaged) or hpinned or hreads:
        raise AssertionError(f"bank-pinned: the host route staged "
                             f"{sum(hstaged)} pinned, {hpinned} counted, "
                             f"{hreads} wire reads")
    equal = host.shape == rows.shape and np.array_equal(
        rows.view(np.uint8), host.view(np.uint8))
    if rows.shape != (PIN_ROWS, n_min) or not equal:
        raise AssertionError(f"bank-pinned: wire rows {rows.shape}, host "
                             f"rows {host.shape}, bit-equal {equal}")
    rec = {"chunks": chunks, "read_ahead": ahead,
           "put_ms_median": statistics.median(put_ms),
           "msps": PIN_ROWS * n_min / dt / 1e6,
           "host_msps": PIN_ROWS * n_min / hdt / 1e6}
    log("bank-pinned", f"{PIN_ROWS} u8 rows x {n_min} samples, {chunks} "
                       f"chunks of [{PIN_ROWS}, {2 * PIN_CHUNK}] u8: "
                       f"{ahead} read ahead before the pump's first read, "
                       f"each staged pinned (Feed.pinned_chunks {pinned}, "
                       f"BankSource.wire_reads {reads}); rows equal to the "
                       f"host route's bit for bit; copy enqueue "
                       f"{rec['put_ms_median']:.3f} ms a chunk (median); "
                       f"{rec['msps']:.1f} MS/s wire, {rec['host_msps']:.1f} "
                       f"host route, end to end")
    return rec


# -- this slice: the rest of the signal blocks, file I/O, eager mode -------

def block_rows(tmp):
    """The rows of the reference block benchmark from
    benchmarks/bench_blocks.py (its fixtures written to ``tmp``), each
    (name, the reference's rate on an i5-4570T in M samples/s or None,
    build() -> (top, block under test), optimize); the rows of
    ``OPTIMIZE_OFF`` (the two IIR rows and the five back-to-back FFT
    FIRs, which the optimizer folds) also run with optimize=False."""
    rows = []
    for name, base, build in pblocks.benchmarks(tmp, BLOCK_FILE):
        rows.append((name, base, build, True))
        if name in pblocks.OPTIMIZE_OFF:
            rows.append((name + ", optimize off", base, build, False))
    return rows, pblocks.file_paths(tmp)


def hold_graph(make, inputs, types_, device, chunk, optimize=True,
               max_chunks=None, source=None):
    """``make()`` fed by host arrays (or ``source()``), each output into a
    host collector, run through the Runner on ``device``; the outputs."""
    blk, top = make(), CompositeBlock()
    srcs = ([source()] if source else
            [_ArraySource(x, 1e6, t) for x, t in zip(inputs, types_)])
    for src, port in zip(srcs, blk.inputs):
        top.connect(src, "out", blk, port.name)
    sinks = []
    for port in blk.outputs:
        sinks.append(_Collect())
        top.connect(blk, port.name, sinks[-1], "in")
    Runner(top, chunk_size=chunk, optimize=optimize, device=device).run(
        max_chunks=max_chunks)
    return [np.concatenate(s.got) for s in sinks]


def hold_inputs(kind, n, rng):
    """Host inputs of the holds: (arrays, their types)."""
    c = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    if kind == "complex":
        return [c], [ComplexFloat32]
    if kind == "real":
        return [c.real.copy()], [lr.Float32]
    if kind == "bits":
        return [rng.integers(0, 2, n).astype(np.uint8)], [lr.Bit]
    if kind == "tone":      # the modulator's audio: a 1 kHz tone in noise
        t = np.arange(n) / 1e6
        return [(0.5 * np.cos(2 * np.pi * 1e3 * t) + 0.01 * c.real).astype(
            np.float32)], [lr.Float32]
    if kind == "bursts":    # the squelch: 0.01 and 1.0 in turns of 40 000
        return [(c * np.where((np.arange(n) // 40000) % 2, 1.0, 0.01))
                .astype(np.complex64)], [ComplexFloat32]
    if kind == "complex2":
        d = np.roll(c, 12345)
        return [c, d], [ComplexFloat32, ComplexFloat32]
    raise ValueError(kind)


def phase_blocks(tmp, dev, smi, ns_step):
    """Every row of the reference block benchmark on the card (block_rows),
    its launch counts zeroed before each row and read after: the noise-fed
    PLL row must launch K3 (sequential tier: the coherence gate keeps the
    scan off noise, as the JAX package's scan rejects it, bench_blocks.py
    :211-213) and the acquiring row the overlap scan.  Then each block new
    in this slice is held against the same graph with device="cpu" over
    its first HOLD_CHUNKS chunks, fed the same host arrays, at the
    tolerance of its CPU test (exact for the bit-driven and plumbing
    blocks and the file sources).  The first K3 launch and the first
    overlap scan of each PLL row are recorded on the row's own inputs
    (its 2^22-sample chunks, at the scan's plan for them) and held
    against their twins; K3 is timed alone on the noise-fed row's
    (``ns_step``: the chain probe's time a step)."""
    from scipy.signal import cheby1
    rows, paths = block_rows(tmp)
    out = []
    paths_launch = {}
    pll_calls = []
    for name, base, build, optimize in rows:
        chunk = pblocks.CHUNK_OVERRIDES.get(name.removesuffix(
            ", optimize off"), BLOCK_CHUNK)
        k3_calls, scan_calls, restores = [], [], []
        if name.startswith("PLL"):
            restores = [_record(pll, "_launch", k3_calls, keep=1),
                        _record(pll_overlap, "_run", scan_calls, keep=1)]
        try:
            pll.pll_phase.launches = 0
            pll_overlap.pll_overlap_discard.launches = 0
            sps, chunks, typ = pblocks.bench_one(build, chunk, dev, ROW_S,
                                                 optimize)
            launches = {"K3": pll.pll_phase.launches,
                        "scan": pll_overlap.pll_overlap_discard.launches}
        finally:
            for r in restores:
                r()
        pll_calls.append((name, k3_calls, scan_calls))
        row = {"name": name, "msps": sps / 1e6, "baseline_i5_msps": base,
               "chunk": chunk, "chunks": chunks, "dtype": typ,
               "optimize": optimize}
        row.update({k: v for k, v in launches.items() if v})
        out.append(row)
        vs = f", {sps / 1e6 / base:.1f}x the i5-4570T's {base} M" \
            if base else ""
        log("blocks", f"{name}: {sps / 1e6:.1f} M {typ} samples/s "
                      f"({chunks} chunks of {chunk}{vs}); launches "
                      f"{launches}")
        if name == "PLL":
            paths_launch["k3"] = launches["K3"]
            if launches["K3"] == 0:
                raise AssertionError("blocks: the noise-fed PLL row did "
                                     "not launch K3")
        if name.startswith("PLL (acquiring"):
            paths_launch["scan"] = launches["scan"]
            if launches["scan"] == 0:
                raise AssertionError("blocks: the acquiring PLL row did "
                                     "not launch the overlap scan")
    log("blocks", json.dumps({"device": smi, "rows": out}))

    rng = np.random.default_rng(99)
    taps = np.random.default_rng(5).standard_normal(128)
    iir = (lambda: lr.IIRFilterBlock([0.2] * 5, [1.0, 0.1, 0.05]))
    holds = [
        ("IIR 5 ff 3 fb, complex, optimize on", iir, "complex", 2e-5, True),
        ("IIR 5 ff 3 fb, complex, optimize off", iir, "complex", 2e-5,
         False),
        ("IIR 5 ff 3 fb, real, optimize off", iir, "real", 2e-5, False),
        ("IIR 4th-order Chebyshev I, real, optimize off",
         lambda: lr.IIRFilterBlock(*cheby1(4, 1.0, 0.3)), "real", 2e-5,
         False),
        ("FIR FFT 128 real taps, complex input", lambda: lr.FIRFilterBlock(
            taps.astype(np.float32), use_fft=True), "complex", 1e-3, True),
        ("FIR FFT 128 real taps, real input", lambda: lr.FIRFilterBlock(
            taps.astype(np.float32), use_fft=True), "real", 1e-3, True),
        ("FIR FFT 128 complex taps, complex input",
         lambda: lr.FIRFilterBlock((taps + 1j * taps[::-1]).astype(
             np.complex64), use_fft=True), "complex", 1e-3, True),
        ("FrequencyModulator", lambda: lr.FrequencyModulatorBlock(0.05),
         "tone", 2e-5, True, 8192),
        ("PulseAmplitudeModulator (4 levels)",
         lambda: lr.PulseAmplitudeModulatorBlock(1e3, 8e3, 4), "bits", 0,
         True),
        ("QuadratureAmplitudeModulator (16 points)",
         lambda: lr.QuadratureAmplitudeModulatorBlock(1e3, 8e3, 16), "bits",
         0, True),
        ("PowerSquelch", lambda: lr.PowerSquelchBlock(-20.0), "bursts", 1e-6,
         True),
        ("Interleave (2)", lambda: lr.InterleaveBlock(2), "complex2", 0,
         True),
        ("Deinterleave (2)", lambda: lr.DeinterleaveBlock(2), "complex", 0,
         True),
        ("Nop", lr.NopBlock, "complex", 0, True),
    ]
    held = []
    for name, make, kind, tol, optimize, *chunk in holds:
        chunk = chunk[0] if chunk else HOLD_CHUNK
        xs, ts = hold_inputs(kind, chunk * HOLD_CHUNKS, rng)
        got = hold_graph(make, xs, ts, dev, chunk, optimize)
        exp = hold_graph(make, xs, ts, torch.device("cpu"), chunk, optimize)
        held.append((name, hold_outputs(name, got, exp, tol), tol))
    for name, src in (
            ("Real File Source (f32le)", lambda: lr.RealFileSource(
                paths["f32"], "f32le", 1e6, repeat_on_eof=True,
                resident=False)),
            ("Raw File Source (float)", lambda: lr.RawFileSource(
                paths["f32"], lr.Float32, 1e6, repeat_on_eof=True,
                resident=False)),
            ("Real File Source (u8, device-side conversion)",
             lambda: lr.RealFileSource(paths["u8"], "u8", 1e6,
                                       repeat_on_eof=True, resident=False)),
            ("Raw File Source (complex, resident ring)",
             lambda: lr.RawFileSource(paths["iq"], ComplexFloat32, 1e6,
                                      repeat_on_eof=True))):
        got = hold_graph(lr.NopBlock, [], [], dev, 1 << 20,
                         max_chunks=HOLD_CHUNKS, source=src)
        exp = hold_graph(lr.NopBlock, [], [], torch.device("cpu"), 1 << 20,
                         max_chunks=HOLD_CHUNKS, source=src)
        held.append((name, hold_outputs(name, got, exp, 0), 0))
    for name, err, tol in held:
        log("blocks", f"{name}: card vs the same graph on the CPU over "
                      f"{HOLD_CHUNKS} chunks: max |diff| {err:.3g} (limit "
                      f"{tol:g} * scale)")

    blk = carrier.PLLBlock(1e3, 200e3, 220e3)
    blk.input_rate = 1e6
    blk.initialize()
    params = (blk._alpha, blk._beta, blk._freq_min, blk._freq_max)
    k3_err = scan_err = 0.0
    k3_alone = scan_alone = None
    for name, k3_calls, scan_calls in pll_calls:
        if k3_calls:
            k3_err = max(k3_err, hold_k3_launch(name, k3_calls[0], params))
            if name == "PLL":
                k3_alone = time_k3_alone(k3_calls[0], params, ns_step)
        if scan_calls:
            scan_err = max(scan_err, hold_scan_launch(name, scan_calls[0]))
            scan_alone = time_scan_alone(name, scan_calls[0])
    return {"rows": out, "k3_launches": paths_launch["k3"],
            "scan_launches": paths_launch["scan"], "k3_err": k3_err,
            "scan_err": scan_err, "k3_alone": k3_alone,
            "scan_alone": scan_alone}


def time_k3_alone(call, params, ns_step):
    """K3 alone on the noise-fed PLL row's first 2^22-sample chunk (its
    recorded inputs, multiplier 1): CUDA events around each launch,
    median of 5 after 3 warm-ups, beside its byte bound and the chain
    floor of phase 8's probe."""
    (_, x, state, _), _ = call
    n = x.shape[0]
    ms = median_ms(lambda: pll.pll_phase(x, state, *params, 1.0), reps=5)
    t_bytes = n * PLL_BYTES / HBM_BYTES_PER_S
    t_ops = n * PLL_OPS / FP32_FLOP_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    floor_ms = n * ns_step / 1e6
    log("blocks", f"PLL: K3 alone on the row's first chunk [{n} samples]: "
                  f"{ms:.3f} ms a launch (CUDA events, median of 5), "
                  f"{n / ms / 1e3:.2f} M samples/s; bound {bound_ms:.4f} ms "
                  f"({'bytes' if t_bytes >= t_ops else 'operations'}); chain "
                  f"floor {floor_ms:.2f} ms: {ms / floor_ms:.3f}x it")
    return {"samples": n, "ms": ms, "bound_ms": bound_ms,
            "chain_floor_ms": floor_ms, "floor_ratio": ms / floor_ms}


def time_scan_alone(row, call):
    """The overlap scan's launch alone (pll_overlap._scan_kernel, without
    the torch set-up and chaining) on a PLL row's first recorded 2^22
    chunk, at the row's plan and constants: a launch (CUDA events, median
    of 5) and device time (CUDA-graph replay), the device time a serial
    step beside the chain probe run at the row's constants."""
    (_, x, state, alpha, beta, fmin, fmax, mult, lseg, warm, *_), _ = call
    n = x.shape[0]
    s, steps = n // lseg, warm + lseg
    xb = x[None]
    init = pll_overlap._initial_states(xb, state, s, lseg, warm)
    consts = tuple(float(np.float32(v))
                   for v in (alpha, beta, fmin, fmax, mult))
    launch_ms = median_ms(lambda: pll_overlap._scan_kernel(
        xb, init, consts, lseg, warm), reps=5)
    dev_ms = graph_ms(lambda: pll_overlap._scan_kernel(
        xb, init, consts, lseg, warm), 5, 3)
    pll_overlap.chain_probe(64, x.device, alpha, beta, fmin, fmax)
    probe_steps = 1 << 14
    probe_ms, _ = pll_overlap.chain_probe(probe_steps, x.device, alpha,
                                          beta, fmin, fmax)
    probe_ns = probe_ms * 1e6 / probe_steps
    ns = dev_ms * 1e6 / steps
    log("blocks", f"{row}: the scan's launch alone on the row's first chunk "
                  f"[{n} samples, {s} segments of {lseg} after {warm} "
                  f"warm-up steps]: {launch_ms:.3f} ms a launch, "
                  f"{dev_ms:.4f} ms device, {ns:.1f} ns a step; chain probe "
                  f"{probe_ns:.1f} ns a step: {ns / probe_ns:.3f}x it")
    return {"samples": n, "segments": s, "lseg": lseg, "warm": warm,
            "launch_ms": launch_ms, "graph_ms": dev_ms, "ns_per_step": ns,
            "chain_floor_ns_per_step": probe_ns,
            "floor_ratio": ns / probe_ns}


def hold_k3_launch(row, call, params):
    """A PLL row's first K3 launch, recorded (pll._launch(lib, x, state,
    k) and its outputs), against pll_phase_reference on the same x and
    state at the row's constants: out, err, phases and frequency within
    1e-5 (0 expected, as compare_pll).  Returns the largest error."""
    (_, x, state, k), got = call
    if pll.constants(*params, 1.0) != k or x.dim() != 1:
        raise AssertionError(f"blocks {row}: K3 launched on {tuple(x.shape)} "
                             f"with constants {k}, not the row's")
    t0 = time.monotonic()
    exp = pll.pll_phase_reference(x, state, *params, 1.0)
    torch.cuda.synchronize()
    plain_s = time.monotonic() - t0
    errs = pll_diff(f"{row} launch 0", got, exp)
    if max(errs) > 1e-5:
        raise AssertionError(f"blocks {row}: K3's first launch vs its twin "
                             f"(out, err, phases, freq) {errs} > 1e-5")
    log("blocks", f"{row}: K3's first launch [{x.shape[0]} samples] against "
                  f"pll_phase_reference on its inputs: max |kernel - twin| "
                  f"(out, err, phases, freq) {max(errs):.3g} (limit 1e-5); "
                  f"twin {plain_s:.1f} s")
    return max(errs)


def hold_scan_launch(row, call):
    """A PLL row's first overlap scan, recorded where pll_overlap_discard
    runs it (pll_overlap._run(scan, x, state, alpha, beta, fmin, fmax,
    mult, lseg, warm, tol_phase, tol_freq) and its outputs), against
    pll_overlap_discard_reference on the same inputs and plan: valid
    equal, out, err and state within 1e-6 (0 expected, as hold_overlap).
    Returns the largest error."""
    (scan, x, state, *rest), got = call
    if scan is not pll_overlap._scan_kernel or x.dim() != 1:
        raise AssertionError(f"blocks {row}: the recorded scan ran "
                             f"{scan.__name__} on {tuple(x.shape)}")
    lseg, warm = rest[5], rest[6]
    t0 = time.monotonic()
    exp = pll_overlap.pll_overlap_discard_reference(x, state, *rest)
    torch.cuda.synchronize()
    plain_s = time.monotonic() - t0
    errs = [(got[2] - exp[2]).abs().max().item(),
            (got[3] - exp[3]).abs().max().item(),
            max(abs(float(a) - float(b)) for a, b in zip(got[1], exp[1]))]
    if bool(got[0]) != bool(exp[0]) or max(errs) > 1e-6:
        raise AssertionError(f"blocks {row}: the scan's first launch: valid "
                             f"{bool(got[0])} vs {bool(exp[0])}, |kernel - "
                             f"twin| (out, err, state) {errs} > 1e-6")
    log("blocks", f"{row}: the overlap scan's first launch [{x.shape[0]} "
                  f"samples, {x.shape[0] // lseg} segments of {lseg} after "
                  f"{warm} warm-up steps] against "
                  f"pll_overlap_discard_reference on its inputs: valid "
                  f"{bool(got[0])} (twin {bool(exp[0])}); max |kernel - "
                  f"twin| (out, err, state) {max(errs):.3g} (limit 1e-6); "
                  f"twin {plain_s:.1f} s")
    return max(errs)


def hold_outputs(name, got, exp, tol):
    """Card against CPU outputs: equal when ``tol`` is 0, else within
    tol * max(1, max |CPU|).  Returns the largest difference."""
    err = 0.0
    for g, e in zip(got, exp):
        if g.shape != e.shape or g.dtype != e.dtype:
            raise AssertionError(f"blocks {name}: card {g.shape} {g.dtype} "
                                 f"vs CPU {e.shape} {e.dtype}")
        if not np.isfinite(g.astype(np.complex128)).all():
            raise AssertionError(f"blocks {name}: non-finite output")
        d = float(np.max(np.abs(g.astype(np.complex128) - e))) if g.size \
            else 0.0
        scale = max(1.0, float(np.max(np.abs(e)))) if e.size else 1.0
        if (tol == 0 and d != 0) or d > tol * scale:
            raise AssertionError(f"blocks {name}: |card - CPU| {d} > "
                                 f"{tol} * {scale}")
        err = max(err, d)
    return err


def phase_fir_fft(dev, gen, smi):
    """fir_fft (overlap-save on cuFFT) and fir_direct (cuDNN conv1d, TF32
    off) for a 129-tap real FIR on [64, 65 536] and [1, 2^22], each timed
    with CUDA events (median of REPS launches), the two outputs held
    within 1e-3 * scale of each other: data for the choice of FIR path,
    not a default."""
    from luaradio_tpu_torch.ops import fir as fir_ops
    from luaradio_tpu_torch.utils.filter_design import firwin_lowpass
    taps = firwin_lowpass(129, 0.2).astype(np.float32)
    h = torch.from_numpy(taps).to(dev)
    lf = fir_ops.fft_frame_length(len(taps))
    h_freq = torch.from_numpy(fir_ops.fir_fft_freq_taps(taps, lf, True)).to(
        dev)
    out = {}
    for rows, n in ((64, 65536), (1, 1 << 22)):
        x = torch.randn((rows, n), generator=gen, device=dev)
        tail_d = torch.zeros((rows, len(taps) - 1), device=dev)
        tail_f = torch.zeros((rows, lf), device=dev)
        yd, _ = fir_ops.fir_direct(x, h, tail_d)
        yf, _ = fir_ops.fir_fft(x, h_freq, tail_f, True)
        scale = max(1.0, yd.abs().max().item())
        err = (yd - yf).abs().max().item()
        if err > 1e-3 * scale:
            raise AssertionError(f"fir-fft [{rows}, {n}]: |fft - direct| "
                                 f"{err} > 1e-3 * {scale}")
        fft_ms = median_ms(lambda: fir_ops.fir_fft(x, h_freq, tail_f, True))
        direct_ms = median_ms(lambda: fir_ops.fir_direct(x, h, tail_d))
        out[f"{rows}x{n}"] = {"fir_fft_ms": fft_ms,
                              "fir_direct_ms": direct_ms, "max_abs_err": err}
        log("fir-fft", f"129-tap real FIR on [{rows}, {n}] ({smi}): fir_fft "
                       f"{fft_ms:.4f} ms, fir_direct (cuDNN) "
                       f"{direct_ms:.4f} ms a launch (median of {REPS}); "
                       f"|fft - direct| {err:.3g} (limit 1e-3 * "
                       f"{scale:.3g})")
    return out


def wav_tone(path, rate, seconds, tone):
    t = np.arange(int(rate * seconds)) / rate
    pcm = np.round(0.5 * np.sin(2 * np.pi * tone * t) * 32767.5).astype(
        np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
    return len(pcm)


def phase_roundtrip(tmp, dev):
    """The FM self test (luaradio_tpu_torch.examples.fm_roundtrip_selftest)
    on the card: the tone within 50 Hz; its demodulator again under the K2
    rule, where K2 must launch, match its twin on the path's first chunk
    and give the default audio within 2e-5 * scale.  The SSB round trip of
    BASELINE.json's third configuration: a WAV with a 1.2 kHz tone ->
    examples.wavfile_ssb_modulator (usb, then lsb) -> IQ file -> rx_ssb
    ... usb through the CLI: the usb capture passes the tone, the lsb one
    keeps less than 1/20 of its power.  Then real, raw, WAV and JSON
    files through the new sources and sinks, equal to what was
    written."""
    from luaradio_tpu_torch.examples import fm_roundtrip_selftest as fm
    from luaradio_tpu_torch.examples import wavfile_ssb_modulator as ssb
    t0 = time.monotonic()
    peak, audio, sr = fm.run(tmp)
    if abs(peak - fm.TONE_HZ) > fm.LIMIT_HZ:
        raise AssertionError(f"roundtrip FM: peak at {peak} Hz")
    log("roundtrip", f"FM self test: {len(audio)} audio samples at {sr} Hz, "
                     f"peak {peak:.1f} Hz (want {fm.TONE_HZ:.0f} within "
                     f"{fm.LIMIT_HZ:.0f}), {time.monotonic() - t0:.2f} s")
    capture = os.path.join(tmp, "capture.iq")

    def demodulate():
        sink, top = _Collect(), CompositeBlock()
        top.connect(IQFileSource(capture, "f32le", fm.RATE),
                    *fm.mono_chain(), sink)
        top.run()
        return np.concatenate(sink.got)
    default = demodulate()
    calls = []
    os.environ["LUARADIO_TPU_FORCE_WBFM_KERNEL"] = "1"
    restore = _record(wbfm, "_launch_k2", calls)
    try:
        wbfm.disc_fir.launches = 0
        k2_audio = demodulate()
        launches = wbfm.disc_fir.launches
    finally:
        restore()
        del os.environ["LUARADIO_TPU_FORCE_WBFM_KERNEL"]
    scale = max(1.0, float(np.abs(default).max()))
    diff = float(np.abs(k2_audio - default).max()) \
        if k2_audio.shape == default.shape else np.inf
    if launches == 0 or diff > 2e-5 * scale:
        raise AssertionError(f"roundtrip K2: {launches} launches, audio off "
                             f"the default by {diff}")
    (carry, x, taps, d, inv_gain, _), _ = calls[0]
    err = compare("disc_fir", lambda c, xx, h: wbfm.disc_fir(
        c, xx, h, d, inv_gain), lambda c, xx, h: wbfm.disc_fir_reference(
        c, xx, h, d, inv_gain), [("FM round trip chunk 0", x, carry)], taps)
    log("roundtrip", f"FM demodulator under the K2 rule: {launches} K2 "
                     f"launches ({tuple(x.shape)}, K {taps.shape[0]}, D "
                     f"{d}); audio within {diff:.3g} of the default run's "
                     f"(limit 2e-5 * {scale:.3g})")

    wav = os.path.join(tmp, "tone.wav")
    n = wav_tone(wav, 44100, ANALOG_S, SSB_TONE)
    power = {}
    for sb in ("usb", "lsb"):
        iq, out = (os.path.join(tmp, f"ssb_{sb}.{e}") for e in ("iq", "wav"))
        if ssb.main([wav, iq, "3000", sb]) != 0:
            raise AssertionError(f"wavfile_ssb_modulator {sb} failed")
        rc, dt = run_cli(["-a", "rx_ssb", "-i", f"iqfile:{iq},rate=44100",
                          "-o", f"wavfile:{out}", "0", "usb"], dev)
        pcm, _ = read_wav(out)
        if rc != 0:
            raise AssertionError(f"roundtrip rx_ssb ({sb} capture): rc {rc}")
        power[sb] = float(np.mean(pcm[len(pcm) // 2:, 0].astype(
            np.float64) ** 2))
    f, m, _ = hold_audio("roundtrip SSB usb", os.path.join(
        tmp, "ssb_usb.wav"), n, 44100, SSB_TONE)
    if power["lsb"] * 20 >= power["usb"]:
        raise AssertionError(f"roundtrip SSB: the lsb capture keeps "
                             f"{power['lsb']:.3g} of {power['usb']:.3g}")
    log("roundtrip", f"SSB: WAV {SSB_TONE:.0f} Hz tone -> "
                     f"wavfile_ssb_modulator -> rx_ssb usb: tone at "
                     f"{f:.1f} Hz, margin {m:.3g}; the lsb capture keeps "
                     f"1/{power['usb'] / power['lsb']:.0f} of its power "
                     f"(limit 1/20)")

    # real, raw, WAV and JSON files through the new sources and sinks
    def run(*blocks, **kw):
        top = CompositeBlock()
        top.connect(*blocks)
        top.run(**kw)
    p = {k: os.path.join(tmp, f"rt.{k}") for k in
         ("a.f32", "b.f32", "a.raw", "b.raw", "a.wav", "a.json", "b.json")}
    run(lr.SignalSource("cosine", 1e3, 48e3), lr.RealFileSink(p["a.f32"],
                                                              "f32le"),
        max_chunks=3, chunk_size=1 << 16)
    run(lr.RealFileSource(p["a.f32"], "f32le", 48e3), lr.NopBlock(),
        lr.RealFileSink(p["b.f32"], "f32le"), chunk_size=50000)
    run(lr.SignalSource("exponential", 1e3, 48e3),
        lr.RawFileSink(p["a.raw"]), max_chunks=3, chunk_size=1 << 16)
    run(lr.RawFileSource(p["a.raw"], ComplexFloat32, 48e3), lr.NopBlock(),
        lr.RawFileSink(p["b.raw"]), chunk_size=50000)
    run(lr.SignalSource("cosine", 440.0, 44100.0, amplitude=0.5),
        WAVFileSink(p["a.wav"], 1), max_chunks=2, chunk_size=44100)
    sink = _Collect()
    run(lr.WAVFileSource(p["a.wav"], 1), lr.NopBlock(), sink,
        chunk_size=30000)
    pcm, _ = read_wav(p["a.wav"])
    objs = [{"i": i, "text": "x" * (i % 5)} for i in range(100)]
    with open(p["a.json"], "w") as fh:
        fh.write("".join(json.dumps(o) + "\n" for o in objs))
    run(lr.JSONSource(p["a.json"], 1e3), lr.JSONSink(p["b.json"]),
        chunk_size=7)
    same = {
        "real": open(p["a.f32"], "rb").read() == open(p["b.f32"],
                                                      "rb").read(),
        "raw": open(p["a.raw"], "rb").read() == open(p["b.raw"],
                                                     "rb").read(),
        "wav": np.array_equal(np.concatenate(sink.got),
                              (pcm[:, 0] / np.float32(32767.5)).astype(
                                  np.float32)),
        "json": read_json_lines(p["b.json"]) == objs}
    sizes = (os.path.getsize(p["a.f32"]), os.path.getsize(p["a.raw"]))
    if not all(same.values()) or sizes != (3 * 4 << 16, 3 * 8 << 16):
        raise AssertionError(f"roundtrip files: equal {same}, sizes {sizes}")
    log("roundtrip", f"real (f32le), raw (complex), WAV (16 bit) and JSON "
                     f"files through the new sources and sinks: equal to "
                     f"what was written {same}")
    return {"launches": launches, "max_abs_err": err, "audio_err": diff}


def phase_eager(tmp, dev):
    """The README mono graph in eager mode must write the fused run's WAV
    byte for byte; Runner(trace=True) must record the four span names."""
    paths, n = write_capture(tmp)
    wavs = {m: os.path.join(tmp, f"{m}.wav") for m in ("fused", "eager")}
    dt = {}
    for mode in ("fused", "eager"):
        t0 = time.monotonic()
        readme_graph(paths["f32le"], "f32le", wavs[mode]).run(mode)
        dt[mode] = time.monotonic() - t0
    same = open(wavs["fused"], "rb").read() == open(wavs["eager"],
                                                    "rb").read()
    runner = Runner(readme_graph(paths["f32le"], "f32le",
                                 os.path.join(tmp, "t.wav")), trace=True,
                    device=dev)
    runner.run()
    rep = runner.tracer.report()
    names = sorted(rep)
    want = ("sources.read", "sources.wait", "segment[", "host[")
    missing = [w for w in want if not any(k.startswith(w) for k in names)]
    if not same or missing:
        raise AssertionError(f"eager: WAV equal {same}; spans {names}, "
                             f"missing {missing}")
    spans = {k: f"{v['count']} x {v['mean_s'] * 1e3:.3f} ms"
             for k, v in rep.items()}
    log("eager", f"README graph, eager mode: WAV equal to the fused run's "
                 f"byte for byte; fused {n / dt['fused'] / 1e6:.2f}, eager "
                 f"{n / dt['eager'] / 1e6:.2f} M complex samples/s end to "
                 f"end; trace spans (count x mean, host clock) {spans}")
    return {"spans": names}


def phase_newton(dev):
    """pll_newton_scan with K3 as its sequential fallback on a phase-step
    input (a tone at the bench PLL's 210 kHz with a 0.8 rad step every
    eight segments and noise over three segments): some segments converge
    and some fall back, K3 must launch, and the result must equal the
    same call with K3's twin in K3's place within 1e-5."""
    from luaradio_tpu_torch.ops.pll_linear import pll_newton_scan
    blk = carrier.PLLBlock(1e3, 200e3, 220e3)
    blk.input_rate = 1e6
    blk.initialize()
    params = (blk._alpha, blk._beta, blk._freq_min, blk._freq_max)
    x = newton_input()
    xd = torch.from_numpy(x).to(dev)
    state = (0.0, 0.0, float(blk._freq_min + blk._freq_max) / 2)

    def sequential(fn):
        def run(st, xs):
            s = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                             device=dev).reshape(())
                             for v in st])
            out, err, s2 = fn(xs.contiguous(), s, *params, 1)
            return tuple(s2.unbind(-1)), (out, err)
        return run
    pll.pll_phase.launches = 0
    before = list(pll_newton_scan.segments)
    t0 = time.monotonic()
    got = pll_newton_scan(xd, state, *params, 1, sequential(pll.pll_phase))
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = pll.pll_phase.launches
    segs = [a - b for a, b in zip(pll_newton_scan.segments, before)]
    exp = pll_newton_scan(xd, state, *params, 1,
                          sequential(pll.pll_phase_reference))
    torch.cuda.synchronize()
    errs = [(got[1][0] - exp[1][0]).abs().max().item(),
            wrap_err(got[1][1], exp[1][1], 2 * np.pi),
            max(abs(float(a) - float(b)) for a, b in zip(got[0], exp[0]))]
    if launches == 0 or segs[0] == 0 or segs[1] == 0 or max(errs) > 1e-5:
        raise AssertionError(f"newton: K3 launches {launches}, segments "
                             f"(newton, fallback) {segs}, |K3 - twin| "
                             f"(out, err, state) {errs} > 1e-5")
    log("newton", f"pll_newton_scan on {len(x)} samples: segments solved by "
                  f"Newton / fallen back {segs[0]} / {segs[1]}, K3 "
                  f"launches {launches}, |K3 - twin| (out, err, state) "
                  f"{errs[0]:.3g} / {errs[1]:.3g} / {errs[2]:.3g} (limit "
                  f"1e-5); {dt * 1e3:.1f} ms (host clock, one host read a "
                  f"segment)")
    return {"launches": launches, "max_abs_err": max(errs),
            "segments": segs}


def newton_input(n=NEWTON_N, seg=1024):
    """The newton phase's input: a tone at 0.21 cycles a sample with a
    0.8 rad phase step every 8 segments, 300 samples into the segment,
    and noise over segments 5, 21 and 40."""
    rng = np.random.default_rng(33)
    t = np.arange(n)
    x = np.exp(1j * (2 * np.pi * 0.21 * t
                     + 0.8 * ((t + 8 * seg - 300) // (8 * seg))))
    for s in (5, 21, 40):
        x[s * seg:(s + 1) * seg] = (rng.standard_normal(seg)
                                    + 1j * rng.standard_normal(seg))
    return x.astype(np.complex64)


# -- the port's outside world: SDR wire, live examples, network,
# -- plot and transmit sinks -------------------------------------------------

#: every SDR driver with a wire ring: (class, constructor arguments before
#: frequency and rate)
WIRE_DRIVERS = {
    "rtlsdr": (lr.RtlSdrSource, ()), "hackrf": (lr.HackRFSource, ()),
    "airspy": (lr.AirspySource, ()), "hydrasdr": (lr.HydraSDRSource, ()),
    "bladerf": (lr.BladeRFSource, ()), "sdrplay": (lr.SDRplaySource, ()),
    "uhd": (lr.UHDSource, ("addr=x",)),
    "soapysdr": (lr.SoapySDRSource, ("driver=x",)),
}


def phase_io_wire(dev):
    """Every SDR driver's wire type over all of its codes (256 for the
    8-bit types, 65 536 for s16; each code as I and as Q): device_ingest
    on the card against read()'s host conversion of the same ring, bit
    for bit.  Returns {driver: max |card - host|} (0 everywhere)."""
    errs = {}
    for name, (cls, args) in WIRE_DRIVERS.items():
        info = np.iinfo(cls.wire_dtype)
        codes = np.arange(info.min, info.max + 1).astype(cls.wire_dtype)
        raw = np.concatenate([codes, codes[::-1]])
        src = cls(*args, 1e8, 1e6)
        src._make_ring()
        src.ring.write(raw)
        host = src.read(len(raw) // 2)
        card = src.device_ingest()(torch.from_numpy(raw).to(dev))
        err = float(np.max(np.abs(card.cpu().numpy() - host)))
        if card.dtype != torch.complex64 or err != 0.0:
            raise AssertionError(f"io-wire {name}: {card.dtype}, max |card "
                                 f"- host| {err} (limit 0)")
        errs[name] = err
    log("io-wire", f"device_ingest on the card equals read()'s host "
                   f"conversion bit for bit over every code: "
                   f"{json.dumps(errs)}")
    return errs


class FakeRtlSdr:
    """An in-process librtlsdr serving ``wire`` (u8 I/Q) from
    rtlsdr_read_sync.  Paced (``rate`` complex samples/s), a read returns
    when its last sample is due, on an absolute schedule from the first
    read, as the radio's would; unpaced, at once.  At the end of the
    capture a read fails (-1), as it does when the device is gone."""

    def __init__(self, wire, rate=None):
        self.wire, self.rate, self.pos, self.t0 = wire, rate, 0, None

    def __getattr__(self, name):
        if not name.startswith("rtlsdr_"):
            raise AttributeError(name)
        return lambda *args: 0

    def rtlsdr_open(self, devp, index):
        ctypes.cast(devp, ctypes.POINTER(ctypes.c_void_p))[0] = \
            ctypes.c_void_p(0x171)
        return 0

    def rtlsdr_read_sync(self, dev, buf, nbytes, gotp):
        if self.pos >= len(self.wire):
            return -1
        seg = self.wire[self.pos:self.pos + nbytes]
        if self.rate:
            if self.t0 is None:
                self.t0 = time.monotonic()
            due = self.t0 + (self.pos + len(seg)) / 2 / self.rate
            time.sleep(max(0.0, due - time.monotonic()))
        ctypes.memmove(buf, seg.ctypes.data, len(seg))
        ctypes.cast(gotp, ctypes.POINTER(ctypes.c_int))[0] = len(seg)
        self.pos += len(seg)
        return 0


class FakePulse:
    """An in-process libpulse-simple that keeps what is played."""

    def __init__(self):
        self.audio, self.spec = bytearray(), None

    def pa_simple_new(self, server, app, direction, dev, name, spec, *rest):
        s = ctypes.cast(spec, ctypes.POINTER(audio._pa_sample_spec)).contents
        self.spec = (s.format, s.rate, s.channels)
        return 0x5A

    def pa_simple_write(self, pa, data, n, err):
        self.audio += data[:n]
        return 0

    def pa_simple_drain(self, pa, err):
        return 0

    def pa_simple_free(self, pa):
        pass


def u8_wire(z, shift_hz=0.0):
    """Complex samples at RATE, moved up by ``shift_hz``, as the RTL-SDR's
    u8 I/Q."""
    if shift_hz:
        z = z * np.exp(2j * np.pi * shift_hz / RATE * np.arange(len(z)))
    f = z.astype(np.complex64).view(np.float32)
    return np.clip(np.round(f * 127.5 + 127.5), 0, 255).astype(np.uint8)


def _device_key(events):
    return ("self_device_time_total"
            if len(events) and hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")


def device_ms(prof) -> float:
    """The device time a torch.profiler run recorded, in ms."""
    events = prof.key_averages()
    key = _device_key(events)
    return sum(getattr(e, key) for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def run_example(module, wire, paced, dev, stdout=None):
    """The example module's graph on the card, its RtlSdrSource fed by a
    fake librtlsdr serving ``wire`` (paced at RATE or not), PulseAudio
    replaced by a fake that keeps the audio, standard output (the JSON
    sinks') sent to ``stdout``.  Paced on the card, the run is traced by
    torch.profiler (device activity only) for the card's busy share.  Returns (the
    graph's source, its runner, the fake radio, the fake audio, wall
    seconds, device ms or None)."""
    from torch.profiler import ProfilerActivity, profile
    fake, pulse = FakeRtlSdr(wire, RATE if paced else None), FakePulse()
    load_pulse = audio._load_pulse
    RtlSdrSource._injected_lib = fake
    audio._load_pulse = lambda: pulse
    top = module.build()
    src = next(b for b in top._blocks if isinstance(b, RtlSdrSource))
    traced = paced and torch.device(dev).type == "cuda"
    prof = (profile(activities=[ProfilerActivity.CUDA]) if traced
            else contextlib.nullcontext())
    try:
        with prof, contextlib.redirect_stdout(stdout or sys.stdout):
            t0 = time.monotonic()
            top.start(device=dev)
            top.wait(timeout=120)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    finally:
        RtlSdrSource._injected_lib = None
        audio._load_pulse = load_pulse
    return src, top._runner, fake, pulse, wall, (device_ms(prof) if traced
                                                 else None)


def live_captures(tmp):
    """The synthetic captures of the graph, am and rds phases: the 4 s
    mono FM capture's files and samples (write_capture), the RDS capture's
    file and groups (write_rds_capture), and as the examples' u8 wire the
    mono capture (its station already 250 kHz above the tuning), LIVE_S s
    of the AM capture moved 50 kHz up (rtlsdr_am_synchronous tunes 50 kHz
    below the station) and the 8 s RDS capture moved 250 kHz up."""
    paths, n = write_capture(tmp)
    rds_path, _, sent = write_rds_capture(tmp)
    wires = {"wbfm_mono": u8_wire(np.fromfile(paths["f32le"], np.complex64)),
             "am_synchronous": u8_wire(0.55 * am_capture(LIVE_S), 50e3),
             "rds": u8_wire(0.7 * np.fromfile(rds_path, np.complex64),
                            250e3)}
    return paths, n, rds_path, sent, wires


def phase_live(dev, wires, sent):
    """rtlsdr_wbfm_mono, rtlsdr_am_synchronous (K3 at multiplier 1) and
    rtlsdr_rds (K3 at multiplier 3) as their modules build them, on the
    card, fed by a fake librtlsdr paced at RATE (after an unpaced warm-up
    on its first 0.5 s), into a fake libpulse-simple (DISPLAY set) or the
    RDS JSON lines.  Each run: the source in the runner's wire ingest, no
    ring overflow and no dropped sample, every sample served, the wall
    time within LIVE_SLACK x the capture's length; the audio's tone
    within 50 Hz, or the RDS groups held as in the rds phase; K3's (and
    the scan's) launches counted, zeroed just before the paced run, and
    K3 launched on the two PLL paths.  Returns {example: record}."""
    from luaradio_tpu_torch.examples import (rtlsdr_am_synchronous,
                                             rtlsdr_rds, rtlsdr_wbfm_mono)
    modules = {"wbfm_mono": rtlsdr_wbfm_mono,
               "am_synchronous": rtlsdr_am_synchronous, "rds": rtlsdr_rds}
    display = os.environ.get("DISPLAY")
    os.environ["DISPLAY"] = ":0"
    out = {}
    try:
        for name, module in modules.items():
            wire = wires[name]
            secs = len(wire) / 2 / RATE
            run_example(module, wire[:RATE], False, dev,
                        io.StringIO())                           # warm-up
            pll.pll_phase.launches = 0
            pll_overlap.pll_overlap_discard.launches = 0
            text = io.StringIO()
            src, runner, fake, pulse, wall, dms = run_example(
                module, wire, True, dev, text)
            k3 = pll.pll_phase.launches
            scans = pll_overlap.pll_overlap_discard.launches
            rec = {"seconds": secs, "wall_s": wall,
                   "wall_over_capture": wall / secs,
                   "device_ms": dms, "busy": dms / 1e3 / wall if dms
                   else None, "k3_launches": k3, "scan_launches": scans,
                   "overflows": src.ring.overflows,
                   "dropped": src.ring.dropped_samples}
            route = next(f.route for f in runner.feeds if f.source is src)
            if (route != "wire" or src.ring.overflows
                    or src.ring.dropped_samples or fake.pos != len(wire)
                    or wall > LIVE_SLACK * secs
                    or (name != "wbfm_mono" and k3 < 1)):
                raise AssertionError(f"live {name}: {rec}, served "
                                     f"{fake.pos} of {len(wire)} bytes, "
                                     f"route {route}")
            if name == "rds":
                packets = [json.loads(ln) for ln in
                           text.getvalue().splitlines()]
                found, late = hold_rds_packets("live rds", packets, sent)
                rec.update(packets=len(packets), found=found, late=late)
            else:
                a = np.frombuffer(bytes(pulse.audio), np.float32)
                rate, tone = (44100, TONE) if name == "wbfm_mono" \
                    else (22050, AM_TONE)
                want = round(secs * rate)
                f, m = tone_margin(a, rate, tone, harmonics=True)
                if pulse.spec != (5, rate, 1) or len(a) != want or \
                        abs(f - tone) > 50 or m <= 10:
                    raise AssertionError(
                        f"live {name}: PulseAudio {pulse.spec}, {len(a)} "
                        f"samples (want {want}), {tone:.0f} Hz tone at "
                        f"{f:.1f} Hz, margin {m:.3g} (limits 50 Hz, 10)")
                rec.update(tone_hz=f, margin=m)
            out[name] = rec
            log("live", f"rtlsdr_{name}: {secs:.1f} s paced at {RATE} S/s "
                        f"in {wall:.3f} s ({wall / secs:.3f}x, limit "
                        f"{LIVE_SLACK}x), card busy "
                        f"{'not measured' if not dms else f'{100 * dms / 1e3 / wall:.2f} %'}"
                        f"; K3 launches {k3}, scan {scans}; "
                        f"{json.dumps({k: v for k, v in rec.items() if k not in ('seconds', 'wall_s', 'device_ms', 'busy', 'k3_launches', 'scan_launches')})}")
    finally:
        if display is None:
            del os.environ["DISPLAY"]
        else:
            os.environ["DISPLAY"] = display
    return out


def _free_tcp():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"127.0.0.1:{port}"


def _thread(fn, *args):
    """Run ``fn(*args)`` on a thread; join() returns its result or raises
    its error (after NET_TIMEOUT s at most)."""
    box = {}

    def main():
        try:
            box["out"] = fn(*args)
        except BaseException as exc:  # noqa: BLE001 — raised in join()
            box["err"] = exc
    t = threading.Thread(target=main, daemon=True)
    t.start()

    def join():
        t.join(NET_TIMEOUT)
        if t.is_alive():
            raise AssertionError(f"{fn.__name__}: still running after "
                                 f"{NET_TIMEOUT} s")
        if "err" in box:
            raise box["err"]
        return box.get("out")
    return join


def serve_once(transport, address, payload, listening):
    """A one-client server: listen, set ``listening``, accept, send
    ``payload`` (or, given None, receive until the peer closes), close."""
    srv = NetworkServer(transport, address)
    srv.listen()
    srv.listener.settimeout(NET_TIMEOUT)
    listening.set()
    try:
        srv.accept()
        srv.sock.settimeout(NET_TIMEOUT)
        if payload is not None:
            srv.sock.sendall(payload)
            return None
        data = bytearray()
        while chunk := srv.sock.recv(1 << 20):
            data += chunk
        return bytes(data)
    finally:
        srv.close()


def connect_once(transport, address, payload):
    """A client: connect (retrying until the server listens), send
    ``payload`` (or, given None, receive until the server closes),
    close."""
    cli_ = NetworkClient(transport, address)
    deadline = time.monotonic() + NET_TIMEOUT
    while not cli_.connect():
        if time.monotonic() > deadline:
            raise AssertionError(f"no server at {address}")
        time.sleep(0.01)
    try:
        cli_.sock.settimeout(NET_TIMEOUT)
        if payload is not None:
            cli_.sock.sendall(payload)
            return None
        data = bytearray()
        while chunk := cli_.sock.recv(1 << 20):
            data += chunk
        return bytes(data)
    finally:
        cli_.close()


def mono_net_graph(source, out):
    """The README receiver from ``source`` into a float32 real file."""
    top = CompositeBlock()
    top.connect(source, TunerBlock(-250e3, 200e3, 5), WBFMMonoDemodulator(),
                DownsamplerBlock(5), lr.RealFileSink(out, "f32le"))
    return top


def phase_net(tmp, dev, paths, n, rds_path, rds_packets):
    """The network I/O on loopback: (1) the README mono receiver fed by
    NetworkClientSource(reconnect=False) from a server thread sending the
    graph phase's 4 s capture unpaced, u8 and f32le, over TCP and a UNIX
    socket: every sample arrives and the audio equals the same capture
    through IQFileSource, bit for bit; (2) NetworkServerSource the same
    way, a client thread sending; (3) the CLI's rx_wbfm --mono into
    ``-o networkserver:`` with a client thread reading the f32le audio,
    equal to ``-o realfile`` bit for bit; (4) rx_rds into ``-o
    networkclient:...,format=json`` with a server thread reading, its
    packets equal to the rds phase's.  Returns the rates (host clock)."""
    ref = {}
    for fmt in ("u8", "f32le"):
        ref[fmt] = os.path.join(tmp, f"file.{fmt}.f32")
        mono_net_graph(IQFileSource(paths[fmt], fmt, RATE),
                       ref[fmt]).run(device=dev)
    rates = {}
    for kind in ("client", "server"):
        for fmt in ("u8", "f32le"):
            for transport in ("tcp", "unix"):
                address = (_free_tcp() if transport == "tcp" else
                           os.path.join(tmp, f"{kind}.{fmt}.sock"))
                with open(paths[fmt], "rb") as fh:
                    payload = fh.read()
                if kind == "client":
                    listening = threading.Event()
                    join = _thread(serve_once, transport, address, payload,
                                   listening)
                    listening.wait(NET_TIMEOUT)
                    src = lr.NetworkClientSource(
                        ComplexFloat32, RATE, transport, address,
                        format=fmt, reconnect=False)
                else:
                    join = _thread(connect_once, transport, address,
                                   payload)
                    src = lr.NetworkServerSource(
                        ComplexFloat32, RATE, transport, address,
                        format=fmt, reconnect=False)
                out = os.path.join(tmp, f"net.{kind}.{fmt}.f32")
                t0 = time.monotonic()
                mono_net_graph(src, out).run(device=dev)
                dt = time.monotonic() - t0
                join()
                got, exp = (np.fromfile(p, np.float32) for p in
                            (out, ref[fmt]))
                if got.shape != (n // 25,) or not np.array_equal(got, exp):
                    raise AssertionError(
                        f"net {kind} {fmt} {transport}: {got.shape} audio "
                        f"samples (want {n // 25}), max |net - file| "
                        f"{np.max(np.abs(got - exp)) if got.shape == exp.shape else 'n/a'}")
                rates[f"{kind}_{fmt}_{transport}"] = n / dt
                log("net", f"Network{kind.title()}Source {fmt} over "
                           f"{transport}: {n} samples in {dt:.3f} s, "
                           f"{n / dt / 1e6:.2f} M complex samples/s "
                           f"(host clock); audio equal to the IQ file's "
                           f"bit for bit")
    # (3) the CLI's networkserver output against its realfile output
    base = os.path.join(tmp, "base.f32.iq")
    z = np.fromfile(paths["f32le"], np.complex64)
    (z * np.exp(-2j * np.pi * 250e3 / RATE * np.arange(n))).astype(
        np.complex64).tofile(base)   # the station at the tuned frequency
    del z
    argv = ["-a", "rx_wbfm", "-i", f"iqfile:{base},rate={RATE}", "-o"]
    real = os.path.join(tmp, "cli.f32")
    run_cli(argv + [f"realfile:{real}", "100e6", "--mono"], dev)
    address = _free_tcp()
    join = _thread(connect_once, "tcp", address, None)
    rc, dt = run_cli(argv + [f"networkserver:{address}", "100e6", "--mono"],
                     dev)
    got = np.frombuffer(join(), np.float32)
    exp = np.fromfile(real, np.float32)
    if rc != 0 or got.shape != (n // 25,) or not np.array_equal(got, exp):
        raise AssertionError(f"net CLI networkserver: rc {rc}, {got.shape} "
                             f"audio samples (want {exp.shape})")
    rates["cli_networkserver"] = n / dt
    log("net", f"CLI rx_wbfm --mono -o networkserver:{address}: "
               f"{len(got)} f32le audio samples read by a client, equal to "
               f"-o realfile bit for bit; {n / dt / 1e6:.2f} M complex "
               f"samples/s end to end")
    # (4) rx_rds's JSON into a networkclient output
    address = _free_tcp()
    listening = threading.Event()
    join = _thread(serve_once, "tcp", address, None, listening)
    listening.wait(NET_TIMEOUT)
    rc, dt = run_cli(["-a", "rx_rds", "-i", f"iqfile:{rds_path},rate={RATE}",
                      "-o", f"networkclient:{address},format=json", "0"],
                     dev)
    packets = [json.loads(ln) for ln in join().decode().splitlines()]
    if rc != 0 or packets != rds_packets:
        raise AssertionError(f"net CLI rx_rds networkclient json: rc {rc}, "
                             f"{len(packets)} packets, the rds phase's "
                             f"{len(rds_packets)}")
    log("net", f"CLI rx_rds -o networkclient:{address},format=json: "
               f"{len(packets)} packets, equal to the rds phase's")
    return rates


class FakeHackRFTx:
    """An in-process libhackrf for transmit.  Its transfer thread waits for
    a full transfer of samples in the sink's ring (or the ring's close)
    before each callback, as a device streaming from a host that keeps
    up, and keeps the s8 wire each callback wrote."""

    BUFFER = 1 << 18             # bytes a transfer (131 072 samples)

    def __init__(self):
        self.sent, self.sink, self.thread = [], None, None

    def __getattr__(self, name):
        if not name.startswith("hackrf_"):
            raise AttributeError(name)
        return lambda *args: 0

    def hackrf_open(self, devp):
        ctypes.cast(devp, ctypes.POINTER(ctypes.c_void_p))[0] = \
            ctypes.c_void_p(0xDEAD)
        return 0

    @property
    def hackrf_compute_baseband_filter_bw_round_down_lt(self):
        class RoundDown:
            restype = None

            def __call__(self, bw):
                return int(bw.value * 3 // 4)
        return RoundDown()

    def hackrf_start_tx(self, dev, cb, ctx):
        from luaradio_tpu_torch.blocks.sources.sdr import _hackrf_transfer

        def pump():
            ring = self.sink.ring
            while True:
                while ring.available < self.BUFFER // 2 and not ring.closed:
                    time.sleep(0.001)
                buf = (ctypes.c_uint8 * self.BUFFER)()
                t = _hackrf_transfer(
                    device=dev, buffer=ctypes.cast(
                        buf, ctypes.POINTER(ctypes.c_uint8)),
                    buffer_length=self.BUFFER, valid_length=0)
                if cb(ctypes.byref(t)) != 0:
                    break
                self.sent.append(np.frombuffer(bytes(buf), np.int8).copy())
        self.thread = threading.Thread(target=pump, daemon=True)
        self.thread.start()
        return 0

    def hackrf_stop_tx(self, dev):
        self.thread.join(NET_TIMEOUT)     # the in-flight transfers drain
        return 0


def _plot_blocks(text, header):
    """The data blocks that follow each ``header`` line of a gnuplot
    command stream, as lists of number rows."""
    blocks, rows = [], None
    for ln in text.splitlines():
        if ln == header:
            rows = []
        elif rows is not None and ln == "e":
            blocks.append(rows)
            rows = None
        elif rows is not None:
            rows.append([float(v) for v in ln.split()])
    return blocks


def phase_plot_tx(tmp, dev):
    """GnuplotSpectrumSink and GnuplotWaterfallSink fed from the card (a
    complex tone on a bin of the PSD, made by SignalSource on the card;
    each sink's PSD batch on the card) through a fake gnuplot on PATH that
    copies its input to a file: the last spectrum's peak and every
    waterfall row's peak on the tone's bin.  Then HackRFSink fed by the FM
    modulator on the card through a fake TX library: the s8 wire it sends
    equals the host f32 -> s8 conversion of the IQ the modulator gave
    (tapped on the host)."""
    bindir = os.path.join(tmp, "bin")
    os.makedirs(bindir, exist_ok=True)
    gp = os.path.join(bindir, "gnuplot")
    with open(gp, "w") as fh:
        fh.write('#!/bin/sh\ncat > "$CHIP_SMOKE_GNUPLOT_OUT.$$"\n')
    os.chmod(gp, 0o755)
    env = {k: os.environ.get(k) for k in ("PATH", "CHIP_SMOKE_GNUPLOT_OUT")}
    os.environ["PATH"] = f"{bindir}:{env['PATH'] or ''}"
    os.environ["CHIP_SMOKE_GNUPLOT_OUT"] = os.path.join(tmp, "gnuplot")
    tone = PLOT_BIN * PLOT_RATE / PLOT_N
    try:
        top = CompositeBlock()
        src = lr.SignalSource("exponential", tone, PLOT_RATE)
        top.connect(src, lr.GnuplotSpectrumSink(PLOT_N, "spectrum"))
        top.connect(src, lr.GnuplotWaterfallSink(PLOT_N, "waterfall",
                                                 height=8))
        top.run(max_chunks=4, chunk_size=16 * PLOT_N, device=dev)
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    streams = {}
    for f in os.listdir(tmp):
        if f.startswith("gnuplot."):
            with open(os.path.join(tmp, f)) as fh:
                text = fh.read()
            streams["waterfall" if "set view map" in text
                    else "spectrum"] = text
    spec = _plot_blocks(streams.get("spectrum", ""),
                        "plot '-' with lines notitle")
    water = _plot_blocks(streams.get("waterfall", ""),
                         "plot '-' matrix with image notitle")
    if not spec or not water:
        raise AssertionError(f"plot: {len(spec)} spectra, {len(water)} "
                             f"waterfalls written to the fake gnuplot")
    freqs, psd = np.array(spec[-1]).T
    peak = freqs[np.argmax(psd)]
    cols = {int(np.argmax(row)) for row in water[-1]}
    if peak != tone or cols != {PLOT_N // 2 + PLOT_BIN}:
        raise AssertionError(f"plot: spectrum peak at {peak} Hz (tone "
                             f"{tone} Hz), waterfall peaks in columns "
                             f"{sorted(cols)} (want {PLOT_N // 2 + PLOT_BIN})")
    log("plot-tx", f"GnuplotSpectrumSink: {len(spec)} spectra, peak at "
                   f"{peak:.1f} Hz (the tone's bin); GnuplotWaterfallSink: "
                   f"{len(water)} images, every row's peak in the tone's "
                   f"column; PSDs on the card")
    fake = FakeHackRFTx()
    lr.HackRFSink._injected_lib = fake
    try:
        top = CompositeBlock()
        sink, tap = lr.HackRFSink(433e6, vga_gain=20), _Collect()
        fake.sink = sink
        fm = lr.FrequencyModulatorBlock(0.01)
        top.connect(lr.SignalSource("cosine", 1e3, TX_RATE), fm)
        top.connect(fm, sink)
        top.connect(fm, tap)
        top.run(max_chunks=4, chunk_size=TX_CHUNK, device=dev)
    finally:
        lr.HackRFSink._injected_lib = None
    iq = np.concatenate(tap.got)
    sent = np.concatenate(fake.sent)
    exp = np.clip(iq.view(np.float32) * 127.0, -128, 127).astype(np.int8)
    if len(iq) != 4 * TX_CHUNK or len(sent) < len(exp) or \
            not np.array_equal(sent[:len(exp)], exp):
        raise AssertionError(f"tx: {len(iq)} IQ samples, {len(sent)} s8 "
                             f"values sent")
    log("plot-tx", f"HackRFSink: {len(iq)} FM samples from the card, the "
                   f"s8 wire sent ({len(fake.sent)} transfers) equals the "
                   f"host f32 -> s8 conversion bit for bit")


# -- this slice: time sharding, multihost and the C embedding ----------------

#: the time phase's meshes: the README graph and the RDS receiver in
#: TIME_D time shards, bench.py's graphs in BENCH_D, WBFMMonoBank's bank
#: on (BANK_C, TIME_D); the multihost phase's processes, each holding two
#: time shards (or half the POCSAG bank's rows), and the hard limit on
#: their run
TIME_D, BENCH_D = 4, 8
MH_NPROC, MH_TIMEOUT = 2, 240.0
#: the time-sharded RDS receiver's chunk at the source: 2^20 at its IF
#: rate, 2^18 a shard, 8 192 points of the phase corrector
RDS_CHUNK = 1 << 22


def kernel_counts() -> dict:
    return {"K1": wbfm.wbfm_mono.launches, "K2": wbfm.disc_fir.launches,
            "K3": pll.pll_phase.launches}


def zero_kernel_counts():
    wbfm.wbfm_mono.launches = wbfm.disc_fir.launches = 0
    pll.pll_phase.launches = 0


def time_mesh(d, group=None):
    return Mesh((d,), ("time",), group=group)


def readme_audio(path, fmt, dev, mesh=None):
    """The README graph's float audio (a collector in the WAV sink's
    place), serially or on ``mesh``: (this process's audio blocks, one
    a chunk; seconds)."""
    top, sink = CompositeBlock(), _Collect()
    top.connect(IQFileSource(path, fmt, RATE), TunerBlock(-250e3, 200e3, 5),
                WBFMMonoDemodulator(), DownsamplerBlock(5), sink)
    t0 = time.monotonic()
    Runner(top, mesh=mesh, device=dev).run()        # ends synchronized
    return sink.got, time.monotonic() - t0


def rds_vector_packets(path, dev, mesh=None):
    """rx_rds's graph by hand with the vector pilot (the PLL cannot
    time-shard): the capture -> TunerBlock(0, 200 kHz, 4) ->
    RDSReceiver(pilot="vector"), serially or on ``mesh``, at RDS_CHUNK
    (each time shard must hold the phase corrector's 8 000-point window
    of 32-sample points); (packets as JSON, seconds)."""
    top, sink = CompositeBlock(), _Collect()
    top.connect(IQFileSource(path, "f32le", RATE), TunerBlock(0, 200e3, 4),
                lr.RDSReceiver(pilot="vector"), sink)
    t0 = time.monotonic()
    Runner(top, chunk_size=RDS_CHUNK, mesh=mesh, device=dev).run()
    return ([json.loads(p.to_json()) for call in sink.got for p in call],
            time.monotonic() - t0)


def busy_share(run) -> tuple[float, float]:
    """(wall seconds, the card's busy share) of ``run()`` under
    torch.profiler (device activity only)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    return wall, device_ms(prof) / 1e3 / wall


def phase_time(tmp, dev, smi, paths, rds_path, rds_sent, rds_packets):
    """The time mesh on one card (the port's counterpart of the JAX
    package's shard_map over D devices: D shards stacked on a leading
    axis, parallel/mesh.py), K1/K2/K3 counts zeroed before and read
    after (the JAX package turns its Pallas fusion off under a mesh and
    its PLL cannot time-shard: each must be 0):

    * the README graph over the graph phase's captures (f32 and u8 wire)
      on a ("time",) mesh of TIME_D: audio within 1e-5 of the serial run,
      the tone within 50 Hz;
    * bench.py's random graph at 2^22-sample chunks on BENCH_D shards
      beside the serial run (complex samples/s, host clock), and the
      card's busy share of 16 chunks of each (torch.profiler);
    * the bench u8 file graph from its device-resident ring on BENCH_D
      shards: no host-to-device copy, audio within 1e-5 of the serial
      resident run over 3 chunks;
    * the RDS receiver (vector pilot) over the rds phase's capture on
      TIME_D shards: its packets equal its serial run's, pass the rds
      phase's hold and equal the rds phase's packets;
    * WBFMMonoBank at BANK_C channels on a (BANK_C, TIME_D) ("channel",
      "time") mesh against its one-card run (2e-4 * scale)."""
    out = {}
    zero_kernel_counts()
    audio = {}
    for fmt in ("f32le", "u8"):
        a, dt_s = readme_audio(paths[fmt], fmt, dev)
        b, dt_m = readme_audio(paths[fmt], fmt, dev, time_mesh(TIME_D))
        a, b = np.concatenate(a), np.concatenate(b)
        err = float(np.max(np.abs(a - b))) if a.shape == b.shape else None
        peak = tone_peak(b, RATE / 25)
        if err is None or err > 1e-5 or abs(peak - TONE) > 50:
            raise AssertionError(f"time README {fmt}: shapes {a.shape} "
                                 f"{b.shape}, max |mesh - serial| {err}, "
                                 f"tone {peak} Hz")
        audio[fmt] = a
        out[f"readme_{fmt}"] = {"max_abs_err": err, "tone_hz": peak,
                                "serial_sps": len(a) * 25 / dt_s,
                                "mesh_sps": len(b) * 25 / dt_m}
        log("time", f"README graph, {fmt} wire, ('time',) mesh of {TIME_D}: "
                    f"{len(b)} audio samples, max |mesh - serial| {err:.3g} "
                    f"(limit 1e-5), tone {peak:.1f} Hz; "
                    f"{len(b) * 25 / dt_m / 1e6:.2f} M complex samples/s end "
                    f"to end (serial {len(a) * 25 / dt_s / 1e6:.2f} M)")

    rows = {}
    for label, mesh in (("serial", None), (f"D={BENCH_D}",
                                           time_mesh(BENCH_D))):
        sps, k, _ = bench_run(pbench.runner_graph, dev, mesh=mesh)
        wall, busy = busy_share(lambda: Runner(
            pbench.runner_graph(BenchmarkSink()), chunk_size=BENCH_CHUNK,
            mesh=mesh, device=dev).run(max_chunks=16))
        rows[label] = {"sps": sps, "chunks": k, "busy": busy}
        log("time", f"bench random graph, {label}: {sps / 1e6:.1f} M "
                    f"complex samples/s over {k} chunks of {BENCH_CHUNK} "
                    f"(host clock); card busy {100 * busy:.1f} % of 16 "
                    f"chunks ({wall:.3f} s, torch.profiler); {smi}")
    out["bench_random"] = rows

    ring = pbench.write_u8_file(os.path.join(tmp, "bench.u8.iq"), BENCH_FILE)
    res = {}
    for label, mesh in (("serial", None), ("mesh", time_mesh(BENCH_D))):
        sink = _Collect()
        r = Runner(pbench.file_graph(ring, sink, True),
                   chunk_size=BENCH_CHUNK, mesh=mesh, device=dev)
        r.run(max_chunks=3)
        if r.feeds[0].route != "resident" or r.h2d_copies:
            raise AssertionError(f"time resident {label}: route "
                                 f"{r.feeds[0].route}, "
                                 f"{r.h2d_copies} host-to-device copies")
        res[label] = np.concatenate(sink.got)
    err = float(np.max(np.abs(res["mesh"] - res["serial"]))) \
        if res["mesh"].shape == res["serial"].shape else None
    if err is None or err > 1e-5 or res["mesh"].shape != (
            3 * BENCH_CHUNK // 8,):
        raise AssertionError(f"time resident: {res['mesh'].shape}, max "
                             f"|mesh - serial| {err}")
    out["resident_max_abs_err"] = err
    log("time", f"bench u8 file graph from its resident ring, D={BENCH_D}: "
                f"0 host-to-device copies, max |mesh - serial resident| "
                f"{err:.3g} over 3 chunks (limit 1e-5)")

    serial, dt_s = rds_vector_packets(rds_path, dev)
    sharded, dt_m = rds_vector_packets(rds_path, dev, time_mesh(TIME_D))
    found, late = hold_rds_packets("time rds", sharded, rds_sent)
    # the vector pilot locks at another moment than rx_rds's PLL after
    # the noise: the groups sent after 1.5 s are held equal
    late_groups = {g for start, g in rds_sent if start >= 1.5}

    def late_frames(packets):
        return {tuple(p["data"]["frame"]) for p in packets} & late_groups
    if sharded != serial or late_frames(sharded) != late_frames(
            rds_packets):
        raise AssertionError(
            f"time rds: {len(sharded)} packets on the mesh, {len(serial)} "
            f"serially, {len(rds_packets)} in the rds phase; mesh == "
            f"serial {sharded == serial}; late groups "
            f"{len(late_frames(sharded))} vs the rds phase's "
            f"{len(late_frames(rds_packets))}")
    n = DIGITAL_S * RATE
    out["rds"] = {"packets": len(sharded), "rds_phase_packets":
                  len(rds_packets), "late_groups": len(late_frames(sharded)),
                  "mesh_sps": n / dt_m, "serial_sps": n / dt_s}
    log("time", f"RDS receiver (vector pilot), ('time',) mesh of {TIME_D}: "
                f"{len(sharded)} packets, equal to its serial run's; the "
                f"{len(late_frames(sharded))} groups sent after 1.5 s it "
                f"decoded are the rds phase's (K3 pilot; {len(rds_packets)} "
                f"packets in all), {found} of {late}; "
                f"{n / dt_m / 1e6:.2f} M complex samples/s (serial "
                f"{n / dt_s / 1e6:.2f} M)")

    gen = torch.Generator(device=dev).manual_seed(77)
    x, rate = bank_class_input("mono", dev, gen)
    ys = {}
    for label, mesh in (("one card", None), ("mesh", Mesh(
            (BANK_C, TIME_D), ("channel", "time")))):
        bank = WBFMMonoBank(mesh, if_rate=rate, decimation=8, device=dev)
        state = bank.init_state(BANK_C)
        bank.step(state, x[:, :CLASS_CHUNK].contiguous())     # warm-up
        state = bank.init_state(BANK_C)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        got = []
        for xc in x.split(CLASS_CHUNK, dim=-1):
            state, y = bank.step(state, xc.contiguous())
            got.append(y)
        torch.cuda.synchronize()
        ys[label] = (torch.cat(got, -1).cpu().numpy(),
                     x.numel() / (time.monotonic() - t0))
    exp, got = ys["one card"][0], ys["mesh"][0]
    scale = max(1.0, float(np.abs(exp).max()))
    err = float(np.abs(got - exp).max())
    if got.shape != exp.shape or err > 2e-4 * scale:
        raise AssertionError(f"time WBFMMonoBank: max |mesh - one card| "
                             f"{err} > 2e-4 * {scale:.3g}")
    out["wbfm_mono_bank"] = {"max_abs_err": err, "mesh_sps": ys["mesh"][1],
                             "one_card_sps": ys["one card"][1]}
    log("time", f"WBFMMonoBank [{BANK_C} x {CLASS_CHUNK}] x {CLASS_CHUNKS} "
                f"on a ({BANK_C}, {TIME_D}) ('channel', 'time') mesh: max "
                f"|mesh - one card| {err:.3g} (limit 2e-4 * {scale:.3g}); "
                f"{ys['mesh'][1] / 1e9:.3f} G complex samples/s summed "
                f"(one card {ys['one card'][1] / 1e9:.3f} G)")
    counts = kernel_counts()
    if any(counts.values()):
        raise AssertionError(f"time: kernel launches under a mesh {counts}")
    out["launches"] = counts
    log("time", f"kernel launches over the phase (zeroed before): {counts} "
                f"(the JAX package's meshes run no Pallas kernel either)")
    return out, audio


def mh_worker(rank: int, d: str):
    """One process of the multihost phase (``chip_smoke.py
    --multihost-worker RANK DIR``): joins the group through a file under
    DIR, runs the README graph on a ("time",) mesh of 2 * MH_NPROC
    spanning the processes over both captures (after an untimed warm-up
    run: the first pays for CUDA and cuDNN set-up), then the bank-host graph
    on a ("channel",) mesh of its 8 rows, and writes what its sinks got
    and its kernel counts."""
    import pickle
    from luaradio_tpu_torch.parallel import multihost
    with open(os.path.join(d, "job.json")) as f:
        job = json.load(f)
    dev = torch.device(job["device"])
    group = multihost.initialize(f"file://{os.path.join(d, 'rendezvous')}",
                                 MH_NPROC, rank)
    zero_kernel_counts()
    out = {}
    mesh = time_mesh(2 * MH_NPROC, group)
    readme_audio(job["readme"]["u8"], "u8", dev, mesh)  # warm-up, untimed
    for fmt, path in job["readme"].items():
        out[fmt], out[fmt + "_s"] = readme_audio(path, fmt, dev, mesh)
    top, sink = CompositeBlock(), _Collect()
    top.connect(BankSource([IQFileSource(p, "f32le", RATE)
                            for p in job["pocsag"]]),
                TunerBlock(0, 12e3, round(RATE / 12.5e3)),
                POCSAGReceiver(1200), sink)
    r = Runner(top, mesh=Mesh((8,), ("channel",), group=group), device=dev)
    r.run()
    rows = r._chan_local[1] - r._chan_local[0]
    out["pocsag"] = (r._chan_local, [
        [(m.address, m.func, m.alphanumeric) for call in sink.got[c::rows]
         for m in call] for c in range(rows)])
    out["launches"] = kernel_counts()
    with open(os.path.join(d, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def phase_multihost(tmp, dev, paths, serial_audio):
    """Two processes on the one card over gloo (NCCL refuses two ranks on
    one device), each holding two stacked time shards of a ("time",) mesh
    of 4: the README graph over both captures, each process's sink
    getting its contiguous block of every chunk, the blocks reassembled
    equal to the serial run within 1e-5; then a process-spanning
    ("channel",) bank of the bank-host graph's 8 POCSAG rows, 4 a
    process, each row's messages as sent.  The workers are joined with a
    hard limit (killed past it); K1/K2/K3 launches in them must be 0."""
    import pickle
    d = os.path.join(tmp, "multihost")
    os.makedirs(d)
    rows = write_pocsag_rows(tmp)
    with open(os.path.join(d, "job.json"), "w") as f:
        json.dump({"readme": paths, "pocsag": rows, "device": str(dev)}, f)
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--multihost-worker", str(r), d],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for r in range(MH_NPROC)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=MH_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"multihost: workers still running after "
                             f"{MH_TIMEOUT} s: killed")
    wall = time.monotonic() - t0
    if any(p.returncode for p in procs):
        raise AssertionError(
            f"multihost: workers exited {[p.returncode for p in procs]}:\n"
            + b"\n".join(lg[-3000:] for lg in logs).decode(errors="replace"))
    res = []
    for r in range(MH_NPROC):
        with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    out = {"wall_s": wall}
    for fmt, ref in serial_audio.items():
        blocks = [res[r][fmt] for r in range(MH_NPROC)]
        got = np.concatenate([b[i] for i in range(len(blocks[0]))
                              for b in blocks])
        err = float(np.max(np.abs(got - ref))) if got.shape == ref.shape \
            else None
        if err is None or err > 1e-5:
            raise AssertionError(f"multihost {fmt}: {got.shape} vs "
                                 f"{ref.shape}, max |reassembled - serial| "
                                 f"{err}")
        secs = max(r[fmt + "_s"] for r in res)
        out[fmt] = {"max_abs_err": err, "sps": len(ref) * 25 / secs}
        log("multihost", f"README graph, {fmt} wire, ('time',) mesh of "
                         f"{2 * MH_NPROC} over {MH_NPROC} processes (gloo): "
                         f"blocks of {[len(b[0]) for b in blocks]} a chunk "
                         f"reassembled, max |multihost - serial| {err:.3g} "
                         f"(limit 1e-5); {len(ref) * 25 / secs / 1e6:.2f} M "
                         f"complex samples/s (slowest process)")
    got = {}
    for r in res:
        (lo, hi), msgs = r["pocsag"]
        got.update({lo + i: m for i, m in enumerate(msgs)})
    want = {c: [POCSAG_SENT[c]] if c in POCSAG_SENT else []
            for c in range(8)}
    if got != want:
        raise AssertionError(f"multihost bank-host: {got}, sent {want}")
    counts = [r["launches"] for r in res]
    if any(v for c in counts for v in c.values()):
        raise AssertionError(f"multihost: kernel launches {counts}")
    out["launches"] = counts
    log("multihost", f"bank-host graph on a ('channel',) mesh of 8 over "
                     f"{MH_NPROC} processes: rows "
                     f"{[r['pocsag'][0] for r in res]}, each row's messages "
                     f"as sent; kernel launches {counts}; the phase "
                     f"{wall:.1f} s (workers' start, CUDA and gloo "
                     f"set-up included)")
    return out


def phase_embed(tmp, dev):
    """The C embedding API on the card: cc builds native/src/embed.c and
    the port's lifecycle program (utils/embed.py); the program runs its
    error paths (a raising script, a script with no top, start with no
    graph), then a finite graph on the card (start, status running,
    wait, status stopped, stop) and an endless one (start, stop).  The
    finite graph's output must equal the same graph run from Python."""
    from luaradio_tpu_torch.utils import embed
    t0 = time.monotonic()
    lib, prog = embed.build()
    built = time.monotonic() - t0
    out = os.path.join(tmp, "embed.f32")
    t0 = time.monotonic()
    r = embed.run_lifecycle(torch.device(dev).type, out, timeout=180)
    wall = time.monotonic() - t0
    lines = r.stdout.splitlines()
    if r.returncode != 0 or lines[-1:] != ["embed API lifecycle OK"] \
            or "running: 1" not in lines:
        raise AssertionError(f"embed: rc {r.returncode}\n{r.stdout}\n"
                             f"{r.stderr[-3000:]}")
    top, sink = CompositeBlock(), _Collect()
    top.connect(IQFileSource(f"{out}.iq", "f32le", 1e6),
                FrequencyDiscriminatorBlock(1.25),
                LowpassFilterBlock(64, 1e5), DownsamplerBlock(4), sink)
    top.run(device=dev)
    got, exp = np.fromfile(out, np.float32), np.concatenate(sink.got)
    if got.shape != exp.shape or not np.array_equal(got, exp):
        raise AssertionError(f"embed: the C API's output {got.shape} is "
                             f"not the Python run's {exp.shape}")
    log("embed", f"{os.path.basename(str(lib))} and "
                 f"{os.path.basename(str(prog))} built in {built:.2f} s; the "
                 f"lifecycle on {torch.device(dev).type} in {wall:.2f} s: "
                 f"{'; '.join(lines[:-1])}; {len(got)} samples equal to the "
                 f"Python run's")
    return {"build_s": built, "lifecycle_s": wall}


# -- this slice: the roofline probes and the measurement entry points ------

#: the roofline phase: R1-R3 at bench_roofline.py's [8, 2^23] float32, R3
#: held within 2 ulp at pi of its twin, R3's operations an output for its
#: operation bound (atan2f as ~30), the seconds of bench_roofline's
#: resident row; the entries phase: bench.py's budget (four rows of
#: BENCH_S), the paced realtime run's seconds, the bench_multihost
#: scenarios the multihost phase does not run
ROOF_C, ROOF_W = 8, 1 << 23
ATAN2_TOL, ATAN2_OPS = 4.8e-7, 30
ROOF_RESIDENT_S = 1.5
ENTRY_BUDGET_S, REALTIME_S = 4 * BENCH_S, 8.0
MH_SCENARIOS = ("wbfm_resident", "channel_bank", "rds_bank", "overhead")


def roofline_counts() -> dict:
    return {"R1": roofline.hbm_copy_serial.launches,
            "R2": roofline.hbm_copy_double_buffered.launches,
            "R3": roofline.atan2_halves.launches}


def hold_copy(name, fn, x, quiet=False):
    """R1 or R2 bit-equal to its twin (and to its input)."""
    got, exp = fn(x), roofline.hbm_copy_reference(x)
    torch.cuda.synchronize()
    if not (torch.equal(got, exp) and torch.equal(got, x)):
        raise AssertionError(f"{name} {tuple(x.shape)}: the copy differs "
                             f"from its twin")
    if not quiet:
        log("roofline", f"{name} {tuple(x.shape)}: bit-equal to its twin")


def atan2_edges(dev, h):
    """[2, ...] float32 whose tiles of 2h columns pair every (y, x) of
    signed zeros, infinities, NaN, subnormals, extremes and plain values
    (padded with 1.0)."""
    v = np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                    1e-38, 3e38, -3e38, 1.0, -1.0, 1.5, -2.5, 1e-30, 7.0])
    y, x = (a.ravel() for a in np.meshgrid(v, v, indexing="ij"))
    per = 2 * h
    n = -(-len(y) // per) * per
    y = np.concatenate([y, np.ones(n - len(y), np.float32)])
    x = np.concatenate([x, np.ones(n - len(x), np.float32)])
    w = np.stack([y.reshape(2, -1, h), x.reshape(2, -1, h)], axis=2)
    return torch.from_numpy(w.reshape(2, -1).copy()).to(dev)


def atan2_err(got, exp):
    """Largest |kernel - twin| in rad where both are numbers; raises on a
    NaN in one and not the other or a zero of the other sign."""
    g, e = got.double().cpu(), exp.double().cpu()
    if not torch.equal(g.isnan(), e.isnan()):
        raise AssertionError("atan2_halves: NaN where the twin has none")
    zero = e == 0
    if not torch.equal(torch.signbit(g[zero]), torch.signbit(e[zero])) or \
            (g[zero] != 0).any():
        raise AssertionError("atan2_halves: a signed zero differs")
    ok = ~e.isnan()
    return float((g[ok] - e[ok]).abs().max())


def roofline_entry(name, fn, twin, library, x, nbytes, ops, source_line):
    """A kernels-line entry of R1, R2 or R3: ms, twin and library ms as a
    launch (CUDA events around one call, median of REPS) and as device
    time (CUDA-graph replay: device_ms, plain_device_ms,
    library_device_ms), bound of ``nbytes`` and ``ops``."""
    ms = median_ms(lambda: fn(x))
    plain_ms = median_ms(lambda: twin(x))
    library_ms = median_ms(library)
    dev_ms = graph_ms(lambda: fn(x))
    plain_dev_ms = graph_ms(lambda: twin(x))
    library_dev_ms = graph_ms(library)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    e = {"name": name, "route": "cuda",
         "source": "luaradio_tpu_torch/csrc/roofline.cu",
         "replaces": f"bench_roofline.py:{source_line}", "ms": ms,
         "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "library_ms": library_ms, "device_ms": dev_ms,
         "plain_device_ms": plain_dev_ms,
         "library_device_ms": library_dev_ms}
    log("roofline", f"{name} {tuple(x.shape)}: a launch {ms:.4f} ms (median "
                    f"of {REPS}), twin {plain_ms:.4f}, library "
                    f"{library_ms:.4f}; device {dev_ms:.4f} ms (CUDA-graph "
                    f"replay), twin {plain_dev_ms:.4f}, library "
                    f"{library_dev_ms:.4f} ({dev_ms / library_dev_ms:.4f}x "
                    f"the library); bound {e['bound_ms']:.4f} ms "
                    f"({nbytes / 1e6:.1f} MB at 3.35 TB/s; H100 SXM data "
                    f"sheet); {nbytes / dev_ms / 1e6:.1f} GB/s on device")
    return e


def phase_roofline(dev, gen, smi):
    """R1, R2 and R3 (csrc/roofline.cu) at [8, 2^23]: the copies bit-equal
    to their twin (and on a ragged shape whose bytes are no multiple of
    16, and on each shape of ops/roofline.py edge_shapes for the copy's
    grid on this card), R3 within ATAN2_TOL of its twin (and on every
    pairing of signed zeros, infinities, NaN and extremes, through its
    vector and scalar paths), each timed as a launch and as device time
    beside its twin, its library call and its bound; R2's ring traced
    for the share of its loads' time a store was in flight.  Then
    benchmarks/bench_roofline.py once, its launches of R1-R3 counted
    (zeroed just before), its object printed.  Returns the three
    kernels-line entries."""
    x = torch.randn((ROOF_C, ROOF_W), generator=gen, device=dev)
    ragged = torch.randn((3, 2 * 5003), generator=gen, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, fn, ring in (
            ("hbm_copy serial (R1)", roofline.hbm_copy_serial, roofline.R1),
            ("hbm_copy double-buffered (R2)",
             roofline.hbm_copy_double_buffered, roofline.R2)):
        hold_copy(name, fn, x)
        hold_copy(name, fn, ragged)
        grid = ring.ctas_per_sm * sms
        edges = roofline.edge_shapes(ring, grid)
        for shape in edges.values():
            hold_copy(name, fn, torch.randn(shape, generator=gen,
                                            device=dev), quiet=True)
        log("roofline", f"{name}: bit-equal to its twin on the "
                        f"{len(edges)} edge shapes of its {grid}-CTA grid "
                        f"({', '.join(f'{k} {v}' for k, v in edges.items())})")
    err = atan2_err(roofline.atan2_halves(x),
                    roofline.atan2_halves_reference(x))
    for tile in (8, 6):                    # float4 and scalar paths
        e = atan2_edges(dev, tile // 2)
        err = max(err, atan2_err(roofline.atan2_halves(e, tile),
                                 roofline.atan2_halves_reference(e, tile)))
    if err > ATAN2_TOL:
        raise AssertionError(f"atan2_halves: |kernel - twin| {err} > "
                             f"{ATAN2_TOL}")
    log("roofline", f"atan2_halves (R3) {tuple(x.shape)} and the edge "
                    f"cases: max |kernel - twin| {err:.3g} rad (limit "
                    f"{ATAN2_TOL}); NaN and signed zeros as the twin's")
    nbytes = 2 * x.numel() * 4
    dst = torch.empty_like(x)
    view = x.reshape(ROOF_C, ROOF_W // (1 << 15), 2, 1 << 14)
    out = torch.empty((ROOF_C, ROOF_W // (1 << 15), 1 << 14), device=dev)
    r1 = roofline_entry("hbm_copy_serial", roofline.hbm_copy_serial,
                        roofline.hbm_copy_reference, lambda: dst.copy_(x), x,
                        nbytes, 0, 93)
    r2 = roofline_entry("hbm_copy_double_buffered",
                        roofline.hbm_copy_double_buffered,
                        roofline.hbm_copy_reference, lambda: dst.copy_(x), x,
                        nbytes, 0, 72)
    r3 = roofline_entry("atan2_halves", roofline.atan2_halves,
                        roofline.atan2_halves_reference,
                        lambda: torch.atan2(view[:, :, 0], view[:, :, 1],
                                            out=out), x,
                        x.numel() * 4 * 3 // 2, ATAN2_OPS * x.numel() // 2,
                        155)
    r1["max_abs_err"] = r2["max_abs_err"] = 0.0
    r3["max_abs_err"] = err
    slabs = roofline.n_slabs(x.numel() * 4, roofline.R2.stage_bytes)
    ctas = min(roofline.ring_ctas(), slabs)
    ov = roofline.ring_overlap(roofline.ring_trace(x), ctas)
    r2["ring"] = dict(ov, ctas=ctas, **dataclasses.asdict(roofline.R2))
    r1["ring"] = dataclasses.asdict(roofline.R1)
    log("roofline", f"R2's ring on {ctas} persistent CTAs "
                    f"({roofline.R2}): over {ov['slab_pairs']} slabs a store "
                    f"of the same CTA was in flight "
                    f"{100 * ov['overlap_share']:.1f} % of the load time "
                    f"(%globaltimer trace); R1: {roofline.R1}")
    del x, ragged, dst, out, view
    torch.cuda.empty_cache()
    roofline.hbm_copy_serial.launches = 0
    roofline.hbm_copy_double_buffered.launches = 0
    roofline.atan2_halves.launches = 0
    t0 = time.monotonic()
    obj = proofline.run(dev, resident_s=ROOF_RESIDENT_S)
    counts = roofline_counts()
    for e, key in ((r1, "R1"), (r2, "R2"), (r3, "R3")):
        e["launches"] = counts[key]
    if not all(counts.values()):
        raise AssertionError(f"roofline: bench_roofline launched {counts}")
    hw = obj["hardware_measured"]
    for key in ("hbm_copy_serial_GBps", "hbm_copy_double_buffered_GBps",
                "hbm_copy_copy__GBps", "tensor_core_bf16_TFLOPs",
                "atan2_GSps"):
        if not np.isfinite(hw[key]) or hw[key] <= 0:
            raise AssertionError(f"roofline: {key} = {hw[key]}")
    r1["bench_roofline_GBps"] = hw["hbm_copy_serial_GBps"]
    r2["bench_roofline_GBps"] = hw["hbm_copy_double_buffered_GBps"]
    r2["bench_roofline_copy__GBps"] = hw["hbm_copy_copy__GBps"]
    r2["flagship_fraction_of_R2_byte_roofline"] = \
        obj["rows"][0]["fraction_of_R2_byte_roofline"]
    r3["bench_roofline_GSps"] = hw["atan2_GSps"]
    log("roofline", json.dumps(obj))
    log("roofline", f"bench_roofline in {time.monotonic() - t0:.1f} s; "
                    f"launches {counts}; {smi}")
    torch.cuda.empty_cache()
    return [r1, r2, r3]


#: the probes phase: S8 held bit-equal at the script's and the flagship's
#: shapes (C, head, tile, NT) and on ragged ones; S7 held within
#: PROBE_PLL_TOL (err and state; the same float32 operations and atan2f on
#: both sides) over the first PROBE_PLL_N samples of its entry point's
#: timed 2^21 call and on PROBE_PLL_RAGGED samples (three chunks of 2048,
#: the last ragged); S4 held within 2e-5 * scale at its entry point's own
#: (C, T), tiles and inputs for every variant, then on a random carry
PROBE_S8 = ((8, 512, 8192, 4), (8, 512, 8192, 512))
PROBE_PLL_N, PROBE_PLL_RAGGED, PROBE_PLL_TOL = 4096, 5000, 1e-6
#: S4 at other (K, D, tile, block, deint, fir): the band at u = 64 and 26
#: (5 and 3 k-steps), the CUDA-core sum of a bf16 mode (tile/D = 96), a
#: block of 256
PROBE_S4_SHAPES = ((256, 4, 2048, 128, "sel3", "split22"),
                   (128, 5, 1280, 128, "sel2", "sel3"),
                   (128, 8, 768, 32, "highest", "split22"),
                   (128, 8, 2048, 256, "sel3cat", "two"))
#: S4's ring at its edges (label, C, K, D, tile, tiles a row, x's offset
#: in floats, deint, fir, stage) on the card's grid (ops/wbfm_proto.py
#: edge_shapes), each against the twin at the same tolerances
S4_EDGES = tuple((label, *v) for label, v in
                 wbfm_proto.edge_shapes().items())
PROBE_REPS = 3


def probe_counts() -> dict:
    return {"S4": wbfm_proto.wbfm_proto.launches,
            "S7": pll_ablate.pll_ablate.launches,
            "S8": window.window_gather.launches}


def hold_window(dev, gen):
    """S8 bit-equal to its twin at PROBE_S8's shapes, with a halo of 37
    floats (the scalar path) and with x 4 bytes off a 16-byte boundary.
    Returns the largest |kernel - twin|."""
    cases = [(c, head, tile, nt, 0) for c, head, tile, nt in PROBE_S8]
    cases += [(3, 37, 5, 7, 0), (2, 64, 96, 3, 1)]
    err = 0.0
    for c, head, tile, nt, off in cases:
        buf = torch.randn(c * 2 * tile * nt + off, generator=gen, device=dev)
        x = buf[off:].view(c, 2 * tile * nt)
        carry = torch.randn((c, head), generator=gen, device=dev)
        got = window.window_gather(x, carry, tile)
        exp = window.window_gather_reference(x, carry, tile)
        torch.cuda.synchronize()
        if got.shape != exp.shape or not torch.equal(got, exp):
            raise AssertionError(f"window_gather [{c}, {2 * tile * nt}] "
                                 f"head {head} tile {tile} offset {off}: "
                                 f"differs from its twin")
        err = max(err, float((got - exp).abs().max()))
    log("probes", f"window_gather (S8) bit-equal to its twin on "
                  f"{len(cases)} shapes (flagship [8, 2^23]; a 37-float "
                  f"halo; x 4 bytes off 16): max |kernel - twin| {err}")
    return err


def _hold_pll(label, x, state, params, v, prefix=None):
    """S7's variant ``v`` on x against its twin: the whole err and state,
    or with ``prefix`` the first ``prefix`` err values.  Returns (max
    |kernel - twin|, the twin's host ms)."""
    ge, gs = pll_ablate.pll_ablate(x, state, *params, v)
    xs = x if prefix is None else x[:, :prefix]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ee, es = pll_ablate.pll_ablate_reference(xs, state, *params, v)
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) * 1e3
    if prefix is None:
        e = max(float((ge - ee).abs().max()), float((gs - es).abs().max()))
    else:
        e = float((ge[:, :prefix] - ee).abs().max())
        if not bool(torch.isfinite(gs).all()):
            raise AssertionError(f"pll_ablate {v} {label}: state {gs}")
    if not e <= PROBE_PLL_TOL:
        raise AssertionError(f"pll_ablate {v} {label}: |kernel - twin| {e} "
                             f"> {PROBE_PLL_TOL}")
    return e, ms


def hold_pll_ablate(dev, gen):
    """S7's four variants against the twin on the card: the first
    PROBE_PLL_N err values of the entry point's timed call (its 2^21
    samples and zero state), PROBE_PLL_RAGGED samples of noise from a
    nonzero state (err and state), and 1024 samples at other constants.
    Returns (max error, the twin's host ms a variant at PROBE_PLL_N)."""
    x, zero = pbench_pll.inputs(dev)
    xr = torch.randn((2, PROBE_PLL_RAGGED), generator=gen, device=dev)
    state = torch.tensor([0.4, 1.0, 0.02], device=dev)
    # other constants: a fast loop, a fractional multiplier, a tight clip
    params = (0.05, 1e-3, -0.3, 0.3, 2.5)
    err, plain = 0.0, {}
    for v in pll_ablate.VARIANTS:
        e, plain[v] = _hold_pll(f"[{x.shape[1]}] prefix", x, zero,
                                pbench_pll.PARAMS, v, prefix=PROBE_PLL_N)
        er, _ = _hold_pll(f"[{PROBE_PLL_RAGGED}]", xr, state,
                          pbench_pll.PARAMS, v)
        eo, _ = _hold_pll(f"{params}", xr[:, :1024].contiguous(), state,
                          params, v)
        err = max(err, e, er, eo)
        log("probes", f"pll_ablate (S7) {v}: max |kernel - twin| {e:.3g} on "
                      f"the first {PROBE_PLL_N} of the entry point's "
                      f"{x.shape[1]} samples, {er:.3g} on {PROBE_PLL_RAGGED} "
                      f"(err and state), {eo:.3g} at {params} (limit "
                      f"{PROBE_PLL_TOL}); twin {plain[v]:.1f} ms at "
                      f"{PROBE_PLL_N} (host clock, one run)")
    return err, plain


def _s4_hold(label, got, exp, st, gain=1.0):
    """|kernel - twin| of one S4 call, raising unless dma_only, deint_only
    and no_fir are bit-equal and the FIR stages within 2e-5 * scale.
    Returns (error, scale)."""
    torch.cuda.synchronize()
    if got.shape != exp.shape:
        raise AssertionError(f"wbfm_proto {label}: {tuple(got.shape)} vs "
                             f"{tuple(exp.shape)}")
    scale = max(1.0, float(exp.abs().max()))
    e = float((got - exp).abs().max())
    if st in ("dma_only", "deint_only", "no_fir"):
        ok = torch.equal(got, exp)
    else:
        ok = e <= 2e-5 * scale
    if not ok:
        raise AssertionError(f"wbfm_proto {label} ({st}, inv_gain {gain}): "
                             f"|kernel - twin| {e} (scale {scale})")
    return e, scale


def _s4_plan_holds(c, t, k, d, tile, dp, fp, st):
    """The library's plan (lr_wbfm_proto_plan) equals the Python mirror's
    (ops/wbfm_proto.py ring_plan) for one launch."""
    if st == "dma_only":
        return
    lib = wbfm_proto._lib()
    lib.lr_wbfm_proto_plan.argtypes = [ctypes.c_longlong, ctypes.c_longlong,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
    v = (ctypes.c_int * 16)()
    deint = wbfm_proto._HALVES if st == "no_deint" else \
        wbfm_proto._DEINT.get(dp, 0)
    code = lib.lr_wbfm_proto_plan(c, t, k, d, tile, wbfm_proto._STAGE[st],
                                  deint, wbfm_proto._FIR.get(fp, 0), v)
    if code:
        raise AssertionError(f"wbfm_proto plan: code {code}")
    m = wbfm_proto.ring_plan(c, t, k, d, tile, st, dp, fp)
    want = [m["chunk"], m["ss"], m["q_need"], m["stages"], m["stage_floats"],
            m["reg_cap"], m["rc"], m["rce"], m["ext"], m["item_cols"],
            m["plane_bytes"], m["smem"], wbfm_proto.RING.ctas_per_sm,
            m["warps"], int(m["band"]), m["items"]]
    if list(v) != want:
        raise AssertionError(f"wbfm_proto plan at {(c, t, k, d, tile, st)}: "
                             f"library {list(v)}, mirror {want}")


def hold_wbfm_proto(dev, gen):
    """S4 against its twin for every variant of its entry point (the
    script's, every precision, the four stages) at the entry point's own
    (C, T), tiles and inputs, then on a random carry at inv_gain 0.7; then
    at PROBE_S4_SHAPES and the ring's S4_EDGES (dma_only, deint_only and
    no_fir bit-equal, the FIR stages within 2e-5 * scale), the library's
    plan equal to the mirror's at each shape.  Returns (largest |kernel -
    twin|, largest |kernel - twin| over scale)."""
    x, carry, taps = pbench_s4.inputs(dev)
    c, t = x.shape[0], x.shape[1] // 2
    rand = torch.randn(carry.shape, generator=gen, device=dev)
    worst, worst_scaled = 0.0, 0.0
    for name, dp, fp, st, mul in pbench_s4.VARIANTS:
        ev, sv = 0.0, 0.0
        _s4_plan_holds(c, t, taps.shape[0], pbench_s4.D, mul * pbench_s4.TILE,
                       dp, fp, st)
        for cr, gain in ((carry, 1.0), (rand, 0.7)):
            args = (cr, x, taps, pbench_s4.D, gain, mul * pbench_s4.TILE, 128,
                    dp, fp, st)
            gc, got = wbfm_proto.wbfm_proto(*args)
            ec, exp = wbfm_proto.wbfm_proto_reference(*args)
            torch.cuda.synchronize()
            if not torch.equal(gc, ec):
                raise AssertionError(f"wbfm_proto {name}: the carry differs")
            e, scale = _s4_hold(name, got, exp, st, gain)
            ev, sv = max(ev, e), max(sv, scale)
            worst, worst_scaled = max(worst, e), max(worst_scaled, e / scale)
        log("probes", f"wbfm_proto (S4) {name} ({dp}, {fp}, {st}) [{c} x "
                      f"{t}] tile {mul * pbench_s4.TILE}: max |kernel - "
                      f"twin| {ev:.3g} (scale up to {sv:.4g}) on the entry "
                      f"point's inputs and on a random carry")
    del x, carry, rand
    for k, d, tile, block, dp, fp in PROBE_S4_SHAPES:
        xs = torch.randn((2, 2 * 3 * tile), generator=gen, device=dev)
        cs = torch.randn((2, 2 * k), generator=gen, device=dev)
        hs = torch.randn(k, generator=gen, device=dev) / k
        _s4_plan_holds(2, 3 * tile, k, d, tile, dp, fp, "full")
        args = (cs, xs, hs, d, 1.0, tile, block, dp, fp, "full")
        got = wbfm_proto.wbfm_proto(*args)[1]
        exp = wbfm_proto.wbfm_proto_reference(*args)[1]
        e, scale = _s4_hold(f"K {k} D {d} tile {tile} block {block} ({dp}, "
                            f"{fp})", got, exp, "full")
        worst, worst_scaled = max(worst, e), max(worst_scaled, e / scale)
    log("probes", f"wbfm_proto (S4) at {len(PROBE_S4_SHAPES)} other (K, D, "
                  f"tile, block): within 2e-5 * scale of its twin")
    for label, c, k, d, tile, nt, off, dp, fp, st in S4_EDGES:
        buf = torch.randn(c * 2 * tile * nt + off, generator=gen, device=dev)
        xs = buf[off:].view(c, 2 * tile * nt)
        cs = torch.randn((c, 2 * k), generator=gen, device=dev)
        hs = torch.randn(k, generator=gen, device=dev) / k
        _s4_plan_holds(c, tile * nt, k, d, tile, dp, fp, st)
        block = 128 if (tile // d) % 128 == 0 else 32
        args = (cs, xs, hs, d, 1.0, tile, block, dp, fp, st)
        got = wbfm_proto.wbfm_proto(*args)[1]
        exp = wbfm_proto.wbfm_proto_reference(*args)[1]
        e, scale = _s4_hold(label, got, exp, st)
        worst, worst_scaled = max(worst, e), max(worst_scaled, e / scale)
    log("probes", f"wbfm_proto (S4) at the ring's {len(S4_EDGES)} edge "
                  f"shapes: held against its twin; the library's plan equal "
                  f"to the mirror's at every shape held")
    torch.cuda.empty_cache()
    return worst, worst_scaled


def phase_probes(dev, gen, smi):
    """S8, S7 and S4 held against their twins on the card (hold_*), then
    their entry points (benchmarks/dma_window.py, pll_ablate.py,
    wbfm_proto.py) run once with the launch counts zeroed just before and
    read just after, each record printed and checked (S8 OK at both
    shapes; every rate finite; S4's fp32 and split variants within 2e-5
    of K1).  The holds run at the entry points' sizes and inputs (S7: the
    first PROBE_PLL_N samples of the timed call).  The kernels-line
    entries take their times from the entry points' runs (S8's bound also
    at the R2 rate its entry point measures (back to back: the device
    rate); S7's the clock64 chain floor
    of `full`), S4's and S8's twins timed at the entry points' sizes.
    Returns the three entries."""
    t_start = time.monotonic()
    s8_err = hold_window(dev, gen)
    s7_err, s7_plain = hold_pll_ablate(dev, gen)
    s4_err, s4_scaled = hold_wbfm_proto(dev, gen)
    t_hold = time.monotonic() - t_start

    window.window_gather.launches = 0
    pll_ablate.pll_ablate.launches = 0
    wbfm_proto.wbfm_proto.launches = 0
    s8 = pbench_dma.run(dev, emit=lambda ln: log("probes", ln))
    s7 = pbench_pll.run(dev, emit=lambda ln: log("probes", ln))
    s4 = pbench_s4.run(dev)
    counts = probe_counts()
    log("probes", f"launches over the three entry points: {counts}")
    if not all(counts.values()):
        raise AssertionError(f"probes: a kernel did not launch: {counts}")
    for rec in (s8, s7, s4):
        log("probes", json.dumps(rec))
    if not s8["ok"]:
        raise AssertionError("dma_window: DMA MISMATCH")
    rates = [s7[k] for k in ("shipped",) + pll_ablate.VARIANTS] + [
        s4[k] for k in s4 if k.endswith("_GSps")]
    if not all(np.isfinite(r) and r > 0 for r in rates):
        raise AssertionError(f"probes: a rate is not a positive number")
    for name in ("v2_sel3_fir22", "v3_sel3cat_fir2", "v3_sel3_fir2",
                 "v3_sel3cat_fir22", "v3_sel3cat_fir2_t32k", "p_highest",
                 "p_two_hi"):
        if not s4[f"{name}_rel_err"] <= 2e-5:
            raise AssertionError(f"wbfm_proto {name}: rel_err against K1 "
                                 f"{s4[f'{name}_rel_err']}")

    flag = s8["flagship"]
    nbytes = flag["bytes"]
    s8e = {"name": "window_gather", "route": "cuda",
           "source": "luaradio_tpu_torch/csrc/window.cu",
           "replaces": "scratch/pallas_dma_test.py:13",
           "launches": counts["S8"], "max_abs_err": s8_err, "ms": flag["ms"],
           "plain_ms": None, "bound_ms": flag["bound_ms_at_sheet"],
           "bound_by": "bytes", "library_ms": flag["library_ms"],
           "bound_ms_at_r2": flag["bound_ms_at_r2"],
           "r2_GBps": flag["r2_GBps"], "shape": flag["shape"]}
    x = torch.randn(flag["shape"], generator=gen, device=dev)
    carry = torch.randn((flag["shape"][0], flag["head"]), generator=gen,
                        device=dev)
    s8e["plain_ms"] = median_ms(lambda: window.window_gather_reference(
        x, carry, flag["tile"]), reps=PROBE_REPS)
    del x, carry
    log("probes", f"window_gather {flag['shape']}: {flag['ms']:.4f} ms "
                  f"({flag['GBps']:.1f} GB/s), twin {s8e['plain_ms']:.4f} "
                  f"ms, library {flag['library_ms']:.4f} ms, bound "
                  f"{s8e['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB at "
                  f"3.35 TB/s) and {s8e['bound_ms_at_r2']:.4f} ms at R2's "
                  f"{flag['r2_GBps']:.1f} GB/s; {smi}")

    # S7's bound is the loop-carried chain of `full`: n serial steps at the
    # ns a step its clock64 probe measured in this run (the operations
    # the loop must do one after another); its bytes, 12 a sample, beside
    n = s7["n"]
    ms7 = {v: n / s7[v] / 1e3 for v in pll_ablate.VARIANTS}
    chain_ms = {v: n * s7["chain_probe"][v]["ns_per_step"] / 1e6
                for v in pll_ablate.VARIANTS}
    s7e = {"name": "pll_ablate", "route": "cuda",
           "source": "luaradio_tpu_torch/csrc/pll_ablate.cu",
           "replaces": "scratch/pll_ablate.py:25",
           "launches": counts["S7"], "max_abs_err": s7_err,
           "ms": ms7["full"], "plain_ms": s7_plain["full"],
           "bound_ms": chain_ms["full"], "bound_by": "operations",
           "library_ms": None, "n": n, "plain_n": PROBE_PLL_N,
           "bytes_bound_ms": 1e3 * 12 * n / HBM_BYTES_PER_S,
           "variants": {v: {"ms": ms7[v], "plain_ms_at_plain_n": s7_plain[v],
                            "chain_probe_ms": chain_ms[v],
                            **s7["chain_probe"][v]}
                        for v in pll_ablate.VARIANTS},
           "shipped_k3_ms": n / s7["shipped"] / 1e3}
    s7e["floor_ratio"] = s7e["ms"] / s7e["bound_ms"]
    log("probes", f"pll_ablate full [{n}]: {s7e['ms']:.3f} ms, chain floor "
                  f"{s7e['bound_ms']:.3f} ms ({s7e['floor_ratio']:.3f}x); "
                  f"twin {s7e['plain_ms']:.1f} ms at {PROBE_PLL_N} (host "
                  f"clock); bytes {s7e['bytes_bound_ms']:.5f} ms; {smi}")

    c, t = s4["shape"]
    x, carry, taps = pbench_s4.inputs(dev, c, t)
    name, dp, fp, st, mul = pbench_s4.VARIANTS[0]
    args = (carry, x, taps, 8, 1.0, mul * s4["tile"], 128, dp, fp, st)
    plain_ms = median_ms(lambda: wbfm_proto.wbfm_proto_reference(*args),
                         reps=PROBE_REPS)
    # device time (CUDA-graph replay) of the variant and of K1 on the same
    # input; launches made here are not the entry point's
    dev_ms = graph_ms(lambda: wbfm_proto.wbfm_proto(*args), 5, 5)
    kcarry = torch.zeros((c, taps.shape[0]), dtype=torch.complex64,
                         device=dev)
    k1_dev_ms = graph_ms(lambda: wbfm.wbfm_mono(kcarry, x, taps, 8, 1.0), 5,
                         5)
    issue = pbench_s4.sass_issue_estimate(c, t)
    del x, carry, kcarry
    torch.cuda.empty_cache()
    k = len(pbench_s4.proto_taps())
    nbytes = c * t * 8 + 2 * c * k * 4 * 2 + k * 4 + c * t // 8 * 4
    ops = c * t * DISC_OPS + c * t // 8 * 3 * k * 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    s4e = {"name": "wbfm_proto", "route": "cuda",
           "source": "luaradio_tpu_torch/csrc/wbfm_proto.cu",
           "replaces": "scratch/wbfm_proto.py:82",
           "launches": counts["S4"], "max_abs_err": s4_err,
           "max_scaled_err": s4_scaled,
           "ms": s4[f"{name}_ms"], "plain_ms": plain_ms,
           "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": None, "variant": name, "shape": [c, t],
           "device_ms": dev_ms, "k1_device_ms": k1_dev_ms,
           "issue_bound_ms": issue["issue_bound_ms"],
           "issue_instructions_a_sample": issue["instructions_a_sample"],
           "issue_clock_mhz": issue["clock_mhz"],
           "launch_ms": s4[f"{name}_launch_ms"],
           "k1_ms": s4["prod_ms"],
           "variants_ms": {v[0]: s4[f"{v[0]}_ms"] for v in pbench_s4.VARIANTS},
           "rel_err_vs_k1": {v[0]: s4[f"{v[0]}_rel_err"]
                             for v in pbench_s4.VARIANTS if v[3] == "full"}}
    log("probes", f"wbfm_proto {name} [{c} x {t}]: {s4e['ms']:.4f} ms "
                  f"back to back, {dev_ms:.4f} ms device, "
                  f"{s4e['launch_ms']:.4f} ms a launch; twin {plain_ms:.4f} "
                  f"ms; K1 {s4['prod_ms']:.4f} ms back to back, "
                  f"{k1_dev_ms:.4f} ms device; bound {s4e['bound_ms']:.4f} "
                  f"ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s; {ops / 1e9:.2f} "
                  f"Gop at 67 TFLOP/s), issue slots "
                  f"{issue['issue_bound_ms']:.4f} ms "
                  f"({issue['instructions_a_sample']:.0f} instructions a "
                  f"sample at {issue['clock_mhz']:.0f} MHz); holds "
                  f"{t_hold:.1f} s, phase {time.monotonic() - t_start:.1f} "
                  f"s; {smi}")
    torch.cuda.empty_cache()
    return [s4e, s7e, s8e]


def _close_scaled(label, got, exp, tol):
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    scale = max(1.0, float(np.max(np.abs(exp))))
    err = float(np.max(np.abs(got - exp))) if got.shape == exp.shape \
        else None
    if err is None or err > tol * scale:
        raise AssertionError(f"{label}: {got.shape} vs {exp.shape}, max "
                             f"|card - cpu| {err} (limit {tol} * {scale})")
    return err


def phase_entries(tmp, dev, smi, k1):
    """The measurement entry points (benchmarks/) on the card, each held
    as its CPU test holds it: bench (every row ran, the resident row made
    no host-to-device copy; K1's launches counted), bench_scaling up to 8
    shards (each mesh's audio within 1e-6 of one shard's),
    bench_realtime paced for REALTIME_S s (ok: no overflow after the
    grace, flat latency, margin > 1; every sample accounted for),
    MH_SCENARIOS of bench_multihost in one spawn (each as its serial
    run), entry() (the step within 2e-5 * scale of the same step on the
    CPU) and dryrun_multichip(8) (the CPU run's shapes), and the four new
    examples at a small size against the same module on the CPU."""
    from luaradio_tpu_torch.benchmarks import (bench_multihost,
                                               bench_realtime, bench_scaling,
                                               entry)
    out = {}
    wbfm.wbfm_mono.launches = 0
    rec = pbench.run(dev, budget=ENTRY_BUDGET_S)
    k1["bench_path_launches"] = wbfm.wbfm_mono.launches
    rates = [rec.get(k) for k in ("value", "runner_samples_per_sec",
                                  "file_driven_samples_per_sec",
                                  "file_resident_samples_per_sec",
                                  "h2d_pageable_MBps")]
    if not rec.get("ok") or not all(r and np.isfinite(r) and r > 0
                                    for r in rates) \
            or rec["file_resident_h2d_copies"] or not k1["bench_path_launches"]:
        raise AssertionError(f"entries bench: {rec}, K1 launches "
                             f"{k1['bench_path_launches']}")
    out["bench"] = rec
    log("entries", "bench " + json.dumps(rec))

    lines = []
    summary = bench_scaling.run(8, emit=lines.append, device=dev)
    if any(r["max_abs_err_vs_single"] > 1e-6 for r in summary["results"]):
        raise AssertionError(f"entries bench_scaling: {summary}")
    generic = bench_scaling.run_generic(8, emit=lines.append, device=dev)
    out["scaling"] = {"bank": summary["results"], "generic": generic}
    for ln in lines:
        log("entries", "bench_scaling " + ln)

    rt = bench_realtime.run_realtime(duration=REALTIME_S, device=dev)
    left = rt["delivered_rf_samples"] - rt["dropped_rf_samples"] \
        - 50 * rt["audio_samples_out"]
    if not rt["ok"] or not 0 <= left < 50:
        raise AssertionError(f"entries bench_realtime: {rt}")
    out["realtime"] = rt
    log("entries", "bench_realtime " + json.dumps(rt))

    t0 = time.monotonic()
    mh = bench_multihost.run(MH_SCENARIOS, tmpdir=tmp, device=dev)
    if not all(r["ok"] for r in mh):
        raise AssertionError(f"entries bench_multihost: {mh}")
    out["multihost"] = mh
    log("entries", f"bench_multihost {json.dumps(mh)} "
                   f"({time.monotonic() - t0:.1f} s)")

    step, (state, x) = entry.entry(dev)
    audio = step(state, x)[1]
    cstep, (cstate, cx) = entry.entry("cpu")
    err = _close_scaled("entries entry()", audio.cpu(), cstep(cstate, cx)[1],
                        2e-5)
    dry, cdry = entry.dryrun_multichip(8, dev), entry.dryrun_multichip(
        8, "cpu")
    if dry != cdry:
        raise AssertionError(f"entries dryrun_multichip: {dry} vs {cdry}")
    out["entry"] = {"audio": list(audio.shape), "max_abs_err_vs_cpu": err,
                    "dryrun_multichip": dry}
    log("entries", f"entry(): audio {tuple(audio.shape)} within {err:.3g} "
                   f"of the CPU step; dryrun_multichip(8): {json.dumps(dry)}")
    out["examples"] = phase_new_examples(tmp, dev)
    log("entries", f"{smi}")
    return out


def phase_new_examples(tmp, dev):
    """iqfile_converter (u8, s16le and f32le inputs, each output's bytes
    equal to the CPU run's), iqfile_wbfm_stereo over 0.25 s of a stereo
    station 250 kHz up (L+R within 2 LSB of the CPU run, each channel's
    tone > 3x the other's), channel_bank_pod (64 channels, 4 chunks,
    within 2e-4 * scale of the CPU) and wideband_channelizer_bank (its
    synthesized capture, within 2e-4 * scale of the CPU, channels 1, 3
    and 7 among the four loudest)."""
    from luaradio_tpu_torch.examples import (channel_bank_pod,
                                             iqfile_converter,
                                             iqfile_wbfm_stereo,
                                             wideband_channelizer_bank)
    cpu = torch.device("cpu")
    rng = np.random.default_rng(31)
    out = {}
    for fmt, raw in (("u8", rng.integers(0, 256, 8192).astype(np.uint8)),
                     ("s16le", rng.integers(-32768, 32768, 8192).astype(
                         "<i2")),
                     ("f32le", rng.standard_normal(8192).astype("<f4"))):
        src = os.path.join(tmp, f"conv.{fmt}")
        raw.tofile(src)
        got = {}
        for key, d in (("card", dev), ("cpu", cpu)):
            dst = os.path.join(tmp, f"conv.{fmt}.{key}")
            target = "f32le" if fmt != "f32le" else "s16le"
            iqfile_converter.build(src, fmt, dst, target).run(device=d)
            with open(dst, "rb") as f:
                got[key] = f.read()
        if got["card"] != got["cpu"] or not got["card"]:
            raise AssertionError(f"iqfile_converter {fmt}: the card's bytes "
                                 f"differ from the CPU's")
    out["iqfile_converter"] = "bytes equal to the CPU run (u8, s16le, f32le)"

    n = int(RATE * 0.25)
    t = np.arange(n) / RATE
    left = 0.4 * np.sin(2 * np.pi * TONE_L * t)
    right = 0.4 * np.sin(2 * np.pi * TONE_R * t)
    mpx = (left + right) + 0.1 * np.cos(2 * np.pi * 19e3 * t) \
        + (left - right) * np.cos(2 * np.pi * 38e3 * t)
    z = np.exp(1j * (2 * np.pi * 75e3 * np.cumsum(mpx) / RATE
                     + 2 * np.pi * 250e3 * t)).astype(np.complex64)
    cap = os.path.join(tmp, "stereo_example.iq")
    z.tofile(cap)
    pcm = {}
    for key, d in (("card", dev), ("cpu", cpu)):
        wav = os.path.join(tmp, f"stereo_example.{key}.wav")
        iqfile_wbfm_stereo.build(cap, wav).run(device=d)
        with wave.open(wav) as w:
            pcm[key] = np.frombuffer(w.readframes(w.getnframes()),
                                     np.int16).reshape(-1, 2).astype(
                                         np.int64)
    g, c = pcm["card"], pcm["cpu"]
    sum_err = int(np.max(np.abs(g.sum(1) - c.sum(1)))) \
        if g.shape == c.shape else None

    def tone(ch, f):
        seg = g[4096:8192, ch] / 32767.5
        spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
        i = int(round(f * len(seg) / 44100))
        return spec[max(0, i - 2):i + 3].max()
    if sum_err is None or sum_err > 2 or tone(0, TONE_L) <= 3 * tone(
            0, TONE_R) or tone(1, TONE_R) <= 3 * tone(1, TONE_L):
        raise AssertionError(f"iqfile_wbfm_stereo: {g.shape} vs {c.shape}, "
                             f"L+R off by {sum_err} LSB")
    out["iqfile_wbfm_stereo"] = {"frames": len(g), "sum_lsb": sum_err}

    audio = [torch.cat(channel_bank_pod.run(1, d, emit=lambda _: None),
                       -1).cpu() for d in (dev, cpu)]
    out["channel_bank_pod"] = _close_scaled("channel_bank_pod", *audio, 2e-4)

    cap = os.path.join(tmp, "wideband.iq")
    wideband_channelizer_bank.synth_capture(cap)
    wb = [wideband_channelizer_bank.run(cap, device=d) for d in (dev, cpu)]
    err = _close_scaled("wideband_channelizer_bank", *wb, 2e-4)
    rms = np.sqrt((wb[0] ** 2).mean(axis=-1))
    top = {int(i) for i in np.argsort(rms)[::-1][:4]}
    if not {1, 3, 7} <= top:
        raise AssertionError(f"wideband_channelizer_bank: loudest {top}")
    out["wideband_channelizer_bank"] = err
    log("entries", f"examples: {json.dumps(out)}")
    return out


def profile_run(run, out, what):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    events = prof.key_averages()
    dms = device_ms(prof)
    table = events.table(sort_by=_device_key(events), row_limit=30)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        f.write(table)
    log("profile", f"{what} under torch.profiler: run {wall:.4f} s "
                   f"(profiler overhead included), device time "
                   f"{dms:.3f} ms ({100 * dms / 1e3 / wall:.1f}"
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
    if argv[:1] == ["--multihost-worker"]:
        mh_worker(int(argv[1]), argv[2])
        return 0
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
    built = cudabuild.build(cudabuild.SOURCES + ("wbfm_parts",))
    for src, (secs, out) in built.items():
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        log("build", f"{src} in {secs:.2f} s: {'; '.join(regs)}")
    log("build", f"all kernels ready in {time.monotonic() - t0:.2f} s")
    t0 = time.monotonic()
    log("build", f"native/src/format_conv.c (the host wire conversions) "
                 f"{'built' if native.available() else 'not built: numpy'}"
                 f" in {time.monotonic() - t0:.2f} s")

    gen = torch.Generator(device=dev).manual_seed(1234)
    rfl = phase_roofline(dev, gen, smi)
    probes = phase_probes(dev, gen, smi)
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
        k3_launches, chunk, (overlap_launches, path_err) = phase_stereo(
            tmp, profile)
    k3 = phase_pll_time(dev, gen, chunk)
    k3["launches"] = k3_launches
    k3["max_abs_err"] = max(k3["max_abs_err"], k3_err)
    overlap = phase_overlap_hold(dev, gen, chunk)
    overlap["launches"] = overlap_launches
    overlap["max_abs_err"] = max(overlap["max_abs_err"], path_err)
    with tempfile.TemporaryDirectory() as tmp:
        am = phase_am(tmp, dev, profile)
    k3["am_path"] = time_k3_am(am, dev)
    k3["max_abs_err"] = max(k3["max_abs_err"], am["max_abs_err"])
    del am
    with tempfile.TemporaryDirectory() as tmp:
        phase_analog(tmp, dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_bench_graphs(tmp, dev, smi, profile)
    with tempfile.TemporaryDirectory() as tmp:
        rds = phase_rds(tmp, dev, profile)
        phase_digital_others(tmp, dev)
    k3["rds_path"] = time_k3_rds(rds, dev, k3["chain_ns_per_step"])
    k3["max_abs_err"] = max(k3["max_abs_err"], rds["max_abs_err"])
    overlap["rds_path_launches"] = rds["overlap_launches"]
    overlap["max_abs_err"] = max(overlap["max_abs_err"], rds["overlap_err"])
    rds_packets = rds["packets"]
    del rds
    pfb = phase_channelizer(dev, gen, smi)
    with tempfile.TemporaryDirectory() as tmp:
        pll_lin = phase_pll_linear(tmp, dev, gen, smi)
    with tempfile.TemporaryDirectory() as tmp:
        mono = phase_bank_mono(tmp, dev, profile)
    # the kernel's launches on the bank-mono path, one a chunk
    pfb["launches"] = mono.pop("pfb_launches")
    k2["bank_mono_path"] = mono
    k2["max_abs_err"] = max(k2["max_abs_err"], mono["max_abs_err"])
    with tempfile.TemporaryDirectory() as tmp:
        st = phase_bank_stereo(tmp, dev, profile)
    timing = phase_bank_timing(dev, gen, k3["chain_ns_per_step"],
                               overlap["chain_floor_ns_per_step"])
    k3["bank_stereo_path"] = {
        "launches": st["launches"], "rows": st["rows"], "chunk": ST_CHUNK,
        "plain_ms_4_rows": st["twin_ms_4_rows"],
        "batched": {c: {k: v for k, v in r.items() if k.startswith("k3")}
                    for c, r in timing.items()}}
    k3["max_abs_err"] = max(k3["max_abs_err"], st["max_abs_err"])
    overlap["bank_stereo_path"] = {
        "launches": st["scan_launches"], "rows": st["scan_rows"],
        "chunk": ST_SCAN_CHUNK,
        "plain_ms_4_rows": st["scan_plain_ms_4_rows"],
        "batched": {c: {k: v for k, v in r.items() if k.startswith("scan")}
                    for c, r in timing.items()}}
    overlap["max_abs_err"] = max(overlap["max_abs_err"], st["scan_err"])
    overlap["bank_264_vs_one_row"] = timing[BATCH_ROWS[-1]]["scan_ratio"]
    classes = phase_bank_classes(dev, gen)
    with tempfile.TemporaryDirectory() as tmp:
        host_sps = phase_bank_host(tmp, dev)
    with tempfile.TemporaryDirectory() as tmp:
        pinned = phase_bank_pinned(tmp, dev)
    log("bank", json.dumps({"bank_mono_sps": mono["sps"],
                            "bank_pinned": pinned,
                            "bank_mono_k2_sps": mono["k2_sps"],
                            "bank_stereo_sps": st["sps"],
                            "bank_host_sps": host_sps,
                            "classes_sps": {k: v["sps"]
                                            for k, v in classes.items()}}))
    with tempfile.TemporaryDirectory() as tmp:
        blocks = phase_blocks(tmp, dev, smi, k3["chain_ns_per_step"])
    k3["blocks_path"] = {"launches": blocks["k3_launches"],
                         "max_abs_err": blocks["k3_err"],
                         "alone_2_22": blocks["k3_alone"]}
    k3["max_abs_err"] = max(k3["max_abs_err"], blocks["k3_err"])
    overlap["blocks_path"] = {"launches": blocks["scan_launches"],
                              "max_abs_err": blocks["scan_err"],
                              "alone_2_22": blocks["scan_alone"]}
    overlap["floor_ratio_2_22"] = blocks["scan_alone"]["floor_ratio"]
    overlap["max_abs_err"] = max(overlap["max_abs_err"], blocks["scan_err"])
    fir_fft = phase_fir_fft(dev, gen, smi)
    with tempfile.TemporaryDirectory() as tmp:
        k2["roundtrip_path"] = phase_roundtrip(tmp, dev)
    k2["max_abs_err"] = max(k2["max_abs_err"],
                            k2["roundtrip_path"]["max_abs_err"])
    with tempfile.TemporaryDirectory() as tmp:
        phase_eager(tmp, dev)
    k3["newton_path"] = phase_newton(dev)
    k3["max_abs_err"] = max(k3["max_abs_err"],
                            k3["newton_path"]["max_abs_err"])
    wire_errs = phase_io_wire(dev)
    with tempfile.TemporaryDirectory() as tmp:
        paths, n, rds_path, sent, wires = live_captures(tmp)
        live = phase_live(dev, wires, sent)
        del wires
        net = phase_net(tmp, dev, paths, n, rds_path, rds_packets)
        phase_plot_tx(tmp, dev)
        tsh, serial_audio = phase_time(tmp, dev, smi, paths, rds_path, sent,
                                       rds_packets)
        mh = phase_multihost(tmp, dev, paths, serial_audio)
        emb = phase_embed(tmp, dev)
    for e, key in ((k1, "K1"), (k2, "K2"), (k3, "K3")):
        e["time_path_launches"] = tsh["launches"][key]
        e["multihost_path_launches"] = [c[key] for c in mh["launches"]]
    log("time", json.dumps({"device": smi, **{k: v for k, v in tsh.items()
                                              if k != "launches"},
                            "multihost": {k: v for k, v in mh.items()
                                          if k != "launches"},
                            "embed": emb}))
    k3["live_path"] = {f"rtlsdr_{k}": live[k]["k3_launches"]
                       for k in ("am_synchronous", "rds")}
    overlap["live_path"] = {f"rtlsdr_{k}": live[k]["scan_launches"]
                            for k in ("am_synchronous", "rds")}
    log("io", json.dumps({"device": smi, "wire_max_abs_err": wire_errs,
                          "live": {k: {x: v[x] for x in (
                              "wall_over_capture", "wall_s", "busy",
                              "k3_launches", "scan_launches")}
                              for k, v in live.items()},
                          "net_sps": net}))
    log("fir-fft", json.dumps({"device": smi, **fir_fft}))
    with tempfile.TemporaryDirectory() as tmp:
        phase_entries(tmp, dev, smi, k1)
    if ChannelizerBlock.stock_chunks:
        raise AssertionError(f"{ChannelizerBlock.stock_chunks} channelizer "
                             f"chunks ran on the stock path")
    entries = [k1, k2, k3, overlap, pfb, pll_lin] + rfl + probes
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
