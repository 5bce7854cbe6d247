"""The digital receivers' blocks and the masked Sampler boundary of the
port against the JAX package on the same numpy inputs: SamplerBlock,
SlicerBlock and DifferentialDecoderBlock (device and host mode),
ManchesterDecoderBlock, PreambleSamplerBlock, the zero-crossing clock
recovery, the binary phase corrector, the root-raised-cosine and
matched filters, cummax_blocked, the protocol framers and decoders, the
print and JSON sinks, and the runtime's masked device -> host boundary
(compaction after the copy, the last chunk's padding, dual-block
demotion, the optimizer's chains).

Decisions on a threshold (the Sampler's and the clock recovery's
hysteresis, the clock's pulse counts by ceil, the Slicer) are held
exactly: a sample within rounding of a threshold would flip a bit, and
the test then names the first sample that parted.
"""

import io
import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu.ops.scan import cummax_blocked as jax_cummax  # noqa: E402
from luaradio_tpu_torch.core import optimize as port_optimize  # noqa: E402
from luaradio_tpu_torch.core.composite import Graph  # noqa: E402
from luaradio_tpu_torch.ops.scan import cummax_blocked  # noqa: E402
from tests.blocks.test_protocol import (ax25_encode, hdlc_stuff,  # noqa: E402
                                        pocsag_encode_codeword,
                                        rds_encode_group, scm_encode)


def _setup(mod, block, types, rate=48000.0):
    if mod is tl:
        block.device = torch.device("cpu")
    block.differentiate(types)
    block.input_rate = rate
    block.initialize()
    return block


def _device_run(mod, block, inputs, splits, rate=48000.0):
    """A device block over ``inputs`` (numpy arrays), in the pieces
    np.split(.., splits) gives, with its state carried.  Returns the list
    of per-piece outputs (each a numpy array, or a (values, mask) pair)
    and the block."""
    types = [mod.ComplexFloat32 if np.iscomplexobj(x) else
             (mod.Bit if x.dtype == np.uint8 else mod.Float32)
             for x in inputs]
    blk = _setup(mod, block, types, rate)
    st = blk.init_state()
    process = jax.jit(blk.process) if mod is jl else blk.process
    conv = jnp.asarray if mod is jl else torch.from_numpy
    outs = []
    for parts in zip(*(np.split(x, splits) for x in inputs)):
        st, y = process(st, *(conv(np.ascontiguousarray(p)) for p in parts))
        outs.append(tuple(np.asarray(v) for v in y) if isinstance(y, tuple)
                    else np.asarray(y))
    return outs, blk


def _first_parting(got, exp):
    d = np.flatnonzero(got != exp)
    return (f"first parting at sample {d[0]}: port {got[d[0]]}, JAX "
            f"{exp[d[0]]}") if len(d) else "equal"


def _compact(outs):
    return np.concatenate([v[m] for v, m in outs])


def _nrz(seed, n, sps, noise=0.05, zeros=0):
    """A random +-1 NRZ stream at ``sps`` samples a symbol through a short
    moving average, with Gaussian noise and ``zeros`` samples set to
    exactly 0 (the comparators' hold)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, n // int(sps) + 2) * 2.0 - 1.0
    idx = (np.arange(n) / sps).astype(int)
    x = np.convolve(bits[idx], np.ones(5) / 5, mode="same")
    x = x + noise * rng.standard_normal(n)
    if zeros:
        x[rng.choice(n, zeros, replace=False)] = 0.0
    return x.astype(np.float32)


SPLITS = [1, [700, 1500, 1501, 3000]]


# -- SamplerBlock -------------------------------------------------------------

@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("kind", ["complex", "float"])
def test_sampler_matches_jax(kind, splits):
    """The compacted output and the mask exactly, whole and split (the
    hysteresis state carried), on a clock with exact zeros (holds)."""
    rng = np.random.default_rng(3)
    n = 4096
    clock = _nrz(4, n, 8.0, zeros=200)
    data = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ).astype(np.complex64)
    if kind == "float":
        data = data.real.copy()
    exp, _ = _device_run(jl, jl.SamplerBlock(), [data, clock], 1)
    got, _ = _device_run(tl, tl.SamplerBlock(), [data, clock], splits)
    m_exp, m_got = exp[0][1], np.concatenate([m for _, m in got])
    assert m_got.dtype == np.bool_ and m_got.sum() > 100
    assert np.array_equal(m_got, m_exp), _first_parting(m_got, m_exp)
    assert np.array_equal(_compact(got), _compact(exp))


# -- SlicerBlock, DifferentialDecoderBlock: device and host mode ---------------

@pytest.mark.parametrize("host", [False, True])
@pytest.mark.parametrize("threshold", [0.0, 0.25])
def test_slicer_matches_jax(threshold, host):
    x = _nrz(5, 4096, 6.0, zeros=100)
    x[::97] = np.float32(threshold)                 # on the threshold
    exp, _ = _device_run(jl, jl.SlicerBlock(threshold), [x], 1)
    if host:
        blk = _setup(tl, tl.SlicerBlock(threshold), [tl.Float32])
        got = np.concatenate([blk.process_host(p)
                              for p in np.split(x, SPLITS[1])])
    else:
        got = np.concatenate(_device_run(tl, tl.SlicerBlock(threshold), [x],
                                         SPLITS[1])[0])
    assert got.dtype == np.uint8
    assert np.array_equal(got, exp[0]), _first_parting(got, exp[0])


@pytest.mark.parametrize("host", [False, True])
@pytest.mark.parametrize("invert", [False, True])
def test_differential_decoder_matches_jax(invert, host):
    bits = np.random.default_rng(6).integers(0, 2, 4096).astype(np.uint8)
    exp, _ = _device_run(jl, jl.DifferentialDecoderBlock(invert), [bits], 1)
    if host:
        blk = _setup(tl, tl.DifferentialDecoderBlock(invert), [tl.Bit])
        got = np.concatenate([blk.process_host(p)
                              for p in np.split(bits, SPLITS[1])])
        jblk = _setup(jl, jl.DifferentialDecoderBlock(invert), [jl.Bit])
        jhost = np.concatenate([jblk.process_host(p)
                                for p in np.split(bits, SPLITS[1])])
        assert np.array_equal(jhost, exp[0])
    else:
        got = np.concatenate(_device_run(
            tl, tl.DifferentialDecoderBlock(invert), [bits], SPLITS[1])[0])
    assert got.dtype == np.uint8
    assert np.array_equal(got, exp[0])


# -- host blocks -----------------------------------------------------------------

def _host_run(mod, block, types, x, splits, rate=48000.0):
    blk = _setup(mod, block, types, rate)
    return [blk.process(p) for p in np.split(x, splits)]


@pytest.mark.parametrize("invert", [False, True])
def test_manchester_decoder_matches_jax(invert):
    """Chips with a dropped chip (a clock slip) and a run of equal chips,
    split at odd places, against JAX's block run whole."""
    bits = np.random.default_rng(7).integers(0, 2, 600).astype(np.uint8)
    enc = np.zeros(1200, np.uint8)
    enc[0::2], enc[1::2] = bits, 1 - bits
    enc = np.concatenate([enc[:401], enc[402:], np.ones(5, np.uint8)])
    exp = _host_run(jl, jl.ManchesterDecoderBlock(invert), [jl.Bit], enc, 1)
    got = _host_run(tl, tl.ManchesterDecoderBlock(invert), [tl.Bit], enc,
                    [33, 100, 217, 218, 999])
    assert np.array_equal(np.concatenate(got), exp[0])
    assert len(exp[0]) > 550


def test_preamble_sampler_matches_jax():
    """Two frames in noise at 8.5 samples a symbol (the floor of the period
    is 8), split where a frame is in flight."""
    rate, baud = 8.5, 1.0
    rng = np.random.default_rng(8)
    preamble = np.array([1, 0, 1, 0, 1, 1, 0, 0, 1, 1, 1, 0, 1, 0, 0, 1],
                        np.uint8)
    parts = [0.1 * rng.standard_normal(257)]
    for _ in range(2):
        frame = np.concatenate([preamble, rng.integers(0, 2, 24)])
        parts += [np.repeat(frame * 2.0 - 1.0, 8),
                  0.1 * rng.standard_normal(199)]
    x = np.concatenate(parts).astype(np.float32)
    make = (lambda m: m.PreambleSamplerBlock(baud, preamble, 40))
    exp = _host_run(jl, make(jl), [jl.Float32], x, 1, rate)
    got = _host_run(tl, make(tl), [tl.Float32], x, [100, 300, 301, 620],
                    rate)
    assert np.array_equal(np.concatenate(got), exp[0])
    assert len(exp[0]) >= 80


# -- clock recovery and phase corrector -----------------------------------------

def _zc_closed_form(x, period, threshold=0.0):
    """The clock recovery's closed form (the JAX package's carrier.py,
    ZeroCrossingClockRecoveryBlock.process) on one chunk from the initial
    state, in float64 on the host."""
    n = len(x)
    s, prev, out = -1.0, -1.0, np.zeros(n)
    c, has = -1.0, False
    cross = np.zeros(n, bool)
    for i, v in enumerate(x.astype(np.float64)):
        raw = 1.0 if v > threshold else (-1.0 if v < threshold else 0.0)
        s = s if raw == 0.0 else raw
        cross[i] = s != prev and raw != 0.0
        prev = s
    idx = np.arange(n, dtype=np.float64)
    c = np.maximum.accumulate(np.where(cross, idx, -1.0))
    has = c >= 0
    k = idx - c + 1.0
    m = np.where(has, np.maximum(np.ceil((k + 1.0 - period / 2) / period), 0),
                 np.maximum(np.ceil((idx + 2.0 - period) / period), 0))
    m_prev = np.concatenate([[0.0], m[:-1]])
    m_prev[cross] = 0.0
    out[:] = np.where(m > m_prev, 1.0, -1.0)
    return out


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("rate,baud", [(48000.0, 1200.0), (12528.0, 1200.0),
                                       (275625.0, 2375.0)])
def test_clock_recovery_matches_jax(rate, baud, splits):
    """Pulse positions exactly, whole and split (hysteresis and offset
    carried), at an integer period and at the fractional ones of rx_pocsag
    (10.44) and RDS (116.05).  Both are held to the float64 closed form
    on the whole chunk too: a pulse count within rounding of an integer
    would name its sample here."""
    x = _nrz(9, 6000, rate / baud, zeros=60)
    exp, jb = _device_run(jl, jl.ZeroCrossingClockRecoveryBlock(baud), [x],
                          1, rate)
    got, tb = _device_run(tl, tl.ZeroCrossingClockRecoveryBlock(baud), [x],
                          splits, rate)
    got = np.concatenate(got)
    assert tb._period == jb._period
    assert np.array_equal(got, exp[0]), _first_parting(got, exp[0])
    oracle = _zc_closed_form(x, float(jb._period))
    assert np.array_equal(exp[0], oracle), _first_parting(exp[0], oracle)
    assert (got > 0).sum() >= 6000 / (rate / baud) - 2


def test_clock_recovery_state_is_hysteresis_and_offset():
    x = _nrz(10, 1000, 40.0)
    js, ts = None, None
    for mod in (jl, tl):
        blk = _setup(mod, mod.ZeroCrossingClockRecoveryBlock(1200.0),
                     [mod.Float32])
        st = blk.init_state()
        conv = jnp.asarray if mod is jl else torch.from_numpy
        process = jax.jit(blk.process) if mod is jl else blk.process
        st, _ = process(st, conv(x))
        if mod is jl:
            js = [float(v) for v in st]
        else:
            ts = [float(v) for v in st]
    assert ts == js


@pytest.mark.parametrize("splits", [1, [1024, 2048, 4064]])
@pytest.mark.parametrize("num,interval", [(32, 32), (50, 32), (8000, 32)])
def test_phase_corrector_matches_jax(num, interval, splits):
    """Splits at multiples of the sample interval (the block's chunk
    multiple).  The correction angle exp(-j ma) agrees within 1e-6 rad
    (the two packages' angles and float32 cumulative sums of up to
    8000 + k folded phases round differently; measured up to 3.1e-7 here),
    the output within 2e-6 * |x|."""
    rng = np.random.default_rng(11)
    n = 8192
    bits = rng.integers(0, 2, n // 16 + 1) * 2 - 1
    ph = 0.4 + np.cumsum(1e-4 * rng.standard_normal(n))
    x = (np.repeat(bits, 16)[:n] * np.exp(1j * ph)
         + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    exp, _ = _device_run(jl, jl.BinaryPhaseCorrectorBlock(num, interval),
                         [x], 1)
    got, _ = _device_run(tl, tl.BinaryPhaseCorrectorBlock(num, interval),
                         [x], splits)
    got = np.concatenate(got)
    assert got.dtype == np.complex64
    rot_j = exp[0].astype(np.complex128) / x
    rot_p = got.astype(np.complex128) / x
    assert np.max(np.abs(np.angle(rot_p * np.conj(rot_j)))) < 1e-6
    assert np.max(np.abs(got - exp[0]) / np.abs(x)) < 2e-6
    if num < n // interval:           # the window fills: the offset is gone
        assert np.median(np.abs(np.angle(got[-1000:] ** 2))) < 0.2


def test_phase_corrector_chunk_multiple_in_rds_graph():
    """The planner makes the RDS graph's source chunk a multiple of the
    phase corrector's 32 times the tuner's decimation."""
    top = tl.CompositeBlock()
    src = _array_source(tl, np.zeros(16, np.complex64), 1102500.0)
    tuner = tl.TunerBlock(0.0, 200e3, 4)
    rx = tl.RDSReceiver()
    top.connect(src, tuner, rx, _collector(tl))
    g = Graph(top, chunk_size=100000, device="cpu")
    pc = next(b for b in g.order
              if isinstance(b, tl.BinaryPhaseCorrectorBlock))
    assert g.out_chunk[id(src)] % (32 * 4) == 0
    assert g.in_chunk[id(pc)] % 32 == 0


# -- filters --------------------------------------------------------------------

FILTERS = {
    "rrc_rds": (lambda m: m.RootRaisedCosineFilterBlock(101, 1, 1187.5),
                "complex", 275625.0),
    "rrc_bpsk31": (lambda m: m.RootRaisedCosineFilterBlock(101, 1, 31.25),
                   "complex", 8000.0),
    "rrc_half": (lambda m: m.RootRaisedCosineFilterBlock(63, 0.5, 4800.0),
                 "float", 48000.0),
    "pulse_matched": (lambda m: m.PulseMatchedFilterBlock(1200.0), "float",
                      48000.0),
    "pulse_matched_inv": (lambda m: m.PulseMatchedFilterBlock(
        1200.0, invert=True), "float", 50000.0),
    "manchester_matched": (lambda m: m.ManchesterMatchedFilterBlock(32768),
                           "float", 393216.0),
    "manchester_matched_inv": (lambda m: m.ManchesterMatchedFilterBlock(
        4800.0, invert=True), "complex", 50000.0),
}


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filter_matches_jax(name, splits):
    """The taps exactly (the same float64 design), the outputs at the
    FIR tolerance of tests/test_torch_am.py (2e-5 * scale)."""
    factory, kind, rate = FILTERS[name]
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal(4096)
    if kind == "complex":
        x = x + 1j * rng.standard_normal(4096)
    x = x.astype(np.complex64 if kind == "complex" else np.float32)
    exp, jb = _device_run(jl, factory(jl), [x], 1, rate)
    got, tb = _device_run(tl, factory(tl), [x], splits, rate)
    assert tb.taps.dtype == np.float32
    assert np.array_equal(tb.taps, np.asarray(jb.taps))
    got = np.concatenate(got)
    assert got.dtype == exp[0].dtype
    scale = max(1.0, float(np.max(np.abs(exp[0]))))
    assert np.max(np.abs(got - exp[0])) < 2e-5 * scale


@pytest.mark.parametrize("n", [5, 1000, 1024, 4096, 5000])
def test_cummax_blocked_matches_jax(n):
    rng = np.random.default_rng(n)
    x = np.where(rng.random((2, n)) < 0.05, np.arange(n, dtype=np.float32),
                 -1.0).astype(np.float32)
    got = cummax_blocked(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(jax_cummax(jnp.asarray(x))))


# -- protocol blocks --------------------------------------------------------------

def _frames_json(frames):
    return [f.to_json() for f in frames]


def _both(name, types, stream, splits, *args):
    """The block ``name`` of each package over the stream (the port's in
    pieces); the two lists of objects."""
    out = {}
    for mod in (jl, tl):
        blk = _setup(mod, getattr(mod, name)(*args),
                     [getattr(mod, t) if isinstance(t, str) else t(mod)
                      for t in types])
        pieces = np.split(stream, splits if mod is tl else 1)
        out[mod] = [o for p in pieces for o in blk.process(p)]
    return out[tl], out[jl]


def test_rds_framer_and_decoder_match_jax():
    """Noise, four groups with a correctable error, then the decoder over
    basic tuning, radiotext, date/time and raw groups."""
    rng = np.random.default_rng(17)
    groups = [tuple(int(v) for v in rng.integers(0, 1 << 16, 4))
              for _ in range(4)]
    bits = np.concatenate([rng.integers(0, 2, 37).astype(np.uint8)]
                          + [rds_encode_group(g) for g in groups])
    bits[37 + 104 + 50] ^= 1
    got, exp = _both("RDSFramerBlock", ["Bit"], bits, [100, 150, 300])
    assert [f.blocks for f in got] == groups
    assert _frames_json(got) == _frames_json(exp)
    b1 = (0 << 12) | (1 << 10) | (7 << 5) | (1 << 4) | 2
    words = [(0x1234, b1, 0xE0F1, (ord("A") << 8) | ord("B")),
             (0x1234, (2 << 12) | 3, (ord("W") << 8) | ord("X"),
              (ord("Y") << 8) | ord("Z")),
             (0x1234, 4 << 12, (57483 & 0x7FFF) << 1, (1 << 12) | (2 << 6)),
             groups[0]]
    pk = {}
    for mod in (jl, tl):
        dec = _setup(mod, mod.RDSDecoderBlock(),
                     [mod.RDSFramerBlock.RDSFrameType])
        pk[mod] = dec.process([mod.RDSFrame(w) for w in words])
    assert _frames_json(pk[tl]) == _frames_json(pk[jl])
    assert [p.data["type"] for p in pk[tl]] == ["basictuning", "radiotext",
                                                "datetime", "raw"]


def test_pocsag_framer_and_decoder_match_jax():
    from luaradio_tpu.blocks.protocol.pocsag import (
        POCSAG_FRAME_SYNC_CODEWORD, POCSAG_IDLE_CODEWORD)
    address = 0x12342
    text_bits = []
    for ch in "HI" + chr(0x17):
        text_bits.extend((ord(ch) >> i) & 1 for i in range(7))
    while len(text_bits) % 20:
        text_bits.append(1)
    words = [int("".join(map(str, text_bits[i:i + 20])), 2)
             for i in range(0, len(text_bits), 20)]
    batch, left, placed = [], list(words), False
    for j in range(16):
        if not placed and j >> 1 == (address & 0x7):
            batch.append(pocsag_encode_codeword(((address >> 3) << 2) | 2))
            placed = True
        elif placed and left:
            batch.append(pocsag_encode_codeword((1 << 20) | left.pop(0)))
        else:
            batch.append(POCSAG_IDLE_CODEWORD)
    n2b = tl.types.number_to_bits
    stream = np.concatenate(
        [np.random.default_rng(23).integers(0, 2, 23).astype(np.uint8),
         n2b(POCSAG_FRAME_SYNC_CODEWORD, 32)]
        + [n2b(cw, 32) for cw in batch]
        + [n2b(POCSAG_FRAME_SYNC_CODEWORD, 32)]
        + [n2b(POCSAG_IDLE_CODEWORD, 32)] * 16)
    stream[23 + 32 + 5 * 32 + 7] ^= 1        # a correctable error
    got, exp = _both("POCSAGFramerBlock", ["Bit"], stream, [100, 400, 700])
    assert len(got) == 1 and got[0].address == address
    assert got[0].data == words
    assert _frames_json(got) == _frames_json(exp)
    msgs = {}
    for mod in (jl, tl):
        dec = _setup(mod, mod.POCSAGDecoderBlock("both"),
                     [mod.POCSAGFramerBlock.POCSAGFrameType])
        msgs[mod] = dec.process(got if mod is tl else exp)
    assert _frames_json(msgs[tl]) == _frames_json(msgs[jl])
    assert msgs[tl][0].alphanumeric == "HI"


def test_ax25_framer_matches_jax():
    frame_bits = ax25_encode([("APRS", 0x30), ("KD2BMH", 0x3A)], 0x03, 0xF0,
                             b"Hello AX.25!")
    flag = np.asarray([0, 1, 1, 1, 1, 1, 1, 0], np.uint8)
    stream = np.concatenate([np.zeros(41, np.uint8), flag,
                             hdlc_stuff(frame_bits), flag, flag,
                             hdlc_stuff(frame_bits), flag,
                             np.zeros(29, np.uint8)])
    got, exp = _both("AX25FramerBlock", ["Bit"], stream, [50, 120, 300, 301])
    assert len(got) == 2 and got[0].payload == "Hello AX.25!"
    assert got[1].addresses[1]["callsign"] == "KD2BMH"
    assert _frames_json(got) == _frames_json(exp)


def test_ert_framers_match_jax():
    """SCM with a corrected bit, SCM+ and IDM, each framer split."""
    from luaradio_tpu.blocks.protocol.ert import _crc16_ccitt_bits
    n2b = tl.types.number_to_bits
    msg = np.concatenate([n2b(0x2, 2), n2b(0, 1), n2b(1, 2), n2b(7, 4),
                          n2b(2, 2), n2b(123456, 24), n2b(0xABCDEF, 24)])
    scm = np.concatenate([np.zeros(17, np.uint8),
                          tl.SCMFramerBlock.SCM_PREAMBLE, scm_encode(msg),
                          np.zeros(31, np.uint8)])
    scm[17 + 21 + 30] ^= 1
    got, exp = _both("SCMFramerBlock", ["Bit"], scm, [40, 90])
    assert len(got) == 1 and got[0].consumption == 123456
    assert _frames_json(got) == _frames_json(exp)

    body = np.concatenate([n2b(0x1E, 8), n2b(0xAB, 8), n2b(0x01020304, 32),
                           n2b(987654, 32), n2b(0x5A5A, 16)])
    plus = np.concatenate([np.zeros(9, np.uint8),
                           tl.SCMPlusFramerBlock.SCM_PLUS_PREAMBLE, body,
                           n2b(_crc16_ccitt_bits(body), 16),
                           np.zeros(20, np.uint8)])
    got, exp = _both("SCMPlusFramerBlock", ["Bit"], plus, [60])
    assert len(got) == 1 and got[0].tamper == 0x5A5A
    assert _frames_json(got) == _frames_json(exp)

    body = np.zeros(688, np.uint8)
    body[0:8] = n2b(0x1C, 8)
    body[8:24] = n2b(0x5CC6, 16)
    body[40:72] = n2b(0x11223344, 32)
    body[200:232] = n2b(55555, 32)
    body[672:688] = n2b(_crc16_ccitt_bits(body[40:72]), 16)
    idm = np.concatenate([np.zeros(13, np.uint8), n2b(0x5555, 16),
                          n2b(0x16A3, 16), body,
                          n2b(_crc16_ccitt_bits(body), 16),
                          np.zeros(40, np.uint8)])
    got, exp = _both("IDMFramerBlock", ["Bit"], idm, [300, 600])
    assert len(got) == 1 and got[0].last_consumption_count == 55555
    assert _frames_json(got) == _frames_json(exp)


def test_varicode_decoder_matches_jax():
    bits = [0, 0]
    for ch in "Hello PSK31!":
        bits.extend(int(c) for c in tl.VARICODE[ord(ch)])
        bits.extend([0, 0])
    bits.extend([1] * 12 + [0, 0])                     # a >10-bit run
    got, exp = _both("VaricodeDecoderBlock", ["Bit"],
                     np.asarray(bits, np.uint8), [13, 40, 70])
    assert bytes(np.asarray(got, np.uint8).tolist()).startswith(
        b"Hello PSK31!")
    assert np.array_equal(np.asarray(got), np.asarray(exp))
    assert tl.VARICODE == jl.blocks.protocol.varicode.VARICODE


# -- print and JSON sinks ------------------------------------------------------------

def test_print_and_json_sinks_match_jax():
    frame = {m: m.RDSFrame((1, 2, 3, 4)) for m in (jl, tl)}
    for items in (lambda m: [frame[m]], lambda m: np.arange(3, dtype=np.float32),
                  lambda m: np.array([1 + 2j], np.complex64)):
        outs = {}
        for mod in (jl, tl):
            outs[mod] = []
            for cls in (mod.PrintSink, mod.JSONSink):
                buf = io.StringIO()
                sink = cls(buf)
                sink.initialize()
                sink.process(items(mod))
                sink.cleanup()
                outs[mod].append(buf.getvalue())
        assert outs[tl] == outs[jl]
    json.loads(outs[tl][1].splitlines()[0])


# -- the masked boundary -------------------------------------------------------------

def _array_source(mod, data, rate):
    t = mod.ComplexFloat32 if np.iscomplexobj(data) else mod.Float32

    class ArraySource(mod.HostSourceBlock):
        def __init__(self):
            super().__init__()
            self.rate = rate
            self.pos = 0
            self.add_type_signature([], [mod.Output("out", t)])

        def read(self, n):
            if self.pos >= len(data):
                return None
            chunk = data[self.pos:self.pos + n]
            self.pos += len(chunk)
            return chunk
    return ArraySource()


def _collector(mod):
    class Collect(mod.SinkBlock):
        def __init__(self):
            super().__init__()
            self.got = []
            self.add_type_signature([mod.Input("in", lambda t: True)], [])

        def process(self, x):
            self.got.append(np.array(x))
    return Collect()


def _sampler_graph(mod, x, rate, chain=()):
    """x -> clock recovery -> Sampler.clock, x -> Sampler.data, then the
    blocks of ``chain`` (factories of the module) -> sink."""
    top = mod.CompositeBlock()
    src = _array_source(mod, x, rate)
    clock = mod.ZeroCrossingClockRecoveryBlock(1200.0)
    sampler = mod.SamplerBlock()
    top.connect(src, clock)
    top.connect(src, "out", sampler, "data")
    top.connect(clock, "out", sampler, "clock")
    blocks = [sampler] + [f(mod) for f in chain]
    sink = _collector(mod)
    top.connect(*blocks, sink)
    return top, sink, blocks


@pytest.mark.parametrize("chunk", [4096, 1000])
def test_masked_boundary_compacts_and_cuts_the_padding(chunk):
    """The last chunk is padded with zeros, where the clock recovery runs
    free and keeps pulsing: a mask not cut at the valid count would emit
    samples there.  The compacted stream equals the JAX package's run of
    the same graph and the two blocks run by hand on the unpadded input."""
    rate = 48000.0
    x = _nrz(12, 10_007, 40.0)          # neither chunk size divides it
    out = {}
    for mod in (jl, tl):
        top, sink, _ = _sampler_graph(mod, x, rate)
        kw = {"device": "cpu"} if mod is tl else {}
        top.run(chunk_size=chunk, **kw)
        out[mod] = np.concatenate(sink.got)
    clock, _ = _device_run(tl, tl.ZeroCrossingClockRecoveryBlock(1200.0),
                           [x], 1, rate)
    by_hand, _ = _device_run(tl, tl.SamplerBlock(), [x, clock[0]], 1)
    want = _compact(by_hand)
    pad = _device_run(tl, tl.ZeroCrossingClockRecoveryBlock(1200.0),
                      [np.concatenate([x, np.zeros(2000, np.float32)])], 1,
                      rate)[0][0][len(x):]
    assert (pad > 0).sum() >= 40        # the free-running clock in padding
    assert out[tl].dtype == np.float32 and len(want) >= 240
    assert np.array_equal(out[tl], want)
    assert np.array_equal(out[tl], out[jl])


def test_masked_boundary_demotes_the_dual_chain():
    """Sampler -> ComplexToReal -> Slicer -> DifferentialDecoder run in
    host mode; the bits equal the JAX package's."""
    rng = np.random.default_rng(13)
    n = 9000
    x = (_nrz(14, n, 40.0) + 1j * 0.1 * rng.standard_normal(n)
         ).astype(np.complex64)
    chain = (lambda m: m.ComplexToRealBlock(), lambda m: m.SlicerBlock(),
             lambda m: m.DifferentialDecoderBlock())
    out = {}
    for mod in (jl, tl):
        top = mod.CompositeBlock()
        src = _array_source(mod, x, 48000.0)
        real = mod.ComplexToRealBlock()
        clock = mod.ZeroCrossingClockRecoveryBlock(1200.0)
        blocks = [mod.SamplerBlock()] + [f(mod) for f in chain]
        sink = _collector(mod)
        top.connect(src, real, clock)
        top.connect(src, "out", blocks[0], "data")
        top.connect(clock, "out", blocks[0], "clock")
        top.connect(*blocks, sink)
        kw = {"device": "cpu"} if mod is tl else {}
        top.run(chunk_size=2048, **kw)
        out[mod] = np.concatenate(sink.got)
        if mod is tl:
            assert real.domain == "device"
            assert [b.domain for b in blocks] == ["device", "host", "host",
                                                  "host"]
    assert out[tl].dtype == np.uint8 and len(out[tl]) > 200
    assert np.array_equal(out[tl], out[jl])


def test_non_dual_device_block_after_the_sampler_raises():
    top, _, _ = _sampler_graph(tl, _nrz(15, 1000, 40.0), 48000.0,
                               chain=(lambda m: m.MultiplyConstantBlock(2.0),))
    with pytest.raises(ValueError, match="not dual-capable"):
        Graph(top, chunk_size=512, device="cpu")


def test_optimizer_leaves_masked_blocks_out_of_chains():
    """A single-input masked FIR between two lowpass filters would fold
    into one decimating FIR (dropping its mask) if the optimizer took it
    into a chain; it stays, and the filters around it are not fused
    across it."""
    class MaskedFIR(tl.FIRFilterBlock):
        masked_output = True

        def process(self, state, x):
            state, y = super().process(state, x)
            return state, (y, y > 0)

    top = tl.CompositeBlock()
    src = _array_source(tl, np.zeros(16, np.float32), 48000.0)
    lpf = tl.LowpassFilterBlock(31, 5e3)
    masked = MaskedFIR(np.ones(3) / 3)
    sink = _collector(tl)
    top.connect(src, lpf, masked, sink)
    g = Graph(top, chunk_size=512, device="cpu")
    assert masked in g.order and lpf in g.order and g.n_fusions == 0
    assert not port_optimize._is_chain_candidate(g, masked)
    assert not port_optimize._is_chain_candidate(g, tl.SamplerBlock())
    assert port_optimize._is_chain_candidate(g, lpf)
