"""The port's SDR sources and sinks and its ring buffer against the JAX
package's, driven by in-process fakes of the vendor libraries (the cases
of tests/blocks/test_sdr.py on both packages).

Each fake exposes a vendor C ABI and records the calls it gets.  One fake
class feeds both packages with the same data, built with the package's own
ctypes structures (the callback types check them); each case holds the
port's call sequence and converted samples equal to the JAX package's, bit
for bit.  ``device_ingest`` is held on CPU tensors against ``read()``'s
host conversion over every code of every driver's wire type, and the wire
run through the port's Runner against the run that converts on the host
(rtlsdr, uhd, soapysdr) and against the JAX package's wire run."""

import ctypes
import sys
import threading
import time
import types
import warnings
from ctypes import POINTER, byref, c_int, c_uint8, c_void_p, cast

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu.blocks.sinks import sdr as jsink  # noqa: E402
from luaradio_tpu.blocks.sources import sdr as jsdr  # noqa: E402
from luaradio_tpu.core.runtime import Runner as JRunner  # noqa: E402
from luaradio_tpu_torch.blocks.sinks import sdr as tsink  # noqa: E402
from luaradio_tpu_torch.blocks.sources import sdr as tsdr  # noqa: E402
from luaradio_tpu_torch.core.ingest import Feed  # noqa: E402
from luaradio_tpu_torch.core.runtime import Runner  # noqa: E402
from luaradio_tpu_torch.utils.ringbuffer import \
    SampleRingBuffer  # noqa: E402

#: (package, its SDR source module, its SDR sink module)
PKGS = {"jax": (jl, jsdr, jsink), "port": (tl, tsdr, tsink)}


def _norm(v):
    """A comparable form of a vendor-call argument: ctypes scalars by
    value, structures and pointers by type name."""
    if isinstance(v, (int, float, bytes, str, bool)) or v is None:
        return v
    if isinstance(v, (ctypes._SimpleCData,)):
        return _norm(v.value)
    return type(v).__name__


def _calls(fake):
    return [(n, tuple(_norm(a) for a in args)) for n, args in fake.calls]


def _drain(src, total):
    chunks = []
    while sum(map(len, chunks)) < total:
        c = src.read(total)
        if c is None or len(c) == 0:
            break
        chunks.append(c)
    return np.concatenate(chunks)


# ---------------------------------------------------------------------------
# ring buffer (tests/blocks/test_sdr.py's cases on the port's copy)
# ---------------------------------------------------------------------------

def test_ringbuffer_basic():
    rng = np.random.default_rng(21)
    rb = SampleRingBuffer(1024, np.complex64)
    x = (rng.standard_normal(300) + 1j * rng.standard_normal(300)
         ).astype(np.complex64)
    assert rb.write(x)
    np.testing.assert_array_equal(rb.read(200), x[:200])
    np.testing.assert_array_equal(rb.read(200), x[200:])


def test_ringbuffer_wraparound_and_overflow():
    rb = SampleRingBuffer(256, np.complex64)
    a = np.arange(200, dtype=np.complex64)
    assert rb.write(a)
    rb.read(150)
    b = np.arange(200, dtype=np.complex64) + 1000
    assert rb.write(b)  # wraps
    assert not rb.write(np.zeros(100, np.complex64))  # would overflow
    assert rb.overflows == 1 and rb.dropped_samples == 100
    np.testing.assert_array_equal(rb.read(250),
                                  np.concatenate([a[150:], b]))


def test_ringbuffer_blocking_and_close():
    rb = SampleRingBuffer(64, np.complex64)
    out = []

    def consumer():
        while True:
            c = rb.read(16, timeout=2.0)
            if c is None or len(c) == 0:
                break
            out.append(c)

    t = threading.Thread(target=consumer)
    t.start()
    time.sleep(0.05)
    rb.write(np.arange(40, dtype=np.complex64))
    time.sleep(0.05)
    rb.close()
    t.join(timeout=2.0)
    np.testing.assert_array_equal(np.concatenate(out),
                                  np.arange(40, dtype=np.complex64))
    assert rb.read(4) is None  # closed and drained


def test_ringbuffer_write_blocking_backpressure():
    rb = SampleRingBuffer(128, np.complex64)
    assert rb.write_blocking(np.arange(100, dtype=np.complex64))
    done = []

    def producer():
        done.append(rb.write_blocking(
            np.arange(100, dtype=np.complex64) + 1000, timeout=2.0))

    t = threading.Thread(target=producer)
    t.start()
    time.sleep(0.05)
    assert not done  # blocked: only 28 slots free
    got1 = rb.read(100)
    t.join(timeout=2.0)
    assert done == [True]
    assert rb.overflows == 0 and rb.dropped_samples == 0
    got2 = rb.read(100)
    np.testing.assert_array_equal(
        np.concatenate([got1, got2]),
        np.concatenate([np.arange(100), np.arange(100) + 1000]
                       ).astype(np.complex64))
    rb.close()
    assert not rb.write_blocking(np.ones(4, np.complex64))


def test_ringbuffer_read_exact_slow_producer_not_eof():
    rb = SampleRingBuffer(1024, np.float32)
    stop = threading.Event()

    def slow_producer():
        for i in range(10):
            if stop.is_set():
                return
            time.sleep(0.06)
            rb.write(np.full(10, float(i), np.float32))
        rb.close()

    t = threading.Thread(target=slow_producer, daemon=True)
    t.start()
    try:
        out = np.full(100, -1.0, np.float32)
        assert rb.read_exact(100, out, timeout=0.15) == 100
        np.testing.assert_array_equal(
            out, np.repeat(np.arange(10, dtype=np.float32), 10))
    finally:
        stop.set()
        t.join(timeout=2.0)


def test_ringbuffer_read_exact_true_stall_returns_partial():
    rb = SampleRingBuffer(256, np.float32)
    rb.write(np.arange(30, dtype=np.float32))
    t0 = time.monotonic()
    out = np.full(100, -1.0, np.float32)
    got = rb.read_exact(100, out, timeout=0.1)
    assert time.monotonic() - t0 < 1.0
    assert got == 30
    np.testing.assert_array_equal(out[:30], np.arange(30, dtype=np.float32))


def test_ringbuffer_read_exact_into_out_across_the_wrap():
    """read_exact writes the samples into ``out`` across the ring's
    wrap and returns their count, nothing past it; a stall returns what
    there is, and a closed, drained ring None."""
    rb = SampleRingBuffer(16, np.int16)
    rb.write(np.arange(12, dtype=np.int16))
    out = np.full(16, -1, np.int16)
    assert rb.read_exact(10, out) == 10
    rb.write(np.arange(12, 24, dtype=np.int16))     # wraps at 16
    out[:] = -1
    assert rb.read_exact(14, out) == 14
    np.testing.assert_array_equal(out[:14], np.arange(10, 24))
    assert (out[14:] == -1).all()
    rb.write(np.arange(3, dtype=np.int16))
    assert rb.read_exact(8, out, timeout=0.05) == 3
    np.testing.assert_array_equal(out[:3], np.arange(3))
    rb.close()
    assert rb.read_exact(8, out) is None


# ---------------------------------------------------------------------------
# fakes: one class per vendor ABI, built on either package's structures
# ---------------------------------------------------------------------------

class _Recorder:
    PREFIX = ""

    def __init__(self, mod):
        self.mod = mod
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith(self.PREFIX):
            raise AttributeError(name)
        short = name[len(self.PREFIX):]
        special = getattr(type(self), "_" + short, None)
        if special is not None:
            return lambda *a: special(self, *a)

        def record(*args):
            self.calls.append((short, args))
            return 0
        return record


class FakeHackRF(_Recorder):
    """libhackrf: an RX callback from a 'USB' thread with s8 IQ buffers,
    and a TX callback that pulls buffers from the block's ring."""

    PREFIX = "hackrf_"

    def __init__(self, mod, iq=None, n_buffers=4, buf_samples=4096):
        super().__init__(mod)
        self.n_buffers = n_buffers
        self.buf_samples = buf_samples
        self.iq = iq
        self.sent = []
        self.sink = None    # TX: the sink whose ring the device drains

    def _open(self, devp):
        self.calls.append(("open", ()))
        cast(devp, POINTER(c_void_p))[0] = c_void_p(0xDEAD)
        return 0

    @property
    def hackrf_compute_baseband_filter_bw_round_down_lt(self):
        class F:
            restype = None

            def __call__(self, bw):
                return int(bw.value * 3 // 4)
        return F()

    def _start_rx(self, dev, cb, ctx):
        self.calls.append(("start_rx", ()))
        tr = self.mod._hackrf_transfer

        def pump():
            n = 2 * self.buf_samples
            for i in range(self.n_buffers):
                buf = (c_uint8 * n).from_buffer_copy(
                    self.iq[i * n:(i + 1) * n].tobytes())
                t = tr(device=dev, buffer=cast(buf, POINTER(c_uint8)),
                       buffer_length=n, valid_length=n)
                if cb(byref(t)) != 0:
                    break
        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()
        return 0

    def _start_tx(self, dev, cb, ctx):
        self.calls.append(("start_tx", ()))
        tr = self.mod._hackrf_transfer

        def pump():
            # the device starts streaming once the host has a transfer's
            # worth of samples queued (a TX started early would send zeros)
            ring, deadline = self.sink.ring, time.monotonic() + 5.0
            while (ring.available < self.buf_samples and not ring.closed
                   and time.monotonic() < deadline):
                time.sleep(0.001)
            for _ in range(self.n_buffers):
                n = 2 * self.buf_samples
                buf = (c_uint8 * n)()
                t = tr(device=dev, buffer=cast(buf, POINTER(c_uint8)),
                       buffer_length=n, valid_length=0)
                if cb(byref(t)) != 0:
                    break
                self.sent.append(np.frombuffer(bytes(buf), np.int8).copy())
        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()
        return 0


class FakeAirspy(_Recorder):
    """libairspy (or libhydrasdr): INT16_IQ callback stream."""

    PREFIX = "airspy_"

    def __init__(self, mod, iq, n_buffers=3, buf_samples=2048,
                 transfer="_airspy_transfer"):
        super().__init__(mod)
        self.iq = iq
        self.n_buffers = n_buffers
        self.buf_samples = buf_samples
        self.transfer = getattr(mod, transfer)

    def _open(self, devp):
        self.calls.append(("open", ()))
        cast(devp, POINTER(c_void_p))[0] = c_void_p(0xBEEF)
        return 0

    def _start_rx(self, dev, cb, ctx):
        self.calls.append(("start_rx", ()))

        def pump():
            n = self.buf_samples
            for i in range(self.n_buffers):
                buf = (ctypes.c_int16 * (2 * n)).from_buffer_copy(
                    self.iq[2 * i * n:2 * (i + 1) * n].tobytes())
                t = self.transfer(device=dev, ctx=None,
                                  samples=cast(buf, c_void_p),
                                  sample_count=n, dropped_samples=0,
                                  sample_type=2)
                if cb(byref(t)) != 0:
                    break
        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()
        return 0


class FakeHydraSDR(FakeAirspy):
    PREFIX = "hydrasdr_"

    def __init__(self, mod, iq):
        super().__init__(mod, iq, transfer="_hydrasdr_transfer")


class FakeAirspyHF(_Recorder):
    """libairspyhf: float32 IQ callback stream."""

    PREFIX = "airspyhf_"

    def __init__(self, mod, iq, n_buffers=3, buf_samples=1024):
        super().__init__(mod)
        self.iq = iq
        self.n_buffers = n_buffers
        self.buf_samples = buf_samples

    def _open(self, devp):
        self.calls.append(("open", ()))
        cast(devp, POINTER(c_void_p))[0] = c_void_p(0xAF)
        return 0

    def _start(self, dev, cb, ctx):
        self.calls.append(("start", ()))

        def pump():
            n = self.buf_samples
            for i in range(self.n_buffers):
                buf = (ctypes.c_float * (2 * n)).from_buffer_copy(
                    self.iq[2 * i * n:2 * (i + 1) * n].tobytes())
                t = self.mod._airspyhf_transfer(
                    device=dev, ctx=None, samples=cast(buf, c_void_p),
                    sample_count=n, dropped_samples=0)
                if cb(byref(t)) != 0:
                    break
        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()
        return 0


class FakeBladeRF(_Recorder):
    """libbladeRF: sync RX returns SC16_Q11 buffers; sync TX records."""

    PREFIX = "bladerf_"

    def __init__(self, mod, data=None, n_reads=3):
        super().__init__(mod)
        self.data = data
        self.n_reads = n_reads
        self.reads = 0
        self.sent = []

    def _open(self, devp, devid):
        self.calls.append(("open", (devid,)))
        cast(devp, POINTER(c_void_p))[0] = c_void_p(0xB1AD)
        return 0

    def _sync_rx(self, dev, buf, n, meta, timeout):
        if self.reads >= self.n_reads:
            return -1  # stream end
        n = n.value if hasattr(n, "value") else int(n)
        seg = self.data[2 * self.reads * n:2 * (self.reads + 1) * n]
        ctypes.memmove(buf, seg.ctypes.data, seg.nbytes)
        self.reads += 1
        return 0

    def _sync_tx(self, dev, buf, n, meta, timeout):
        n = n if isinstance(n, int) else n.value
        self.sent.append(np.ctypeslib.as_array(
            cast(buf, POINTER(ctypes.c_int16)), shape=(2 * n,)).copy())
        return 0


class FakeRtlSdr(_Recorder):
    """librtlsdr: blocking sync reads of u8 IQ."""

    PREFIX = "rtlsdr_"

    def __init__(self, mod, data, n_reads=3):
        super().__init__(mod)
        self.data = data
        self.n_reads = n_reads
        self.reads = 0

    def _open(self, devp, idx):
        self.calls.append(("open", (idx,)))
        cast(devp, POINTER(c_void_p))[0] = c_void_p(0x171)
        return 0

    def _read_sync(self, dev, buf, nbytes, gotp):
        if self.reads >= self.n_reads:
            return -1
        n = nbytes if isinstance(nbytes, int) else nbytes.value
        seg = self.data[self.reads * n:(self.reads + 1) * n]
        ctypes.memmove(buf, seg.ctypes.data, len(seg))
        cast(gotp, POINTER(c_int))[0] = len(seg)
        self.reads += 1
        return 0


class FakeUHD(_Recorder):
    """libuhd: the RX streamer serves sc16, the TX streamer records fc32."""

    PREFIX = "uhd_"

    def __init__(self, mod, data=None, n_reads=3, samples=1 << 16):
        super().__init__(mod)
        self.data = data
        self.n_reads = n_reads
        self.samples = samples
        self.reads = 0
        self.sent = []

    def __getattr__(self, name):
        short = name[len("uhd_"):]
        if short in ("usrp_make", "rx_streamer_make", "rx_metadata_make",
                     "subdev_spec_make", "tx_streamer_make",
                     "tx_metadata_make"):
            def make(p, *rest):
                self.calls.append((short, rest))
                cast(p, POINTER(c_void_p))[0] = c_void_p(0xA5)
                return 0
            return make
        return super().__getattr__(name)

    def _rx_streamer_recv(self, rx, buffs, nsamps, md, timeout, one_packet,
                          gotp):
        if self.reads >= self.n_reads:
            return 1  # uhd timeout error
        n = min(self.samples,
                nsamps if isinstance(nsamps, int) else nsamps.value)
        seg = self.data[2 * self.reads * self.samples:
                        2 * self.reads * self.samples + 2 * n]
        ctypes.memmove(cast(buffs, POINTER(c_void_p))[0], seg.ctypes.data,
                       seg.nbytes)
        cast(gotp, POINTER(ctypes.c_size_t))[0] = n
        self.reads += 1
        return 0

    def _tx_streamer_send(self, tx, buffs, nsamps, md, timeout, gotp):
        n = nsamps if isinstance(nsamps, int) else nsamps.value
        src = cast(buffs, POINTER(c_void_p))[0]
        self.sent.append(np.ctypeslib.as_array(
            cast(src, POINTER(ctypes.c_float)), shape=(2 * n,)).copy())
        cast(gotp, POINTER(ctypes.c_size_t))[0] = n
        return 0


class FakeSDRplay(_Recorder):
    """sdrplay_api v3: real parameter structures (field writes are
    observable) and the split int16 stream callback."""

    PREFIX = "sdrplay_api_"

    def __init__(self, mod, xi, xq, n_buffers=3, buf_samples=4096):
        super().__init__(mod)
        self.xi, self.xq = xi, xq
        self.n_buffers = n_buffers
        self.buf_samples = buf_samples
        self.dev_params = mod._sdrplay_dev_params()
        self.rx_a = mod._sdrplay_rx_channel_params()
        self.device_params = mod._sdrplay_device_params(
            devParams=ctypes.pointer(self.dev_params),
            rxChannelA=ctypes.pointer(self.rx_a))

    def _GetDevices(self, devs, ndevp, maxdev):
        self.calls.append(("GetDevices", ()))
        devs[0].SerNo = b"FAKE0001"
        devs[0].hwVer = 3
        devs[0].valid = 1
        devs[0].dev = 0x5D
        cast(ndevp, POINTER(ctypes.c_uint32))[0] = 1
        return 0

    def _GetDeviceParams(self, dev, paramsp):
        self.calls.append(("GetDeviceParams", ()))
        cast(paramsp, POINTER(POINTER(self.mod._sdrplay_device_params)))[0] \
            = ctypes.pointer(self.device_params)
        return 0

    def _Init(self, dev, cbsp, ctx):
        self.calls.append(("Init", ()))
        cbs = cast(cbsp, POINTER(self.mod._sdrplay_callback_fns)).contents
        stream_cb = cbs.StreamACbFn

        def pump():
            bs = self.buf_samples
            for i in range(self.n_buffers):
                xi = self.xi[i * bs:(i + 1) * bs]
                xq = self.xq[i * bs:(i + 1) * bs]
                stream_cb(xi.ctypes.data_as(POINTER(ctypes.c_int16)),
                          xq.ctypes.data_as(POINTER(ctypes.c_int16)),
                          None, bs, 0, None)
        self._thread = threading.Thread(target=pump, daemon=True)
        self._thread.start()
        return 0


class _SoapyResult:
    def __init__(self, ret):
        self.ret = ret


class FakeSoapyDevice:
    """The SoapySDR Python module's Device: CS16 reads, CF32 writes."""

    rx_data = None
    instances = []

    def __init__(self, uri):
        self.uri = uri
        self.calls = []
        self.reads = 0
        self.written = []
        FakeSoapyDevice.instances.append(self)

    def __getattr__(self, name):
        def record(*args):
            self.calls.append((name, args))
            return "stream"
        return record

    def readStream(self, stream, bufs, n):
        if self.reads >= 3:
            return _SoapyResult(-1)
        seg = FakeSoapyDevice.rx_data[self.reads * n:(self.reads + 1) * n]
        bufs[0][:len(seg)] = seg
        self.reads += 1
        return _SoapyResult(len(seg))

    def writeStream(self, stream, bufs, n):
        self.written.append(np.array(bufs[0][:n]))
        return _SoapyResult(n)


def _install_fake_soapy(monkeypatch):
    mod = types.ModuleType("SoapySDR")
    mod.SOAPY_SDR_RX, mod.SOAPY_SDR_TX = 0, 1
    mod.SOAPY_SDR_CF32, mod.SOAPY_SDR_CS16 = "CF32", "CS16"
    mod.Device = FakeSoapyDevice
    monkeypatch.setitem(sys.modules, "SoapySDR", mod)
    FakeSoapyDevice.instances = []


def _inject(cls, fake):
    cls._injected_lib = fake
    return fake


@pytest.fixture(autouse=True)
def _clear_injected():
    yield
    for _, src, snk in PKGS.values():
        for m in (src, snk):
            for v in vars(m).values():
                if isinstance(v, type) and "_injected_lib" in vars(v):
                    v._injected_lib = None


# ---------------------------------------------------------------------------
# the drivers, each on both packages
# ---------------------------------------------------------------------------

def _s8(rng, n):
    return np.round(np.clip(rng.standard_normal(n) * 40, -127, 127)
                    ).astype(np.int8)


def _s16(rng, n, sd, lo=-32768, hi=32767):
    return np.round(np.clip(rng.standard_normal(n) * sd, lo, hi)
                    ).astype(np.int16)


def _hackrf_source(pkg, rng):
    _, mod, _ = PKGS[pkg]
    fake = _inject(mod.HackRFSource, FakeHackRF(mod, _s8(rng, 2 * 4 * 4096)))
    src = mod.HackRFSource(100e6, 8e6, lna_gain=16, vga_gain=22,
                           rf_amplifier_enable=True)
    src.differentiate([])
    src.initialize()
    fake._thread.join(timeout=2.0)
    got = _drain(src, 4 * 4096)
    src.cleanup()
    exp = (fake.iq.astype(np.float32) / 127.5).view(np.complex64)
    np.testing.assert_allclose(got, exp, atol=1e-6)
    return fake, got


def _airspy_source(pkg, rng, hydra=False):
    _, mod, _ = PKGS[pkg]
    cls = mod.HydraSDRSource if hydra else mod.AirspySource
    fake = (FakeHydraSDR if hydra else FakeAirspy)(
        mod, _s16(rng, 2 * 3 * 2048, 8000))
    _inject(cls, fake)
    src = cls(91.1e6, 6e6, gain_mode="custom", lna_gain=4, mixer_gain=1,
              vga_gain=6, biastee_enable=True)
    src.differentiate([])
    src.initialize()
    fake._thread.join(timeout=2.0)
    assert src.ring._buf.dtype == np.int16   # the raw s16 wire ring
    got = src.read(3 * 2048)
    src.cleanup()
    exp = (fake.iq.astype(np.float32) / 32768.0).view(np.complex64)
    np.testing.assert_array_equal(got, exp[:len(got)])
    assert [a for (n, a) in fake.calls if n == "set_sample_type"][0][1] \
        .value == 2                          # INT16_IQ requested
    return fake, got


def _airspy_gain_modes(pkg, rng):
    _, mod, _ = PKGS[pkg]
    fake = _inject(mod.AirspySource,
                   FakeAirspy(mod, _s16(rng, 2 * 2048, 8000), n_buffers=1))
    src = mod.AirspySource(91.1e6, 6e6, gain_mode="linearity",
                           linearity_gain=8)
    src.differentiate([])
    src.initialize()
    fake._thread.join(timeout=2.0)
    src.cleanup()
    assert "set_linearity_gain" in [n for (n, _) in fake.calls]
    return fake, np.zeros(0)


def _airspyhf_source(pkg, rng):
    _, mod, _ = PKGS[pkg]
    iq = rng.standard_normal(2 * 3 * 1024).astype(np.float32)
    fake = _inject(mod.AirspyHFSource, FakeAirspyHF(mod, iq))
    src = mod.AirspyHFSource(7.1e6, 768e3, hf_agc=False, hf_att=12,
                             hf_lna=True)
    src.differentiate([])
    src.initialize()
    fake._thread.join(timeout=2.0)
    assert src.device_ingest() is None       # no wire path: float32 IQ
    got = src.read(3 * 1024)
    src.cleanup()
    np.testing.assert_array_equal(got, iq.view(np.complex64))
    return fake, got


def _bladerf_source(pkg, rng):
    _, mod, _ = PKGS[pkg]
    fake = _inject(mod.BladeRFSource, FakeBladeRF(
        mod, _s16(rng, 2 * 3 * (1 << 16), 1000, -2048, 2047)))
    src = mod.BladeRFSource(915e6, 10e6, gain=20, autogain=False)
    src.differentiate([])
    src.initialize()
    got = _drain(src, 3 * (1 << 16))
    src.cleanup()
    exp = (fake.data.astype(np.float32) / 2048.0).view(np.complex64)
    np.testing.assert_allclose(got, exp[:len(got)], atol=1e-6)
    return fake, got


def _rtlsdr_source(pkg, rng):
    _, mod, _ = PKGS[pkg]
    fake = _inject(mod.RtlSdrSource, FakeRtlSdr(
        mod, rng.integers(0, 256, 2 * 3 * (1 << 16)).astype(np.uint8)))
    src = mod.RtlSdrSource(104.3e6, 2.4e6, freq_correction=12, gain=19.7,
                           bias_tee=True)
    src.differentiate([])
    src.initialize()
    got = _drain(src, 3 * (1 << 16))
    src.cleanup()
    exp = ((fake.data.astype(np.float32) - 127.5) / 127.5
           ).view(np.complex64)
    np.testing.assert_allclose(got, exp[:len(got)], atol=1e-6)
    assert [a for (n, a) in fake.calls if n == "set_tuner_gain"][0][1] == 197
    assert "close" in [n for (n, _) in fake.calls]
    return fake, got


def _uhd_source(pkg, rng):
    _, mod, _ = PKGS[pkg]
    fake = _inject(mod.UHDSource,
                   FakeUHD(mod, _s16(rng, 2 * 3 * (1 << 16), 9000)))
    src = mod.UHDSource("addr=192.168.10.2", 915e6, 10e6,
                        gains={"PGA": 20.0, "LNA": 10.0}, bandwidth=8e6,
                        antenna="RX2", clock_source="external",
                        time_source="gpsdo", subdev="A:0")
    src.differentiate([])
    src.initialize()
    got = _drain(src, 3 * (1 << 16))
    assert src.ring._buf.dtype == np.int16   # the raw sc16 wire ring
    src.cleanup()
    exp = (fake.data.astype(np.float32)
           * np.float32(1.0 / 32767.0)).view(np.complex64)
    np.testing.assert_array_equal(got, exp[:len(got)])
    assert {a[3] for (n, a) in fake.calls if n == "usrp_set_rx_gain"} \
        >= {b"PGA", b"LNA"}
    for s in ("rx_streamer_free", "rx_metadata_free", "usrp_free"):
        assert s in [n for (n, _) in fake.calls], s
    return fake, got


def _sdrplay_source(pkg, rng):
    _, mod, _ = PKGS[pkg]
    n = 3 * 4096
    fake = _inject(mod.SDRplaySource, FakeSDRplay(
        mod, np.round(rng.standard_normal(n) * 8000).astype(np.int16),
        np.round(rng.standard_normal(n) * 8000).astype(np.int16)))
    src = mod.SDRplaySource(98.5e6, 2e6, gain_reduction=52, bandwidth=1.6e6,
                            lna_state=2, agc="50hz", agc_setpoint=-30,
                            freq_correction=1.5, iq_correction=False)
    src.differentiate([])
    src.initialize()
    assert fake.dev_params.fsFreq.fsHz == 2e6
    assert fake.dev_params.ppm == 1.5
    t = fake.rx_a.tunerParams
    assert (t.rfFreq.rfHz, t.bwType, t.ifType, t.gain.gRdB,
            t.gain.LNAstate) == (98.5e6, 1536, 0, 52, 2)
    c = fake.rx_a.ctrlParams
    assert (c.agc.enable, c.agc.setPoint_dBfs, c.dcOffset.DCenable,
            c.dcOffset.IQenable) == (2, -30, 1, 0)
    fake._thread.join(timeout=2.0)
    assert src.ring._buf.dtype == np.int16
    got = src.read(n)
    src.cleanup()
    exp = ((fake.xi.astype(np.float32) + 1j * fake.xq.astype(np.float32))
           / 32767.5).astype(np.complex64)
    np.testing.assert_allclose(got, exp[:len(got)], atol=1e-6)
    for s in ("Uninit", "ReleaseDevice", "Close"):
        assert s in [nm for (nm, _) in fake.calls], s
    return fake, got


SOURCES = {"hackrf": _hackrf_source, "airspy": _airspy_source,
           "hydrasdr": lambda p, r: _airspy_source(p, r, hydra=True),
           "airspy_gain_modes": _airspy_gain_modes,
           "airspyhf": _airspyhf_source, "bladerf": _bladerf_source,
           "rtlsdr": _rtlsdr_source, "uhd": _uhd_source,
           "sdrplay": _sdrplay_source}


@pytest.mark.parametrize("driver", sorted(SOURCES))
def test_source_matches_jax(driver):
    """The driver's vendor calls in order (by value) and its converted
    samples, bit for bit, on both packages fed the same fake data."""
    runs = {pkg: SOURCES[driver](pkg, np.random.default_rng(21))
            for pkg in PKGS}
    (jf, jgot), (tf, tgot) = runs["jax"], runs["port"]
    assert _calls(tf) == _calls(jf)
    assert tgot.dtype == jgot.dtype
    np.testing.assert_array_equal(tgot, jgot)


def test_soapysdr_source_matches_jax(monkeypatch):
    n = 1 << 16
    FakeSoapyDevice.rx_data = _s16(np.random.default_rng(6), (3 * n, 2),
                                   7000)
    got, calls = {}, {}
    for pkg, (_, mod, _) in PKGS.items():
        _install_fake_soapy(monkeypatch)
        src = mod.SoapySDRSource("driver=fake", 433e6, 1e6, gain=30,
                                 settings={"biastee": "true"})
        src.differentiate([])
        src.initialize()
        got[pkg] = _drain(src, 3 * n)
        assert src.ring._buf.dtype == np.int16   # the raw CS16 wire ring
        src.cleanup()
        dev = FakeSoapyDevice.instances[0]
        calls[pkg] = [(nm, tuple(_norm(a) for a in args))
                      for nm, args in dev.calls]
        assert [a for (nm, a) in dev.calls if nm == "setupStream"][0][1] \
            == "CS16"
    exp = (FakeSoapyDevice.rx_data.astype(np.float32).reshape(-1)
           * np.float32(1.0 / 32767.0)).view(np.complex64)
    np.testing.assert_array_equal(got["port"], exp[:len(got["port"])])
    np.testing.assert_array_equal(got["port"], got["jax"])
    assert calls["port"] == calls["jax"]
    assert "deactivateStream" in [c[0] for c in calls["port"]]


def test_sdrplay_rejects_bad_modes():
    xs = np.zeros(4096, np.int16)
    for _, mod, _ in PKGS.values():
        _inject(mod.SDRplaySource, FakeSDRplay(mod, xs, xs))
        src = mod.SDRplaySource(98.5e6, 2e6, agc="warp9")
        src.differentiate([])
        with pytest.raises(ValueError, match="invalid agc"):
            src.initialize()
        src.cleanup()


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_missing_library_raises_clear_error(pkg):
    _, mod, _ = PKGS[pkg]
    src = mod.AirspyHFSource(7.1e6, 192e3)
    src.differentiate([])
    src.LIBRARY_NAMES = ("definitely_not_a_real_library_xyz",)
    with pytest.raises(RuntimeError, match="vendor library not found"):
        src.initialize()


def test_soapysdr_without_bindings_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "SoapySDR", None)
    src = tl.SoapySDRSource("driver=x", 1e8, 1e6)
    src.differentiate([])
    with pytest.raises(RuntimeError, match="SoapySDR Python bindings"):
        src.initialize()


def test_sdr_stall_warns_instead_of_silent_eof():
    src = tl.RtlSdrSource(104.3e6, 2.4e6)
    src.differentiate([])
    src.READ_TIMEOUT = 0.1
    src._make_ring()
    src.ring.write(np.zeros(10, np.uint8))   # some data, then silence
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = src._ring_read(np.empty(100, np.uint8))
    assert got == 10
    assert any("stalled" in str(x.message) for x in w)


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------

def _x(rng, n, scale=1.0):
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * scale).astype(np.complex64)


def _wait(pred, secs=2.0):
    deadline = time.monotonic() + secs
    while time.monotonic() < deadline and not pred():
        time.sleep(0.01)


def _hackrf_sink(pkg, rng):
    m, _, mod = PKGS[pkg]
    fake = _inject(mod.HackRFSink,
                   FakeHackRF(PKGS[pkg][1], n_buffers=3, buf_samples=2048))
    sink = mod.HackRFSink(433e6, vga_gain=20)
    fake.sink = sink
    sink.differentiate([m.ComplexFloat32])
    sink.input_rate = 2e6
    x = _x(rng, 2 * 2048, 0.5)
    sink.initialize()
    sink.process(x)
    fake._thread.join(timeout=2.0)
    sent = np.concatenate(fake.sent)
    exp = np.clip(x.view(np.float32) * 127.0, -128, 127).astype(np.int8)
    n = min(len(sent), len(exp))
    assert n >= 2 * 2048
    np.testing.assert_array_equal(sent[:n], exp[:n])
    sink.cleanup()
    return fake, sent


def _bladerf_sink(pkg, rng):
    m, _, mod = PKGS[pkg]
    fake = _inject(mod.BladeRFSink, FakeBladeRF(PKGS[pkg][1], n_reads=0))
    sink = mod.BladeRFSink(915e6, gain=30, bandwidth=5e6)
    sink.differentiate([m.ComplexFloat32])
    sink.input_rate = 10e6
    sink.initialize()
    x = _x(rng, 8192, 0.4)
    sink.process(x)
    _wait(lambda: sum(len(s) // 2 for s in fake.sent) >= len(x))
    sink.cleanup()
    sent = np.concatenate(fake.sent)
    exp = np.clip(x.view(np.float32) * 2048.0, -2048, 2047).astype(np.int16)
    assert len(sent) >= len(exp)
    np.testing.assert_array_equal(sent[:len(exp)], exp)
    return fake, sent[:len(exp)]


def _uhd_sink(pkg, rng):
    m, _, mod = PKGS[pkg]
    fake = _inject(mod.UHDSink, FakeUHD(PKGS[pkg][1], n_reads=0))
    sink = mod.UHDSink("addr=192.168.10.3", 915e6, gain=15,
                       antenna="TX/RX")
    sink.differentiate([m.ComplexFloat32])
    sink.input_rate = 5e6
    sink.initialize()
    x = _x(rng, 4096)
    sink.process(x)
    _wait(lambda: sum(len(s) // 2 for s in fake.sent) >= len(x))
    sink.cleanup()
    sent = np.concatenate(fake.sent).view(np.complex64)
    np.testing.assert_array_equal(sent[:len(x)], x)
    return fake, sent[:len(x)]


SINKS = {"hackrf": _hackrf_sink, "bladerf": _bladerf_sink, "uhd": _uhd_sink}


@pytest.mark.parametrize("driver", sorted(SINKS))
def test_sink_matches_jax(driver):
    """The TX sink's vendor calls and the wire it sends, bit for bit, on
    both packages fed the same samples."""
    runs = {pkg: SINKS[driver](pkg, np.random.default_rng(22))
            for pkg in PKGS}
    (jf, jsent), (tf, tsent) = runs["jax"], runs["port"]
    assert _calls(tf) == _calls(jf)
    np.testing.assert_array_equal(tsent, jsent)


def test_soapysdr_sink_matches_jax(monkeypatch):
    x = _x(np.random.default_rng(23), 4096)
    sent = {}
    for pkg, (m, _, mod) in PKGS.items():
        _install_fake_soapy(monkeypatch)
        sink = mod.SoapySDRSink("driver=fake", 433e6, gain=10)
        sink.differentiate([m.ComplexFloat32])
        sink.input_rate = 1e6
        sink.initialize()
        sink.process(x)
        dev = FakeSoapyDevice.instances[0]
        _wait(lambda: sum(map(len, dev.written)) >= len(x))
        sink.cleanup()
        sent[pkg] = np.concatenate(dev.written)
    np.testing.assert_array_equal(sent["port"][:len(x)], x)
    np.testing.assert_array_equal(sent["port"], sent["jax"])


# ---------------------------------------------------------------------------
# device_ingest and the wire run
# ---------------------------------------------------------------------------

#: every driver with a wire ring: (class, wire dtype, offset, scale)
WIRE = {
    "rtlsdr": (tl.RtlSdrSource, np.uint8, 127.5, 1 / 127.5),
    "hackrf": (tl.HackRFSource, np.int8, 0.0, 1 / 127.5),
    "airspy": (tl.AirspySource, np.int16, 0.0, 1 / 32768),
    "hydrasdr": (tl.HydraSDRSource, np.int16, 0.0, 1 / 32768),
    "bladerf": (tl.BladeRFSource, np.int16, 0.0, 1 / 2048),
    "uhd": (tl.UHDSource, np.int16, 0.0, 1 / 32767),
    "soapysdr": (tl.SoapySDRSource, np.int16, 0.0, 1 / 32767),
    "sdrplay": (tl.SDRplaySource, np.int16, 0.0, 1 / 32767.5),
}


@pytest.mark.parametrize("driver", sorted(WIRE))
def test_device_ingest_equals_read_over_every_code(driver):
    """device_ingest on a CPU tensor of every code of the driver's wire
    type equals read()'s host conversion of the same ring, bit for bit,
    and the table of offsets and scales is the JAX package's."""
    cls, dtype, offset, scale = WIRE[driver]
    jcls = getattr(jl, cls.__name__)
    assert (cls._wire_offset, cls._wire_scale, np.dtype(cls.wire_dtype)) \
        == (jcls._wire_offset, jcls._wire_scale, np.dtype(jcls._wire_dtype))
    assert (cls._wire_offset, cls._wire_scale) == (offset, scale)
    info = np.iinfo(dtype)
    codes = np.arange(info.min, info.max + 1).astype(dtype)
    raw = np.concatenate([codes, codes[::-1]])       # even: (I, Q) pairs
    src = (cls("x", 1e8, 1e6) if driver in ("uhd", "soapysdr")
           else cls(1e8, 1e6))
    src._make_ring()
    src.ring.write(raw)
    host = src.read(len(raw) // 2)
    dev = src.device_ingest()(torch.from_numpy(raw))
    assert dev.dtype == torch.complex64
    np.testing.assert_array_equal(dev.numpy(), host)
    exp = ((raw.astype(np.float32) - np.float32(offset))
           * np.float32(scale)).view(np.complex64)
    np.testing.assert_array_equal(host, exp)


def test_wire_feed_chunks_read_ahead_keep_their_contents():
    """An s8 HackRF ring's wire feed on the CPU: four chunks read before
    any is consumed keep their own items, each equal after conversion to
    read()'s host conversion of a twin ring, bit for bit.  At the ring's
    close the short last chunk's tail is zero and its nvalid right.
    Nothing is staged pinned."""
    want = 1000
    raw = np.random.default_rng(5).integers(
        -128, 128, 2 * (3 * want + 321)).astype(np.int8)
    wire, host = tl.HackRFSource(1e8, 1e6), tl.HackRFSource(1e8, 1e6)
    for s in (wire, host):
        s._make_ring()
        s.ring.write(raw)
        s.ring.close()
    feed = Feed(wire, "wire", ["h.0"], want, copied=True,
                ingest=wire.device_ingest())
    pinned = Feed.pinned_chunks
    chunks = []
    for _ in range(4):
        values, nvalid = {}, {}
        short = feed.read(values, nvalid)
        chunks.append((values["h.0"], nvalid["h.0"], short))
    assert feed.read({}, {}) is None
    assert Feed.pinned_chunks == pinned
    assert [(nv, short) for _, nv, short in chunks] == [
        (want, False)] * 3 + [(321, True)]
    for w, nv, _ in chunks:
        assert w.dtype == np.int8 and w.shape == (2 * want,)
        assert not w[2 * nv:].any()
        np.testing.assert_array_equal(
            feed.ingest(torch.from_numpy(w[:2 * nv])).numpy(),
            host.read(want))


def _wire_graph(mod, src, path, gain):
    top = mod.CompositeBlock()
    top.connect(src, mod.MultiplyConstantBlock(gain),
                mod.IQFileSink(path, "f32le"))
    return top


def _make_wire_source(driver, mod, data, monkeypatch):
    if driver == "rtlsdr":
        _inject(mod.RtlSdrSource, FakeRtlSdr(mod, data, n_reads=4))
        return mod.RtlSdrSource(104.3e6, 2.4e6), 2.0
    if driver == "uhd":
        _inject(mod.UHDSource, FakeUHD(mod, data))
        return mod.UHDSource("addr=192.168.10.2", 915e6, 10e6), 0.5
    _install_fake_soapy(monkeypatch)
    FakeSoapyDevice.rx_data = data
    return mod.SoapySDRSource("driver=fake", 433e6, 1e6), 0.5


WIRE_DATA = {
    "rtlsdr": lambda r: r.integers(0, 256, 2 * 4 * (1 << 16)
                                   ).astype(np.uint8),
    "uhd": lambda r: _s16(r, 2 * 3 * (1 << 16), 9000),
    "soapysdr": lambda r: _s16(r, (3 * (1 << 16), 2), 7000),
}


@pytest.mark.parametrize("driver", sorted(WIRE_DATA))
def test_wire_run_matches_host_conversion_and_jax(driver, tmp_path,
                                                  monkeypatch):
    """The source ships its raw wire items through the port's fused
    Runner when every consumer is a device block (its feed's route is
    ``"wire"``); the output equals the run where the source converts on
    the host (device_ingest off) and the JAX package's wire run, bit for
    bit."""
    data = WIRE_DATA[driver](np.random.default_rng(123))
    outs = {}
    for run in ("wire", "host", "jax"):
        mod = jsdr if run == "jax" else tsdr
        src, gain = _make_wire_source(driver, mod, data, monkeypatch)
        if run == "host":
            src.device_ingest = lambda: None
        path = str(tmp_path / f"{run}.iq")
        if run == "jax":
            r = JRunner(_wire_graph(jl, src, path, gain), mode="fused",
                        chunk_size=1 << 14, ingest="wire")
        else:
            r = Runner(_wire_graph(tl, src, path, gain), chunk_size=1 << 14,
                       device="cpu")
        if run == "jax":
            assert len(r._wire_srcs) == 1
        else:
            assert [f.route for f in r.feeds] == [run]
        r.run()
        outs[run] = np.fromfile(path, dtype=np.complex64)
    assert outs["wire"].size >= 2 * (1 << 14)
    np.testing.assert_array_equal(outs["wire"], outs["host"])
    np.testing.assert_array_equal(outs["wire"], outs["jax"])
