"""SDR hardware sources: ctypes bindings with asynchronous lossless ingest
(the JAX package's blocks/sources/sdr.py; reference
radio/blocks/sources/{rtlsdr,airspy,airspyhf,hackrf,hydrasdr,sdrplay,
bladerf,uhd,soapysdr}.lua).  The ctypes structures, the drivers' call
sequences and the ``_injected_lib`` test hook are the JAX package's; only
``device_ingest`` differs, as a torch function on the wire tensor.

The reference reaches vendor C libraries through LuaJIT FFI, with async
read callbacks manufactured in a separate Lua state so driver threads can
call them (radio/core/async.lua:74).  Here each driver is a ctypes binding
(ctypes acquires the GIL for foreign-thread callbacks natively) and every
source shares one ingest architecture:

    vendor USB thread / reader thread  ->  SampleRingBuffer  ->  read()

so hardware streaming never stalls on device compute or host I/O — the
flow-graph pump drains the ring in chunk-sized reads while the driver
keeps capturing (blocking sync reads in the pump loop would drop
samples at 2+ MS/s whenever a downstream stage stalls).  Overruns are counted (``ring.overflows``), not silent.

Like the reference, hardware blocks are constructible without hardware;
a missing vendor library raises a clear error at initialize().  The
bindings are exercised in CI against fake ctypes libraries
(tests/test_torch_sdr.py) — the reference ships its SDR drivers untested.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import threading
from ctypes import (CFUNCTYPE, POINTER, byref, c_bool, c_char, c_char_p,
                    c_double, c_int, c_int16, c_int64, c_size_t,
                    c_uint8, c_uint32, c_uint64, c_void_p)

import numpy as np

from luaradio_tpu_torch.core.block import HostSourceBlock, Output
from luaradio_tpu_torch.ops.complexutil import wire_converter
from luaradio_tpu_torch.types import ComplexFloat32
from luaradio_tpu_torch.utils.ringbuffer import SampleRingBuffer


def _load_library(*names):
    for name in names:
        path = ctypes.util.find_library(name)
        if path:
            try:
                return ctypes.CDLL(path)
            except OSError:
                continue
        try:
            return ctypes.CDLL(f"lib{name}.so")
        except OSError:
            continue
    return None


class _SDRSourceBase(HostSourceBlock):
    """Common scaffolding: ComplexFloat32 output, tuned frequency, ring
    buffer ingest shared by all drivers."""

    LIBRARY_NAMES: tuple = ()
    #: ring capacity in seconds of samples at the source rate
    RING_SECONDS = 2.0
    #: read() returns EOF after this long with no samples (dead hardware)
    READ_TIMEOUT = 5.0
    #: test hook: inject a fake ctypes library (tests/test_torch_sdr.py)
    _injected_lib = None

    def __init__(self, frequency: float, rate: float, **options):
        super().__init__()
        self.frequency = float(frequency)
        self.rate = float(rate)
        self.options = options
        self.ring: SampleRingBuffer | None = None
        self.add_type_signature([], [Output("out", ComplexFloat32)])

    def _require_library(self):
        if type(self)._injected_lib is not None:
            return type(self)._injected_lib
        lib = _load_library(*self.LIBRARY_NAMES)
        if lib is None:
            raise RuntimeError(
                f"{self.name}: vendor library not found "
                f"(tried {', '.join(self.LIBRARY_NAMES)}); install the "
                f"driver or use a file/network source")
        return lib

    #: drivers whose ring stores raw integer wire items set offset, scale
    #: and dtype (float = (raw - offset) * scale, exact in float32): the
    #: plumbing below then offers the wire route (core/ingest.py).
    _wire_offset: float | None = None
    _wire_scale: float | None = None
    wire_dtype = np.uint8
    wire_factor = 2           # wire items (I, Q) per complex sample

    def _make_ring(self):
        cap = max(int(self.rate * self.RING_SECONDS), 1 << 18)
        if self._wire_offset is not None:
            self.ring = SampleRingBuffer(self.wire_factor * cap,
                                         self.wire_dtype)
        else:
            self.ring = SampleRingBuffer(cap, np.complex64)
        return self.ring

    def _ring_read(self, out: np.ndarray) -> int:
        """Exactly ``out.size`` ring items written into ``out``, blocking
        while the radio produces them in real time (a short mid-stream
        read would be misread as EOF by the static-chunk runtime); the
        final partial batch at stream close, then 0 at EOF; 0 too on a
        stalled producer (timeout with no data — dead hardware).  Returns
        the items written.  The timeout scales with the chunk's real-time
        duration so big chunks at low rates are not misread as stalls."""
        items = out.size
        if items > self.ring.capacity:
            raise ValueError(
                f"{self.name}: a chunk needs {items} ring items but the "
                f"ring holds {self.ring.capacity}; increase RING_SECONDS "
                f"or reduce chunk_size")
        per_s = self.rate * (self.wire_factor
                             if self._wire_offset is not None else 1)
        timeout = max(self.READ_TIMEOUT, 2.0 * items / per_s)
        got = self.ring.read_exact(items, out, timeout=timeout)
        if not got:
            if got is not None and not self.ring.closed:
                import warnings
                warnings.warn(
                    f"{self.name}: no samples for {timeout:.1f}s (stalled "
                    f"producer); treating the stream as ended",
                    RuntimeWarning, stacklevel=3)
            return 0
        if got < items and not self.ring.closed:
            import warnings
            warnings.warn(
                f"{self.name}: producer stalled mid-chunk ({got}/"
                f"{items} ring items after a {timeout:.1f}s no-progress "
                f"window); treating the partial chunk as end of stream",
                RuntimeWarning, stacklevel=3)
        return got

    def read(self, n: int):
        """A full n-sample complex chunk (the host route)."""
        if self._wire_offset is None:
            out = np.empty(n, np.complex64)
            got = self._ring_read(out)
            return out[:got] if got else None
        k = self.wire_factor
        raw = np.empty(k * n, self.wire_dtype)
        count = self.read_wire_into(raw)
        if count == 0:
            return None
        f = (raw[:k * count].astype(np.float32)
             - np.float32(self._wire_offset)) * np.float32(self._wire_scale)
        return f.view(np.complex64)

    def read_wire_into(self, out: np.ndarray) -> int:
        """Raw interleaved wire items from the ring written into ``out``;
        returns the whole complex samples written (0 at EOF)."""
        return self._ring_read(out) // self.wire_factor

    def device_ingest(self):
        """``raw tensor -> complex64`` on the tensor's device, equal to
        read()'s host conversion (a float32 product) bit for bit."""
        if self._wire_offset is None:
            return None
        return wire_converter(self._wire_offset, self._wire_scale,
                              divide=False)


class _ReaderThreadSource(_SDRSourceBase):
    """Drivers with blocking sync-read APIs (librtlsdr, libbladeRF, libuhd,
    SoapySDR): a dedicated reader thread pulls from the hardware and feeds
    the ring, the analog of the reference's async read callbacks."""

    def _start_reader(self):
        self._reader_stop = threading.Event()
        self._reader = threading.Thread(target=self._reader_main, daemon=True)
        self._reader.start()

    def _reader_main(self):
        try:
            while not self._reader_stop.is_set():
                chunk = self._read_hw()
                if chunk is None:
                    break
                if len(chunk):
                    self.ring.write(chunk)
        finally:
            self.ring.close()

    def _read_hw(self) -> np.ndarray | None:
        raise NotImplementedError

    def _stop_reader(self) -> bool:
        """Stop the reader thread.  Returns True when it has exited — only
        then may the caller free the vendor handle.  A reader stalled
        inside a blocking vendor call (dead hardware) keeps the handle
        alive (leaked, with a warning) instead of a use-after-free."""
        ok = True
        if getattr(self, "_reader_stop", None) is not None:
            self._reader_stop.set()
        if self.ring is not None:
            self.ring.close()   # unblocks a reader waiting on ring space
        reader = getattr(self, "_reader", None)
        if reader is not None:
            reader.join(timeout=2.0)
            if reader.is_alive():
                import warnings
                warnings.warn(
                    f"{self.name}: reader thread still blocked in the "
                    f"vendor library after 2s; leaking the device handle "
                    f"instead of freeing it under the reader",
                    RuntimeWarning, stacklevel=2)
                ok = False
            else:
                self._reader = None
        return ok


# ---------------------------------------------------------------------------
# RTL-SDR (librtlsdr) — reference: rtlsdr.lua
# ---------------------------------------------------------------------------

class RtlSdrSource(_ReaderThreadSource):
    """RTL-SDR dongle source (reference: rtlsdr.lua:98-266).

    Options: freq_correction (ppm), gain (dB, None = autogain),
    bias_tee (bool)."""

    LIBRARY_NAMES = ("rtlsdr",)
    _READ_BYTES = 1 << 17  # 64k complex samples per USB read
    # raw u8 wire ring: the reader thread does no conversion, and only
    # 2 bytes/sample cross the host->device link when every consumer is
    # a device block (the card applies the identical (u8-127.5)*(1/127.5)
    # — the reference converts per sample on the host in the USB callback,
    # rtlsdr.lua:224-232)
    _wire_offset = 127.5
    _wire_scale = 1.0 / 127.5

    def initialize(self):
        lib = self._require_library()
        self._lib = lib
        dev = c_void_p()
        if lib.rtlsdr_open(byref(dev), 0) != 0:
            raise RuntimeError("rtlsdr_open() failed (no device?)")
        self._dev = dev
        lib.rtlsdr_set_sample_rate(dev, int(self.rate))
        lib.rtlsdr_set_center_freq(dev, int(self.frequency))
        ppm = int(self.options.get("freq_correction", 0))
        if ppm:
            lib.rtlsdr_set_freq_correction(dev, ppm)
        gain = self.options.get("gain")
        if gain is None:
            lib.rtlsdr_set_tuner_gain_mode(dev, 0)  # autogain
        else:
            lib.rtlsdr_set_tuner_gain_mode(dev, 1)
            lib.rtlsdr_set_tuner_gain(dev, int(gain * 10))
        if self.options.get("bias_tee"):
            lib.rtlsdr_set_bias_tee(dev, 1)
        lib.rtlsdr_reset_buffer(dev)
        self._buf = (c_uint8 * self._READ_BYTES)()
        self._make_ring()
        self._start_reader()

    def _read_hw(self):
        got = c_int(0)
        r = self._lib.rtlsdr_read_sync(self._dev, self._buf,
                                       self._READ_BYTES, byref(got))
        if r != 0 or got.value <= 0:
            return None
        # raw u8 wire bytes into the ring; conversion happens on the
        # device (wire ingest) or lazily in read() for host consumers
        return np.frombuffer(self._buf, dtype=np.uint8,
                             count=got.value & ~1).copy()

    def cleanup(self):
        if self._stop_reader() and getattr(self, "_dev", None):
            self._lib.rtlsdr_close(self._dev)
            self._dev = None


# ---------------------------------------------------------------------------
# HackRF One (libhackrf) — reference: hackrf.lua
# ---------------------------------------------------------------------------

class _hackrf_transfer(ctypes.Structure):
    _fields_ = [("device", c_void_p),
                ("buffer", POINTER(c_uint8)),
                ("buffer_length", c_int),
                ("valid_length", c_int),
                ("rx_ctx", c_void_p),
                ("tx_ctx", c_void_p)]


_HACKRF_CB = CFUNCTYPE(c_int, POINTER(_hackrf_transfer))


class HackRFSource(_SDRSourceBase):
    """HackRF One source (reference: hackrf.lua:1-296).

    Options: lna_gain (0..40 dB, 8 dB steps, default 8),
    vga_gain (0..62 dB, 2 dB steps, default 40), bandwidth (Hz, default
    round-down from rate), rf_amplifier_enable, antenna_power_enable."""

    LIBRARY_NAMES = ("hackrf",)
    # raw s8 wire ring: 2 bytes/sample on the host->device link, the card
    # applies the reference's s8 * (1/127.5) (hackrf.lua:244-245)
    _wire_offset = 0.0
    _wire_scale = 1.0 / 127.5
    wire_dtype = np.int8

    def initialize(self):
        lib = self._require_library()
        self._lib = lib
        r = lib.hackrf_init()
        if r != 0:
            raise RuntimeError(f"hackrf_init() failed ({r})")
        dev = c_void_p()
        r = lib.hackrf_open(byref(dev))
        if r != 0:
            raise RuntimeError(f"hackrf_open() failed ({r}; no device?)")
        self._dev = dev

        lib.hackrf_set_sample_rate(dev, c_double(self.rate))
        bw = self.options.get("bandwidth")
        if bw is None:
            f = lib.hackrf_compute_baseband_filter_bw_round_down_lt
            f.restype = c_uint32
            bw = f(c_uint32(int(self.rate)))
        lib.hackrf_set_baseband_filter_bandwidth(dev, c_uint32(int(bw)))
        lib.hackrf_set_lna_gain(dev, c_uint32(
            int(self.options.get("lna_gain", 8))))
        lib.hackrf_set_vga_gain(dev, c_uint32(
            int(self.options.get("vga_gain", 40))))
        lib.hackrf_set_amp_enable(dev, c_uint8(
            1 if self.options.get("rf_amplifier_enable") else 0))
        lib.hackrf_set_antenna_enable(dev, c_uint8(
            1 if self.options.get("antenna_power_enable") else 0))
        lib.hackrf_set_freq(dev, c_uint64(int(self.frequency)))

        ring = self._make_ring()

        def on_rx(transfer_ptr):
            # vendor USB thread: raw s8 interleaved IQ straight into the
            # wire ring (conversion on-device, or lazily in read())
            t = transfer_ptr.contents
            n = t.valid_length & ~1
            if n <= 0:
                return 0
            raw = np.ctypeslib.as_array(t.buffer, shape=(n,))
            ring.write(raw.view(np.int8).copy())
            return 0  # continue streaming

        self._cb = _HACKRF_CB(on_rx)  # keep a ref: prevents GC
        r = lib.hackrf_start_rx(dev, self._cb, None)
        if r != 0:
            raise RuntimeError(f"hackrf_start_rx() failed ({r})")

    def cleanup(self):
        if getattr(self, "_dev", None):
            self._lib.hackrf_stop_rx(self._dev)
            self._lib.hackrf_close(self._dev)
            self._lib.hackrf_exit()
            self._dev = None
        if self.ring is not None:
            self.ring.close()


# ---------------------------------------------------------------------------
# Airspy R2 / Mini (libairspy) — reference: airspy.lua
# ---------------------------------------------------------------------------

class _airspy_transfer(ctypes.Structure):
    _fields_ = [("device", c_void_p),
                ("ctx", c_void_p),
                ("samples", c_void_p),
                ("sample_count", c_int),
                ("dropped_samples", c_uint64),
                ("sample_type", c_int)]


_AIRSPY_CB = CFUNCTYPE(c_int, POINTER(_airspy_transfer))
_AIRSPY_SAMPLE_FLOAT32_IQ = 0
_AIRSPY_SAMPLE_INT16_IQ = 2


class AirspySource(_SDRSourceBase):
    """Airspy R2/Mini source (reference: airspy.lua:1-375).

    Streams INT16_IQ and converts on-device: libairspy shifts its 12-bit
    samples to full 16-bit scale, so s16 * (1/32768) is numerically the
    same stream the reference receives via FLOAT32_IQ — at 4 bytes/sample
    on the host->device link instead of 8 (the reference converts nothing
    because the library hands it floats; here the link is the bottleneck).

    Options: gain_mode ("linearity"|"sensitivity"|"custom", default
    "linearity"), linearity_gain / sensitivity_gain (0..21, default 10),
    lna_gain / mixer_gain / vga_gain (custom mode), lna_agc / mixer_agc
    (custom mode), biastee_enable."""

    LIBRARY_NAMES = ("airspy",)
    _PREFIX = "airspy"
    _TRANSFER = _airspy_transfer
    _CBTYPE = _AIRSPY_CB
    # raw s16 wire ring (INT16_IQ): float = s16 * 2^-15, exact in float32
    _wire_offset = 0.0
    _wire_scale = 1.0 / 32768.0
    wire_dtype = np.int16

    def _call(self, fname, *args):
        fn = getattr(self._lib, f"{self._PREFIX}_{fname}")
        r = fn(*args)
        if r != 0:
            raise RuntimeError(f"{self._PREFIX}_{fname}() failed ({r})")
        return r

    def _configure_gains(self, dev):
        mode = self.options.get("gain_mode", "linearity")
        if mode == "linearity":
            self._call("set_linearity_gain", dev, c_uint8(
                int(self.options.get("linearity_gain", 10))))
        elif mode == "sensitivity":
            self._call("set_sensitivity_gain", dev, c_uint8(
                int(self.options.get("sensitivity_gain", 10))))
        elif mode == "custom":
            self._call("set_lna_gain", dev, c_uint8(
                int(self.options.get("lna_gain", 5))))
            self._call("set_mixer_gain", dev, c_uint8(
                int(self.options.get("mixer_gain", 1))))
            self._call("set_vga_gain", dev, c_uint8(
                int(self.options.get("vga_gain", 5))))
            self._call("set_lna_agc", dev, c_uint8(
                1 if self.options.get("lna_agc") else 0))
            self._call("set_mixer_agc", dev, c_uint8(
                1 if self.options.get("mixer_agc") else 0))
        else:
            raise ValueError(f"{self.name}: unknown gain_mode {mode!r}")

    def initialize(self):
        self._lib = self._require_library()
        dev = c_void_p()
        self._call("open", byref(dev))
        self._dev = dev
        self._call("set_sample_type", dev, c_int(_AIRSPY_SAMPLE_INT16_IQ))
        self._call("set_samplerate", dev, c_uint32(int(self.rate)))
        self._configure_gains(dev)
        if self.options.get("biastee_enable"):
            self._call("set_rf_bias", dev, c_uint8(1))
        self._call("set_freq", dev, c_uint32(int(self.frequency)))

        ring = self._make_ring()

        def on_rx(transfer_ptr):
            t = transfer_ptr.contents
            n = t.sample_count
            if n > 0 and t.samples:
                # raw s16 interleaved IQ into the wire ring; conversion
                # happens on-device (wire ingest) or lazily in read()
                buf = ctypes.cast(t.samples, POINTER(c_int16 * (2 * n)))
                iq = np.frombuffer(buf.contents, dtype=np.int16).copy()
                ring.write(iq)
            if t.dropped_samples:
                ring.dropped_samples += int(t.dropped_samples)
            return 0

        self._cb = self._CBTYPE(on_rx)
        self._call("start_rx", dev, self._cb, None)

    def cleanup(self):
        if getattr(self, "_dev", None):
            try:
                self._call("stop_rx", self._dev)
            finally:
                self._call("close", self._dev)
                self._dev = None
        if self.ring is not None:
            self.ring.close()


class _hydrasdr_transfer(ctypes.Structure):
    _fields_ = _airspy_transfer._fields_


_HYDRASDR_CB = CFUNCTYPE(c_int, POINTER(_hydrasdr_transfer))


class HydraSDRSource(AirspySource):
    """HydraSDR RFOne source (reference: hydrasdr.lua:1-374 — the C API
    mirrors libairspy with a hydrasdr_ prefix)."""

    LIBRARY_NAMES = ("hydrasdr",)
    _PREFIX = "hydrasdr"
    _TRANSFER = _hydrasdr_transfer
    _CBTYPE = _HYDRASDR_CB


# ---------------------------------------------------------------------------
# Airspy HF+ (libairspyhf) — reference: airspyhf.lua
# ---------------------------------------------------------------------------

class _airspyhf_transfer(ctypes.Structure):
    _fields_ = [("device", c_void_p),
                ("ctx", c_void_p),
                ("samples", c_void_p),       # airspyhf_complex_float_t*
                ("sample_count", c_int),
                ("dropped_samples", c_uint64)]


_AIRSPYHF_CB = CFUNCTYPE(c_int, POINTER(_airspyhf_transfer))


class AirspyHFSource(_SDRSourceBase):
    """Airspy HF+ source (reference: airspyhf.lua:1-315).

    No wire-ingest path: libairspyhf's only sample format is float32 IQ
    (its DDC runs in float), so the "wire" bytes ARE the complex64
    payload, which crosses the host->device link as it is.

    Options: hf_agc (default True), hf_agc_threshold ("low"|"high"),
    hf_att (0..48 dB in 6 dB steps, manual attenuation), hf_lna (bool)."""

    LIBRARY_NAMES = ("airspyhf",)

    def _call(self, fname, *args):
        fn = getattr(self._lib, f"airspyhf_{fname}")
        r = fn(*args)
        if r != 0:
            raise RuntimeError(f"airspyhf_{fname}() failed ({r})")

    def initialize(self):
        self._lib = self._require_library()
        dev = c_void_p()
        self._call("open", byref(dev))
        self._dev = dev
        self._call("set_samplerate", dev, c_uint32(int(self.rate)))
        hf_agc = self.options.get("hf_agc", True)
        self._call("set_hf_agc", dev, c_uint8(1 if hf_agc else 0))
        if hf_agc:
            thresh = self.options.get("hf_agc_threshold", "low")
            self._call("set_hf_agc_threshold", dev,
                       c_uint8(0 if thresh == "low" else 1))
        else:
            att = int(self.options.get("hf_att", 0))
            self._call("set_hf_att", dev, c_uint8(att // 6))
        self._call("set_hf_lna", dev, c_uint8(
            1 if self.options.get("hf_lna") else 0))
        self._call("set_freq", dev, c_uint32(int(self.frequency)))

        ring = self._make_ring()

        def on_rx(transfer_ptr):
            t = transfer_ptr.contents
            n = t.sample_count
            if n > 0 and t.samples:
                buf = ctypes.cast(t.samples, POINTER(ctypes.c_float * (2 * n)))
                iq = np.frombuffer(buf.contents, dtype=np.float32).copy()
                ring.write(iq.view(np.complex64))
            if t.dropped_samples:
                ring.dropped_samples += int(t.dropped_samples)
            return 0

        self._cb = _AIRSPYHF_CB(on_rx)
        self._call("start", dev, self._cb, None)

    def cleanup(self):
        if getattr(self, "_dev", None):
            try:
                self._call("stop", self._dev)
            finally:
                self._call("close", self._dev)
                self._dev = None
        if self.ring is not None:
            self.ring.close()


# ---------------------------------------------------------------------------
# Nuand bladeRF (libbladeRF) — reference: bladerf.lua
# ---------------------------------------------------------------------------

_BLADERF_RX_X1 = 0          # bladerf_channel_layout
_BLADERF_FORMAT_SC16_Q11 = 0
_BLADERF_GAIN_DEFAULT = 0
_BLADERF_GAIN_MGC = 1


def _bladerf_channel_rx(ch: int) -> int:
    return (ch << 1) | 0x0


class BladeRFSource(_ReaderThreadSource):
    """Nuand bladeRF source (reference: bladerf.lua:1-447).

    Options: device_id (str, default ""), channel (int, default 0),
    gain (dB, manual), bandwidth (Hz, default 80% of rate),
    autogain (default True when gain is None)."""

    LIBRARY_NAMES = ("bladeRF",)
    _SYNC_SAMPLES = 1 << 16

    def initialize(self):
        lib = self._require_library()
        self._lib = lib
        dev = c_void_p()
        devid = self.options.get("device_id", "").encode()
        r = lib.bladerf_open(byref(dev), devid or None)
        if r != 0:
            raise RuntimeError(f"bladerf_open() failed ({r}; no device?)")
        self._dev = dev
        ch = _bladerf_channel_rx(int(self.options.get("channel", 0)))
        self._ch = ch

        actual = c_uint32(0)
        r = lib.bladerf_set_sample_rate(dev, ch, c_uint32(int(self.rate)),
                                        byref(actual))
        if r != 0:
            raise RuntimeError(f"bladerf_set_sample_rate() failed ({r})")
        bw = int(self.options.get("bandwidth", 0.8 * self.rate))
        lib.bladerf_set_bandwidth(dev, ch, c_uint32(bw), byref(actual))
        gain = self.options.get("gain")
        autogain = self.options.get("autogain", gain is None)
        if autogain:
            lib.bladerf_set_gain_mode(dev, ch, _BLADERF_GAIN_DEFAULT)
        else:
            lib.bladerf_set_gain_mode(dev, ch, _BLADERF_GAIN_MGC)
            lib.bladerf_set_gain(dev, ch, c_int(int(gain or 0)))
        r = lib.bladerf_set_frequency(dev, ch, c_uint64(int(self.frequency)))
        if r != 0:
            raise RuntimeError(f"bladerf_set_frequency() failed ({r})")

        # sync RX: 16 buffers x 8192 samples, 8 transfers (reference
        # bladerf.lua:390 uses the same sync-config shape)
        r = lib.bladerf_sync_config(dev, _BLADERF_RX_X1,
                                    _BLADERF_FORMAT_SC16_Q11,
                                    c_uint32(16), c_uint32(8192),
                                    c_uint32(8), c_uint32(1000))
        if r != 0:
            raise RuntimeError(f"bladerf_sync_config() failed ({r})")
        r = lib.bladerf_enable_module(dev, ch, True)
        if r != 0:
            raise RuntimeError(f"bladerf_enable_module() failed ({r})")

        self._buf = (c_int16 * (2 * self._SYNC_SAMPLES))()
        self._make_ring()
        self._start_reader()

    # raw SC16_Q11 wire ring: 4 bytes/sample on the host->device link
    # instead of 8, converted on the card (11 fractional bits, exact in
    # float32)
    _wire_offset = 0.0
    _wire_scale = 1.0 / 2048.0
    wire_dtype = np.int16

    def _read_hw(self):
        r = self._lib.bladerf_sync_rx(self._dev, self._buf,
                                      c_uint32(self._SYNC_SAMPLES), None,
                                      c_uint32(1000))
        if r != 0:
            return None
        return np.frombuffer(self._buf, dtype=np.int16,
                             count=2 * self._SYNC_SAMPLES).copy()

    def cleanup(self):
        if self._stop_reader() and getattr(self, "_dev", None):
            self._lib.bladerf_enable_module(self._dev, self._ch, False)
            self._lib.bladerf_close(self._dev)
            self._dev = None


# ---------------------------------------------------------------------------
# Ettus USRP (libuhd C API) — reference: uhd.lua
# ---------------------------------------------------------------------------

class _uhd_tune_request(ctypes.Structure):
    _fields_ = [("target_freq", c_double),
                ("rf_freq_policy", c_int),
                ("rf_freq", c_double),
                ("dsp_freq_policy", c_int),
                ("dsp_freq", c_double),
                ("args", c_char_p)]


class _uhd_tune_result(ctypes.Structure):
    _fields_ = [("clipped_rf_freq", c_double),
                ("target_rf_freq", c_double),
                ("actual_rf_freq", c_double),
                ("target_dsp_freq", c_double),
                ("actual_dsp_freq", c_double)]


class _uhd_stream_args(ctypes.Structure):
    _fields_ = [("cpu_format", c_char_p),
                ("otw_format", c_char_p),
                ("args", c_char_p),
                ("channel_list", POINTER(c_size_t)),
                ("n_channels", c_int)]


class _uhd_stream_cmd(ctypes.Structure):
    _fields_ = [("stream_mode", c_int),
                ("num_samps", c_size_t),
                ("stream_now", c_bool),
                ("time_spec_full_secs", c_int64),
                ("time_spec_frac_secs", c_double)]


_UHD_TUNE_POLICY_AUTO = 65
_UHD_STREAM_MODE_START_CONTINUOUS = 97
_UHD_STREAM_MODE_STOP_CONTINUOUS = 111


class UHDSource(_ReaderThreadSource):
    """Ettus USRP source via the libuhd C API (reference: uhd.lua:1-658).

    Options: channel (int, default 0), gain (dB, overall), gains (dict of
    per-stage gain element name -> dB, reference uhd.lua options.gains),
    bandwidth (Hz), antenna (str), autogain (default True when no gain
    given), clock_source / time_source (str, e.g. "external", "gpsdo"),
    subdev (str subdevice spec, e.g. "A:0")."""

    LIBRARY_NAMES = ("uhd",)
    _RECV_SAMPLES = 1 << 16
    # raw sc16 wire ring: cpu_format "sc16" skips UHD's own host-side
    # sc16->fc32 conversion AND halves->quarters the link bytes; the card
    # applies UHD's converter scale, s16 * (1/32767) (the reference asks
    # UHD for fc32 with otw sc16 and gets the identical stream,
    # uhd.lua stream_args)
    _wire_offset = 0.0
    _wire_scale = 1.0 / 32767.0
    wire_dtype = np.int16

    def __init__(self, device: str, frequency: float, rate: float, **options):
        super().__init__(frequency, rate, **options)
        # the UHD device arguments ("addr=..."); ``device`` is the torch
        # device the graph runs on (core/block.py)
        self.device_args = device

    def _check(self, name, r):
        if r != 0:
            raise RuntimeError(f"{name}() failed (uhd_error {r})")

    def initialize(self):
        lib = self._require_library()
        self._lib = lib
        usrp = c_void_p()
        self._check("uhd_usrp_make",
                    lib.uhd_usrp_make(byref(usrp), self.device_args.encode()))
        self._usrp = usrp
        ch = c_size_t(int(self.options.get("channel", 0)))
        mb = c_size_t(0)
        # motherboard-level configuration (clock/time source, subdevice)
        if "clock_source" in self.options:
            self._check("uhd_usrp_set_clock_source",
                        lib.uhd_usrp_set_clock_source(
                            usrp, self.options["clock_source"].encode(), mb))
        if "time_source" in self.options:
            self._check("uhd_usrp_set_time_source",
                        lib.uhd_usrp_set_time_source(
                            usrp, self.options["time_source"].encode(), mb))
        if "subdev" in self.options:
            spec = c_void_p()
            self._check("uhd_subdev_spec_make",
                        lib.uhd_subdev_spec_make(
                            byref(spec), self.options["subdev"].encode()))
            try:
                self._check("uhd_usrp_set_rx_subdev_spec",
                            lib.uhd_usrp_set_rx_subdev_spec(usrp, spec, mb))
            finally:
                lib.uhd_subdev_spec_free(byref(spec))
        self._check("uhd_usrp_set_rx_rate",
                    lib.uhd_usrp_set_rx_rate(usrp, c_double(self.rate), ch))
        gain = self.options.get("gain")
        autogain = self.options.get("autogain", gain is None
                                    and not self.options.get("gains"))
        if autogain and hasattr(lib, "uhd_usrp_set_rx_agc"):
            lib.uhd_usrp_set_rx_agc(usrp, True, ch)
        elif gain is not None:
            self._check("uhd_usrp_set_rx_gain",
                        lib.uhd_usrp_set_rx_gain(usrp, c_double(gain), ch,
                                                 b""))
        # per-stage named gain elements (reference uhd.lua options.gains)
        for gname, gval in (self.options.get("gains") or {}).items():
            self._check("uhd_usrp_set_rx_gain",
                        lib.uhd_usrp_set_rx_gain(usrp, c_double(gval), ch,
                                                 gname.encode()))
        if "bandwidth" in self.options:
            self._check("uhd_usrp_set_rx_bandwidth",
                        lib.uhd_usrp_set_rx_bandwidth(
                            usrp, c_double(self.options["bandwidth"]), ch))
        if "antenna" in self.options:
            self._check("uhd_usrp_set_rx_antenna",
                        lib.uhd_usrp_set_rx_antenna(
                            usrp, self.options["antenna"].encode(), ch))
        req = _uhd_tune_request(target_freq=self.frequency,
                                rf_freq_policy=_UHD_TUNE_POLICY_AUTO,
                                dsp_freq_policy=_UHD_TUNE_POLICY_AUTO)
        res = _uhd_tune_result()
        self._check("uhd_usrp_set_rx_freq",
                    lib.uhd_usrp_set_rx_freq(usrp, byref(req), ch,
                                             byref(res)))

        rx = c_void_p()
        self._check("uhd_rx_streamer_make",
                    lib.uhd_rx_streamer_make(byref(rx)))
        self._rx = rx
        chans = (c_size_t * 1)(ch.value)
        sargs = _uhd_stream_args(cpu_format=b"sc16", otw_format=b"sc16",
                                 args=b"", channel_list=chans, n_channels=1)
        self._check("uhd_usrp_get_rx_stream",
                    lib.uhd_usrp_get_rx_stream(usrp, byref(sargs), rx))
        md = c_void_p()
        self._check("uhd_rx_metadata_make",
                    lib.uhd_rx_metadata_make(byref(md)))
        self._md = md
        cmd = _uhd_stream_cmd(
            stream_mode=_UHD_STREAM_MODE_START_CONTINUOUS,
            num_samps=0, stream_now=True)
        self._check("uhd_rx_streamer_issue_stream_cmd",
                    lib.uhd_rx_streamer_issue_stream_cmd(rx, byref(cmd)))

        self._buf = np.zeros(2 * self._RECV_SAMPLES, dtype=np.int16)
        self._buf_ptr = (c_void_p * 1)(self._buf.ctypes.data)
        self._make_ring()
        self._start_reader()

    def _read_hw(self):
        got = c_size_t(0)
        r = self._lib.uhd_rx_streamer_recv(
            self._rx, self._buf_ptr, c_size_t(self._RECV_SAMPLES),
            byref(self._md), c_double(1.0), c_bool(False), byref(got))
        if r != 0:
            return None
        if got.value == 0:
            return np.empty(0, np.int16)
        return self._buf[:2 * got.value].copy()

    def cleanup(self):
        if not self._stop_reader():
            return  # reader stalled in uhd recv: leak rather than free
        lib = getattr(self, "_lib", None)
        if getattr(self, "_rx", None) and lib is not None:
            cmd = _uhd_stream_cmd(
                stream_mode=_UHD_STREAM_MODE_STOP_CONTINUOUS,
                num_samps=0, stream_now=True)
            lib.uhd_rx_streamer_issue_stream_cmd(self._rx, byref(cmd))
            lib.uhd_rx_streamer_free(byref(self._rx))
            self._rx = None
        if getattr(self, "_md", None) and lib is not None:
            lib.uhd_rx_metadata_free(byref(self._md))
            self._md = None
        if getattr(self, "_usrp", None) and lib is not None:
            lib.uhd_usrp_free(byref(self._usrp))
            self._usrp = None


# ---------------------------------------------------------------------------
# SDRplay RSP (sdrplay_api v3) — reference: sdrplay.lua
# ---------------------------------------------------------------------------

class _sdrplay_device(ctypes.Structure):
    _fields_ = [("SerNo", c_char * 64),
                ("hwVer", c_uint8),
                ("tuner", c_int),
                ("rspDuoMode", c_int),
                ("valid", c_uint8),
                ("rspDuoSampleFreq", c_double),
                ("dev", c_void_p)]


class _sdrplay_stream_cb_params(ctypes.Structure):
    _fields_ = [("firstSampleNum", c_uint32),
                ("grChanged", c_int),
                ("rfChanged", c_int),
                ("fsChanged", c_int),
                ("numSamples", c_uint32),
                ("reset", c_uint32)]


# Nested device-parameter structures per the published sdrplay_api.h v3
# layout (the same declarations the reference carries as FFI cdefs,
# sdrplay.lua:108-199).  Only the leading members of DevParamsT and
# RxChannelParamsT are declared: the API owns the allocations, so partial
# prefix declarations are safe for field access and immune to the
# device-model-specific tails.

class _sdrplay_fs_freq(ctypes.Structure):
    _fields_ = [("fsHz", c_double), ("syncUpdate", c_uint8),
                ("reCal", c_uint8)]


class _sdrplay_dev_params(ctypes.Structure):
    _fields_ = [("ppm", c_double), ("fsFreq", _sdrplay_fs_freq)]


class _sdrplay_gain_values(ctypes.Structure):
    _fields_ = [("curr", ctypes.c_float), ("max", ctypes.c_float),
                ("min", ctypes.c_float)]


class _sdrplay_gain(ctypes.Structure):
    _fields_ = [("gRdB", c_int), ("LNAstate", c_uint8),
                ("syncUpdate", c_uint8), ("minGr", c_int),
                ("gainVals", _sdrplay_gain_values)]


class _sdrplay_rf_freq(ctypes.Structure):
    _fields_ = [("rfHz", c_double), ("syncUpdate", c_uint8)]


class _sdrplay_dc_offset_tuner(ctypes.Structure):
    _fields_ = [("dcCal", c_uint8), ("speedUp", c_uint8),
                ("trackTime", c_int), ("refreshRateTime", c_int)]


class _sdrplay_tuner_params(ctypes.Structure):
    _fields_ = [("bwType", c_int), ("ifType", c_int), ("loMode", c_int),
                ("gain", _sdrplay_gain), ("rfFreq", _sdrplay_rf_freq),
                ("dcOffsetTuner", _sdrplay_dc_offset_tuner)]


class _sdrplay_dc_offset(ctypes.Structure):
    _fields_ = [("DCenable", c_uint8), ("IQenable", c_uint8)]


class _sdrplay_decimation(ctypes.Structure):
    _fields_ = [("enable", c_uint8), ("decimationFactor", c_uint8),
                ("wideBandSignal", c_uint8)]


class _sdrplay_agc(ctypes.Structure):
    _fields_ = [("enable", c_int), ("setPoint_dBfs", c_int),
                ("attack_ms", ctypes.c_ushort), ("decay_ms", ctypes.c_ushort),
                ("decay_delay_ms", ctypes.c_ushort),
                ("decay_threshold_dB", ctypes.c_ushort),
                ("syncUpdate", c_int)]


class _sdrplay_ctrl_params(ctypes.Structure):
    _fields_ = [("dcOffset", _sdrplay_dc_offset),
                ("decimation", _sdrplay_decimation),
                ("agc", _sdrplay_agc), ("adsbMode", c_int)]


class _sdrplay_rx_channel_params(ctypes.Structure):
    _fields_ = [("tunerParams", _sdrplay_tuner_params),
                ("ctrlParams", _sdrplay_ctrl_params)]


class _sdrplay_device_params(ctypes.Structure):
    _fields_ = [("devParams", POINTER(_sdrplay_dev_params)),
                ("rxChannelA", POINTER(_sdrplay_rx_channel_params)),
                ("rxChannelB", POINTER(_sdrplay_rx_channel_params))]


#: sdrplay_api_Bw_MHzT values (kHz); chosen nearest-below like the
#: reference's compute_bandwidth_closest (sdrplay.lua)
_SDRPLAY_BANDWIDTHS_KHZ = (200, 300, 600, 1536, 5000, 6000, 7000, 8000)

#: sdrplay_api_If_kHzT / AgcControlT values
_SDRPLAY_IF_MODES = {0: 0, 450: 450, 1620: 1620, 2048: 2048}
_SDRPLAY_AGC_MODES = {"disable": 0, "100hz": 1, "50hz": 2, "5hz": 3}


_SDRPLAY_STREAM_CB = CFUNCTYPE(
    None, POINTER(c_int16), POINTER(c_int16),
    POINTER(_sdrplay_stream_cb_params), c_uint32, c_uint32, c_void_p)
_SDRPLAY_EVENT_CB = CFUNCTYPE(None, c_int, c_int, c_void_p, c_void_p)


class _sdrplay_callback_fns(ctypes.Structure):
    _fields_ = [("StreamACbFn", _SDRPLAY_STREAM_CB),
                ("StreamBCbFn", _SDRPLAY_STREAM_CB),
                ("EventCbFn", _SDRPLAY_EVENT_CB)]


class SDRplaySource(_SDRSourceBase):
    """SDRplay RSP source via sdrplay_api v3 (reference: sdrplay.lua:1-984).

    The v3 service API hands out a nested device-params struct to mutate
    before Init; this binding declares the documented DeviceParamsT /
    DevParamsT / RxChannelParamsT structure family and writes fields at
    their true offsets (reference sets the same fields,
    sdrplay.lua:654-661).

    Options: gain_reduction (dB, default 40), bandwidth (Hz, default =
    sample rate), lna_state (default 0), if_mode (kHz: 0/450/1620/2048),
    agc ("disable"/"100hz"/"50hz"/"5hz"), agc_setpoint (dBfs),
    dc_correction (bool), iq_correction (bool), freq_correction (ppm)."""

    LIBRARY_NAMES = ("sdrplay_api", "mirsdrapi-rsp")
    # raw s16 wire ring: the stream callback interleaves the API's split
    # xi/xq buffers (cheap int16 copy, no float math on the USB thread);
    # the card applies the reference's s16 * (1/32767.5)
    # (sdrplay.lua per-sample host conversion)
    _wire_offset = 0.0
    _wire_scale = 1.0 / 32767.5
    wire_dtype = np.int16

    def initialize(self):
        lib = self._require_library()
        self._lib = lib
        r = lib.sdrplay_api_Open()
        if r != 0:
            raise RuntimeError(f"sdrplay_api_Open() failed ({r}); is the "
                               f"sdrplay service running?")
        self._opened = True
        lib.sdrplay_api_LockDeviceApi()
        devs = (_sdrplay_device * 8)()
        ndev = c_uint32(0)
        r = lib.sdrplay_api_GetDevices(devs, byref(ndev), c_uint32(8))
        if r != 0 or ndev.value == 0:
            lib.sdrplay_api_UnlockDeviceApi()
            raise RuntimeError("sdrplay: no devices found")
        self._devt = devs[0]
        r = lib.sdrplay_api_SelectDevice(byref(self._devt))
        lib.sdrplay_api_UnlockDeviceApi()
        if r != 0:
            raise RuntimeError(f"sdrplay_api_SelectDevice() failed ({r})")

        ring = self._make_ring()

        def on_stream(xi, xq, params_ptr, num, reset, ctx):
            n = int(num)
            if n <= 0:
                return
            raw = np.empty(2 * n, np.int16)
            raw[0::2] = np.ctypeslib.as_array(xi, shape=(n,))
            raw[1::2] = np.ctypeslib.as_array(xq, shape=(n,))
            ring.write(raw)

        def on_event(event_id, tuner, params, ctx):
            return None

        self._cbs = _sdrplay_callback_fns(
            StreamACbFn=_SDRPLAY_STREAM_CB(on_stream),
            StreamBCbFn=_SDRPLAY_STREAM_CB(lambda *a: None),
            EventCbFn=_SDRPLAY_EVENT_CB(on_event))

        # Device params: configure the nested param structs before Init
        # (required entry point per sdrplay_api.h; the reference errors if
        # absent, sdrplay.lua:642-645).
        params = POINTER(_sdrplay_device_params)()
        r = lib.sdrplay_api_GetDeviceParams(self._devt.dev, byref(params))
        if r != 0 or not params:
            raise RuntimeError(f"sdrplay_api_GetDeviceParams() failed ({r})")
        self._apply_params(params)

        r = lib.sdrplay_api_Init(self._devt.dev, byref(self._cbs), None)
        if r != 0:
            raise RuntimeError(f"sdrplay_api_Init() failed ({r})")

    @staticmethod
    def _bandwidth_enum(hz: float) -> int:
        """Closest-below sdrplay_api_Bw_MHzT value (kHz), like the
        reference's compute_bandwidth_closest."""
        khz = hz / 1e3
        below = [b for b in _SDRPLAY_BANDWIDTHS_KHZ if b <= khz]
        return below[-1] if below else _SDRPLAY_BANDWIDTHS_KHZ[0]

    def _apply_params(self, params):
        """Write frequency/rate/tuner/control fields into the declared
        sdrplay_api v3 structures (reference: sdrplay.lua:654-661)."""
        opts = self.options
        dp = params.contents
        if dp.devParams:
            dev = dp.devParams.contents
            dev.ppm = float(opts.get("freq_correction", 0.0))
            dev.fsFreq.fsHz = float(self.rate)
        if not dp.rxChannelA:
            return
        ch = dp.rxChannelA.contents
        t = ch.tunerParams
        t.bwType = self._bandwidth_enum(
            float(opts.get("bandwidth", self.rate)))
        if_mode = int(opts.get("if_mode", 0))
        if if_mode not in _SDRPLAY_IF_MODES:
            raise ValueError(f"sdrplay: invalid if_mode {if_mode} "
                             f"(choose from {sorted(_SDRPLAY_IF_MODES)})")
        t.ifType = _SDRPLAY_IF_MODES[if_mode]
        t.loMode = 0  # sdrplay_api_LO_Auto
        t.gain.gRdB = int(opts.get("gain_reduction", 40))
        t.gain.minGr = 0  # sdrplay_api_NORMAL_MIN_GR
        t.gain.LNAstate = int(opts.get("lna_state", 0))
        t.rfFreq.rfHz = float(self.frequency)
        c = ch.ctrlParams
        agc = str(opts.get("agc", "disable")).lower()
        if agc not in _SDRPLAY_AGC_MODES:
            raise ValueError(f"sdrplay: invalid agc mode {agc!r} "
                             f"(choose from {sorted(_SDRPLAY_AGC_MODES)})")
        c.agc.enable = _SDRPLAY_AGC_MODES[agc]
        if "agc_setpoint" in opts:
            c.agc.setPoint_dBfs = int(opts["agc_setpoint"])
        c.dcOffset.DCenable = 1 if opts.get("dc_correction", True) else 0
        c.dcOffset.IQenable = 1 if opts.get("iq_correction", True) else 0

    def cleanup(self):
        lib = getattr(self, "_lib", None)
        if getattr(self, "_devt", None) is not None and lib is not None:
            lib.sdrplay_api_Uninit(self._devt.dev)
            lib.sdrplay_api_LockDeviceApi()
            lib.sdrplay_api_ReleaseDevice(byref(self._devt))
            lib.sdrplay_api_UnlockDeviceApi()
            self._devt = None
        if getattr(self, "_opened", False) and lib is not None:
            lib.sdrplay_api_Close()
            self._opened = False
        if self.ring is not None:
            self.ring.close()


# ---------------------------------------------------------------------------
# SoapySDR (generic vendor coverage through one API)
# ---------------------------------------------------------------------------

class SoapySDRSource(_ReaderThreadSource):
    """Generic SoapySDR source covering most vendor hardware through one
    API (reference: soapysdr.lua:1-542).  Uses the SoapySDR Python bindings
    when installed, else raises.

    Streams CS16 and converts on-device: SoapySDR's own CS16->CF32
    converter primitive scales by 1/32767, so s16 * (1/32767) is the
    identical stream the reference receives via CF32 — at 4 bytes/sample
    on the host->device link instead of 8."""

    LIBRARY_NAMES = ("SoapySDR",)
    _wire_offset = 0.0
    _wire_scale = 1.0 / 32767.0
    wire_dtype = np.int16

    def __init__(self, uri: str, frequency: float, rate: float, **options):
        super().__init__(frequency, rate, **options)
        self.uri = uri

    def initialize(self):
        try:
            import SoapySDR  # noqa: F401
            from SoapySDR import SOAPY_SDR_CS16, SOAPY_SDR_RX
        except ImportError as e:
            raise RuntimeError(
                f"{self.name}: SoapySDR Python bindings not installed") from e
        self._soapy = SoapySDR
        self._dev = SoapySDR.Device(self.uri)
        self._dev.setSampleRate(SOAPY_SDR_RX, 0, self.rate)
        self._dev.setFrequency(SOAPY_SDR_RX, 0, self.frequency)
        for key, value in self.options.get("settings", {}).items():
            self._dev.writeSetting(key, value)
        if "gain" in self.options:
            self._dev.setGain(SOAPY_SDR_RX, 0, self.options["gain"])
        self._stream = self._dev.setupStream(SOAPY_SDR_RX, SOAPY_SDR_CS16)
        self._dev.activateStream(self._stream)
        self._buf = np.zeros((1 << 16, 2), dtype=np.int16)
        self._make_ring()
        self._start_reader()

    def _read_hw(self):
        sr = self._dev.readStream(self._stream, [self._buf], len(self._buf))
        if sr.ret < 0:
            return None
        if sr.ret == 0:
            return np.empty(0, np.int16)
        return self._buf[:sr.ret].reshape(-1).copy()

    def cleanup(self):
        if not self._stop_reader():
            return  # reader stalled in readStream: leak rather than free
        if getattr(self, "_stream", None):
            self._dev.deactivateStream(self._stream)
            self._dev.closeStream(self._stream)
            self._stream = None


__all__ = ["RtlSdrSource", "SoapySDRSource", "AirspySource", "AirspyHFSource",
           "HackRFSource", "HydraSDRSource", "SDRplaySource", "BladeRFSource",
           "UHDSource"]
