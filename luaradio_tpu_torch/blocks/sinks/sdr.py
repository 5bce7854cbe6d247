"""SDR hardware transmit sinks: ctypes bindings with asynchronous egress
(the JAX package's blocks/sinks/sdr.py; reference
radio/blocks/sinks/{hackrf,uhd,soapysdr,bladerf}.lua).  The egress mirrors the ingest architecture of
blocks/sources/sdr.py: process() enqueues converted samples into a
SampleRingBuffer, and the vendor TX callback (HackRF) or a writer thread
(bladeRF, UHD, SoapySDR) drains it at the hardware rate — the flow graph
never blocks on USB, and underruns transmit zeros (counted) instead of
tearing the stream, like the reference's async TX callbacks
(radio/blocks/sinks/hackrf.lua).  Host sinks: their input arrives as
host arrays through the runtime's boundary."""

from __future__ import annotations

import threading
from ctypes import (byref, c_bool, c_double, c_int, c_size_t,
                    c_uint8, c_uint32, c_uint64, c_void_p)

import numpy as np

from luaradio_tpu_torch.blocks.sources.sdr import (_HACKRF_CB,
                                                   _UHD_TUNE_POLICY_AUTO,
                                                   _load_library,
                                                   _uhd_stream_args,
                                                   _uhd_tune_request,
                                                   _uhd_tune_result)
from luaradio_tpu_torch.core.block import Input, SinkBlock
from luaradio_tpu_torch.types import ComplexFloat32
from luaradio_tpu_torch.utils.ringbuffer import SampleRingBuffer

_BLADERF_TX_X1 = 1          # bladerf_channel_layout
_BLADERF_FORMAT_SC16_Q11 = 0


def _bladerf_channel_tx(ch: int) -> int:
    return (ch << 1) | 0x1


class _SDRSinkBase(SinkBlock):
    LIBRARY_NAMES: tuple = ()
    RING_SECONDS = 2.0
    _injected_lib = None  # test hook (tests/test_torch_sdr.py)

    def __init__(self, frequency: float, **options):
        super().__init__()
        self.frequency = float(frequency)
        self.options = options
        self.ring: SampleRingBuffer | None = None
        self.underruns = 0
        self.add_type_signature([Input("in", ComplexFloat32)], [])

    def _require_library(self):
        if type(self)._injected_lib is not None:
            return type(self)._injected_lib
        lib = _load_library(*self.LIBRARY_NAMES)
        if lib is None:
            raise RuntimeError(
                f"{self.name}: vendor library not found "
                f"(tried {', '.join(self.LIBRARY_NAMES)})")
        return lib

    def _make_ring(self):
        cap = max(int(self.get_rate() * self.RING_SECONDS), 1 << 18)
        self.ring = SampleRingBuffer(cap, np.complex64)
        return self.ring

    def process(self, x):
        buf = np.ascontiguousarray(np.asarray(x, dtype=np.complex64))
        # Back-pressure: block the pump while the ring is full (the
        # hardware drains it at the TX rate).  write_blocking waits on the
        # ring's condition under its lock — no counter rollback races.
        pos = 0
        while pos < len(buf):
            take = min(len(buf) - pos, self.ring.capacity // 2)
            if not self.ring.write_blocking(buf[pos:pos + take]):
                return  # closed (shutdown)
            pos += take


class _WriterThreadSink(_SDRSinkBase):
    """Sinks with blocking sync-write APIs: a writer thread drains the
    ring into the hardware."""

    def _start_writer(self):
        self._writer_stop = threading.Event()
        self._writer = threading.Thread(target=self._writer_main,
                                        daemon=True)
        self._writer.start()

    def _writer_main(self):
        while not self._writer_stop.is_set():
            chunk = self.ring.read(self._WRITE_SAMPLES, timeout=0.25)
            if chunk is None:
                break
            if len(chunk) == 0:
                continue
            if not self._write_hw(chunk):
                break

    def _write_hw(self, chunk: np.ndarray) -> bool:
        raise NotImplementedError

    def _stop_writer(self):
        if self.ring is not None:
            self.ring.close()
        if getattr(self, "_writer_stop", None) is not None:
            self._writer_stop.set()
        if getattr(self, "_writer", None) is not None:
            self._writer.join(timeout=2.0)
            self._writer = None


class SoapySDRSink(_WriterThreadSink):
    """Generic SoapySDR transmit sink (reference: sinks/soapysdr.lua)."""

    _WRITE_SAMPLES = 1 << 14

    def __init__(self, uri: str, frequency: float, **options):
        super().__init__(frequency, **options)
        self.uri = uri

    def initialize(self):
        try:
            import SoapySDR  # noqa: F401
            from SoapySDR import SOAPY_SDR_CF32, SOAPY_SDR_TX
        except ImportError as e:
            raise RuntimeError(
                f"{self.name}: SoapySDR Python bindings not installed") from e
        self._dev = SoapySDR.Device(self.uri)
        self._dev.setSampleRate(SOAPY_SDR_TX, 0, self.get_rate())
        self._dev.setFrequency(SOAPY_SDR_TX, 0, self.frequency)
        if "gain" in self.options:
            self._dev.setGain(SOAPY_SDR_TX, 0, self.options["gain"])
        self._stream = self._dev.setupStream(SOAPY_SDR_TX, SOAPY_SDR_CF32)
        self._dev.activateStream(self._stream)
        self._make_ring()
        self._start_writer()

    def _write_hw(self, chunk):
        pos = 0
        while pos < len(chunk):
            sr = self._dev.writeStream(self._stream, [chunk[pos:]],
                                       len(chunk) - pos)
            if sr.ret <= 0:
                return False
            pos += sr.ret
        return True

    def cleanup(self):
        self._stop_writer()
        if getattr(self, "_stream", None):
            self._dev.deactivateStream(self._stream)
            self._dev.closeStream(self._stream)
            self._stream = None


class HackRFSink(_SDRSinkBase):
    """HackRF One transmit sink (reference: sinks/hackrf.lua:1-275).

    Options: vga_gain (0..47 dB TX VGA, default 0), bandwidth (Hz,
    default round-down from rate), rf_amplifier_enable,
    antenna_power_enable."""

    LIBRARY_NAMES = ("hackrf",)

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
        rate = self.get_rate()
        lib.hackrf_set_sample_rate(dev, c_double(rate))
        bw = self.options.get("bandwidth")
        if bw is None:
            f = lib.hackrf_compute_baseband_filter_bw_round_down_lt
            f.restype = c_uint32
            bw = f(c_uint32(int(rate)))
        lib.hackrf_set_baseband_filter_bandwidth(dev, c_uint32(int(bw)))
        lib.hackrf_set_txvga_gain(dev, c_uint32(
            int(self.options.get("vga_gain", 0))))
        lib.hackrf_set_amp_enable(dev, c_uint8(
            1 if self.options.get("rf_amplifier_enable") else 0))
        lib.hackrf_set_antenna_enable(dev, c_uint8(
            1 if self.options.get("antenna_power_enable") else 0))
        lib.hackrf_set_freq(dev, c_uint64(int(self.frequency)))

        ring = self._make_ring()
        sink = self

        def on_tx(transfer_ptr):
            # vendor USB thread: fill the transfer buffer from the ring;
            # underruns pad zeros (counted) instead of tearing the stream
            t = transfer_ptr.contents
            n = t.buffer_length & ~1
            want = n // 2
            chunk = ring.read(want, timeout=0.05)
            if chunk is None:
                return -1  # ring closed: stop streaming
            out = np.zeros(want, np.complex64)
            if len(chunk):
                out[:len(chunk)] = chunk
            if len(chunk) < want:
                sink.underruns += 1
            s8 = np.clip(out.view(np.float32) * 127.0, -128, 127
                         ).astype(np.int8)
            buf = np.ctypeslib.as_array(t.buffer, shape=(n,))
            buf[:] = s8.view(np.uint8)
            t.valid_length = n
            return 0

        self._cb = _HACKRF_CB(on_tx)
        r = lib.hackrf_start_tx(dev, self._cb, None)
        if r != 0:
            raise RuntimeError(f"hackrf_start_tx() failed ({r})")

    def cleanup(self):
        if self.ring is not None:
            self.ring.close()
        if getattr(self, "_dev", None):
            self._lib.hackrf_stop_tx(self._dev)
            self._lib.hackrf_close(self._dev)
            self._lib.hackrf_exit()
            self._dev = None


class BladeRFSink(_WriterThreadSink):
    """Nuand bladeRF transmit sink (reference: sinks/bladerf.lua:1-435).

    Options: device_id (str), channel (int, default 0), gain (dB),
    bandwidth (Hz, default 80% of rate)."""

    LIBRARY_NAMES = ("bladeRF",)
    _WRITE_SAMPLES = 1 << 14

    def initialize(self):
        lib = self._require_library()
        self._lib = lib
        dev = c_void_p()
        devid = self.options.get("device_id", "").encode()
        r = lib.bladerf_open(byref(dev), devid or None)
        if r != 0:
            raise RuntimeError(f"bladerf_open() failed ({r}; no device?)")
        self._dev = dev
        ch = _bladerf_channel_tx(int(self.options.get("channel", 0)))
        self._ch = ch
        actual = c_uint32(0)
        rate = self.get_rate()
        lib.bladerf_set_sample_rate(dev, ch, c_uint32(int(rate)),
                                    byref(actual))
        bw = int(self.options.get("bandwidth", 0.8 * rate))
        lib.bladerf_set_bandwidth(dev, ch, c_uint32(bw), byref(actual))
        if "gain" in self.options:
            lib.bladerf_set_gain(dev, ch, c_int(int(self.options["gain"])))
        r = lib.bladerf_set_frequency(dev, ch, c_uint64(int(self.frequency)))
        if r != 0:
            raise RuntimeError(f"bladerf_set_frequency() failed ({r})")
        r = lib.bladerf_sync_config(dev, _BLADERF_TX_X1,
                                    _BLADERF_FORMAT_SC16_Q11,
                                    c_uint32(16), c_uint32(8192),
                                    c_uint32(8), c_uint32(1000))
        if r != 0:
            raise RuntimeError(f"bladerf_sync_config() failed ({r})")
        r = lib.bladerf_enable_module(dev, ch, True)
        if r != 0:
            raise RuntimeError(f"bladerf_enable_module() failed ({r})")
        self._make_ring()
        self._start_writer()

    def _write_hw(self, chunk):
        sc16 = np.clip(chunk.view(np.float32) * 2048.0, -2048, 2047
                       ).astype(np.int16)
        buf = sc16.ctypes.data_as(c_void_p)
        r = self._lib.bladerf_sync_tx(self._dev, buf,
                                      c_uint32(len(chunk)), None,
                                      c_uint32(1000))
        return r == 0

    def cleanup(self):
        self._stop_writer()
        if getattr(self, "_dev", None):
            self._lib.bladerf_enable_module(self._dev, self._ch, False)
            self._lib.bladerf_close(self._dev)
            self._dev = None


class UHDSink(_WriterThreadSink):
    """Ettus USRP transmit sink via the libuhd C API
    (reference: sinks/uhd.lua:1-598).

    Options: channel (int), gain (dB), bandwidth (Hz), antenna (str)."""

    LIBRARY_NAMES = ("uhd",)
    _WRITE_SAMPLES = 1 << 14

    def __init__(self, device: str, frequency: float, **options):
        super().__init__(frequency, **options)
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
        self._check("uhd_usrp_set_tx_rate",
                    lib.uhd_usrp_set_tx_rate(usrp, c_double(self.get_rate()),
                                             ch))
        if "gain" in self.options:
            self._check("uhd_usrp_set_tx_gain",
                        lib.uhd_usrp_set_tx_gain(
                            usrp, c_double(self.options["gain"]), ch, b""))
        if "bandwidth" in self.options:
            self._check("uhd_usrp_set_tx_bandwidth",
                        lib.uhd_usrp_set_tx_bandwidth(
                            usrp, c_double(self.options["bandwidth"]), ch))
        if "antenna" in self.options:
            self._check("uhd_usrp_set_tx_antenna",
                        lib.uhd_usrp_set_tx_antenna(
                            usrp, self.options["antenna"].encode(), ch))
        req = _uhd_tune_request(target_freq=self.frequency,
                                rf_freq_policy=_UHD_TUNE_POLICY_AUTO,
                                dsp_freq_policy=_UHD_TUNE_POLICY_AUTO)
        res = _uhd_tune_result()
        self._check("uhd_usrp_set_tx_freq",
                    lib.uhd_usrp_set_tx_freq(usrp, byref(req), ch,
                                             byref(res)))
        tx = c_void_p()
        self._check("uhd_tx_streamer_make",
                    lib.uhd_tx_streamer_make(byref(tx)))
        self._tx = tx
        chans = (c_size_t * 1)(ch.value)
        sargs = _uhd_stream_args(cpu_format=b"fc32", otw_format=b"sc16",
                                 args=b"", channel_list=chans, n_channels=1)
        self._check("uhd_usrp_get_tx_stream",
                    lib.uhd_usrp_get_tx_stream(usrp, byref(sargs), tx))
        md = c_void_p()
        self._check("uhd_tx_metadata_make",
                    lib.uhd_tx_metadata_make(byref(md), c_bool(False),
                                             0, c_double(0.1),
                                             c_bool(True), c_bool(False)))
        self._md = md
        self._make_ring()
        self._start_writer()

    def _write_hw(self, chunk):
        buf = np.ascontiguousarray(chunk)
        ptrs = (c_void_p * 1)(buf.ctypes.data)
        sent = c_size_t(0)
        pos = 0
        while pos < len(buf):
            sub = buf[pos:]
            ptrs[0] = sub.ctypes.data
            r = self._lib.uhd_tx_streamer_send(
                self._tx, ptrs, c_size_t(len(sub)), byref(self._md),
                c_double(1.0), byref(sent))
            if r != 0 or sent.value == 0:
                return False
            pos += sent.value
        return True

    def cleanup(self):
        self._stop_writer()
        lib = getattr(self, "_lib", None)
        if getattr(self, "_tx", None) and lib is not None:
            lib.uhd_tx_streamer_free(byref(self._tx))
            self._tx = None
        if getattr(self, "_md", None) and lib is not None:
            lib.uhd_tx_metadata_free(byref(self._md))
            self._md = None
        if getattr(self, "_usrp", None) and lib is not None:
            lib.uhd_usrp_free(byref(self._usrp))
            self._usrp = None


__all__ = ["SoapySDRSink", "HackRFSink", "UHDSink", "BladeRFSink"]
