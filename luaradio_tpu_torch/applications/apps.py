"""Receiver applications (the JAX package's applications/apps.py;
reference: radio/applications/*.lua).  Each application is a spec (name,
description, supported inputs and outputs, arguments, options) plus a
run(input, output, args, device) that builds and runs the flow graph.
IF/AF decimation factors follow from the source rate as in the reference
(rx_wbfm.lua:38-44).  ``APPLICATIONS`` holds the analog receivers,
the digital ones (rx_rds, rx_ax25, rx_pocsag, rx_ert) and iq_converter."""

from __future__ import annotations

import luaradio_tpu_torch as radio


class Application:
    def __init__(self, name, description, arguments=(), options=(),
                 supported_inputs=(), supported_outputs=()):
        self.name = name
        self.description = description
        self.arguments = list(arguments)      # (name, help)
        self.options = list(options)          # (name, default, help)
        self.supported_inputs = dict(supported_inputs)   # name -> defaults
        self.supported_outputs = list(supported_outputs)

    def run(self, input, output, args, device=None):
        """Build and run the graph on ``device`` (None: the CUDA card)."""
        raise NotImplementedError


_SDR_RATES = {  # per-input default sample rates (reference rx_wbfm.lua:6-18)
    "rtlsdr": 1102500, "airspy": 3000000, "airspyhf": 768000,
    "bladerf": 1102500, "hackrf": 8820000, "hydrasdr": 10000000,
    "sdrplay": 2205000, "uhd": 1102500, "soapysdr": None,
    "networkclient": None, "networkserver": None, "iqfile": None,
}

_AUDIO_OUTPUTS = ("pulseaudio", "portaudio", "wavfile")
_DATA_OUTPUTS = ("print", "json", "networkclient", "networkserver")


def _round(x):
    return int(x + 0.5)


class RxRaw(Application):
    def __init__(self):
        super().__init__(
            "rx_raw", "Raw IQ Receiver",
            arguments=[("frequency", "Station frequency in Hz"),
                       ("sample_rate", "Sample rate in Hz")],
            options=[("tune-offset", None, "Tune offset in Hz")],
            supported_inputs={k: {} for k in _SDR_RATES},
            supported_outputs=["iqfile", "networkclient", "networkserver"])

    def run(self, input, output, args, device=None):
        frequency = float(args[0])
        rate = float(args[1])
        tune_offset = args.get("tune-offset")
        source = input.make(frequency + (float(tune_offset or 0)), rate)
        sink = output.make()
        top = radio.CompositeBlock()
        if tune_offset is None:
            top.connect(source, sink)
        else:
            top.connect(source,
                        radio.FrequencyTranslatorBlock(float(tune_offset)),
                        sink)
        top.run(device=device)


class RxWBFM(Application):
    def __init__(self):
        super().__init__(
            "rx_wbfm", "Wideband FM Receiver",
            arguments=[("frequency", "Station frequency in Hz, e.g. 104.3e6")],
            options=[("mono", False, "Mono receiver (default stereo)")],
            supported_inputs=_SDR_RATES,
            supported_outputs=_AUDIO_OUTPUTS)

    def run(self, input, output, args, device=None):
        tune_offset = input.options.get("_tune_offset", -250e3)
        frequency = float(args[0])
        mono = bool(args.get("mono"))
        source = input.make(frequency + tune_offset, input.rate)
        rate = source.get_rate()
        if_downsample = _round(rate / 220.5e3)
        af_downsample = _round(rate / if_downsample / 44.1e3)
        tuner = radio.TunerBlock(tune_offset, 200e3, if_downsample)
        sink = output.make(1 if mono else 2)
        top = radio.CompositeBlock()
        if mono:
            demod = radio.WBFMMonoDemodulator()
            top.connect(source, tuner, demod,
                        radio.DownsamplerBlock(af_downsample), sink)
        else:
            demod = radio.WBFMStereoDemodulator()
            l_ds = radio.DownsamplerBlock(af_downsample)
            r_ds = radio.DownsamplerBlock(af_downsample)
            top.connect(source, tuner, demod)
            top.connect(demod, "left", l_ds, "in")
            top.connect(demod, "right", r_ds, "in")
            top.connect(l_ds, "out", sink, "in1")
            top.connect(r_ds, "out", sink, "in2")
        top.run(device=device)


class RxNBFM(Application):
    def __init__(self):
        super().__init__(
            "rx_nbfm", "Narrowband FM Receiver",
            arguments=[("frequency", "Station frequency in Hz")],
            options=[("deviation", 5e3, "Deviation in Hz"),
                     ("bandwidth", 4e3, "Bandwidth in Hz")],
            supported_inputs=_SDR_RATES,
            supported_outputs=_AUDIO_OUTPUTS)

    def run(self, input, output, args, device=None):
        tune_offset = input.options.get("_tune_offset", -100e3)
        frequency = float(args[0])
        deviation = float(args.get("deviation") or 5e3)
        bandwidth = float(args.get("bandwidth") or 4e3)
        source = input.make(frequency + tune_offset, input.rate)
        if_downsample = _round(source.get_rate() / 44.1e3)
        tuner = radio.TunerBlock(tune_offset, 2 * (deviation + bandwidth),
                                 if_downsample)
        demod = radio.NBFMDemodulator(deviation, bandwidth)
        top = radio.CompositeBlock()
        top.connect(source, tuner, demod, output.make(1))
        top.run(device=device)


class RxAM(Application):
    def __init__(self):
        super().__init__(
            "rx_am", "AM Receiver",
            arguments=[("frequency", "Station frequency in Hz")],
            options=[("synchronous", False, "Synchronous demodulator"),
                     ("bandwidth", 5e3, "Bandwidth in Hz")],
            supported_inputs=_SDR_RATES,
            supported_outputs=_AUDIO_OUTPUTS)

    def run(self, input, output, args, device=None):
        tune_offset = input.options.get("_tune_offset", -50e3)
        frequency = float(args[0])
        bandwidth = float(args.get("bandwidth") or 5e3)
        source = input.make(frequency + tune_offset, input.rate)
        rate = source.get_rate()
        sink = output.make(1)
        top = radio.CompositeBlock()
        if not args.get("synchronous"):
            if_downsample = _round(rate / 44.1e3)
            tuner = radio.TunerBlock(tune_offset, 2 * bandwidth, if_downsample)
            demod = radio.AMEnvelopeDemodulator(bandwidth)
            top.connect(source, tuner, demod, radio.AGCBlock("slow"), sink)
        else:
            if_downsample = _round(rate / 220.5e3)
            af_downsample = _round(rate / if_downsample / 44.1e3)
            demod = radio.AMSynchronousDemodulator(-tune_offset, bandwidth)
            top.connect(source, radio.DecimatorBlock(if_downsample), demod,
                        radio.DownsamplerBlock(af_downsample),
                        radio.AGCBlock("slow"), sink)
        top.run(device=device)


class RxSSB(Application):
    def __init__(self):
        super().__init__(
            "rx_ssb", "SSB Receiver",
            arguments=[("frequency", "Station frequency in Hz"),
                       ("sideband", "'lsb' or 'usb'")],
            options=[("bandwidth", 3e3, "Bandwidth in Hz")],
            supported_inputs=_SDR_RATES,
            supported_outputs=_AUDIO_OUTPUTS)

    def run(self, input, output, args, device=None):
        tune_offset = input.options.get("_tune_offset", -100e3)
        frequency = float(args[0])
        sideband = args[1]
        if sideband not in ("lsb", "usb"):
            raise ValueError("sideband should be 'lsb' or 'usb'")
        bandwidth = float(args.get("bandwidth") or 3e3)
        source = input.make(frequency + tune_offset, input.rate)
        if_downsample = _round(source.get_rate() / 44.1e3)
        tuner = radio.TunerBlock(tune_offset, 2 * bandwidth, if_downsample)
        demod = radio.SSBDemodulator(sideband, bandwidth)
        top = radio.CompositeBlock()
        top.connect(source, tuner, demod, output.make(1))
        top.run(device=device)


class _RxDigital(Application):
    """Shared shape of rx_rds / rx_ax25 / rx_pocsag: tuner + receiver +
    data sink."""

    TUNE_OFFSET = -100e3
    IF_TARGET = 12.5e3
    BANDWIDTH = 12e3

    def make_receiver(self, args):
        raise NotImplementedError

    def run(self, input, output, args, device=None):
        tune_offset = input.options.get("_tune_offset", self.TUNE_OFFSET)
        frequency = float(args[0])
        source = input.make(frequency + tune_offset, input.rate)
        if_downsample = _round(source.get_rate() / self.IF_TARGET)
        tuner = radio.TunerBlock(tune_offset, self.BANDWIDTH, if_downsample)
        top = radio.CompositeBlock()
        top.connect(source, tuner, self.make_receiver(args), output.make())
        top.run(device=device)


class RxRDS(_RxDigital):
    TUNE_OFFSET = -250e3
    IF_TARGET = 250e3
    BANDWIDTH = 200e3

    def __init__(self):
        super().__init__(
            "rx_rds", "RDS Receiver (on broadcast FM)",
            arguments=[("frequency", "Station frequency in Hz")],
            supported_inputs=_SDR_RATES, supported_outputs=_DATA_OUTPUTS)

    def make_receiver(self, args):
        return radio.RDSReceiver()


class RxAX25(_RxDigital):
    def __init__(self):
        super().__init__(
            "rx_ax25", "AX.25 Packet Radio Receiver",
            arguments=[("frequency", "Station frequency in Hz")],
            supported_inputs=_SDR_RATES, supported_outputs=_DATA_OUTPUTS)

    def make_receiver(self, args):
        return radio.AX25Receiver()


class RxPOCSAG(_RxDigital):
    def __init__(self):
        super().__init__(
            "rx_pocsag", "POCSAG Pager Receiver",
            arguments=[("frequency", "Station frequency in Hz")],
            options=[("baudrate", 1200, "Baudrate (512 or 1200)")],
            supported_inputs=_SDR_RATES, supported_outputs=_DATA_OUTPUTS)

    def make_receiver(self, args):
        return radio.POCSAGReceiver(int(args.get("baudrate") or 1200))


class RxERT(Application):
    def __init__(self):
        super().__init__(
            "rx_ert", "ERT Utility Meter Receiver",
            options=[("frequency", 915e6, "Center frequency in Hz"),
                     ("sample-rate", None, "Sample rate in Hz"),
                     ("protocols", "idm,scm,scm+", "Protocols to decode")],
            supported_inputs=_SDR_RATES, supported_outputs=_DATA_OUTPUTS)

    def run(self, input, output, args, device=None):
        frequency = float(args.get("frequency") or 915e6)
        rate = float(args.get("sample-rate") or input.rate)
        protocols = (args.get("protocols") or "idm,scm,scm+").split(",")
        source = input.make(frequency, rate)
        receiver = radio.ERTReceiver(
            protocols, decimation=input.options.get("_decimation", 6))
        top = radio.CompositeBlock()
        top.connect(source, "out", receiver, "in")
        for i in range(len(protocols)):
            top.connect(receiver, f"out{i+1}", output.make(), "in")
        top.run(device=device)


class IQConverter(Application):
    def __init__(self):
        super().__init__(
            "iq_converter", "IQ File Format Converter",
            supported_inputs={"iqfile": {}}, supported_outputs=["iqfile"])

    def run(self, input, output, args, device=None):
        source = input.make(0.0, input.rate or 1.0)
        top = radio.CompositeBlock()
        top.connect(source, output.make())
        top.run(device=device)


APPLICATIONS = {app.name: app for app in [
    RxRaw(), RxWBFM(), RxNBFM(), RxAM(), RxSSB(), RxRDS(), RxAX25(),
    RxPOCSAG(), RxERT(), IQConverter(),
]}

__all__ = ["Application", "APPLICATIONS", "RxRaw", "RxWBFM", "RxNBFM",
           "RxAM", "RxSSB", "RxRDS", "RxAX25", "RxPOCSAG", "RxERT",
           "IQConverter"]
