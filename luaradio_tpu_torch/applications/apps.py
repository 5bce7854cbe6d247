"""Receiver applications (the JAX package's applications/apps.py;
reference: radio/applications/*.lua).  Each application is a spec (name,
description, supported inputs and outputs, arguments, options) plus a
run(input, output, args, device) that builds and runs the flow graph.
IF/AF decimation factors follow from the source rate as in the reference
(rx_wbfm.lua:38-44).  The other nine applications are later slices of the
port: ``APPLICATIONS`` holds the ported ones only."""

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


def _round(x):
    return int(x + 0.5)


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


APPLICATIONS = {app.name: app for app in [RxWBFM()]}

__all__ = ["Application", "APPLICATIONS", "RxWBFM"]
