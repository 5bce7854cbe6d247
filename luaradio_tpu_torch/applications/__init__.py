"""Application dispatcher: input/output factories and spec parsing (the
JAX package's applications/__init__.py; reference
radio/applications/init.lua: :4-195 factory tables, :282-322
"name:arg,opt=val,..." spec parsing, :324-419 dispatch).

``INPUTS`` and ``OUTPUTS`` hold the JAX package's names: the file,
network, SDR and audio inputs, and the file, audio, print, JSON, benchmark
and network outputs.  Any other name raises."""

from __future__ import annotations

import luaradio_tpu_torch as radio
from luaradio_tpu_torch.applications.apps import APPLICATIONS, Application


class InputSpec:
    """Parsed -i input: factory + options; make(frequency, rate) builds the
    source block."""

    def __init__(self, name, args, options, factory, default_rate=None):
        self.name = name
        self.args = args
        self.options = options
        self._factory = factory
        self.rate = float(options["rate"]) if "rate" in options else \
            default_rate

    def make(self, frequency, rate):
        return self._factory(self, frequency, rate or self.rate)


class OutputSpec:
    def __init__(self, name, args, options, factory):
        self.name = name
        self.args = args
        self.options = options
        self._factory = factory

    def make(self, *a):
        return self._factory(self, *a)


def _in_iqfile(spec, frequency, rate):
    filename = spec.args[0]
    fmt = spec.args[1] if len(spec.args) > 1 else \
        spec.options.get("format", "f32le")
    if rate is None:
        raise ValueError("iqfile input requires rate=... option")
    return radio.IQFileSource(filename, fmt, rate,
                              repeat_on_eof=bool(spec.options.get("repeat")))


def _in_network(cls):
    def make(spec, frequency, rate):
        transport = spec.options.get("transport", "tcp")
        address = spec.args[0] if spec.args else spec.options["address"]
        fmt = spec.options.get("format", "f32le")
        if rate is None:
            raise ValueError(f"{spec.name} input requires rate=... option")
        return cls(radio.ComplexFloat32, rate, transport, address, format=fmt)
    return make


def _in_sdr(cls, needs_device=False):
    def make(spec, frequency, rate):
        opts = {k: v for k, v in spec.options.items()
                if not k.startswith("_") and k != "rate"}
        if needs_device:
            return cls(spec.args[0] if spec.args else "", frequency, rate,
                       **opts)
        return cls(frequency, rate, **opts)
    return make


INPUTS = {
    "iqfile": (_in_iqfile, {"_tune_offset": 0}),
    "networkclient": (_in_network(radio.NetworkClientSource),
                      {"_tune_offset": 0}),
    "networkserver": (_in_network(radio.NetworkServerSource),
                      {"_tune_offset": 0}),
    "rtlsdr": (_in_sdr(radio.RtlSdrSource), {"_rate": 1102500}),
    "airspy": (_in_sdr(radio.AirspySource), {"_rate": 3000000}),
    "airspyhf": (_in_sdr(radio.AirspyHFSource), {"_rate": 768000}),
    "bladerf": (_in_sdr(radio.BladeRFSource), {"_rate": 1102500}),
    "hackrf": (_in_sdr(radio.HackRFSource), {"_rate": 8820000}),
    "hydrasdr": (_in_sdr(radio.HydraSDRSource), {"_rate": 10000000}),
    "sdrplay": (_in_sdr(radio.SDRplaySource), {"_rate": 2205000}),
    "uhd": (_in_sdr(radio.UHDSource, needs_device=True), {"_rate": 1102500}),
    "soapysdr": (_in_sdr(radio.SoapySDRSource, needs_device=True), {}),
    "pulseaudio": (lambda spec, f, rate: radio.PulseAudioSource(
        int(spec.options.get("channels", 1)), rate), {}),
    "portaudio": (lambda spec, f, rate: radio.PortAudioSource(
        int(spec.options.get("channels", 1)), rate), {}),
}


def _out_wavfile(spec, num_channels=1):
    bits = int(spec.options.get("bits", 16))
    return radio.WAVFileSink(spec.args[0], num_channels, bits_per_sample=bits)


def _out_iqfile(spec, *a):
    fmt = spec.args[1] if len(spec.args) > 1 else \
        spec.options.get("format", "f32le")
    return radio.IQFileSink(spec.args[0], fmt)


def _out_realfile(spec, *a):
    fmt = spec.args[1] if len(spec.args) > 1 else \
        spec.options.get("format", "f32le")
    return radio.RealFileSink(spec.args[0], fmt)


def _out_network(cls):
    def make(spec, *a):
        transport = spec.options.get("transport", "tcp")
        address = spec.args[0] if spec.args else spec.options["address"]
        fmt = spec.options.get("format", "f32le")
        return cls(transport, address, format=fmt)
    return make


OUTPUTS = {
    "wavfile": _out_wavfile,
    "iqfile": _out_iqfile,
    "realfile": _out_realfile,
    "pulseaudio": lambda spec, nch=1: radio.PulseAudioSink(nch),
    "portaudio": lambda spec, nch=1: radio.PortAudioSink(nch),
    "print": lambda spec, *a: radio.PrintSink(),
    "json": lambda spec, *a: radio.JSONSink(
        spec.args[0] if spec.args else None),
    "benchmark": lambda spec, *a: radio.BenchmarkSink(),
    "networkclient": _out_network(radio.NetworkClientSink),
    "networkserver": _out_network(radio.NetworkServerSink),
}


def parse_spec(spec: str):
    """Parse "name:arg1,arg2,opt=val,..." (reference
    applications/init.lua:282-322)."""
    name, sep, rest = spec.partition(":")
    args, options = [], {}
    if sep:
        for tok in rest.split(","):
            if not tok:
                continue
            k, eq, v = tok.partition("=")
            if eq:
                options[k] = v
            else:
                args.append(tok)
    return name, args, options


def make_input(spec: str, app: Application) -> InputSpec:
    name, args, options = parse_spec(spec)
    if name not in INPUTS:
        raise ValueError(f"unsupported input {name!r} "
                         f"(choices: {', '.join(sorted(INPUTS))})")
    factory, defaults = INPUTS[name]
    merged = dict(defaults)
    app_defaults = app.supported_inputs.get(name)
    if isinstance(app_defaults, (int, float)):
        # the receivers list each input's default rate as a number
        # (apps.py _SDR_RATES); the JAX package's dispatcher merges it as
        # a dict and raises TypeError for every SDR input of them
        app_defaults = {"_rate": app_defaults}
    merged.update(app_defaults or {})
    merged.update(options)
    return InputSpec(name, args, merged, factory,
                     default_rate=merged.get("_rate"))


def make_output(spec: str, app: Application) -> OutputSpec:
    name, args, options = parse_spec(spec)
    if name not in OUTPUTS:
        raise ValueError(f"unsupported output {name!r} "
                         f"(choices: {', '.join(sorted(OUTPUTS))})")
    return OutputSpec(name, args, options, OUTPUTS[name])


def run(name: str, input_spec: str, output_spec: str, args, device=None):
    """Dispatch an application by name (reference
    applications/init.lua:324-419) on ``device`` (None: the CUDA card)."""
    if name not in APPLICATIONS:
        raise ValueError(f"unknown application {name!r} "
                         f"(choices: {', '.join(sorted(APPLICATIONS))})")
    app = APPLICATIONS[name]
    app.run(make_input(input_spec, app), make_output(output_spec, app), args,
            device=device)


__all__ = ["APPLICATIONS", "Application", "InputSpec", "OutputSpec",
           "INPUTS", "OUTPUTS", "parse_spec", "make_input", "make_output",
           "run"]
