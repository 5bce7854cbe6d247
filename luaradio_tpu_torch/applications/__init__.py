"""Application dispatcher: input/output factories and spec parsing (the
JAX package's applications/__init__.py; reference
radio/applications/init.lua: :4-195 factory tables, :282-322
"name:arg,opt=val,..." spec parsing, :324-419 dispatch).

Only the sources and sinks the port has are listed: ``INPUTS`` holds
``iqfile``; ``OUTPUTS`` holds ``wavfile``, ``iqfile``, ``realfile``,
``print``, ``json`` and ``benchmark``.  Any other name raises."""

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


INPUTS = {
    "iqfile": (_in_iqfile, {"_tune_offset": 0}),
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


OUTPUTS = {
    "wavfile": _out_wavfile,
    "iqfile": _out_iqfile,
    "realfile": _out_realfile,
    "print": lambda spec, *a: radio.PrintSink(),
    "json": lambda spec, *a: radio.JSONSink(
        spec.args[0] if spec.args else None),
    "benchmark": lambda spec, *a: radio.BenchmarkSink(),
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
    merged.update(app.supported_inputs.get(name) or {})
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
