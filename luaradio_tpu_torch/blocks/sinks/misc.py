"""Print, JSON, Nop and Benchmark sinks (reference:
radio/blocks/sinks/{print,json,nop,benchmark}.lua).  Nop and Benchmark
have ``wants_data=False``: the runtime hands them the device tensor and
never copies it to the host, so a graph ending in them stays on the
card."""

from __future__ import annotations

import json as _json
import sys
import time

import numpy as np

from luaradio_tpu_torch.core.block import Input, SinkBlock


class NopSink(SinkBlock):
    """Accepts and discards samples (reference: nop.lua)."""

    wants_data = False

    def __init__(self):
        super().__init__()
        self.add_type_signature([Input("in", lambda t: True)], [])

    def process(self, x):
        return None


class PrintSink(SinkBlock):
    """Print samples line-by-line (reference: print.lua)."""

    def __init__(self, file=None):
        super().__init__()
        self.file = file or sys.stdout
        self.add_type_signature([Input("in", lambda t: True)], [])

    def process(self, x):
        if isinstance(x, (list, tuple)):
            for v in x:
                print(v, file=self.file)
        else:
            for v in np.asarray(x).reshape(-1):
                print(v, file=self.file)


class JSONSink(SinkBlock):
    """Serialize any sample with a JSON representation, newline-delimited
    (reference: json.lua — predicate type signature accepting any type with
    to_json)."""

    def __init__(self, file=None):
        super().__init__()
        self._file_arg = file
        self.file = None
        self._owns = False
        self.add_type_signature([Input("in", lambda t: True)], [])

    def initialize(self):
        if self.file is None:
            if isinstance(self._file_arg, str):
                self.file = open(self._file_arg, "w")
                self._owns = True
            else:
                self.file = self._file_arg or sys.stdout

    @staticmethod
    def _dump(v) -> str:
        if hasattr(v, "to_json"):
            return v.to_json()
        import dataclasses
        if dataclasses.is_dataclass(v):
            return _json.dumps(dataclasses.asdict(v))
        if isinstance(v, np.generic):
            v = v.item()
        if isinstance(v, complex):
            return _json.dumps({"real": v.real, "imag": v.imag})
        return _json.dumps(v)

    def process(self, x):
        vals = x if isinstance(x, (list, tuple)) else np.asarray(x).reshape(-1)
        for v in vals:
            self.file.write(self._dump(v) + "\n")

    def cleanup(self):
        if self.file is not None:
            self.file.flush()
            if self._owns:
                self.file.close()
                self.file = None


class BenchmarkSink(SinkBlock):
    """Report samples/sec and bytes/sec of its input stream periodically or
    as a JSON aggregate at cleanup (reference: benchmark.lua:88-136).

    Counts samples from the tensor's shape without transferring it.  The
    rate is the host's view of the pump: chunks are counted when they are
    handed over, before the card has finished them."""

    wants_data = False

    def __init__(self, file=None, title: str = "BenchmarkSink",
                 use_json: bool = False, report_period: float = 3.0):
        super().__init__()
        self.file = file or sys.stderr
        self.title = title
        self.use_json = use_json
        self.report_period = report_period
        self.count = 0
        self.total_count = 0
        self._t0 = None
        self._t_report = None
        self._itemsize = 1
        self.add_type_signature([Input("in", lambda t: True)], [])

    def initialize(self):
        self._itemsize = self.get_input_type().dtype.itemsize

    def process(self, x):
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = self._t_report = now
        n = int(x.shape[-1]) if hasattr(x, "shape") and len(x.shape) \
            else len(x)
        self.count += n
        self.total_count += n
        if not self.use_json and now - self._t_report >= self.report_period:
            sps = self.count / (now - self._t_report)
            print(f"[{self.title}] {sps/1e6:.2f} MS/s "
                  f"({sps*self._itemsize/1e6:.2f} MiB/s)", file=self.file)
            self.count = 0
            self._t_report = now

    def cleanup(self):
        if self.use_json and self._t0 is not None:
            dt = max(time.monotonic() - self._t0, 1e-9)
            sps = self.total_count / dt
            rec = {"samples_per_second": sps,
                   "bytes_per_second": sps * self._itemsize}
            out = self.file
            if isinstance(out, int):
                import os
                os.write(out, (_json.dumps(rec) + "\n").encode())
            else:
                out.write(_json.dumps(rec) + "\n")
                out.flush()


__all__ = ["NopSink", "PrintSink", "JSONSink", "BenchmarkSink"]
