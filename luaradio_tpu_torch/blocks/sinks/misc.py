"""Nop and Benchmark sinks (reference: radio/blocks/sinks/{nop,benchmark}.lua).
Both have ``wants_data=False``: the runtime hands them the device tensor
and never copies it to the host, so a graph ending in them stays on the
card."""

from __future__ import annotations

import json as _json
import sys
import time

from luaradio_tpu_torch.core.block import Input, SinkBlock


class NopSink(SinkBlock):
    """Accepts and discards samples (reference: nop.lua)."""

    wants_data = False

    def __init__(self):
        super().__init__()
        self.add_type_signature([Input("in", lambda t: True)], [])

    def process(self, x):
        return None


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


__all__ = ["NopSink", "BenchmarkSink"]
