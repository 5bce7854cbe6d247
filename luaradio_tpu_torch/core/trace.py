"""Per-stage runtime tracing (the JAX package's core/trace.py).

The reference's observability is limited to an in-graph BenchmarkSink and a
debug logger (radio/blocks/sinks/benchmark.lua:88-121, radio/core/debug.lua).
The runtime adds a light span tracer around the pump: the host wall time of
each chunk's source read (``sources.read``, on the read-ahead thread in
fused mode), the pump's wait for it (``sources.wait``), each device
segment's dispatch (``segment[i].dispatch``) and each host stage
(``host[i].process``), aggregated into count/total/mean/min/max.  A
dispatch span times the host's queueing of the card's work, not the card.

Enable with ``LUARADIO_TPU_TRACE=1`` or ``Runner(top, trace=True)``; read
the result from ``Runner.tracer.report()``.  Nothing prints it: the JAX
package's docstring says its report is printed at the end of ``run()``,
but its code never prints it, and the port follows the code (it has no
printing method).
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager


class Tracer:
    def __init__(self):
        self.spans: dict[str, list[float]] = {}
        # the read-ahead thread records sources.read while the pump
        # records the rest
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                agg = self.spans.setdefault(name,
                                            [0, 0.0, float("inf"), 0.0])
                agg[0] += 1
                agg[1] += dt
                agg[2] = min(agg[2], dt)
                agg[3] = max(agg[3], dt)

    def report(self) -> dict:
        with self._lock:
            return {
                name: {"count": int(c), "total_s": t,
                       "mean_s": t / max(c, 1), "min_s": mn, "max_s": mx}
                for name, (c, t, mn, mx) in self.spans.items()
            }


def enabled_by_env() -> bool:
    v = os.environ.get("LUARADIO_TPU_TRACE", "")
    return v not in ("", "0", "false")


__all__ = ["Tracer", "enabled_by_env"]
