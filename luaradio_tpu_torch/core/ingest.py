"""The ingest seam: each host source's route to the card, chosen once per
source when the Runner is built (:func:`plan_feeds`) from its side of the
contract (core/block.py HostSourceBlock), and carried by its
:class:`Feed`: ``"resident"`` (windows of a ring the source keeps on the
card: no host read, no copy), ``"wire"`` (the 1-2 byte integer items
copied and converted on the card, where the reference converts on the
host per sample, iqfile.lua:82-116) or ``"host"`` (samples, copied where
only device blocks consume them).  A new route is one more feed form plus
its source's side of the contract.
"""

from __future__ import annotations

import numpy as np

from luaradio_tpu_torch.core.composite import PortRef


def pad_to(arr: np.ndarray, n: int) -> np.ndarray:
    """``arr`` zero-padded on its last (time) axis to ``n`` samples, so a
    short last chunk keeps the planned shape (nvalid trims the outputs)."""
    short = n - arr.shape[-1]
    if short <= 0:
        return arr
    return np.concatenate(
        [arr, np.zeros(arr.shape[:-1] + (short,), arr.dtype)], axis=-1)


class Feed:
    """One host source's ``route`` (module docstring): its output ``keys``,
    planned chunk length ``want``, whether its payload is ``copied`` to
    the card, and the ``ingest`` converter of the wire route (else None).
    ``read(values, nvalid)`` puts one chunk into the two dicts, a short one
    zero-padded, and returns whether it came short, or None at EOF."""

    def __init__(self, source, route: str, keys: list[str], want: int,
                 copied: bool, ingest=None):
        self.source, self.route, self.keys, self.want = \
            source, route, keys, want
        self.copied, self.ingest = copied, ingest
        self.read = getattr(self, f"_read_{route}")

    def _read_resident(self, values, nvalid):
        values[self.keys[0]] = self.source.resident_read(self.want)
        nvalid[self.keys[0]] = self.want
        return False

    def _read_wire(self, values, nvalid):
        got = self.source.wire_read(self.want)
        if got is None:
            return None
        raw, nv = got
        values[self.keys[0]] = pad_to(raw, self.want * self.source.wire_factor)
        nvalid[self.keys[0]] = nv
        return nv < self.want

    def _read_host(self, values, nvalid):
        data = self.source.read(self.want)
        if data is None:
            return None
        short = False
        for k, arr in zip(self.keys, data if isinstance(data, tuple)
                          else (data,)):
            if isinstance(arr, list):       # host objects: never padded
                values[k], nvalid[k] = arr, len(arr)
                continue
            arr = np.asarray(arr)
            nvalid[k] = arr.shape[-1]
            values[k] = pad_to(arr, self.want)
            short |= nvalid[k] < self.want
        return None if nvalid[self.keys[0]] == 0 else short


def plan_feeds(sources, graph, bid: dict) -> list[Feed]:
    """Each host source's feed: where every consumer is a device block and
    the source has one output, resident if its ring can be set up, else
    wire if it converts on the card; host otherwise.  ``resident=True``
    without a ring raises."""
    feeds = []
    for s in sources:
        keys = [f"{bid[id(s)]}.{oi}" for oi in range(len(s.outputs))]
        want = graph.out_chunk[id(s)]
        on_card = all(c.block.domain == "device"
                      for oi in range(len(s.outputs))
                      for c in graph.consumers(PortRef(s, oi)))
        single = on_card and len(keys) == 1
        if single and s.resident_setup(want):
            feeds.append(Feed(s, "resident", keys, want, copied=False))
            continue
        if s.resident is True:
            raise ValueError(
                f"{s.name}: resident=True, but the source cannot hold a "
                f"device-resident ring here (it needs repeat_on_eof, a "
                f"payload within RESIDENT_BUDGET and outputs that feed "
                f"only device blocks)")
        ingest = s.device_ingest() if single else None
        feeds.append(Feed(s, "host" if ingest is None else "wire", keys,
                          want, copied=on_card, ingest=ingest))
    return feeds


__all__ = ["Feed", "plan_feeds", "pad_to"]
