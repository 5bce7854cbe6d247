"""Traffic: a mix (``traffic/<mix>.json``, data only) is played by the
player its ``kind`` names, ``players/<kind>.py`` (class ``Player``, on
``Capture``) beside the cell's other files, which makes the mix's inputs
from the seed and the mix's parameters and gives the graph its source
(radiobench/harness.py ``make_player``).  A player of a live
radio plays the capture through a paced fake of the radio's library,
``fakes/<sdr>.py``, the ``sdr`` the mix names.

Captures are made on ``device`` (radiobench/synth.py) and written under
``tmpdir``.
"""

from __future__ import annotations

import importlib
import os

import numpy as np
import torch

import luaradio_tpu_torch as lr
from radiobench import synth


class Capture:
    """What every player shares: one capture (a row) made from the seed,
    written to a file, and that file replayed in a loop through
    ``IQFileSource(..., repeat_on_eof=True, resident=<the mix's>)``."""

    rows = 1

    def __init__(self, cfg: dict, mix: dict, seed: int, device, tmpdir):
        self.cfg, self.mix = cfg, mix
        self.length = synth.seamless_length(mix["capture_samples"], cfg)
        self.wire = self._make(seed, device)
        self.paths = []
        for r, w in enumerate(self.wire):
            path = os.path.join(tmpdir, f"capture{r}.{self.cfg['wire']}")
            w.tofile(path)
            self.paths.append(path)

    def _make(self, seed, device) -> list[np.ndarray]:
        return [synth.capture(seed, self.length, self.cfg, self.mix["signal"],
                              device).cpu().numpy()]

    def _file(self, path):
        return lr.IQFileSource(path, self.cfg["wire"], self.cfg["rate"],
                               repeat_on_eof=True,
                               resident=self.mix.get("resident"))

    def file_source(self):
        """The captures replayed from their files (a bank's rows in one
        ``BankSource``)."""
        if self.rows == 1:
            return self._file(self.paths[0])
        return lr.BankSource([self._file(p) for p in self.paths])

    def source(self):
        return self.file_source()

    def raw(self, device) -> torch.Tensor:
        """The captures' wire items [rows, 2 n], for the reference."""
        return torch.from_numpy(np.stack(self.wire)).to(device)

    def close(self):
        pass


def fake_library(sdr: str):
    """The module of the paced fake of SDR library ``sdr``."""
    return importlib.import_module(f"radiobench.fakes.{sdr}")


__all__ = ["Capture", "make", "fake_library"]
