"""Kind ``bank``: ``rows`` captures, each a station of its own (seeded by
radiobench/synth.py ``row_seed``), replayed in loops through one
``BankSource`` of ``IQFileSource``s (a closed loop;
``run(channels=rows)``)."""

from radiobench import synth
from radiobench.drive import Capture


class Player(Capture):
    def __init__(self, cfg, mix, seed, device, tmpdir):
        self.rows = int(mix["rows"])
        super().__init__(cfg, mix, seed, device, tmpdir)

    def _make(self, seed, device):
        return [synth.capture(synth.row_seed(seed, r), self.length, self.cfg,
                              self.mix["signal"], device).cpu().numpy()
                for r in range(self.rows)]


__all__ = ["Player"]
