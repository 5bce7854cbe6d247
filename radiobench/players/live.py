"""Kind ``live``: one capture played by a paced fake of the mix's SDR
library (``sdr``, radiobench/fakes/<sdr>.py) at the configuration's rate,
whether or not the graph keeps up (an open loop).  The capture's file
stays for the warm-up, which an open loop cannot wait for."""

from radiobench.drive import Capture, fake_library


class Player(Capture):
    def __init__(self, cfg, mix, seed, device, tmpdir):
        super().__init__(cfg, mix, seed, device, tmpdir)
        self.lib = fake_library(mix["sdr"])
        #: the paced generator: its drops, lateness and sample stamps
        self.fake = self.lib.make(self.wire[0], cfg, mix)

    def warm_source(self):
        return self.file_source()

    def source(self):
        return self.lib.open_source(self.fake, self.cfg)

    def close(self):
        self.fake.stop()
        self.lib.release()


__all__ = ["Player"]
