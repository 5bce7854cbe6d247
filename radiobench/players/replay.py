"""Kind ``replay``: one capture written to a file and replayed in a loop
through ``IQFileSource(..., repeat_on_eof=True, resident=<the mix's>)``,
as fast as the graph takes it (a closed loop)."""

from radiobench.drive import Capture


class Player(Capture):
    pass


__all__ = ["Player"]
