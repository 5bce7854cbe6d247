"""Configuration ``wbfm_stereo_hackrf``: the graph rx_wbfm (stereo)
builds (the port's applications/apps.py ``RxWBFM.run``) between a source
and a sink (radiobench/configs/wbfm.py)."""

from radiobench.configs.wbfm import build, program_state

__all__ = ["build", "program_state"]
