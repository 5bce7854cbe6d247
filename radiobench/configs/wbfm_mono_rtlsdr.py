"""Configuration ``wbfm_mono_rtlsdr``: the graph rx_wbfm --mono builds
(the port's applications/apps.py ``RxWBFM.run``) between a source and a
sink (radiobench/configs/wbfm.py)."""

from radiobench.configs.wbfm import build, program_state

__all__ = ["build", "program_state"]
