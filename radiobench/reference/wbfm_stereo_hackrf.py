"""The plain reference of configuration ``wbfm_stereo_hackrf``: rx_wbfm
stereo with the pilot PLL (reference/wbfm.py)."""

from radiobench.reference.wbfm import audio, plan, work

__all__ = ["audio", "plan", "work"]
