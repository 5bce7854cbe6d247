"""The plain reference of configuration ``wbfm_mono_rtlsdr``: rx_wbfm
--mono (reference/wbfm.py)."""

from radiobench.reference.wbfm import audio, plan, work

__all__ = ["audio", "plan", "work"]
