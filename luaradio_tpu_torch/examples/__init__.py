"""Runnable examples of the port (``python -m
luaradio_tpu_torch.examples.<name>``): ``fm_roundtrip_selftest`` (a tone
through the FM modulator and the mono receiver and back) and
``wavfile_ssb_modulator`` (WAV in, SSB IQ file out)."""
