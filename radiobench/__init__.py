"""radiobench: the benchmark of luaradio_tpu_torch (README.md)."""
