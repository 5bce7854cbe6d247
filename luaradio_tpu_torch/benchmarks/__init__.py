"""The port's measurement entry points, each runnable as ``python -m
luaradio_tpu_torch.benchmarks.<name>`` (the JAX system's root scripts of
the same names, on the port):

* ``bench`` — the flagship step and bench.py's three graph rows, one JSON
  line with bench.py's keys;
* ``bench_roofline`` — the card's copy, bf16 product and atan2 rates
  (the roofline probes R1-R3, ops/roofline.py) and the flagship, PLL and
  resident rows against them;
* ``bench_blocks`` — the reference's block benchmark, one object a row;
* ``bench_scaling`` — the WBFM bank and a time-sharded graph on meshes of
  growing size;
* ``bench_realtime`` — rx_wbfm mono from a paced fake RTL-SDR;
* ``bench_multihost`` — graphs over meshes spanning processes (gloo);
* ``entry`` — the flagship step and a dry run of the three mesh kinds.

Each runs on the CUDA card by default and raises without one; its
functions take ``device="cpu"`` for the plain path at small sizes (the
tests).  Every result names its device and the card's power limit.
Importing a module starts no run.
"""
