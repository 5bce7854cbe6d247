"""Runnable examples of the port (``python -m
luaradio_tpu_torch.examples.<name>``): ``fm_roundtrip_selftest`` (a tone
through the FM modulator and the mono receiver and back),
``wavfile_ssb_modulator`` (WAV in, SSB IQ file out) and the nine RTL-SDR
receivers ``rtlsdr_{wbfm_mono,wbfm_stereo,am_envelope,am_synchronous,
nbfm,ssb,rds,pocsag,ax25}``.  Each RTL-SDR module's ``build()`` returns
its flow graph, constructible without the radio (librtlsdr is loaded
when the graph starts); ``main`` runs it on the CUDA card, or with
``--cpu`` on the plain path."""

from __future__ import annotations

import sys


def run_main(build, argv=None, converters=(float,)) -> int:
    """Run ``build(*args)`` with the command line's positional arguments
    converted by ``converters`` in turn; ``--cpu`` runs the plain path."""
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    args = [a for a in argv if a != "--cpu"]
    build(*(c(a) for c, a in zip(converters, args))).run(device=device)
    return 0
