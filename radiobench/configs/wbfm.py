"""The rx_wbfm graph, built from the program's public blocks as the
port's applications/apps.py ``RxWBFM.run`` derives it from the source's
rate (IF and AF decimations rounded half up), with the benchmark's sink
in place of the audio output; and the one piece of the program's state
the comparison reads (radiobench/judge.py ``lmr_angle``)."""

from __future__ import annotations

import math

import luaradio_tpu_torch as lr


def build(cfg: dict, source, sink) -> lr.CompositeBlock:
    rate = source.get_rate()
    if_downsample = int(rate / cfg["if_rate"] + 0.5)
    af_downsample = int(rate / if_downsample / cfg["af_rate"] + 0.5)
    tuner = lr.TunerBlock(cfg["tune_offset"], cfg["tuner_bandwidth"],
                          if_downsample)
    top = lr.CompositeBlock()
    if cfg["mono"]:
        top.connect(source, tuner, lr.WBFMMonoDemodulator(cfg["tau"]),
                    lr.DownsamplerBlock(af_downsample), sink)
        return top
    demod = lr.WBFMStereoDemodulator(cfg["tau"])
    l_ds = lr.DownsamplerBlock(af_downsample)
    r_ds = lr.DownsamplerBlock(af_downsample)
    top.connect(source, tuner, demod)
    top.connect(demod, "left", l_ds, "in")
    top.connect(demod, "right", r_ds, "in")
    top.connect(l_ds, "out", sink, "in1")
    top.connect(r_ds, "out", sink, "in2")
    return top


def program_state(runner) -> dict | None:
    """Stereo: the pilot PLL's multiplied-phase offset phi_m - 2 phi a row
    from its state after the run, and the chunks it had run; None for
    mono, or where the graph holds no such loop."""
    for seg, _ in runner.stage_plan:
        if seg is None:
            continue
        for b in seg.blocks:
            if isinstance(b, lr.PLLBlock) and b.multiplier == 2:
                phi, phi_m, _ = (v.double().reshape(-1).cpu() for v in
                                 seg.states[runner.bid[id(b)]])
                d = phi_m - 2 * phi
                d = (d + math.pi).remainder(2 * math.pi) - math.pi
                return {"offset": d.tolist(),
                        "chunks": runner.chunks_processed}
    return None


__all__ = ["build", "program_state"]
