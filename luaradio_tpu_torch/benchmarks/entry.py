"""Driver entry points (the JAX system's __graft_entry__.py, on the port).

    python -m luaradio_tpu_torch.benchmarks.entry [--devices N]

* :func:`entry` -> ``(step, (state, x))``: the flagship step (the WBFM
  mono receiver chain, kernel K1) on 4 channels x 2^16 samples of the
  interleaved I/Q wire, the JAX system's seed-0 payload.
* :func:`dryrun_multichip` (n): the three mesh kinds on the port's
  one-card ``Mesh`` at tiny shapes, one step or run each: the WBFM bank on
  (ch, n / ch) ("channel", "time") shards, a channel Runner on a
  ("channel",) mesh of n and a time Runner on a ("time",) mesh of n.  On
  one card the shards are stacked on the device (parallel/mesh.py), not
  spread over n devices.

Run as a module, it takes one flagship step and the dry run on the card
and prints their shapes, the device and its power limit as one JSON line.
"""

from __future__ import annotations

import argparse
import io
import sys

import numpy as np
import torch

import luaradio_tpu_torch as lr
from luaradio_tpu_torch.benchmarks import common
from luaradio_tpu_torch.parallel.flagship import make_wbfm_mono_step
from luaradio_tpu_torch.parallel.mesh import Mesh
from luaradio_tpu_torch.parallel.wbfm import WBFMMonoBank

CHANNELS, TIME = 4, 1 << 16
DECIMATION = 8


def entry(device=None):
    """(step, (state, x_payload)) for the flagship on ``device``."""
    dev, _ = common.setup(device)
    step, init_state = make_wbfm_mono_step(if_rate=256e3,
                                           decimation=DECIMATION, device=dev)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (CHANNELS, 2 * TIME)).astype(np.float32)).to(dev)
    return step, (init_state(CHANNELS), x)


class _Shapes(lr.SinkBlock):
    """Records the shape of each call's input."""

    def __init__(self):
        super().__init__()
        self.shapes = []
        self.add_type_signature([lr.Input("in", lambda t: True)], [])

    def process(self, x):
        self.shapes.append(tuple(x.shape))


def _iq_source(rng, n):
    z = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)
    return lr.IQFileSource(io.BytesIO(z.tobytes()), "f32le", 256e3)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The bank, channel and time parts on meshes of ``n_devices``; the
    shapes each produced."""
    dev, _ = common.setup(device)
    n = int(n_devices)
    ch = 2 if n % 2 == 0 and n >= 2 else 1
    tm = n // ch
    out = {}

    # 1. the sharded receiver bank: channels over "channel", each stream's
    # time axis over "time"
    bank = WBFMMonoBank(Mesh((ch, tm), ("channel", "time")), if_rate=256e3,
                        decimation=DECIMATION, device=dev)
    n_channels, t = 2 * ch, tm * DECIMATION * 32
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal((n_channels, t))
                          + 1j * rng.standard_normal((n_channels, t))
                          ).astype(np.complex64)).to(dev)
    _, audio = bank.step(bank.init_state(n_channels), x)
    common.sync(dev)
    if tuple(audio.shape) != (n_channels, t // DECIMATION):
        raise AssertionError(f"bank: audio {tuple(audio.shape)}")
    out["bank"] = {"mesh": [ch, tm], "audio": list(audio.shape)}

    # 2. the Runner as a channel bank of ordinary blocks over n channels
    rng = np.random.default_rng(2)
    sink = _Shapes()
    top = lr.CompositeBlock()
    top.connect(lr.BankSource([_iq_source(rng, 4096) for _ in range(n)]),
                lr.WBFMMonoDemodulator(tau=75e-6),
                lr.DownsamplerBlock(DECIMATION), sink)
    top.run(chunk_size=1024, mesh=Mesh((n,), ("channel",)), channels=n,
            device=dev)
    out["channel"] = {"mesh": [n], "chunks": sink.shapes}

    # 3. one stream of ordinary blocks split over n time shards
    rng = np.random.default_rng(3)
    sink = _Shapes()
    top = lr.CompositeBlock()
    top.connect(_iq_source(rng, 1 << 14), lr.FrequencyTranslatorBlock(-50e3),
                lr.LowpassFilterBlock(64, 100e3),
                lr.FrequencyDiscriminatorBlock(1.25),
                lr.LowpassFilterBlock(32, 15e3, use_fft=False),
                lr.FMDeemphasisFilterBlock(75e-6),
                lr.DownsamplerBlock(DECIMATION), sink)
    top.run(chunk_size=1 << 13, mesh=Mesh((n,), ("time",)), device=dev)
    out["time"] = {"mesh": [n], "chunks": sink.shapes}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=8)
    args = ap.parse_args(argv)
    step, (state, x) = entry()
    state, audio = step(state, x)
    dry = dryrun_multichip(args.devices)
    dev = x.device
    common.sync(dev)
    info = common.device_info(dev)
    common.emit({"entry_audio": list(audio.shape),
                 "entry_finite": bool(torch.isfinite(audio).all()),
                 "dryrun_multichip": dry, "device": info["device"],
                 "power_limit_w": info["power_limit_w"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
