"""A multi-channel receiver bank on a (channel, time) mesh (the JAX
package's examples/channel_bank_pod.py): 64 WBFM mono channels of random
I/Q through ``WBFMMonoBank`` (parallel/wbfm.py), 4 chunks.

    python -m luaradio_tpu_torch.examples.channel_bank_pod [shards] [--cpu]

``shards`` (default 1) sets the mesh as the JAX example sets it from its
device count n: (2, n / 2) for an even n, else (1, n).  On one card the
shards are stacked on the device (parallel/mesh.py).  Each chunk is
``time shards * 8 * 4096`` samples a channel.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from luaradio_tpu_torch.core.platform import resolve_device
from luaradio_tpu_torch.parallel.mesh import Mesh
from luaradio_tpu_torch.parallel.wbfm import WBFMMonoBank

N_CHANNELS, CHUNKS = 64, 4


def build(shards: int = 1, device=None):
    """(the bank on its mesh, the chunk a channel)."""
    n = int(shards)
    ch = 2 if n % 2 == 0 and n >= 2 else 1
    bank = WBFMMonoBank(Mesh((ch, n // ch), ("channel", "time")),
                        if_rate=256e3, decimation=8, device=device)
    return bank, (n // ch) * 8 * 4096


def run(shards: int = 1, device=None, n_channels: int = N_CHANNELS,
        chunks: int = CHUNKS, chunk=None, seed: int = 0, emit=print):
    """Run the bank over ``chunks`` chunks of random I/Q (numpy, from
    ``seed``); returns each chunk's audio [n_channels, chunk / 8]."""
    dev = resolve_device(device)
    bank, default_chunk = build(shards, dev)
    chunk = chunk or default_chunk
    state = bank.init_state(n_channels)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(chunks):
        iq = (rng.standard_normal((n_channels, chunk))
              + 1j * rng.standard_normal((n_channels, chunk))
              ).astype(np.complex64)
        state, audio = bank.step(state, torch.from_numpy(iq).to(dev))
        out.append(audio)
        emit(f"chunk {i}: audio {tuple(audio.shape)} on a "
             f"{tuple(bank.mesh.shape.values())} mesh")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cpu" if "--cpu" in argv else None
    args = [a for a in argv if a != "--cpu"]
    run(int(args[0]) if args else 1, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
