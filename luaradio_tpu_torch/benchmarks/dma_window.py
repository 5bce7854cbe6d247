"""The windowed gather S8 on the card (scratch/pallas_dma_test.py, on the
port): the script's check, then the kernel at the flagship's size.

    python -m luaradio_tpu_torch.benchmarks.dma_window [--out PATH]

First the script's shape (C = 8, head 512, tile 8192, NT = 4, x normal
from seed 0, a zero carry): for each tile, the largest error of its head
against the halo it should hold (the carry, then the ``head`` floats
before the tile) per channel and of its body against the tile, one line a
tile, then ``OK`` or ``DMA MISMATCH``, as the script prints them.  Then
the flagship's size, C = 8 and 2 tile NT = 2^23 floats (NT = 512), checked
the same way (one summary line) and timed: the kernel
(ops/window.py ``window_gather``), the same gather by one PyTorch call
(``cat`` + ``unfold`` + ``contiguous``) and R2's copy of x
(ops/roofline.py) for the card's measured rate, each over ``5 reps``
back-to-back calls between two CUDA events, fenced once
(common.batch_ms, as bench_roofline times R2); the bound is the bytes
read plus written over 3.35 TB/s (H100 SXM data sheet) and over R2's
rate.  Prints one JSON object last (``--out`` also writes it), with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from luaradio_tpu_torch.benchmarks import common
from luaradio_tpu_torch.ops import roofline, window

C, HEAD, TILE, NT = 8, 512, 8192, 4
#: the flagship's row: 2 tile NT = 2^23 floats
FLAGSHIP_NT = (1 << 23) // (2 * TILE)
SHEET_BYTES_PER_S = 3.35e12
REPS = 10


def check(dev, c=C, head=HEAD, tile=TILE, nt=NT, seed=0, emit=print,
          per_tile=True) -> dict:
    """The script's check on ``dev``: each window's head and body against
    numpy slices of the input.  Returns {"ok", "tiles": per tile (head
    error per channel, body error), or their maxima}."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, 2 * tile * nt)).astype(np.float32)
    carry = np.zeros((c, head), np.float32)
    out = window.window_gather(torch.from_numpy(x).to(dev),
                               torch.from_numpy(carry).to(dev),
                               tile).cpu().numpy()
    w = head + 2 * tile
    ok, tiles = True, []
    for i in range(nt):
        win = out[:, i * w:(i + 1) * w]
        exp_head = carry if i == 0 else x[:, i * 2 * tile - head:i * 2 * tile]
        exp_body = x[:, i * 2 * tile:(i + 1) * 2 * tile]
        eh = np.abs(win[:, :head] - exp_head).max(axis=1)
        eb = np.abs(win[:, head:] - exp_body).max(axis=1)
        if per_tile:
            emit(f"tile {i}: head err per ch {eh}  body err max "
                 f"{eb.max():.1e}")
        tiles.append({"head_err": [float(v) for v in eh],
                      "body_err": float(eb.max())})
        ok = ok and bool(eh.max() == 0 and eb.max() == 0)
    if not per_tile:
        emit(f"{nt} tiles: head err max "
             f"{max(max(t['head_err']) for t in tiles):.1e}  body err max "
             f"{max(t['body_err'] for t in tiles):.1e}")
    emit("OK" if ok else "DMA MISMATCH")
    rec = {"shape": {"C": c, "head": head, "tile": tile, "NT": nt}, "ok": ok}
    if per_tile:
        rec["tiles"] = tiles
    return rec


def measure(dev, c=C, head=HEAD, tile=TILE, nt=FLAGSHIP_NT, reps=REPS,
            seed=0) -> dict:
    """Kernel, library and R2 ms at [c, 2 tile nt] (each over 5 reps
    back-to-back calls), the bytes and bounds."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((c, 2 * tile * nt), generator=g, device=dev)
    carry = torch.randn((c, head), generator=g, device=dev)
    w = head + 2 * tile
    nbytes = 4 * (x.numel() + carry.numel() + c * nt * w)
    ms = common.batch_ms(lambda: window.window_gather(x, carry, tile), dev,
                         5 * reps)
    lib_ms = common.batch_ms(
        lambda: torch.cat([carry, x], 1).unfold(1, w, 2 * tile).contiguous(),
        dev, 5 * reps)
    rec = {"shape": [c, 2 * tile * nt], "head": head, "tile": tile,
           "NT": nt, "bytes": nbytes, "ms": ms, "GBps": nbytes / ms / 1e6,
           "library_ms": lib_ms,
           "bound_ms_at_sheet": 1e3 * nbytes / SHEET_BYTES_PER_S}
    if dev.type == "cuda":
        r2_ms = common.batch_ms(
            lambda: roofline.hbm_copy_double_buffered(x), dev, 5 * reps)
        r2_rate = 2 * 4 * x.numel() / r2_ms * 1e3          # bytes/s
        rec.update(r2_GBps=r2_rate / 1e9,
                   bound_ms_at_r2=1e3 * nbytes / r2_rate)
    return rec


def run(device=None, c=C, head=HEAD, tile=TILE, nt=NT,
        flagship_nt=FLAGSHIP_NT, reps=REPS, emit=print) -> dict:
    """The check at the script's shape, then at the flagship's (checked
    and timed), on ``device`` (the card by default)."""
    dev, info = common.setup(device)
    script = check(dev, c, head, tile, nt, emit=emit)
    big = check(dev, c, head, tile, flagship_nt, seed=1, emit=emit,
                per_tile=False)
    timing = measure(dev, c, head, tile, flagship_nt, reps)
    return {"device": info["device"], "power_limit_w": info["power_limit_w"],
            "ok": script["ok"] and big["ok"], "script": script,
            "flagship": {"ok": big["ok"], **timing},
            "method": "back-to-back calls between two CUDA events, "
                      "fenced once, over their number; bound from the H100 "
                      "SXM data sheet's 3.35 TB/s and from R2's copy rate "
                      "measured the same way"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the object here")
    args = ap.parse_args(argv)
    rec = run()
    common.emit(rec, args.out)
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
