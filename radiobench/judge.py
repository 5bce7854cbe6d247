"""The comparison that decides ``correct``.

The window's kept chunks (the program's audio as it reached the sink) are
held against the plain reference's audio over the same stream.  A looped
capture of n samples gives an audio stream that repeats every P = n / D
samples (D the total decimation) once the receiver has played it once;
the reference computes the first two periods from zero state, and the
program's audio sample j is held against reference sample j in the first
period and against P + (j mod P) after it.

The gaps are widest gaps over every compared sample, as a fraction of
the row's full scale (the reference's largest sample over its second
period, over all channels):

* mono, ``audio_gap``: the audio;
* stereo, ``lpr_gap``: (L + R) / 2, the path without the PLL;
* stereo, ``lmr_gap``: (L - R) / 2 against cos(c) I + sin(c) Q, I and Q
  the reference's L-R path and its quadrature, with one angle c a chunk
  and row that fits the chunk best (least squares): the angle by which
  the program's 38 kHz carrier sits from the reference's there;
* stereo, ``lmr_angle``, in radians: how far those fitted angles lie
  from the one the two receivers' carriers give, wrap(d_p - d_r), d =
  phi_m - 2 phi the multiplied phase's offset: the program's from its
  PLL's own state after the run (the configuration's ``program_state``),
  the reference's from its loop at the same stream position.  The PLL's
  multiplied phase keeps whatever its acquisition's clamped steps left in
  it (reference/wbfm.py ``audio``), and which offset that is turns on
  every rounding of the acquisition, so a float32 receiver's carrier
  cannot be held to the float64 one's, only to its own loop's state.
  Swapped or inverted channels read pi here, a carrier a quarter cycle
  off pi / 2, a carrier that wanders as far as its wander.
"""

from __future__ import annotations

import numpy as np
import torch


def _index(c: int, per_chunk: int, period: int) -> np.ndarray:
    j = c * per_chunk + np.arange(per_chunk)
    return np.where(j < period, j, period + j % period)


def _wrap(a: torch.Tensor) -> torch.Tensor:
    return torch.remainder(a + np.pi, 2 * np.pi) - np.pi


def gaps(kept: dict, ref: torch.Tensor, per_chunk: int,
         state: dict | None = None) -> tuple[dict, dict]:
    """({number: reading}, {"lmr_fit" (the median fitted angle), "lmr_want":
    [angle a row]}) over the kept chunks {chunk: [rows, channels,
    per_chunk]} against ``ref``
    [rows, channels (+ Q and the carrier's offset), 2 P].  ``state``, for
    stereo: {"offset": [d_p a row], "chunks": the chunks the program's
    loop had run when d_p was read}.  A chunk of the wrong shape, or
    stereo without a state, reads inf."""
    period = ref.shape[-1] // 2
    stereo = ref.shape[-2] == 4
    ch = 2 if stereo else 1
    full = ref[:, :ch, period:].abs().amax(-1).amax(-1)         # [rows]
    names = ("lpr_gap", "lmr_gap", "lmr_angle") if stereo \
        else ("audio_gap",)
    shape = (ref.shape[0], ch, per_chunk)
    if any(tuple(y.shape) != shape for y in kept.values()):
        return {k: float("inf") for k in names}, {}
    out = {k: 0.0 for k in names}
    lmr, ii, qq = [], [], []
    for c in sorted(kept):
        idx = torch.from_numpy(_index(c, per_chunk, period)).to(ref.device)
        y = torch.from_numpy(kept[c]).to(ref.device, ref.dtype)
        r = ref[..., idx]
        if not stereo:
            g = (y[:, 0] - r[:, 0]).abs().amax(-1) / full
            out["audio_gap"] = max(out["audio_gap"], float(g.max()))
            continue
        g = ((y[:, 0] + y[:, 1]) - (r[:, 0] + r[:, 1])).abs().amax(-1) \
            / (2 * full)
        out["lpr_gap"] = max(out["lpr_gap"], float(g.max()))
        lmr.append((y[:, 0] - y[:, 1]) / 2)
        ii.append((r[:, 0] - r[:, 1]) / 2)
        qq.append(r[:, 2])
    extra = {}
    if stereo:
        # [chunks, rows, n]
        y, i, q = (torch.stack(v) for v in (lmr, ii, qq))
        # least squares a I + b Q ~ y a chunk and row; the angle of (a, b)
        sii, sqq, siq = (i * i).sum(-1), (q * q).sum(-1), (i * q).sum(-1)
        syi, syq = (y * i).sum(-1), (y * q).sum(-1)
        det = sii * sqq - siq * siq
        a = (syi * sqq - syq * siq) / det
        b = (syq * sii - syi * siq) / det
        ang = torch.atan2(b, a)                             # [chunks, rows]
        fit = torch.cos(ang)[..., None] * i + torch.sin(ang)[..., None] * q
        g = (y - fit).abs().amax(-1) / full
        out["lmr_gap"] = float(g.max())
        extra["lmr_fit"] = [float(v) for v in ang.median(0).values]
        if not state or len(state["offset"]) != ref.shape[0]:
            out["lmr_angle"] = float("inf")
        else:
            at = int(_index(state["chunks"], per_chunk, period)[0])
            d_p = torch.tensor(state["offset"], dtype=ref.dtype,
                               device=ref.device)
            want = _wrap(d_p - ref[:, 3, at])
            out["lmr_angle"] = float(_wrap(ang - want).abs().max())
            extra["lmr_want"] = [float(v) for v in want]
    return out, extra


__all__ = ["gaps"]
