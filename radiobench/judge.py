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

Decoded messages (``messages``; a configuration whose file says
``"output": "messages"``) are held against the reference's messages in
order, row by row.  The reference decodes each looped capture (P input
samples) twice from zero state and gives each message's ``at``, the
input sample at which its last bit enters the receiver; over the window
its messages unroll as audio does in ``_index``: the first period as
decoded, the second repeated.  A message is expected where its ``at``
lies from the first window chunk's start to the last one's end less
``lag`` (the reference's ``plan(cfg)["lag"]``: the most input samples
after ``at`` at which a correct receiver may still emit it).  A message
emitted in chunk c matches the next reference message in order whose
text is equal and whose ``at`` satisfies (c + 1) chunk_in > at (its last
bit has entered) and c chunk_in <= at + lag (it is not late); one that
matches a reference message outside the expected span, at the window's
edges, is neither expected nor wrong.  The numbers, the first two the
largest over the rows:

* ``msg_missed``: expected messages left unmatched over the expected
  count (1.0 for a silent row);
* ``msg_wrong``: emitted messages that match no reference message at
  their place (altered, repeated, early, late or in another row's place)
  over the emitted count;
* ``compared_messages``: the fewest expected messages of any row, a count
  held from below at 1, as ``compared_chunks`` is (radiobench/harness.py
  ``AT_LEAST``), so that no row goes unjudged.

The first two have the limit 0.  The generator of a message cell keeps
every bit decision's eye open (its SNR is part of the traffic mix), so
the float64 reference and a correct float32 program slice the same bits
and decode the same messages: any difference is a fault, not rounding.
For the same reason the messages cannot tell a receiver one precision
down from a sound one, so a message cell is also held by the samples its
slicer decides on: the configuration's graph taps them (the clock
recovery's input, ``window.MessageSink.soft``), and ``gaps`` holds a
sample of their chunks against the reference's ``soft``, as mono audio,
under the name

* ``soft_gap``: the widest gap over every compared sample, as a fraction
  of the row's full scale.

Its limit, like ``audio_gap``'s, lies between the largest that sound
runs read and the smallest that the control (the reference one
precision down, radiobench/control.py) reads.
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


def _unroll(ref_row: list, period: int, lo: int, hi: int) -> list:
    """The reference's (at, text) of one row with lo <= at < hi in the
    looped stream, in order: its first period as decoded, its second
    repeated every ``period`` input samples after it."""
    out = [(at, t) for at, t in ref_row if at < period and lo <= at < hi]
    second = [(at, t) for at, t in ref_row if period <= at < 2 * period]
    for k in range(max(0, (lo - 2 * period) // period),
                   max(0, (hi - period) // period) + 1):
        out += [(at + k * period, t) for at, t in second
                if lo <= at + k * period < hi]
    return sorted(out, key=lambda m: m[0])


def messages(kept: dict, ref: list, chunk_in: int, lag: int,
             period: int) -> tuple[dict, dict]:
    """({number: reading}, {counts for the run's record}) over the
    window's messages ``kept`` {chunk: [(chunk, row, text), ...]} (every
    window chunk, each chunk's records in row order) against ``ref``, a
    list a row of (at, text) over two periods of ``period`` input samples
    (module docstring)."""
    first, last = min(kept), max(kept)
    lo, hi = first * chunk_in, (last + 1) * chunk_in
    emitted = [[] for _ in ref]
    stray = 0                       # records of a row the reference lacks
    for c in sorted(kept):
        for cc, row, text in kept[c]:
            if 0 <= row < len(ref):
                emitted[row].append((cc, text))
            else:
                stray += 1
    missed = wrong = edge = 0
    n_exp = []
    miss_share, wrong_share = 0.0, 1.0 if stray else 0.0
    for row, ref_row in enumerate(ref):
        cands = _unroll(ref_row, period, lo - lag, hi)
        matched = set()
        p = 0
        for c, text in emitted[row]:
            for j in range(p, len(cands)):
                at, t = cands[j]
                if at >= (c + 1) * chunk_in:
                    break
                if t == text and c * chunk_in <= at + lag:
                    matched.add(j)
                    p = j + 1
                    break
        expected = {j for j, (at, _) in enumerate(cands)
                    if lo <= at < hi - lag}
        row_missed = len(expected - matched)
        row_wrong = len(emitted[row]) - len(matched)
        missed += row_missed
        wrong += row_wrong
        edge += len(matched - expected)
        n_exp.append(len(expected))
        if expected:
            miss_share = max(miss_share, row_missed / len(expected))
        if emitted[row]:
            wrong_share = max(wrong_share, row_wrong / len(emitted[row]))
    return ({"msg_missed": miss_share, "msg_wrong": wrong_share,
             "compared_messages": min(n_exp, default=0)},
            {"messages_emitted": sum(map(len, emitted)) + stray,
             "messages_missed": missed, "messages_wrong": wrong + stray,
             "messages_edge": edge, "messages_expected": sum(n_exp)})


__all__ = ["gaps", "messages"]
