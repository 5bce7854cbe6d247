"""The overlap scan's ring kernel (csrc/pll_overlap.cu scan_ring_kernel)
mirrored in Python: its stage and copy formulas (ring_stages, copy_plan
below), its protocol run under hypothesis in arbitrary
orders, and the values the protocol hands each step, evaluated as the
kernel evaluates them (segment 0 walks its zero warm-up and gets its
carry back at step W), against the plain scan _scan_reference bit for
bit.  Also the scan's [C*S, L] output layout through _run and
pll_overlap_discard against the JAX package on a bank, row by row.

The mirror moves tokens, not values: the copy lanes write sample indices
(or zeros) into x slots, the walker reads them and writes (segment, step)
tokens into the w ring, the oscillator reads those and writes output
tokens into its output stages, and the bulk stores read a stage at a
time the schedule chooses.  Every mbarrier is modelled (arrival counts,
transaction bytes, phases), as are each lane's bulk groups; a wait that
can never be met, an arrival on a completed phase, a read of a slot no
one wrote or a store that reads a stage after it was overwritten fails
the run.
"""

import os
import random
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from luaradio_tpu.ops import pll_overlap as jax_pll_overlap  # noqa: E402
from luaradio_tpu_torch.ops import pll_overlap  # noqa: E402
from luaradio_tpu_torch.ops.pll_overlap import (  # noqa: E402
    plan_overlap, pll_overlap_discard)

jax_overlap = jax.jit(jax_pll_overlap.pll_overlap_discard,
                      static_argnums=(2, 3, 4, 5, 6, 7, 8))
SRC = os.path.join(os.path.dirname(__file__), "..", "luaradio_tpu_torch",
                   "csrc", "pll_overlap.cu")
CONSTS = tuple(float(np.float32(v)) for v in (0.05, 0.0012, -0.3, 0.3, 2.0))


def ring_stages(warm: int, lseg: int, t: int):
    """The kernel's stages of T = ``t`` steps over a segment's W+L walk:
    (k0, [(start, end), ...]) with boundaries at W + j T clipped to
    [0, W+L], so that step W starts stage k0 (ceil(W / T)) and output
    stage m = k - k0 covers outputs [m T, min(L, m T + T))."""
    k0 = -(-warm // t)
    count = k0 + -(-lseg // t)
    return k0, [(max(0, warm + (k - k0) * t),
                 min(warm + lseg, warm + (k - k0 + 1) * t))
                for k in range(count)]


def copy_plan(x8: int, n_row: int, seg_per_row: int, lseg: int, warm: int,
              s_count: int, g: int, start: int, end: int,
              zero_warm: bool = False):
    """What the copy lane of segment ``g`` (of ``s_count``; a lane past
    the last has none) writes for the stage of walk steps [start, end),
    x's address being ``x8`` float2s: a dict with the slot's shift ``o``
    (the parity of the address of the stage's first sample, so that slot
    position and address agree in parity), and steps -> source:
    ``zeros`` (steps written as zeros), ``plain`` ([(step, sample)], one
    sample each at a head 8 bytes off 16 and at an odd tail) and ``bulk``
    ((first step, first sample, samples) or None: one 16-byte aligned
    cp.async.bulk of an even count).  Samples are absolute indices over
    x; step i of segment (row, sr) reads sample row N + sr L - W + i.
    Where that sample does not exist, ``zero_warm`` walks zeros (segment
    0's warm-up; every step of a lane past the last segment); else
    segment 0's warm-up walks its row's first W samples (row N + i) and a
    lane past the last segment the last segment's samples: those steps
    are discarded either way, and real samples keep atan2f's 0/0 path
    off the walker's lanes (the kernel's stage_base)."""
    valid = g < s_count
    row, sr = divmod(g if zero_warm or valid else s_count - 1, seg_per_row)
    base = row * n_row
    if zero_warm or sr != 0 or start >= warm:
        base += sr * lseg - warm
    o = (x8 + base + start) & 1
    zend = 0
    if zero_warm:
        zend = warm + lseg if not valid else (warm if sr == 0 else 0)
    zeros = list(range(start, min(end, max(start, zend))))
    i = max(start, min(end, zend))
    plain, bulk = [], None
    if i < end:
        a0, a1 = base + i, base + end
        if (x8 + a0) & 1:
            plain.append((i, a0))
            a0 += 1
            i += 1
        nb = (a1 - a0) & ~1
        if a1 - a0 > nb:
            plain.append((end - 1, a1 - 1))
        if nb:
            bulk = (i, a0, nb)
    return {"o": o, "zeros": zeros, "plain": plain, "bulk": bulk}


class Stuck(Exception):
    pass


class Bar:
    """An mbarrier: ``count`` arrivals and the transaction bytes complete
    a phase."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.done = count, count, 0, 0

    def arrive(self, tx=0):
        assert self.pending > 0, "arrival on a completed phase"
        self.tx += tx
        self.pending -= 1
        self._check()

    def complete_tx(self, n):
        self.tx -= n
        self._check()

    def _check(self):
        if self.pending == 0 and self.tx == 0:
            self.done += 1
            self.pending = self.count

    def passed(self, parity):
        # mbarrier.try_wait.parity: the phase of that parity has completed
        return (self.done & 1) != parity


def simulate(rows, seg_per_row, lseg, warm, g_blk, t, p, x8, aligned, rng,
             faults=frozenset(), zero_warm=False):
    """Run the ring kernel's protocol on every block of a launch in an
    order drawn from ``rng``.  Returns (reads, wreads, out, snaps): the
    token each walker step read, the w token each oscillator step read,
    the output tokens in [C*S, L] and the steps each lane snapshotted
    at; ``zero_warm`` as copy_plan.  ``faults`` drops waits, to show the
    mirror catches their loss:
    "xempty" (the copier's), "wempty" (the walker's), "read" (the
    oscillator's bulk_wait_read before it reuses an output stage)."""
    s_count = rows * seg_per_row
    n_row = seg_per_row * lseg
    k0, stages = ring_stages(warm, lseg, t)
    xs = t + 2
    blocks = -(-s_count // g_blk)
    out = [[[None] * lseg for _ in range(s_count)] for _ in range(3)]
    reads, wreads, snaps = {}, {}, {}
    actors, pending = [], []        # generators; outstanding async copies

    for b in range(blocks):
        bars = {k: [Bar(g_blk) for _ in range(p)]
                for k in ("xfull", "xempty", "wfull", "wempty")}
        xring = [[[None] * xs for _ in range(g_blk)] for _ in range(p)]
        wring = [[[None] * g_blk for _ in range(t)] for _ in range(p)]
        oring = [[[[None] * (t + 4) for _ in range(g_blk)] for _ in range(3)]
                 for _ in range(2)]

        def wait(bar, parity):
            while not bar.passed(parity):
                yield "blocked"

        def copier(lane, b=b, bars=bars, xring=xring):
            g = b * g_blk + lane
            for k, (s, e) in enumerate(stages):
                q = k % p
                if k >= p and "xempty" not in faults:
                    yield from wait(bars["xempty"][q], (k // p - 1) & 1)
                plan = copy_plan(x8, n_row, seg_per_row, lseg, warm,
                                 s_count, g, s, e, zero_warm)
                slot, o = xring[q][lane], plan["o"]
                assert all(v is None for v in slot), \
                    "the copier overwrote a slot the walker has not read"
                for i in plan["zeros"]:
                    slot[o + i - s] = "Z"
                for i, a in plan["plain"]:
                    slot[o + i - s] = a
                nbytes = 0
                if plan["bulk"]:
                    i0, a0, cnt = plan["bulk"]
                    assert cnt % 2 == 0 and (x8 + a0) % 2 == 0
                    assert (o + i0 - s) % 2 == 0, "bulk lands unaligned"
                    assert o + i0 - s + cnt <= xs
                    nbytes = cnt * 8
                bars["xfull"][q].arrive(nbytes)
                if plan["bulk"]:
                    def land(slot=slot, pos=o + i0 - s, a0=a0, cnt=cnt,
                             bar=bars["xfull"][q], nbytes=nbytes):
                        for j in range(cnt):
                            slot[pos + j] = a0 + j
                        bar.complete_tx(nbytes)
                    pending.append(land)
                yield "step"

        def walker(lane, b=b, bars=bars, xring=xring, wring=wring):
            g = b * g_blk + lane
            for k, (s, e) in enumerate(stages):
                q, ph = k % p, (k // p) & 1
                if k == k0:
                    snaps[("v", g)] = s
                yield from wait(bars["xfull"][q], ph)
                if k >= p and "wempty" not in faults:
                    yield from wait(bars["wempty"][q], ph ^ 1)
                o = copy_plan(x8, n_row, seg_per_row, lseg, warm, s_count,
                              g, s, e, zero_warm)["o"]
                assert o + (e - s) < xs, "the prefetch reads past the slot"
                for i in range(s, e):
                    tok = xring[q][lane][o + i - s]
                    assert tok is not None, f"step {i} read an empty slot"
                    tok_w = wring[q][i - s][lane]
                    assert tok_w is None, "the walker overwrote a w step " \
                        "the oscillator has not read"
                    reads[(g, i)] = tok
                    wring[q][i - s][lane] = ("w", g, i)
                # the slot goes back to the copier: poison what was read
                for j in range(xs):
                    xring[q][lane][j] = None
                bars["xempty"][q].arrive()
                bars["wfull"][q].arrive()
                yield "step"

        def oscillator(lane, b=b, bars=bars, wring=wring, oring=oring):
            g = b * g_blk + lane
            valid = g < s_count
            groups = []                       # this lane's bulk groups
            for k, (s, e) in enumerate(stages):
                q, ph = k % p, (k // p) & 1
                if k == k0:
                    snaps[("m", g)] = s
                m = k - k0
                is_out = k >= k0 and valid
                if is_out and m >= 2 and "read" not in faults:
                    # bulk_wait_read<1>: all but the newest group read
                    while not all(gr["read"] for gr in groups[:-1]):
                        yield "blocked"
                yield from wait(bars["wfull"][q], ph)
                stage = oring[m & 1]
                for i in range(s, e):
                    tok = wring[q][i - s][lane]
                    assert tok is not None
                    wreads[(g, i)] = tok
                    if is_out:
                        for a in range(3):
                            stage[a][lane][i - s] = ("o", g, i)
                    wring[q][i - s][lane] = None
                bars["wempty"][q].arrive()
                if is_out:
                    n = e - s
                    base = g * lseg + m * t
                    if aligned:
                        assert (base % 4, (n * 4) % 16) == (0, 0)
                        grp = {"read": False}
                        groups.append(grp)

                        def read(stage=stage, lane=lane, g=g, m=m, n=n,
                                 grp=grp):
                            for a in range(3):
                                for j in range(n):
                                    tok = stage[a][lane][j]
                                    assert tok == ("o", g, warm + m * t + j), \
                                        "a store read an overwritten stage"
                                    out[a][g][m * t + j] = tok
                            grp["read"] = True
                        pending.append(read)
                    else:
                        for a in range(3):
                            for j in range(n):
                                out[a][g][m * t + j] = stage[a][lane][j]
                yield "step"
            while not all(gr["read"] for gr in groups):
                yield "blocked"

        for lane in range(g_blk):
            actors += [copier(lane), walker(lane), oscillator(lane)]

    live = list(actors)
    idle = 0
    while live or pending:
        pick = rng.randrange(len(live) + len(pending))
        if pick >= len(live):
            pending.pop(pick - len(live))()
            idle = 0
            continue
        actor = live[pick]
        try:
            what = next(actor)
        except StopIteration:
            live.remove(actor)
            idle = 0
            continue
        idle = idle + 1 if what == "blocked" else 0
        if idle > 20 * len(live) and not pending:
            # perhaps every live actor is blocked: give each one more try
            moved = False
            for a in list(live):
                try:
                    moved |= next(a) != "blocked"
                except StopIteration:
                    live.remove(a)
                    moved = True
            if not moved:
                raise Stuck("no actor can move")
            idle = 0
    return reads, wreads, out, snaps


def want_sample(g, i, rows, seg_per_row, lseg, warm, zero_warm):
    """The token step i of lane g must read: its sample, where there is
    none zeros or (zero_warm False) segment 0's own row's sample i, and
    for a lane past the last segment zeros or the last segment's."""
    s_count, n_row = rows * seg_per_row, seg_per_row * lseg
    if g >= s_count:
        if zero_warm:
            return "Z"
        g = s_count - 1
    row, sr = divmod(g, seg_per_row)
    q = sr * lseg - warm + i
    if q >= 0:
        return row * n_row + q
    return "Z" if zero_warm else row * n_row + i


def check_tokens(rows, seg_per_row, lseg, warm, reads, wreads, out, snaps,
                 zero_warm=False):
    s_count = rows * seg_per_row
    for g in range(s_count):
        for i in range(warm + lseg):
            assert reads[(g, i)] == want_sample(g, i, rows, seg_per_row,
                                                lseg, warm, zero_warm)
            assert wreads[(g, i)] == ("w", g, i)
        for a in range(3):
            assert out[a][g] == [("o", g, warm + j) for j in range(lseg)]
        assert snaps[("v", g)] == snaps[("m", g)] == warm


def mirror_values(x, init, consts, lseg, warm, reads, out):
    """The kernel's arithmetic on the inputs the protocol handed out,
    over all segments at once in the twin's operation order: every
    segment updates through its warm-up and segment 0 of each row is put
    back to its carry at step W (the kernel's restore); outputs placed
    where the stores put them."""
    alpha, beta, fmin, fmax, multf = consts
    rows, n = x.shape
    s = n // lseg
    flat = x.reshape(-1)
    width = rows * s
    xin = torch.zeros(warm + lseg, width, dtype=torch.complex64)
    for (g, i), tok in reads.items():
        if g < width and tok != "Z":
            xin[i, g] = flat[tok]
    xr_all, xi_all = xin.real.contiguous(), xin.imag.contiguous()
    vr, vi, mr, mi, fr = init.unbind(0)
    is0 = torch.arange(width) % s == 0
    steps = []
    for i in range(warm + lseg):
        if i == warm:
            vr, vi, mr, mi, fr = (torch.where(is0, c, v) for c, v in
                                  zip(init.unbind(0), (vr, vi, mr, mi, fr)))
            snap = torch.stack([vr, vi, mr, mi, fr])
        xr, xim = xr_all[i], xi_all[i]
        pr = xr * vr + xim * vi
        pi_ = xim * vr - xr * vi
        err = torch.atan2(pi_, pr)
        f2 = fr + beta * err
        dl = f2 + alpha * err
        dm = multf * f2 + alpha * err
        sl, cl = torch.sin(dl), torch.cos(dl)
        sm, cm = torch.sin(dm), torch.cos(dm)
        vr2 = vr * cl - vi * sl
        vi2 = vr * sl + vi * cl
        mr2 = mr * cm - mi * sm
        mi2 = mr * sm + mi * cm
        gv = 1.5 - 0.5 * (vr2 * vr2 + vi2 * vi2)
        gm = 1.5 - 0.5 * (mr2 * mr2 + mi2 * mi2)
        steps.append((mr, mi, err))
        vr, vi, mr, mi, fr = (vr2 * gv, vi2 * gv, mr2 * gm, mi2 * gm,
                              torch.clamp(f2, fmin, fmax))
    o = [torch.empty(width, lseg) for _ in range(3)]
    for a in range(3):
        for g in range(width):
            for j, tok in enumerate(out[a][g]):
                o[a][g, j] = steps[tok[2]][a][g]
    return (*o, snap, torch.stack([vr, vi, mr, mi, fr]))


def bank(rows, n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    x = np.exp(1j * (0.3 * t[None] + rng.uniform(0, 6, (rows, 1)))) \
        + 0.3 * (rng.standard_normal((rows, n))
                 + 1j * rng.standard_normal((rows, n)))
    return torch.from_numpy(x.astype(np.complex64))


def init_states(x, seg_per_row, lseg, warm, seed):
    rows = x.shape[0]
    rng = np.random.default_rng(seed)
    st_ = (torch.from_numpy(rng.uniform(-3, 3, rows).astype(np.float32)),
           torch.from_numpy(rng.uniform(-3, 3, rows).astype(np.float32)),
           torch.from_numpy(rng.uniform(-0.3, 0.3, rows).astype(np.float32)))
    return pll_overlap._initial_states(x, st_, seg_per_row, lseg, warm)


# -- the stage and copy formulas ------------------------------------------

@settings(max_examples=200, deadline=None)
@given(st.integers(1, 90), st.data(), st.sampled_from([4, 8, 12, 16, 32]))
def test_stages_split_the_walk_at_w(lseg, data, t):
    """Stages partition [0, W+L) in order, none longer than T, step W
    starts stage k0 = ceil(W / T), and output stage m covers outputs
    [m T, min(L, m T + T))."""
    warm = data.draw(st.integers(0, lseg))
    k0, stages = ring_stages(warm, lseg, t)
    assert k0 == -(-warm // t)
    assert stages[0][0] == 0 and stages[-1][1] == warm + lseg
    assert all(a[1] == b[0] for a, b in zip(stages, stages[1:]))
    assert all(0 < e - s <= t for s, e in stages)
    assert (stages[k0][0] if k0 < len(stages) else None) == warm
    for m, (s, e) in enumerate(stages[k0:]):
        assert (s - warm, e - warm) == (m * t, min(lseg, m * t + t))


@settings(max_examples=200, deadline=None)
@given(st.integers(1, 4), st.integers(1, 5), st.integers(1, 70),
       st.data(), st.sampled_from([4, 8, 16]), st.integers(0, 1),
       st.booleans())
def test_copy_plan_fills_each_step_once(rows, seg_per_row, lseg, data, t,
                                        x8, zero_warm):
    """Each step of each stage of each segment (and of a lane past the
    last) is written exactly once, with its sample or, where there is
    none, zeros (zero_warm) or a sample that exists (segment 0's warm-up:
    its row's first W; a lane past the last segment: the last segment's);
    the bulk copy is an even count from an even address into an even
    slot position, and every position stays inside the T + 2 slot."""
    warm = data.draw(st.integers(0, lseg))
    s_count, n_row = rows * seg_per_row, seg_per_row * lseg
    _, stages = ring_stages(warm, lseg, t)
    for g in range(s_count + 2):
        for s, e in stages:
            plan = copy_plan(x8, n_row, seg_per_row, lseg, warm, s_count,
                             g, s, e, zero_warm)
            o = plan["o"]
            got = {i: "Z" for i in plan["zeros"]}
            for i, a in plan["plain"]:
                assert i not in got
                got[i] = a
            if plan["bulk"]:
                i0, a0, cnt = plan["bulk"]
                assert cnt > 0 and cnt % 2 == 0 and (x8 + a0) % 2 == 0
                assert (o + i0 - s) % 2 == 0
                for j in range(cnt):
                    assert i0 + j not in got
                    got[i0 + j] = a0 + j
            assert sorted(got) == list(range(s, e))
            assert 0 <= o and o + (e - s) <= t + 1
            # the parity of the stage's first sample's address: with zeros
            # the would-be sample's, else the sample walked
            row, sr = divmod(g, seg_per_row)
            first = row * n_row + sr * lseg - warm + s if zero_warm else \
                want_sample(g, s, rows, seg_per_row, lseg, warm, False)
            assert o == (x8 + first) % 2
            for i, tok in got.items():
                assert tok == want_sample(g, i, rows, seg_per_row, lseg,
                                          warm, zero_warm)


# -- the protocol -----------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.integers(1, 2), st.integers(2, 4), st.integers(1, 24), st.data(),
       st.sampled_from([4, 8]), st.integers(1, 4), st.integers(1, 5),
       st.integers(0, 1), st.integers(0, 2 ** 32 - 1), st.booleans())
def test_ring_protocol_holds_in_any_order(rows, seg_per_row, lseg, data, t,
                                          p, g_blk, x8, seed, zero_warm):
    """The copy -> walker -> oscillator -> store hand-offs over P stages
    in any order of the lanes and of the asynchronous completions: no
    wait is left unmet, no phase takes an extra arrival, each walker step
    reads its own sample (zeros in segment 0's warm-up), each oscillator
    step its own walker step, each output lands at its place from an
    output stage not yet overwritten, and both snapshots fall at step
    W; with L a multiple of 4 through bulk stores, else plain ones;
    steps with no sample walk zeros or existing samples (zero_warm)."""
    warm = data.draw(st.integers(0, lseg))
    aligned = lseg % 4 == 0
    got = simulate(rows, seg_per_row, lseg, warm, g_blk, t, p, x8, aligned,
                   random.Random(seed), zero_warm=zero_warm)
    check_tokens(rows, seg_per_row, lseg, warm, *got, zero_warm=zero_warm)


@pytest.mark.parametrize("fault", ["xempty", "wempty", "read"])
def test_ring_protocol_catches_a_dropped_wait(fault):
    """The mirror fails when a wait is dropped (a bug it must catch): a
    slot or stage overwritten before it was read shows in some order of
    the lanes and completions."""
    caught = 0
    for seed in range(30):
        try:
            got = simulate(1, 3, 24, 5, 2, 4, 1, 0, True, random.Random(seed),
                           faults={fault})
            check_tokens(1, 3, 24, 5, *got)
        except (AssertionError, Stuck):
            caught += 1
    assert caught > 0


@pytest.mark.parametrize("zero_warm", [True, False])
@pytest.mark.parametrize("rows,seg_per_row,lseg,warm,t,p,g_blk,x8", [
    (1, 4, 24, 9, 8, 2, 4, 0),        # W, L no multiple of T
    (2, 3, 16, 0, 8, 3, 4, 1),        # W = 0, a part-full last block
    (1, 2, 20, 20, 8, 2, 2, 1),       # W = L
    (3, 2, 13, 5, 4, 4, 3, 0),        # L no multiple of 4: plain stores
    (1, 5, 32, 11, 16, 2, 8, 1),      # one block, lanes past the last
])
def test_mirror_equals_the_plain_scan(rows, seg_per_row, lseg, warm, t, p,
                                      g_blk, x8, zero_warm):
    """The protocol's hand-offs evaluated as the kernel evaluates them
    (segment 0 updates through its warm-up, on zeros or on its row's
    first samples, then its carry is put back at step W) equal
    _scan_reference bit for bit: outputs, the snapshot at step W and the
    exit state."""
    n = seg_per_row * lseg
    x = bank(rows, n, seed=lseg + warm)
    init = init_states(x, seg_per_row, lseg, warm, seed=rows)
    reads, wreads, out, snaps = simulate(
        rows, seg_per_row, lseg, warm, g_blk, t, p, x8, lseg % 4 == 0,
        random.Random(rows * 7 + t), zero_warm=zero_warm)
    check_tokens(rows, seg_per_row, lseg, warm, reads, wreads, out, snaps,
                 zero_warm)
    got = mirror_values(x, init, CONSTS, lseg, warm, reads, out)
    exp = pll_overlap._scan_reference(x, init, CONSTS, lseg, warm)
    assert exp[0].shape == (rows * seg_per_row, lseg)
    for a, b in zip(got, exp):
        assert torch.equal(a, b)


# -- the layout ---------------------------------------------------------------

def test_run_reads_segment_rows():
    """_run takes a scan's outputs as [C*S, L], segment g = c S + s in row
    g, and gives [C, N] with out[c, s L + t] = row (c S + s) at t, times
    the segment's chaining factor (1 for segment 0; the scan here leaves
    every state at (1, 0), so every factor is 1)."""
    rows, s, lseg, warm = 2, 3, 8, 4
    n = s * lseg
    x = torch.ones(rows, n, dtype=torch.complex64)
    ramp = torch.arange(rows * s * lseg, dtype=torch.float32).reshape(
        rows * s, lseg)

    def scan(xb, init, consts, lseg_, warm_):
        one = torch.zeros(5, rows * s)
        one[0] = one[2] = 1.0
        return ramp, -ramp, ramp + 0.5, one.clone(), one.clone()
    valid, _, out, err = pll_overlap._run(scan, x, (0.0, 0.0, 0.1), *CONSTS,
                                          lseg, warm, 0.02, 0.005)
    assert valid.tolist() == [True, True]
    assert torch.equal(out.real, ramp.reshape(rows, n))
    assert torch.equal(out.imag, -ramp.reshape(rows, n))
    assert torch.equal(err, (ramp + 0.5).reshape(rows, n))


@pytest.mark.parametrize("mult", [1.0, 2.0])
def test_bank_matches_jax_row_by_row(mult):
    """pll_overlap_discard on a [2, N] bank on the CPU (the [C*S, L]
    layout reshaped to [C, N]) against the JAX pll_overlap_discard on
    each row: equal valid flags; where valid, outputs within 2e-2, err
    within 2e-2 (modulo 2 pi) and the frequency within 1e-4, as
    tests/test_torch_pll.py holds one row."""
    alpha, beta = np.float32(0.0266), np.float32(0.000357)
    fmin, fmax = np.float32(2 * np.pi * 0.19), np.float32(2 * np.pi * 0.23)
    n = 1 << 13
    rng = np.random.default_rng(31)
    t = np.arange(n)
    noise = rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
    x = np.stack([np.exp(1j * (2 * np.pi * 0.21 * t + 0.5)) + 0.3 * noise[0],
                  noise[1]]).astype(np.complex64)
    plan = plan_overlap(n, float(alpha))
    assert plan is not None
    st_ = (np.float32(0.3), np.float32(0.1), np.float32((fmin + fmax) / 2))
    tok, tst, tout, terr = pll_overlap_discard(
        torch.from_numpy(x), st_, alpha, beta, fmin, fmax, mult, *plan)
    for c in range(2):
        jok, jst, jout, jerr = jax_overlap(jnp.asarray(x[c]), st_, alpha,
                                           beta, fmin, fmax, mult, *plan)
        assert bool(tok[c]) == bool(jok) == (c == 0)
        if c == 0:
            assert np.max(np.abs(tout[c].numpy() - np.asarray(jout))) < 2e-2
            d = terr[c].numpy() - np.asarray(jerr)
            d = np.abs((d + np.pi) % (2 * np.pi) - np.pi)
            assert np.max(d) < 2e-2
            assert abs(float(tst[2][c]) - float(jst[2])) < 1e-4


def test_shipped_ring_fits_and_is_swept():
    """The shipped constants (kG, kT, kP, kStore, kZeroWarm) are a point
    of the measurement build's sweep, T is a multiple of the oscillator's
    unroll and of 4, and the ring's shared memory (barriers, the x slots
    of T + 2 float2s, the [T][G] w ring, two output stages of rows of T +
    4 floats) fits in the 227 KB a block may use."""
    src = open(SRC).read()
    shipped = re.search(
        r"constexpr int kG = (\d+), kT = (\d+), kP = (\d+), kStore = (\d+),"
        r" kZeroWarm = (\d+);", src).groups()
    points = re.findall(r"X\((\d+), (\d+), (\d+), (\d+), (\d+)\)",
                        src.split("#define LR_SCAN_POINTS(X)")[1].split(
                            "int lr_scan_sweep_count")[0])
    assert shipped in points
    for gg, tt, pp, ss, _ in ((int(v) for v in pt) for pt in points):
        assert tt % 4 == 0 and 1 <= gg <= 32 and pp >= 1
        smem = 128 + pp * gg * (tt + 2) * 8 + pp * tt * gg * 8 + (
            2 * 3 * gg * (tt + 4) * 4 if ss == 0 else 0)
        assert smem <= 232448
    assert "kOutStages = 2" in src and "kU = 4" in src


def test_scan_kernel_layout_is_segment_rows():
    """_scan_kernel allocates the [C*S, L] outputs it hands _run (the CPU
    cannot launch it: the source of the allocation is checked), and the
    twin returns the same layout."""
    import inspect
    body = inspect.getsource(pll_overlap._scan_kernel)
    assert "torch.empty(width, lseg" in body
    x = bank(2, 4 * 16, seed=3)
    init = init_states(x, 4, 16, 5, seed=4)
    got = pll_overlap._scan_reference(x, init, CONSTS, 16, 5)
    assert [tuple(v.shape) for v in got] == [(8, 16)] * 3 + [(5, 8)] * 2
    assert all(v.is_contiguous() for v in got)
