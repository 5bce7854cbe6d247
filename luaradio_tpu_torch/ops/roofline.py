"""The roofline probes: an HBM copy through shared memory (serial and
prefetched) and an in-kernel atan2, written by hand in CUDA
(csrc/roofline.cu), each with its plain PyTorch twin in this module.

* :func:`hbm_copy` — x float32 [C, 2T] contiguous -> an identical copy.
  Both copies are persistent CTAs over a ring of shared-memory stages,
  one thread claiming slabs from a counter and loading them by TMA bulk
  copies, another storing them (:data:`R1`, :data:`R2` hold their
  constants).
  ``double_buffered=False`` launches R1 (:func:`hbm_copy_serial`), which
  issues a CTA's next load only once its last one has landed;
  ``True`` launches R2 (:func:`hbm_copy_double_buffered`), which keeps
  ``stages - 1`` loads in flight ahead of its stores.  Replace the two
  bodies of ``measure_hbm_copy`` in the JAX system's bench_roofline.py
  (:59; kern :93 and :72).
* :func:`atan2_halves` (R3) — x float32 [C, 2T] -> out float32 [C, T]
  with, for each column tile j of ``tile`` columns and h = tile / 2,
  ``out[:, j h:(j + 1) h] = atan2(x[:, j tile:j tile + h],
  x[:, j tile + h:(j + 1) tile])``.  ``tile`` is part of the function.
  Replaces ``measure_vpu_atan2`` (bench_roofline.py:144, kern :155).

A wrapper launches the CUDA kernel for CUDA tensors and takes the twin only
for tensors on the CPU; anything else raises.  ``<wrapper>.launches``
counts kernel launches (:func:`hbm_copy_serial`,
:func:`hbm_copy_double_buffered`, :func:`atan2_halves`).
:func:`ring_trace` runs R2 once with its timestamps recorded and
:func:`ring_overlap` reads from them how much of the ring's load time a
store overlaps.

The copies' launch plan and ring protocol are mirrored here for the CPU
tests: :func:`copy_plan` (grid, each slab's bytes, the slabs dealt per
CTA, the tail), :func:`stage_use` (a slab's stage and
the mbarrier parities its waits take) and :func:`simulate_ring` (every
CTA's loader and storer against models of the mbarriers, the slab counter
and the bulk groups, the asynchronous completions in a random order);
:func:`edge_shapes` gives the shapes that reach the schedule's edges.
"""

from __future__ import annotations

import ctypes
import dataclasses
import random

import numpy as np
import torch

from luaradio_tpu_torch.ops import cudabuild

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@dataclasses.dataclass(frozen=True)
class Ring:
    """A copy kernel's constants (csrc/roofline.cu kR1* and kR2*)."""

    stage_bytes: int
    stages: int
    #: loads a CTA keeps in flight at most (P)
    ahead: int
    ctas_per_sm: int
    evict_first: bool
    #: slabs past a CTA's first claimed from a counter (as the ring can
    #: take them), else dealt round robin
    dynamic: bool

    @property
    def lag(self) -> int:
        """Stores a CTA leaves reading before it hands the oldest stage
        back (kLag)."""
        return self.stages - self.ahead - 1


#: the shipped constants, the winners of scratch/roofline_ab.py's sweep
R1 = Ring(32 * 1024, 3, 1, 2, True, True)
R2 = Ring(16 * 1024, 4, 3, 1, True, True)
#: SMs of an H100 SXM, the mirror's default
SMS = 132


def _lib():
    lib = cudabuild.load("roofline")
    if not lib.lr_hbm_copy.argtypes:
        lib.lr_hbm_copy.argtypes = [_VP, _VP, _LL, _I, _VP, _I, _VP, _VP]
        lib.lr_hbm_copy.restype = ctypes.c_int
        lib.lr_hbm_copy_ring_ctas.argtypes = []
        lib.lr_hbm_copy_ring_ctas.restype = ctypes.c_int
        lib.lr_capture_id.argtypes = [_VP]
        lib.lr_capture_id.restype = ctypes.c_ulonglong
        lib.lr_atan2_halves.argtypes = [_VP, _VP, _LL, _LL, _LL, _VP]
        lib.lr_atan2_halves.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, what: str):
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"{what}: want float32 [C, 2T], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: the input must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{what}: the bulk copies need a 16-byte aligned "
                         f"start (the tensor begins at an offset)")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# -- plain PyTorch twins ------------------------------------------------------

def hbm_copy_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`hbm_copy`."""
    return torch.empty_like(x).copy_(x)


def atan2_halves_reference(x: torch.Tensor, tile: int = 1 << 15
                           ) -> torch.Tensor:
    """Plain twin of :func:`atan2_halves`: a view [C, 2T/tile, 2,
    tile/2] and torch.atan2 of its two halves, as [C, T]."""
    c, w = x.shape
    v = x.reshape(c, w // tile, 2, tile // 2)
    return torch.atan2(v[:, :, 0], v[:, :, 1]).reshape(c, w // 2)


# -- kernel wrappers ----------------------------------------------------------

#: the rings' two slab counters, by (device, stream, capture id)
_counters: dict[tuple[int, int, int], torch.Tensor] = {}


def _copy(x: torch.Tensor, double_buffered: bool, trace=None):
    """Launch R1 or R2.  The slab counters are kept for the current stream
    (and the graph capture it is in, if any): every launch leaves them at
    zero (its last CTA resets them), launches on one stream or in one
    graph run one after another, and a new pair is zeroed by its first
    launch (a memset on the stream)."""
    out = torch.empty_like(x)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = _stream(x.device)
        key = (x.device.index, stream, int(lib.lr_capture_id(stream)))
        counters = _counters.get(key)
        new = counters is None
        if new:
            counters = _counters[key] = torch.empty(2, dtype=torch.int64,
                                                    device=x.device)
        code = lib.lr_hbm_copy(x.data_ptr(), out.data_ptr(),
                               x.numel() * 4, int(double_buffered),
                               counters.data_ptr(), int(new),
                               None if trace is None else trace.data_ptr(),
                               stream)
    if code != 0 and new:
        del _counters[key]
    cudabuild.check(lib, code, "hbm_copy")
    return out


def hbm_copy_serial(x: torch.Tensor) -> torch.Tensor:
    """R1: x float32 [C, 2T] contiguous -> a copy by persistent CTAs over
    a ring (:data:`R1`), each issuing its next bulk load only once its
    last one has landed, its stores of earlier slabs still in flight."""
    _check(x, "hbm_copy")
    if x.device.type == "cpu":
        return hbm_copy_reference(x)
    out = _copy(x, False)
    hbm_copy_serial.launches += 1
    return out


def hbm_copy_double_buffered(x: torch.Tensor) -> torch.Tensor:
    """R2: the same copy by persistent CTAs over a ring (:data:`R2`)
    that keeps ``stages - 1`` bulk loads in flight ahead of its
    stores."""
    _check(x, "hbm_copy")
    if x.device.type == "cpu":
        return hbm_copy_reference(x)
    out = _copy(x, True)
    hbm_copy_double_buffered.launches += 1
    return out


def hbm_copy(x: torch.Tensor, double_buffered: bool = False) -> torch.Tensor:
    """x float32 [C, 2T] contiguous -> an identical copy, by R2 when
    ``double_buffered`` else by R1."""
    return (hbm_copy_double_buffered if double_buffered
            else hbm_copy_serial)(x)


def atan2_halves(x: torch.Tensor, tile: int = 1 << 15) -> torch.Tensor:
    """R3: x float32 [C, 2T] -> float32 [C, T], atan2 of the first half
    of each ``tile``-column tile over its second half.  ``tile`` must be
    even and divide 2T."""
    _check(x, "atan2_halves")
    tile = int(tile)
    w = x.shape[1]
    if tile < 2 or tile % 2 or w % tile:
        raise ValueError(f"atan2_halves: tile {tile} must be even and "
                         f"divide the {w} columns")
    if x.device.type == "cpu":
        return atan2_halves_reference(x, tile)
    c, t = x.shape[0], w // 2
    out = torch.empty((c, t), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.lr_atan2_halves(x.data_ptr(), out.data_ptr(), c, t, tile,
                                   _stream(x.device))
    cudabuild.check(lib, code, "atan2_halves")
    atan2_halves.launches += 1
    return out


hbm_copy_serial.launches = 0
hbm_copy_double_buffered.launches = 0
atan2_halves.launches = 0


# -- the ring's overlap -------------------------------------------------------

def ring_ctas() -> int:
    """R2's grid on this card: the persistent CTAs it holds at once."""
    n = int(_lib().lr_hbm_copy_ring_ctas())
    if n < 1:
        raise RuntimeError("hbm_copy: the occupancy query failed")
    return n


def ring_trace(x: torch.Tensor) -> np.ndarray:
    """Run R2 once on the card with its trace on: [slabs, 5] int64 a slab
    of R2's stage: nanoseconds (%globaltimer) at the load's
    issue, its landing (as the storer saw it), the store's issue and the
    time the storer saw it had read shared memory (0 for a slab of no
    bulk bytes), and the CTA that copied it.  A measurement probe: it
    counts no launch and its copy is checked, not returned."""
    _check(x, "hbm_copy")
    if x.device.type != "cuda":
        raise ValueError("ring_trace: the trace is the card's")
    slabs = n_slabs(x.numel() * 4, R2.stage_bytes)
    trace = torch.zeros((slabs, 5), dtype=torch.int64, device=x.device)
    out = _copy(x, True, trace)
    if not torch.equal(out, x):
        raise AssertionError("hbm_copy: the traced ring's copy differs")
    return trace.cpu().numpy()


def _union(spans) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def ring_overlap(trace: np.ndarray, ctas: int) -> dict:
    """From :func:`ring_trace` (slab s on CTA s mod ``ctas``): for each
    slab's load in flight [issue, landed] but a CTA's first, the time
    during which at least one store of the same CTA was in flight [issue,
    read]; the share of all that load time.  A load counts where the
    slab before it on its CTA has a recorded store.  With two stages only
    the store of the slab before can overlap a load, so this is the
    overlap of each load with that store."""
    t = np.asarray(trace, np.int64)
    load_ns = overlap_ns = pairs = 0
    for cta in range(min(ctas, len(t))):
        if t.shape[1] > 4:                     # the CTA is recorded
            rows = t[t[:, 4] == cta]
            rows = rows[np.argsort(rows[:, 0], kind="stable")]
        else:
            rows = t[cta::ctas]
        stores = _union((int(si), int(sr)) for si, sr in rows[:, 2:4]
                        if sr > 0)
        for j in range(1, len(rows)):
            if rows[j - 1, 3] <= 0:
                continue
            li, ll = int(rows[j, 0]), int(rows[j, 1])
            load_ns += ll - li
            overlap_ns += sum(max(0, min(ll, b) - max(li, a))
                              for a, b in stores)
            pairs += 1
    return {"load_ns": int(load_ns), "overlap_ns": int(overlap_ns),
            "overlap_share": overlap_ns / load_ns if load_ns else 0.0,
            "slab_pairs": int(pairs)}


# -- the copies' launch plan and ring protocol, mirrored ---------------------

def n_slabs(nbytes: int, stage_bytes: int) -> int:
    """Slabs of an array of ``nbytes`` (the last may be partial)."""
    return -(-nbytes // stage_bytes)


def slab_bytes(s: int, nbytes: int, stage_bytes: int) -> int:
    """Bytes of slab ``s`` the bulk copies move: the slab's bytes cut
    down to a multiple of 16 (csrc/roofline.cu slab_bytes)."""
    return min(stage_bytes, nbytes - s * stage_bytes) & ~15


def tail(nbytes: int) -> range:
    """The bytes past the last multiple of 16, which the storer of CTA 0
    copies by plain loads and stores (copy_tail)."""
    return range(nbytes & ~15, nbytes)


def copy_plan(nbytes: int, ring: Ring, sms: int = SMS) -> dict:
    """The launch of a copy of ``nbytes``: the grid (``ctas_per_sm`` CTAs
    an SM, no more than the slabs), the slabs each CTA walks when they are
    dealt round robin (s = cta + j grid; a dynamic ring claims them
    instead, :func:`simulate_ring`), each slab's bulk bytes and the
    tail."""
    n = n_slabs(nbytes, ring.stage_bytes)
    grid = min(n, ring.ctas_per_sm * sms)
    return {"grid": grid, "n_slabs": n,
            "slabs": [list(range(c, n, grid)) for c in range(grid)],
            "bytes": [slab_bytes(s, nbytes, ring.stage_bytes)
                      for s in range(n)],
            "tail": tail(nbytes)}


def stage_use(j: int, stages: int) -> tuple[int, int, int | None]:
    """A CTA's j-th slab: (its stage, the parity of the stage's "full"
    phase the storer waits on, the parity of the "empty" phase the loader
    waits on before reusing the stage, or None on its first use):
    ``(j % N, (j / N) & 1, (j / N - 1) & 1)`` as in the kernel."""
    u = j // stages
    return j % stages, u & 1, (u - 1) & 1 if u else None


class _Barrier:
    """An mbarrier of arrival count 1: a phase completes when its arrival
    is in and its expected transaction bytes have landed; try_wait.parity
    p passes once the phase of parity p has completed (the current
    phase's parity is not p)."""

    def __init__(self):
        self.phase, self.pending, self.tx = 0, 1, 0

    def arrive(self, tx: int = 0):
        self.tx += tx
        self.pending -= 1
        self._step()

    def complete_tx(self, n: int):
        self.tx -= n
        self._step()

    def _step(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = 1

    def passes(self, parity: int) -> bool:
        return (self.phase & 1) != parity


class _Cta:
    """One CTA of the ring: its barriers, the slab each stage holds
    (slab_of, -1 for the loader's end), the loader's and the storer's
    place, the loads in flight and the storer's bulk groups."""

    def __init__(self, ring: Ring, first: int):
        self.full = [_Barrier() for _ in range(ring.stages)]
        self.empty = [_Barrier() for _ in range(ring.stages)]
        self.slab_of = [None] * ring.stages
        self.next, self.lj, self.sj = first, 0, 0
        self.loading, self.storing, self.waits_read = True, True, False
        self.loads: list[tuple[int, int, int]] = []   # (j, stage, bytes)
        self.groups: list[list] = []                   # [j, slab, read]


def simulate_ring(nbytes: int, ring: Ring, sms: int = SMS,
                  seed: int = 0) -> list[tuple]:
    """A launch of the copy kernel on a card of ``sms`` SMs (its grid and
    slabs as :func:`copy_plan`), event by event.  Each
    CTA's loader and storer run csrc/roofline.cu's loops against models of
    the mbarriers, the stage's slab beside it and the bulk groups; a
    dynamic ring's loaders, after the CTA's own first slab, claim grid +
    the counter's next value as the ring can take the slab, as the kernel
    does; loads land and
    stores finish reading in an order drawn from ``seed``, and each step
    takes one of the actions that can run, in any CTA.  Returns the
    events in order, each (cta, kind, j, slab, stage, phase): "load"
    (issued; the phase of the stage's "empty" barrier the loader's wait
    saw), "land", "acquire" (the storer's wait on "full" passed; the
    phase it saw), "store" (issued), "read" (the store's group read
    shared memory), "handback" (the storer arrived on "empty"; the phase
    before), "end" (the loader found no slab left), "reset" (a dynamic
    ring's last CTA to finish put the counter, whose value stands in the
    slab's place, back to zero).  Raises where no action can run before
    every CTA is done."""
    plan = copy_plan(nbytes, ring, sms)
    n, grid, lag, ns = plan["n_slabs"], plan["grid"], ring.lag, ring.stages
    bulk = plan["bytes"]
    rng = random.Random(seed)
    counter = 0

    def claim(s):
        nonlocal counter
        if not ring.dynamic:
            return s + grid
        counter += 1
        return grid + counter - 1

    ctas = [_Cta(ring, c) for c in range(grid)]     # first slab: the CTA's
    done = 0
    events: list[tuple] = []

    def loader_ready(k: _Cta):
        if not k.loading:
            return False
        st, _, ep = stage_use(k.lj, ns)
        if ep is not None and not k.empty[st].passes(ep):
            return False
        if k.lj >= ring.ahead:
            ist, fp, _ = stage_use(k.lj - ring.ahead, ns)
            if not k.full[ist].passes(fp):
                return False
        return True

    def storer_ready(k: _Cta):
        if not k.storing:
            return False
        if k.waits_read:
            older = k.groups[:-lag] if lag else k.groups
            return all(g[2] for g in older)
        st, fp, _ = stage_use(k.sj, ns)
        return k.full[st].passes(fp)

    while True:
        acts = []
        for c, k in enumerate(ctas):
            if loader_ready(k):
                acts.append((c, "load"))
            if k.loads:
                acts.append((c, "land"))
            if storer_ready(k):
                acts.append((c, "storer"))
            if any(not g[2] for g in k.groups):
                acts.append((c, "read"))
        if not acts:
            break
        c, act = rng.choice(acts)
        k = ctas[c]
        if act == "load":
            st = k.lj % ns
            s = k.next = claim(k.next) if k.lj else k.next
            if s >= n:                               # no more: tell the storer
                k.slab_of[st] = -1
                events.append((c, "end", k.lj, -1, st, None))
                k.full[st].arrive(0)
                k.loading = False
                continue
            b = bulk[s]
            events.append((c, "load", k.lj, s, st, k.empty[st].phase))
            k.slab_of[st] = s
            k.full[st].arrive(b)
            if b:
                k.loads.append((k.lj, st, b))
            k.lj += 1
        elif act == "land":
            j, st, b = k.loads.pop(rng.randrange(len(k.loads)))
            events.append((c, "land", j, k.slab_of[st], st, None))
            k.full[st].complete_tx(b)
        elif act == "read":
            g = rng.choice([g for g in k.groups if not g[2]])
            g[2] = True
            if bulk[g[1]]:
                events.append((c, "read", g[0], g[1], g[0] % ns, None))
        elif not k.waits_read:
            st = k.sj % ns
            s = k.slab_of[st]
            if s < 0:                                # the loader's end
                k.storing = False
                done += 1
                if ring.dynamic and done == grid:    # the last resets
                    events.append((c, "reset", k.sj, counter, st, None))
                    counter = 0
                continue
            events.append((c, "acquire", k.sj, s, st, k.full[st].phase))
            has = bulk[s] > 0
            if has:
                events.append((c, "store", k.sj, s, st, None))
            k.groups.append([k.sj, s, not has])      # an empty group is read
            k.waits_read = True
        else:
            if k.sj >= lag:
                i = k.sj - lag
                st = i % ns
                events.append((c, "handback", i, k.slab_of[st], st,
                               k.empty[st].phase))
                k.empty[st].arrive()
            k.sj += 1
            k.waits_read = False
    for c, k in enumerate(ctas):
        if k.loading or k.storing or k.loads or \
                any(not g[2] for g in k.groups):
            raise RuntimeError(f"ring deadlocked: CTA {c}, loader at "
                               f"{k.lj}, storer at {k.sj}")
    return events


def edge_shapes(ring: Ring, grid: int) -> dict[str, tuple[int, int]]:
    """float32 [C, W] shapes that reach the edges of a copy's schedule on
    ``grid`` persistent CTAs: fewer slabs than CTAs, a slab count that is
    no multiple of the grid, a partial last slab, a byte count that is no
    multiple of 16 (with a last slab of 16 bulk bytes, and one of none),
    a single slab, and a tail alone."""
    f = ring.stage_bytes // 4                      # floats a stage
    return {"fewer slabs than CTAs": (2, max(1, grid // 4) * f),
            "slabs no multiple of the grid": (1, (3 * grid + 5) * f),
            "partial last slab": (1, (2 * grid + 1) * f + 260),
            "bytes no multiple of 16": (1, 7 * f + 6),
            "last slab under 16 bytes": (1, 5 * f + 2),
            "single slab": (1, f // 2),
            "tail alone": (1, 2)}


__all__ = ["hbm_copy", "hbm_copy_serial", "hbm_copy_double_buffered",
           "atan2_halves", "hbm_copy_reference", "atan2_halves_reference",
           "ring_trace", "ring_overlap", "ring_ctas", "Ring", "R1", "R2",
           "SMS", "n_slabs", "slab_bytes", "tail", "copy_plan", "stage_use",
           "simulate_ring", "edge_shapes"]
