"""The flagship kernel taken apart, S4: K1's function stopped after a
chosen stage, with a chosen precision for the deinterleave and for the
FIR's tap product, written by hand in CUDA (csrc/wbfm_proto.cu), with its
plain PyTorch twin in this module.

* :func:`wbfm_proto` (S4) — carry float32 [C, 2K], x float32 [C, 2T]
  interleaved I/Q, taps float32 [K], decimation D, ``inv_gain``, ``tile``,
  ``block`` and the three axes -> (new carry float32 [C, 2K], out float32
  [C, T/D]).  Replaces the Pallas TPU kernel of ``scratch/wbfm_proto.py``
  (``make_proto`` :172 -> ``_kernel`` :82, ``pallas_call`` :195).

For each tile i of ``tile`` complex samples, the window is
``[carry | x][:, 2 tile i : 2 tile i + 2 (K + tile)]`` and the output's
tile i holds tile/D values (``stage``):

* ``dma_only`` — the window's first tile/D floats (S8's gather);
* ``deint_only`` — re + im of the window's first tile/D samples;
* ``no_fir`` — the discriminator m = arg(w[q+1] conj(w[q])) inv_gain;
* ``full`` — the decimating FIR y[j] = sum_k h[k] m[j D + K-1 - k];
* ``no_deint`` — ``full`` with re/im the window's two halves.

The stage outputs depend on the tile, so ``tile`` is part of the function.
Precision follows the TPU's meaning of each mode (:data:`PRECISIONS`): a
product is a sum of terms whose operands are rounded to bf16 (one, two or
three terms), accumulated in fp32; ``highest`` is fp32 and ``default``
one bf16 pass of both operands (JAX on the CPU computes DEFAULT in fp32;
the port keeps the TPU's meaning).  The deinterleave of a selection
matrix rounds each float as its mode's product does.  ``two`` and
``two_hi`` split the TPU's frame into body and tail products of
``split22`` and ``highest`` terms: the same sum in another order.

The wrapper raises where ``make_proto`` raises (an unknown precision, a
tile that is no multiple of block * D for a FIR stage, taps too long for
the frame, a window whose samples are no multiple of 128 for the
selection product) and where the port's shapes do not hold (T a multiple
of tile, tile of D, tile >= K); an unknown stage raises too, where
``make_proto`` would run ``full``.  It launches the CUDA kernel for CUDA
tensors and takes the twin only for tensors on the CPU; anything else
raises.  ``wbfm_proto.launches`` counts kernel launches.  The bf16 FIR
modes run on the tensor cores (mma.sync along K1's Toeplitz band), fp32
on the CUDA cores.
"""

from __future__ import annotations

import ctypes
import dataclasses
import random

import numpy as np
import torch

from luaradio_tpu_torch.ops import cudabuild
from luaradio_tpu_torch.ops.fir import _conv_real
from luaradio_tpu_torch.ops.wbfm import discriminate

#: the precisions of split3_dot (scratch/wbfm_proto.py:36-79)
PRECISIONS = ("highest", "default", "sel3", "sel3cat", "sel2", "split22")
#: the FIR's precisions: those and the body + tail forms (:150-163)
FIR_PRECISIONS = PRECISIONS + ("two", "two_hi")
STAGES = ("dma_only", "no_deint", "deint_only", "no_fir", "full")

#: csrc/wbfm_proto.cu's codes of the stage, the deinterleave and the FIR
_STAGE = {"dma_only": 0, "deint_only": 1, "no_fir": 2, "full": 3,
          "no_deint": 3}
_DEINT = {"highest": 0, "default": 1, "sel3": 2, "sel3cat": 2, "sel2": 3,
          "split22": 3}
_HALVES = 4
_FIR = {"highest": 0, "two_hi": 0, "default": 1, "sel3": 2, "sel3cat": 2,
        "sel2": 3, "split22": 4, "two": 4}

_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def _lib():
    lib = cudabuild.load("wbfm_proto")
    if not lib.lr_wbfm_proto.argtypes:
        lib.lr_wbfm_proto.argtypes = [_VP, _VP, _VP, _LL, _LL, _I, _I, _F,
                                      _I, _I, _I, _I, _VP, _VP]
        lib.lr_wbfm_proto.restype = ctypes.c_int
    return lib


def _validate(c, t, k, d, tile, block, deint_prec, fir_prec, stage):
    """Raise ValueError where ``make_proto``'s kernel cannot run (or the
    port's shapes do not hold); the arguments are counts of complex
    samples and taps."""
    if stage not in STAGES:
        raise ValueError(f"wbfm_proto: stage {stage!r} is not one of "
                         f"{STAGES}")
    if min(k, d, block, tile) < 1 or t < 1:
        raise ValueError(f"wbfm_proto: K {k}, D {d}, block {block}, tile "
                         f"{tile} and T {t} must be positive")
    if t % tile or tile % d or tile < k:
        raise ValueError(f"wbfm_proto: T {t} must be a multiple of tile "
                         f"{tile}, tile a multiple of D {d} and at least "
                         f"K {k}")
    bb = block * d
    w = bb + max(k - d, 0)
    if fir_prec.startswith("two") and w > bb + 128:
        raise ValueError(f"wbfm_proto: fir_prec {fir_prec!r} pads the "
                         f"{w}-row tap matrix to block * D + 128 = "
                         f"{bb + 128} rows: the taps are too long")
    if stage in ("deint_only", "no_fir", "full"):
        if deint_prec not in PRECISIONS:
            raise ValueError(f"wbfm_proto: deint_prec {deint_prec!r} is not "
                             f"one of {PRECISIONS}")
        if (k + tile) % 128:
            raise ValueError(f"wbfm_proto: the selection product takes the "
                             f"window's K + tile = {k + tile} samples in "
                             f"rows of 128")
    if stage in ("no_deint", "full"):
        if fir_prec not in FIR_PRECISIONS:
            raise ValueError(f"wbfm_proto: fir_prec {fir_prec!r} is not one "
                             f"of {FIR_PRECISIONS}")
        if tile % bb:
            raise ValueError(f"wbfm_proto: tile {tile} must be a multiple of "
                             f"block * D = {bb}")
        if fir_prec.startswith("two"):
            if bb < 128 or 2 * bb < k - 1:
                raise ValueError(f"wbfm_proto: the body + tail FIR needs "
                                 f"block * D = {bb} >= 128 and >= (K-1)/2")
        elif k - 1 > bb:
            raise ValueError(f"wbfm_proto: taps too long for the frame "
                             f"window: K - 1 = {k - 1} > block * D = {bb}")


def _check(carry, x, taps, d, tile, block, deint_prec, fir_prec, stage):
    for name, v, dim in (("carry", carry, 2), ("x", x, 2), ("taps", taps, 1)):
        if v.dtype != torch.float32 or v.dim() != dim:
            raise ValueError(f"wbfm_proto: {name} must be float32 {dim}-D, "
                             f"got {v.dtype} {tuple(v.shape)}")
        if not v.is_contiguous():
            raise ValueError(f"wbfm_proto: {name} must be contiguous")
        if v.device != x.device:
            raise ValueError(f"wbfm_proto: {name} on {v.device}, x on "
                             f"{x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wbfm_proto: unsupported device {x.device}")
    k = taps.shape[0]
    c, w = x.shape
    if w % 2 or tuple(carry.shape) != (c, 2 * k):
        raise ValueError(f"wbfm_proto: want x [C, 2T] and carry [C, 2K], "
                         f"got {tuple(x.shape)} and {tuple(carry.shape)} "
                         f"for K = {k}")
    _validate(c, w // 2, k, d, tile, block, deint_prec, fir_prec, stage)


def _bf(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.bfloat16).to(torch.float32)


def round_deint(v: torch.Tensor, prec: str) -> torch.Tensor:
    """What the selection product of precision ``prec`` gives for each
    float: highest v, default bf(v), sel3/sel3cat the 3-term split summed
    back, sel2/split22 hi + bf(v - hi)."""
    if prec == "highest":
        return v
    hi = _bf(v)
    if prec == "default":
        return hi
    if prec in ("sel3", "sel3cat"):
        r1 = v - hi
        mid = _bf(r1)
        return (hi + mid) + _bf(r1 - mid)
    return hi + _bf(v - hi)


def fir_terms(m: torch.Tensor, h: torch.Tensor, prec: str):
    """[(m term, tap term)] whose products the FIR of precision ``prec``
    sums."""
    if prec in ("highest", "two_hi"):
        return [(m, h)]
    if prec == "default":
        return [(_bf(m), _bf(h))]
    hi = _bf(m)
    if prec in ("sel3", "sel3cat"):
        r1 = m - hi
        mid = _bf(r1)
        hb = _bf(h)
        return [(hi, hb), (mid, hb), (_bf(r1 - mid), hb)]
    lo = _bf(m - hi)
    h_hi = _bf(h)
    if prec == "sel2":
        return [(hi, h_hi), (lo, h_hi)]
    return [(hi, h_hi), (lo, h_hi), (hi, _bf(h - h_hi))]    # split22, two


def wbfm_proto_reference(carry, x, taps, d: int, inv_gain: float,
                         tile: int, block: int = 128,
                         deint_prec: str = "highest",
                         fir_prec: str = "highest", stage: str = "full"):
    """Plain twin of :func:`wbfm_proto` (no argument checks)."""
    k = taps.shape[0]
    c, w = x.shape
    t = w // 2
    nt, n, per = t // tile, k + tile, tile // d
    win = torch.cat([carry, x], 1).unfold(1, 2 * n, 2 * tile)  # [C, NT, 2n]
    new_carry = x[:, w - 2 * k:].clone()
    if stage == "dma_only":
        return new_carry, win[..., :per].reshape(c, t // d)
    if stage == "no_deint":
        re, im = win[..., :n], win[..., n:]
    else:
        re = round_deint(win[..., 0::2], deint_prec)
        im = round_deint(win[..., 1::2], deint_prec)
    if stage == "deint_only":
        return new_carry, (re[..., :per] + im[..., :per]).reshape(c, t // d)
    m = discriminate(re, im, torch.tensor(np.float32(inv_gain),
                                          device=x.device))
    if stage == "no_fir":
        return new_carry, m[..., :per].reshape(c, t // d)
    y = None
    for mt, ht in fir_terms(m, taps, fir_prec):
        part = _conv_real(mt.reshape(c * nt, n - 1), ht, d)
        y = part if y is None else y + part
    return new_carry, y.reshape(c, t // d)


def wbfm_proto(carry: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
               d: int, inv_gain: float, tile: int, block: int = 128,
               deint_prec: str = "highest", fir_prec: str = "highest",
               stage: str = "full"):
    """S4: carry float32 [C, 2K], x float32 [C, 2T] -> (new carry float32
    [C, 2K], out float32 [C, T/D]) of the stage, at the precisions."""
    d, tile, block = int(d), int(tile), int(block)
    _check(carry, x, taps, d, tile, block, deint_prec, fir_prec, stage)
    if x.device.type == "cpu":
        return wbfm_proto_reference(carry, x, taps, d, inv_gain, tile, block,
                                    deint_prec, fir_prec, stage)
    k = taps.shape[0]
    c, w = x.shape
    t = w // 2
    out = torch.empty((c, t // d), dtype=torch.float32, device=x.device)
    deint = _HALVES if stage == "no_deint" else _DEINT.get(deint_prec, 0)
    lib = _lib()
    with torch.cuda.device(x.device):
        code = lib.lr_wbfm_proto(
            x.data_ptr(), carry.data_ptr(), taps.data_ptr(), c, t, k, d,
            float(np.float32(inv_gain)), tile, _STAGE[stage], deint,
            _FIR.get(fir_prec, 0), out.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    cudabuild.check(lib, code, "wbfm_proto")
    wbfm_proto.launches += 1
    return x[:, w - 2 * k:].clone(), out


wbfm_proto.launches = 0


# --- the ring's plan and protocol, mirrored (csrc/wbfm_proto.cu) ---------


@dataclasses.dataclass(frozen=True)
class Ring:
    """S4's ring constants (csrc/wbfm_proto.cu kChunk, kStages,
    kCtasPerSm, kWarps, kClaimed, kAtan, kUnroll): the atan2 is 0 for
    libdevice atan2f, 1 the Hopper polynomial, 3 atan2f's fast path
    without its branches."""

    chunk: int
    stages: int
    ctas_per_sm: int
    warps: int
    claimed: bool
    atan: int
    unroll: int


#: the shipped constants, the winners of scratch/wbfm_proto_ab.py's sweep
RING = Ring(512, 2, 2, 8, False, 3, 2)
#: SMs of an H100 SXM, the mirror's default
SMS = 132
#: a CTA's dynamic shared memory at most, an SM's (1 KB a CTA reserved),
#: the head of barriers and infos before the stages
SMEM_CTA, SMEM_SM, HEADER = 227 * 1024, 228 * 1024, 256
#: terms (m, h) of the FIR codes
_MT, _HT = (1, 1, 3, 2, 2), (1, 1, 1, 1, 2)
_KIND = {"deint_only": 1, "no_fir": 2, "full": 3, "no_deint": 3}


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def _geo(kind, per, k, d, halves, mt, ht, band, chunk, stages):
    """make_geo: the plan's sizes at `chunk`, and its shared memory in
    bytes or None where it does not fit a CTA."""
    u = (k + d - 1) // d
    ks = (u + 7 + 15) // 16
    u4 = _round_up(u, 4)
    g = {"per": per, "chunk": chunk, "stages": stages, "u": u, "ks": ks,
         "u4": u4,
         "pw": 16 * ks + 8, "band": band, "halves": halves,
         "q_need": (per - 1) * d + k if kind == 3 else per,
         "rc": 0, "rce": 0, "ext": 0, "item_cols": 0}
    extra = 0 if kind == 1 else 1
    plane = taps = 0
    if kind == 3:
        g["rc"] = 2 * chunk + _round_up(u + 16 * ks, 128) + 128
        g["ext"] = max(16 * ks - 8, u4)
        g["rce"] = (_round_up(g["rc"] + g["ext"] - 8, 64) + 8 if band else
                    _round_up(g["rc"] + g["ext"] - 4, 32) + 4)
        g["item_cols"] = _round_up(-(-per // chunk) * chunk + 16 * ks, 128)
        plane = _round_up(mt * d * g["rce"] * (2 if band else 4), 16)
        taps = ht * d * g["pw"] * 4 if band else ht * d * u4 * 4
    g["plane_bytes"] = plane
    first = min(g["q_need"], (chunk - 1) * d + k) if kind == 3 else 0
    for ss in (max(first, chunk * d) if kind == 3 else chunk * d,
               chunk * d):
        g["ss"] = ss
        g["reg_cap"] = (_round_up(ss + extra + 3, 4) if halves else
                        _round_up(2 * (ss + extra) + 3, 4))
        g["stage_floats"] = 2 * g["reg_cap"] if halves else g["reg_cap"]
        smem = HEADER + stages * g["stage_floats"] * 4 + plane + taps
        if smem <= SMEM_CTA:
            return g, smem
    return g, None


def ring_plan(c: int, t: int, k: int, d: int, tile: int, stage: str,
              deint_prec: str = "highest", fir_prec: str = "highest",
              ring: Ring = RING, sms: int = SMS) -> dict:
    """The kernel's plan for a launch (csrc/wbfm_proto.cu make_geo,
    fit_geo, launch_as; lr_wbfm_proto_plan returns the same numbers on the
    card): the chunk (halved from ring.chunk until ring.ctas_per_sm CTAs
    of an SM fit), the m values a piece at most (ss), the m values an
    item needs (q_need), the stage and region floats, the planes' ring
    (rc columns, rows of rce, the first ext mirrored, item_cols an item),
    the dynamic shared memory, the band or the CUDA cores, the items and
    the grid.  Raises where no chunk fits."""
    kind = _KIND[stage]
    fir = _FIR.get(fir_prec, 0)
    halves = stage == "no_deint"
    band = kind == 3 and fir != 0 and (tile // d) % 128 == 0
    mt, ht = (_MT[fir], _HT[fir]) if kind == 3 else (1, 1)
    budget = min(SMEM_CTA, SMEM_SM // ring.ctas_per_sm - 1024)
    chunk, g, smem = ring.chunk, None, None
    while chunk >= 128:
        g, smem = _geo(kind, tile // d, k, d, halves, mt, ht, band, chunk,
                       ring.stages)
        if smem is not None and smem <= budget:
            break
        chunk //= 2
    if smem is None:
        raise ValueError(f"ring_plan: no chunk fits at K {k}, D {d}, "
                         f"tile {tile}")
    items = c * (t // tile)
    fit = min(ring.ctas_per_sm, SMEM_SM // (smem + 1024))
    g.update(kind=kind, smem=smem, items=items, tiles=t // tile, k=k, d=d,
             tile=tile, n=k + tile, warps=ring.warps,
             deint=_HALVES if halves else _DEINT.get(deint_prec, 0),
             grid=min(items, max(fit, 1) * sms),
             mt=mt, ht=ht, extra=0 if kind == 1 else 1)
    return g


def item_pieces(plan: dict) -> list[tuple[int, int, int]]:
    """One item's pieces (q0, q1, fire) as the producer makes them: the m
    values [q0, q1) (deint_only: the samples), at most ss a piece, each
    FIR chunk's last piece naming the chunk (else -1)."""
    out, q, c = [], 0, 0
    d, k = plan["d"], plan["k"]
    while q < plan["q_need"]:
        if plan["kind"] == 3:
            qe = min(plan["q_need"], ((c + 1) * plan["chunk"] - 1) * d + k)
        else:
            qe = min(plan["q_need"], (c + 1) * plan["ss"])
        q1 = min(qe, q + plan["ss"])
        out.append((q, q1, c if plan["kind"] == 3 and q1 == qe else -1))
        q = q1
        if q1 == qe:
            c += 1
    return out


def item_order(plan: dict, claimed: bool = False, seed: int = 0
               ) -> list[list[int]]:
    """Each CTA's items in order: its first is its index; then, dealt,
    every grid-th after it, or, claimed, grid + the counter's next value,
    the CTAs claiming in an order drawn from ``seed`` (the counter ends
    at zero: the last CTA resets it)."""
    grid, items = plan["grid"], plan["items"]
    if not claimed:
        return [list(range(b, items, grid)) for b in range(grid)]
    rng = random.Random(seed)
    orders = [[b] for b in range(grid)]
    live = list(range(grid))
    counter = 0
    while live:
        b = rng.choice(live)
        nxt = grid + counter
        counter += 1
        if nxt >= items:
            live.remove(b)
        else:
            orders[b].append(nxt)
    return orders


def piece_regions(plan: dict, x_float_addr: int, row: int, i: int, q0: int,
                  q1: int) -> list[dict]:
    """The floats a piece stages (csrc/wbfm_proto.cu region): one region of
    the window's interleaved floats, or no_deint's two halves, each
    {"p0", "p1": positions in the row's [carry | x], "a": p0's float
    address mod 4 (its offset in the stage; 0 for interleaved pairs at an
    odd address, which go all by plain loads), "pa", "pb": the span one
    bulk copy moves (16-byte aligned, pa == pb == p1 where none), "plain":
    the positions plain loads move}.  x_float_addr: the float address (byte
    address / 4) of x[0, 0]; rows are 2T floats apart."""
    k2, t = 2 * plan["k"], plan["tiles"] * plan["tile"]
    x4 = x_float_addr + row * 2 * t                # x[row, 0]
    pbase = 2 * plan["tile"] * i
    ext = plan["extra"]
    if plan["halves"]:
        spans = [(pbase + q0, pbase + q1 + ext),
                 (pbase + plan["n"] + q0, pbase + plan["n"] + q1 + ext)]
    else:
        spans = [(pbase + 2 * q0, pbase + 2 * (q1 + ext))]
    out = []
    for p0, p1 in spans:
        a = (x4 + p0 - k2) % 4
        lo = max(p0, k2)
        pa = pb = p1
        if not plan["halves"] and a % 2:
            # interleaved pairs at an odd float address: all plain, staged
            # from offset 0 (a sample stays one aligned float2)
            a = 0
        elif lo < p1:
            ca = lo + (4 - (x4 + lo - k2) % 4) % 4
            cb = p1 - (x4 + p1 - k2) % 4
            if cb > ca:
                pa, pb = ca, cb
        plain = list(range(p0, min(p1, k2))) + list(range(lo, pa)) + \
            list(range(pb, p1))
        out.append({"p0": p0, "p1": p1, "a": a, "pa": pa, "pb": pb,
                    "plain": plain})
    return out


class Bar:
    """An mbarrier: a phase completes when its ``count`` arrivals are in
    and its expected transaction bytes have landed; try_wait.parity p
    passes once the phase of parity p has completed."""

    def __init__(self, count: int):
        self.count, self.phase, self.pending, self.tx = count, 0, count, 0

    def arrive(self, tx: int = 0):
        if self.pending == 0:
            raise RuntimeError("arrive on a completed phase")
        self.tx += tx
        self.pending -= 1
        self._step()

    def complete_tx(self, n: int):
        self.tx -= n
        self._step()

    def _step(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def passes(self, parity: int) -> bool:
        return (self.phase & 1) != parity


def stage_use(j: int, stages: int) -> tuple[int, int, int | None]:
    """Piece j of a CTA: (its stage, the parity of the "full" phase the
    consumers wait on, the parity of the "empty" phase the producer waits
    on before refilling the stage, None on its first use)."""
    u = j // stages
    return j % stages, u & 1, (u - 1) & 1 if u else None


def simulate_cta(plan: dict, items: list[int], seed: int = 0,
                 drop: str | None = None) -> list[tuple]:
    """One CTA's producer and consumer warps run csrc/wbfm_proto.cu's
    loops over ``items`` against models of the mbarriers (full: 32
    producer lanes and the bulk bytes; empty: one arrival a consumer
    warp) and the consumers' named barrier before each FIR; bulk copies
    land and warps step in an order drawn from ``seed``.  ``drop``
    ("empty" or "full") leaves out the producer's or the consumers' wait,
    as a faulty kernel would.  Checks, as it goes, that no stage is
    refilled before every consumer warp has released its last piece and
    that no consumer reads a stage before its piece has landed; raises on
    a violation or a deadlock.  Returns the events (warp, kind, j,
    piece)."""
    rng = random.Random(seed)
    ns, nw = plan["stages"], plan["warps"]
    pieces = [(it, q0, q1, fire) for it in items
              for q0, q1, fire in item_pieces(plan)] + [(-1, 0, 0, -1)]
    full = [Bar(32) for _ in range(ns)]
    empty = [Bar(nw) for _ in range(ns)]
    holds = [None] * ns                      # (piece index, landed)
    released = [set() for _ in range(ns)]    # warps done with its piece
    loads: list[tuple[int, int]] = []        # (stage, bytes) in flight
    pj = 0
    cj = [0] * nw
    at_bar = [None] * nw                     # the FIR chunk a warp waits at
    done = [False] * nw
    events: list[tuple] = []
    while True:
        acts = []
        if pj < len(pieces):
            st, _, ep = stage_use(pj, ns)
            if ep is None or drop == "empty" or empty[st].passes(ep):
                acts.append(("produce", None))
        if loads:
            acts.append(("land", None))
        for w in range(nw):
            if done[w] or at_bar[w] is not None:
                continue
            st, fp, _ = stage_use(cj[w], ns)
            if drop == "full" or full[st].passes(fp):
                acts.append(("consume", w))
        waiting = [w for w in range(nw) if at_bar[w] is not None]
        if waiting and len(waiting) + sum(done) == nw:
            acts.append(("barrier", None))
        if not acts:
            break
        act, w = rng.choice(acts)
        if act == "produce":
            st = pj % ns
            if holds[st] is not None and holds[st][0] == pj - ns and \
                    len(released[st]) < nw:
                raise RuntimeError(f"stage {st} refilled with piece {pj} "
                                   f"before every consumer released piece "
                                   f"{pj - ns}")
            it = pieces[pj][0]
            nbytes = 0 if it < 0 else 16 * (1 + rng.randrange(4))
            holds[st] = (pj, nbytes == 0)
            released[st] = set()
            for lane in range(32):
                full[st].arrive(nbytes if lane == 0 else 0)
            if nbytes:
                loads.append((st, nbytes))
            events.append((-1, "produce", pj, pieces[pj]))
            pj += 1
        elif act == "land":
            st, nbytes = loads.pop(rng.randrange(len(loads)))
            holds[st] = (holds[st][0], True)
            full[st].complete_tx(nbytes)
            events.append((-1, "land", holds[st][0], None))
        elif act == "consume":
            j = cj[w]
            st = j % ns
            if holds[st] is None or holds[st][0] != j or not holds[st][1]:
                raise RuntimeError(f"warp {w} read stage {st} for piece {j} "
                                   f"while it holds {holds[st]}")
            piece = pieces[j]
            events.append((w, "consume", j, piece))
            if piece[0] < 0:
                done[w] = True
                continue
            released[st].add(w)
            empty[st].arrive()
            cj[w] += 1
            if piece[3] >= 0:
                at_bar[w] = piece[3]
        else:
            chunks = {at_bar[w] for w in waiting}
            if len(chunks) != 1:
                raise RuntimeError(f"warps met at the barrier for chunks "
                                   f"{chunks}")
            for w in waiting:
                events.append((w, "fir", cj[w] - 1, at_bar[w]))
                at_bar[w] = None
    if not all(done) or pj < len(pieces) or loads:
        raise RuntimeError(f"ring deadlocked: producer at {pj}, consumers "
                           f"at {cj}")
    return events


def edge_shapes(ring: Ring = RING, sms: int = SMS) -> dict[str, tuple]:
    """(C, K, D, tile, tiles a row, x's float offset, deint, fir, stage)
    at the ring's edges on ``sms`` SMs: fewer items than CTAs, an item
    count no multiple of the grid, a last chunk shorter than the others,
    x 8 and 4 bytes off 16, tile 0's carry span (no_deint and fp32), the
    2^15 tile, and a first piece split (K - D past a chunk of D values)."""
    grid = ring.ctas_per_sm * sms
    return {"fewer items than CTAs": (1, 128, 8, 2048, 2, 0, "sel3",
                                      "split22", "full"),
            "items no multiple of the grid": (3, 128, 8, 1024,
                                              grid // 3 + 5, 0, "sel3",
                                              "split22", "full"),
            "a last chunk shorter than the others": (
                2, 128, 8, 3 * ring.chunk * 8 // 2, 3, 0, "sel3cat",
                "split22", "full"),
            "x 8 bytes off 16": (2, 128, 8, 2048, 3, 2, "sel2", "split22",
                                 "full"),
            "x 4 bytes off 16, deint_only": (2, 128, 8, 2048, 3, 1,
                                             "default", "default",
                                             "deint_only"),
            "tile 0's carry span, no_deint": (2, 128, 8, 1024, 1, 0, "sel3",
                                              "split22", "no_deint"),
            "tile 0's carry span, fp32": (2, 128, 8, 1024, 2, 2, "highest",
                                          "highest", "full"),
            "tile 2^15": (1, 128, 8, 1 << 15, 1, 2, "sel3cat", "two",
                          "full")}


def mirror_values(carry: torch.Tensor, x: torch.Tensor, taps: torch.Tensor,
                  d: int, inv_gain: float, tile: int,
                  deint_prec: str = "highest", fir_prec: str = "highest",
                  stage: str = "full", ring: Ring = RING, sms: int = SMS,
                  x_float_addr: int = 0) -> torch.Tensor:
    """The kernel's outputs by its plan, on the CPU: each CTA takes its
    dealt items in order; each piece's floats are gathered from its
    regions (plain and bulk spans, at the stage offsets a), each rounded
    once; each m computed once from neighbouring samples of the piece (the
    twin's discriminate on the piece's samples); m's terms written into a
    ring of rc columns (the first ext mirrored past rc) at the CTA's
    column base, which moves on item_cols an item; at a chunk's last
    piece its outputs summed from the ring: on the band, over the 16 ks
    columns each 8-output row of a 128-output tile reads (the taps zero
    past u), else over the u taps.  Matches the twin bit for bit in
    deint_only and no_fir and up to the order of accumulation in the FIR
    stages."""
    plan = ring_plan(x.shape[0], x.shape[1] // 2, taps.shape[0], d, tile,
                     stage, deint_prec, fir_prec, ring, sms)
    c, w = x.shape
    t = w // 2
    per, k = plan["per"], plan["k"]
    out = torch.full((c, t // d), float("nan"))
    flat = torch.cat([carry, x], 1)               # the row's [carry | x]
    gain = torch.tensor(np.float32(inv_gain))
    ext, rc = plan["ext"], plan["rc"]
    if plan["kind"] == 3:
        hterms = _tap_terms(taps, fir_prec)
        mt_n = plan["mt"]
    for cta_items in item_order(plan):
        col_base = 0
        ring_m = None
        if plan["kind"] == 3:
            ring_m = torch.zeros((mt_n, d, rc + ext))
        for item in cta_items:
            row, i = divmod(item, plan["tiles"])
            base = col_base
            col_base = (col_base + plan["item_cols"]) % rc if rc else 0
            for q0, q1, fire in item_pieces(plan):
                regs = piece_regions(plan, x_float_addr, row, i, q0, q1)
                vals = []
                for r in regs:
                    n_f = r["p1"] - r["p0"]
                    stg = torch.full((r["a"] + n_f,), float("nan"))
                    idx = torch.arange(r["p0"], r["p1"])
                    stg[r["a"]:] = flat[row, idx]
                    vals.append(stg[r["a"]:])
                if plan["halves"]:
                    re, im = vals[0], vals[1]
                else:
                    re = round_deint(vals[0][0::2], deint_prec)
                    im = round_deint(vals[0][1::2], deint_prec)
                if plan["kind"] == 1:
                    out[row, i * per + q0:i * per + q1] = re + im
                    continue
                m = discriminate(re, im, gain)            # [q1 - q0]
                if plan["kind"] == 2:
                    out[row, i * per + q0:i * per + q1] = m
                    continue
                q = torch.arange(q0, q1)
                cols = (base + q // d) % rc
                ph = q % d
                fterms = fir_terms(m, taps, fir_prec)
                for tt, (mterm, _) in enumerate(fterms[:mt_n]):
                    ring_m[tt, ph, cols] = mterm
                    mir = cols < ext
                    ring_m[tt, ph[mir], cols[mir] + rc] = mterm[mir]
                if fire < 0:
                    continue
                o0 = fire * plan["chunk"]
                nout = min(per, o0 + plan["chunk"]) - o0
                s0 = (base + o0) % rc
                y = _mirror_fir(plan, ring_m, fterms, hterms, fir_prec, s0,
                                nout, taps)
                out[row, i * per + o0:i * per + o0 + nout] = y
    return out


def _tap_terms(taps, fir_prec):
    """The FIR mode's tap terms (csrc/wbfm_proto.cu h_terms)."""
    if fir_prec in ("highest", "two_hi"):
        return [taps]
    hi = _bf(taps)
    if fir_prec in ("split22", "two"):
        return [hi, _bf(taps - hi)]
    return [hi]


def _mirror_fir(plan, ring_m, fterms, hterms, fir_prec, s0, nout, taps):
    """A chunk's nout outputs from the ring at column s0 (see
    mirror_values)."""
    d, u, rc = plan["d"], plan["u"], plan["rc"]
    k = plan["k"]
    # g_p[j] = h[K-1 - jD - p] as each tap term, zero outside 0 <= j < u
    width = 16 * plan["ks"] + 8 if plan["band"] else u
    gp = torch.zeros((len(hterms), d, width))
    for p in range(d):
        for j in range(u):
            kk = k - 1 - j * d - p
            if kk >= 0:
                for tt, ht in enumerate(hterms):
                    gp[tt, p, j] = ht[kk]
    # which (m term, tap term) pairs the mode sums
    if fir_prec in ("split22", "two"):
        pairs = [(0, 0), (1, 0), (0, 1)]
    else:
        pairs = [(tt, 0) for tt in range(plan["mt"])]
    o = torch.arange(nout)
    pos = s0 + o
    pos = torch.where(pos >= rc, pos - rc, pos)
    y = torch.zeros(nout)
    if plan["band"]:
        # a tile's row of 8 outputs reads columns start + [0, 16 ks):
        # output n of the row takes column start + c with tap c - n
        start = pos - (o % 8)
        for mt_i, ht_i in pairs:
            for p in range(d):
                for cc in range(16 * plan["ks"]):
                    j = cc - (o % 8)
                    ok = (j >= 0) & (j < width)
                    g = torch.where(ok, gp[ht_i, p, j.clamp(0, width - 1)],
                                    0.0)
                    y = y + ring_m[mt_i, p, start + cc] * g
    else:
        for mt_i, ht_i in pairs:
            for p in range(d):
                for j in range(u):
                    y = y + ring_m[mt_i, p, pos + j] * gp[ht_i, p, j]
    return y


__all__ = ["wbfm_proto", "wbfm_proto_reference", "round_deint", "fir_terms",
           "PRECISIONS", "FIR_PRECISIONS", "STAGES", "Ring",
           "RING", "SMS", "ring_plan", "item_pieces", "item_order",
           "piece_regions", "Bar", "stage_use", "simulate_cta",
           "edge_shapes", "mirror_values"]
