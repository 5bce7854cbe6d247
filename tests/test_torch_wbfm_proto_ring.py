"""S4's ring kernel (csrc/wbfm_proto.cu ring_kernel) mirrored in Python
(ops/wbfm_proto.py ring_plan, item_order, item_pieces, piece_regions,
simulate_cta, mirror_values): every (row, tile) item taken once, dealt
or claimed; each piece's span covering exactly the floats its
discriminator values need (tile 0 across the carry, no_deint's halves,
the 2^15 tile, x 4 or 8 bytes off 16); the producer -> consumer hand-offs
over the stages in any order of the warps and of the bulk copies'
completions (a dropped wait must fail); the values the plan computes,
each float rounded once and each m computed once from its neighbours,
against the plain twin (bit for bit in deint_only and no_fir, within
2e-5 * scale in the FIR stages); and the shipped constants read from the
source, a point of the sweep whose shared memory fits the card."""

import os
import re
import zlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import chip_smoke  # noqa: E402
from luaradio_tpu_torch.benchmarks import wbfm_proto as bench  # noqa: E402
from luaradio_tpu_torch.ops import wbfm_proto as wp  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "luaradio_tpu_torch",
                   "csrc", "wbfm_proto.cu")
TOL = 2e-5
#: (K, D, tile, block, deint, fir) chip_smoke.py holds S4 at
PROBE_S4_SHAPES = chip_smoke.PROBE_S4_SHAPES
#: rings of the mirror's tests: the shipped one, and smaller chunks and
#: more stages (a window of several chunks and pieces at a small size)
RINGS = (wp.RING, wp.Ring(128, 3, 2, 4, False, 0, 1),
         wp.Ring(256, 2, 3, 8, True, 1, 4))


def _inputs(c, k, t, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((c, 2 * t)).astype(np.float32))
    carry = torch.from_numpy(rng.standard_normal((c, 2 * k)).astype(
        np.float32))
    taps = torch.from_numpy((rng.standard_normal(k) / k).astype(np.float32))
    return carry, x, taps


def _close(label, got, exp, stage):
    assert got.shape == exp.shape, label
    if stage in ("deint_only", "no_fir"):
        assert torch.equal(got, exp), label
    else:
        scale = max(1.0, float(exp.abs().max()))
        err = float((got - exp).abs().max())
        assert err <= TOL * scale, (label, err, scale)


# -- the items ----------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.integers(1, 6), st.integers(1, 40), st.integers(1, 8),
       st.integers(1, 3), st.booleans(), st.integers(0, 2 ** 32 - 1))
def test_every_item_is_taken_once(c, tiles, sms, ctas, claimed, seed):
    """Dealt round robin or claimed from the counter in any order of the
    CTAs, each (row, tile) item goes to exactly one CTA, each CTA's first
    item is its own index, and the grid is never larger than the items."""
    ring = wp.Ring(256, 2, ctas, 8, claimed, 0, 2)
    plan = wp.ring_plan(c, tiles * 1024, 128, 8, 1024, "full", "sel3",
                        "split22", ring, sms)
    assert plan["grid"] == min(plan["items"], ctas * sms)
    orders = wp.item_order(plan, claimed, seed)
    assert len(orders) == plan["grid"]
    assert all(o[0] == b for b, o in enumerate(orders))
    taken = sorted(i for o in orders for i in o)
    assert taken == list(range(c * tiles))


# -- the pieces and their spans -----------------------------------------------

SHAPES = st.sampled_from([(128, 8, 1024), (128, 8, 2048), (128, 8, 768),
                          (256, 4, 2048), (128, 5, 1280), (128, 8, 1 << 15),
                          (640, 8, 1 << 14), (8, 1, 256), (3, 2, 6)])


@settings(max_examples=80, deadline=None)
@given(SHAPES, st.sampled_from(["full", "no_deint", "no_fir", "deint_only"]),
       st.sampled_from(RINGS))
def test_pieces_cover_each_value_once(shape, stage, ring):
    """An item's pieces cut [0, q_need) (the m values its outputs read:
    (tile/D - 1) D + K for the FIR stages, tile/D for the heads) into
    consecutive spans of at most ss values, the FIR chunks' ends among
    them, each chunk fired once, in order, at its last piece, once the
    m values its outputs read are all in."""
    k, d, tile = shape
    plan = wp.ring_plan(1, 2 * tile, k, d, tile, stage, "sel3", "split22",
                        ring)
    pieces = wp.item_pieces(plan)
    per = tile // d
    assert plan["q_need"] == ((per - 1) * d + k if plan["kind"] == 3
                              else per)
    assert pieces[0][0] == 0 and pieces[-1][1] == plan["q_need"]
    assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
    assert all(0 < q1 - q0 <= plan["ss"] for q0, q1, _ in pieces)
    fired = [(f, q1) for _, q1, f in pieces if f >= 0]
    if plan["kind"] != 3:
        assert not fired
        return
    assert [f for f, _ in fired] == list(range(-(-per // plan["chunk"])))
    for f, q1 in fired:
        last_out = min(per, (f + 1) * plan["chunk"]) - 1
        assert q1 >= last_out * d + k                # the chunk's m is in
    assert plan["chunk"] % 128 == 0 and plan["chunk"] <= ring.chunk


@settings(max_examples=120, deadline=None)
@given(SHAPES, st.sampled_from(["full", "no_deint", "no_fir", "deint_only"]),
       st.integers(0, 3), st.integers(0, 2), st.integers(0, 3), st.data())
def test_piece_spans_are_exactly_what_the_values_need(shape, stage, off, row,
                                                      tile_i, data):
    """Each piece stages exactly the floats of [carry | x] its values
    read: the interleaved floats [2 q0, 2 (q1 + 1)) (deint_only: up to 2
    q1), or no_deint's halves [q0, q1 + 1) and [n + q0, n + q1 + 1); plain
    loads and one 16-byte aligned bulk span a region partition it (the
    carry, tile 0's, always plain; interleaved pairs at an odd address
    all plain from offset 0, so a sample is one aligned float2); each
    region fits its stage capacity at its offset a, and a bulk span lands
    on a 16-byte boundary of the stage, for x 0, 4, 8 or 12 bytes off
    16."""
    k, d, tile = shape
    plan = wp.ring_plan(3, 4 * tile, k, d, tile, stage, "sel3", "split22")
    pieces = wp.item_pieces(plan)
    q0, q1, _ = pieces[data.draw(st.integers(0, len(pieces) - 1))]
    x4 = 1024 + off                          # x[0, 0]'s float address
    regs = wp.piece_regions(plan, x4, row, tile_i, q0, q1)
    pbase, n, ext = 2 * tile * tile_i, k + tile, plan["extra"]
    if stage == "no_deint":
        want = [(pbase + q0, pbase + q1 + 1),
                (pbase + n + q0, pbase + n + q1 + 1)]
    else:
        want = [(pbase + 2 * q0, pbase + 2 * (q1 + ext))]
    assert [(r["p0"], r["p1"]) for r in regs] == want
    k2, xrow = 2 * k, x4 + row * 2 * 4 * tile
    for r in regs:
        span = set(range(r["p0"], r["p1"]))
        bulk = set(range(r["pa"], r["pb"]))
        plain = r["plain"]
        assert len(plain) == len(set(plain)) and not bulk & set(plain)
        assert bulk | set(plain) == span
        assert set(range(r["p0"], min(r["p1"], k2))) <= set(plain)
        assert not bulk & set(range(k2))
        if r["pb"] > r["pa"]:
            assert (xrow + r["pa"] - k2) % 4 == 0        # 16-byte source
            assert (r["pb"] - r["pa"]) % 4 == 0          # whole 16 bytes
            assert (r["a"] + r["pa"] - r["p0"]) % 4 == 0  # 16-byte stage
        a = (xrow + r["p0"] - k2) % 4
        if stage != "no_deint" and a % 2:      # odd pairs: all plain
            assert r["a"] == 0 and r["pa"] == r["pb"] == r["p1"]
        else:
            assert r["a"] == a
        assert r["a"] % 2 == 0 or stage == "no_deint"
        assert r["a"] + r["p1"] - r["p0"] <= plan["reg_cap"]


# -- the protocol --------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(st.sampled_from(RINGS), SHAPES.filter(lambda s: s[2] <= 4096),
       st.sampled_from(["full", "no_fir", "deint_only", "no_deint"]),
       st.integers(1, 3), st.integers(0, 2 ** 32 - 1))
def test_ring_protocol_holds_in_any_order(ring, shape, stage, n_items, seed):
    """The producer -> consumer hand-offs over the stages, the bulk copies
    landing and the warps stepping in any order: no stage is refilled
    before every consumer warp released it, no warp reads a stage before
    its piece landed, every warp meets the others at each FIR chunk's
    barrier, nothing is left waiting, and every warp reads every piece of
    its CTA's items in order, then the end."""
    k, d, tile = shape
    plan = wp.ring_plan(1, n_items * tile, k, d, tile, stage, "sel3",
                        "split22", ring)
    items = list(range(n_items))
    events = wp.simulate_cta(plan, items, seed)
    n_pieces = n_items * len(wp.item_pieces(plan))
    for w in range(plan["warps"]):
        seen = [j for ww, kind, j, _ in events if ww == w and
                kind == "consume"]
        assert seen == list(range(n_pieces + 1))
    firs = [e for e in events if e[1] == "fir"]
    n_fire = sum(f >= 0 for _, _, f in wp.item_pieces(plan)) * n_items
    assert len(firs) == n_fire * plan["warps"]


@pytest.mark.parametrize("drop", ["empty", "full"])
def test_ring_protocol_catches_a_dropped_wait(drop):
    """The mirror fails when a wait is dropped (a bug it must catch): the
    producer refilling a stage some warp still reads, or a warp reading
    a stage whose piece has not landed, shows in some order."""
    plan = wp.ring_plan(1, 3 * 1024, 128, 8, 1024, "full", "sel3", "split22",
                        wp.Ring(128, 2, 2, 4, False, 0, 1))
    caught = 0
    for seed in range(40):
        try:
            wp.simulate_cta(plan, [0, 1, 2], seed, drop=drop)
        except RuntimeError:
            caught += 1
    assert caught > 0
    wp.simulate_cta(plan, [0, 1, 2], 0)          # no drop: it holds


# -- the values ----------------------------------------------------------------

EDGES = [(label, *v) for label, v in wp.edge_shapes(
    wp.Ring(256, 2, 2, 8, False, 3, 2), sms=2).items()]


#: (ring, edge): every edge at the shipped ring, and at the small one
#: those up to a tile of 4096
EDGE_CASES = [(ring, e) for ring in RINGS[:2] for e in EDGES
              if ring is wp.RING or e[4] <= 4096]


@pytest.mark.parametrize(
    "ring,edge", EDGE_CASES,
    ids=[f"{'shipped' if r is wp.RING else 'small'}-{e[0]}"
         for r, e in EDGE_CASES])
def test_mirror_equals_the_twin_at_the_edges(ring, edge):
    """The plan's values (each float rounded once, each m once from its
    neighbours, the FIR from the ring of planes) equal the twin's at the
    ring's edge shapes on a 2-SM card (so the grid is small: fewer items
    than CTAs, items no multiple of the grid), x's offset as the
    kernel's staging offsets."""
    label, c, k, d, tile, nt, off, dp, fp, stage = edge
    nt = min(nt, 8)
    carry, x, taps = _inputs(c, k, nt * tile, zlib.crc32(label.encode()))
    exp = wp.wbfm_proto_reference(carry, x, taps, d, 0.7, tile, 128, dp, fp,
                                  stage)[1]
    got = wp.mirror_values(carry, x, taps, d, 0.7, tile, dp, fp, stage, ring,
                           sms=2, x_float_addr=off)
    _close(label, got, exp, stage)


@pytest.mark.parametrize("k,d,tile,block,dp,fp", PROBE_S4_SHAPES)
def test_mirror_equals_the_twin_at_the_probe_shapes(k, d, tile, block, dp,
                                                    fp):
    """chip_smoke.py's PROBE_S4_SHAPES (the band at 5 and 3 k-steps, the
    CUDA cores for a bf16 mode at tile/D = 96, a block of 256) through
    the shipped plan on two rows of three tiles, and their no_fir and
    deint_only stages."""
    carry, x, taps = _inputs(2, k, 3 * tile, k + d)
    for stage in ("full", "no_fir", "deint_only"):
        exp = wp.wbfm_proto_reference(carry, x, taps, d, 1.0, tile, block,
                                      dp, fp, stage)[1]
        got = wp.mirror_values(carry, x, taps, d, 1.0, tile, dp, fp, stage,
                               sms=2)
        _close(f"K {k} D {d} tile {tile} {stage}", got, exp, stage)


@pytest.mark.parametrize("name,dp,fp,stage,mul", [
    v for v in bench.VARIANTS if v[3] != "dma_only"])
def test_mirror_equals_the_twin_on_every_variant(name, dp, fp, stage, mul):
    """Every variant of the entry point other than dma_only (S8's gather)
    at a small size: two rows of two tiles of 2^11 (2^12 for t32k)."""
    tile = mul * 2048
    carry, x, taps = _inputs(2, 128, 2 * tile, 7)
    taps = torch.from_numpy(bench.proto_taps())
    exp = wp.wbfm_proto_reference(carry, x, taps, 8, 1.0, tile, 128, dp, fp,
                                  stage)[1]
    got = wp.mirror_values(carry, x, taps, 8, 1.0, tile, dp, fp, stage,
                           sms=1)
    _close(name, got, exp, stage)


# -- the shipped constants -----------------------------------------------------

def _source_ring():
    src = open(SRC).read()
    m = re.search(r"constexpr int kChunk = (\d+), kStages = (\d+), "
                  r"kCtasPerSm = (\d+), kWarps = (\d+);\s*"
                  r"constexpr bool kClaimed = (true|false);\s*"
                  r"constexpr int kAtan = (\d+);.*\s*"
                  r"constexpr int kUnroll = (\d+);", src)
    assert m, "the shipped constants moved"
    v = m.groups()
    return src, wp.Ring(int(v[0]), int(v[1]), int(v[2]), int(v[3]),
                        v[4] == "true", int(v[5]), int(v[6]))


def test_shipped_constants_fit_and_are_swept():
    """The source's shipped constants are the mirror's RING and a point of
    the measurement build's sweep (with its kernels instantiated); the
    shared memory of every entry-point variant, of PROBE_S4_SHAPES and of
    the edge shapes fits the 227 KB a CTA may take (the head, the stages,
    the planes and the taps), and the flagship variants' lets an SM hold
    kCtasPerSm CTAs."""
    src, ring = _source_ring()
    assert ring == wp.RING
    sweep = src.split("static const int kPoints[][7] = {")[1].split("};")[0]
    points = [tuple(int(v) for v in p) for p in re.findall(
        r"\{(\d+), (\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\}", sweep)]
    shipped = (ring.chunk, ring.stages, ring.ctas_per_sm, ring.warps,
               int(ring.claimed), ring.atan, ring.unroll)
    assert shipped in points
    kernels = re.findall(r"LR_S4_KERNELS\((\d+), (\d+), (\d+)\)", src)
    assert (str(ring.warps), str(ring.atan), str(ring.unroll)) in kernels
    for p in points:                # atan2 4: libdevice's kernels, no FIR
        fa = 0 if p[5] == 4 else p[5]
        assert (str(p[3]), str(fa), str(p[6])) in kernels
    assert "kMaxStages = 4" in src and ring.stages <= 4
    assert re.search(r"kSmemMax = 227 \* 1024", src)
    for name, dp, fp, stage, mul in bench.VARIANTS:
        if stage == "dma_only":
            continue
        plan = wp.ring_plan(bench.C, bench.T, 128, bench.D, mul * bench.TILE,
                            stage, dp, fp)
        assert plan["smem"] <= 227 * 1024
        assert plan["smem"] + 1024 <= wp.SMEM_SM // ring.ctas_per_sm, name
    for k, d, tile, block, dp, fp in PROBE_S4_SHAPES:
        assert wp.ring_plan(2, 3 * tile, k, d, tile, "full", dp,
                            fp)["smem"] <= 227 * 1024
    for c, k, d, tile, nt, off, dp, fp, stage in wp.edge_shapes().values():
        assert wp.ring_plan(c, nt * tile, k, d, tile, stage, dp,
                            fp)["smem"] <= 227 * 1024


def test_the_edges_reach_the_ring_s_edges():
    """chip_smoke.py holds S4 at the mirror's edge_shapes on the card's
    grid, and they reach the ring's edges there: fewer items than CTAs,
    an item count no multiple of the grid, a last FIR chunk shorter than
    the others, x 8 and 4 bytes off 16, tile 0's carry span (no_deint and
    the fp32 path), the 2^15 tile."""
    assert [e[0] for e in chip_smoke.S4_EDGES] == list(wp.edge_shapes())
    grid = wp.RING.ctas_per_sm * wp.SMS
    seen = set()
    for label, c, k, d, tile, nt, off, dp, fp, stage in chip_smoke.S4_EDGES:
        plan = wp.ring_plan(c, nt * tile, k, d, tile, stage, dp, fp)
        assert plan["grid"] == min(plan["items"], grid)
        if plan["items"] < grid:
            seen.add("fewer items")
        if plan["items"] > grid and plan["items"] % grid:
            seen.add("no multiple")
        per = tile // d
        if plan["kind"] == 3 and per > plan["chunk"] and per % plan["chunk"]:
            seen.add("short chunk")
        seen.add(f"offset {off % 4}")
        if nt == 1 and stage == "no_deint":
            seen.add("carry halves")
        if tile == 1 << 15:
            seen.add("2^15")
    assert {"fewer items", "no multiple", "short chunk", "offset 0",
            "offset 1", "offset 2", "carry halves", "2^15"} <= seen


def test_issue_estimate_reads_the_discriminator_loop():
    """The SASS reader picks the innermost loop holding a SHFL.UP with the
    most bf16 conversions (sel3's rounding) and counts its instructions a
    sample (two SHFL.UP a sample), leaving out atan2f's fallback."""
    sass = "\n".join(f"        /*{a:04x}*/  {op} ;" for a, op in [
        (0x10, "MOV R1, c[0x0][0x28]"),
        (0x20, "SHFL.UP PT, R2, R3, 0x1, RZ"),      # loop A: no rounding
        (0x30, "SHFL.UP PT, R4, R5, 0x1, RZ"),
        (0x40, "FADD R4, R4, R2"),
        (0x50, "@P0 BRA 0x20"),
        (0x60, "SHFL.UP PT, R2, R3, 0x1, RZ"),      # loop B: sel3
        (0x70, "SHFL.UP PT, R4, R5, 0x1, RZ"),
        (0x80, "F2FP.BF16.F32.PACK_AB R6, R4, R2"),
        (0x90, "F2FP.BF16.F32.PACK_AB R7, R4, R2"),
        (0xa0, "@P1 BRA 0x60"),
        (0xb0, "@P2 BRA 0x10")])                    # the outer loop
    n, shfl, body = bench.disc_loop_sass(sass)
    assert (n, shfl) == (5, 2) and "F2FP" in body[2]
    # a forward branch over a division check or a call (atan2f's
    # fallback) is not counted
    sass = "\n".join(f"        /*{a:04x}*/  {op} ;" for a, op in [
        (0x10, "SHFL.UP PT, R2, R3, 0x1, RZ"),
        (0x20, "SHFL.UP PT, R4, R5, 0x1, RZ"),
        (0x30, "F2FP.BF16.F32.PACK_AB R6, R4, R2"),
        (0x40, "@P0 BRA 0x80"),
        (0x50, "MUFU.RCP R6, R7"),
        (0x60, "FCHK P1, R6, R7"),
        (0x70, "FFMA R6, R6, R7, R6"),
        (0x80, "FADD R4, R4, R6"),
        (0x90, "@P2 BRA 0x10")])
    n, shfl, body = bench.disc_loop_sass(sass)
    assert (n, shfl) == (6, 2)
    assert sum("(fallback)" in b for b in body) == 3
    # and over a call (the fallback not inlined)
    n, _, _ = bench.disc_loop_sass(sass.replace("FCHK P1, R6, R7",
                                                "CALL.REL.NOINC 0x400"))
    assert n == 6
