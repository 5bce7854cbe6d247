"""The roofline probes (luaradio_tpu_torch/ops/roofline.py): the twins of
R1/R2 (the HBM copies) and R3 (atan2 of each tile's halves) against the
TPU probe bodies' math of bench_roofline.py, the wrappers' refusals, the
ring-overlap arithmetic, and every measurement entry point refusing to
run without a card.

bench_roofline.py fixes its shapes and the TPU inside its functions, so
R3's twin is held against the body of its kernel (:155-163): per tile,
``luaradio_tpu.ops.pll._atan2`` of the first half over the second, on the
same numpy input.  ``_atan2`` is 2.69e-7 rad from a float64 arctan2 on 8 x
2^14 normal samples, so the bound is 5e-7 rad; signed zeros must agree
exactly, but for atan2(-0, x > 0), where the TPU body returns +0 and the
twin, like IEEE 754 and float64 numpy, -0 (asserted both ways)."""

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from luaradio_tpu.ops.pll import _atan2  # noqa: E402
from luaradio_tpu_torch.benchmarks import (bench, bench_blocks,  # noqa: E402
                                           bench_multihost, bench_realtime,
                                           bench_roofline, bench_scaling,
                                           common, entry)
from luaradio_tpu_torch.ops import cudabuild, roofline  # noqa: E402

ATOL = 5e-7


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tpu_body(x: np.ndarray, tile: int) -> np.ndarray:
    """bench_roofline.py:155-163's math: for each column tile of
    ``tile``, _atan2(first half, second half) into the tile's half-width
    output block."""
    c, w = x.shape
    v = x.reshape(c, w // tile, 2, tile // 2)
    out = _atan2(jnp.asarray(v[:, :, 0]), jnp.asarray(v[:, :, 1]))
    return np.asarray(out).reshape(c, w // 2)


def _halves(x, tile):
    """(y, x) of each output, laid out as the output [C, T]."""
    c, w = x.shape
    v = x.reshape(c, w // tile, 2, tile // 2)
    return v[:, :, 0].reshape(c, w // 2), v[:, :, 1].reshape(c, w // 2)


def _hold_zeros(got, exp, y, x):
    """Every zero of the TPU body's output is the twin's zero of the same
    sign, but where y = -0 and x > 0: there ``_atan`` (pll.py:69) takes the
    sign from ``x < 0``, false for -0, so the body gives +0 where IEEE
    754 (and its docstring, pll.py:101-103) give -0; the twin keeps -0."""
    zero = exp == 0
    assert zero.any()
    assert np.all(got[zero] == 0)
    fault = zero & np.signbit(y) & (y == 0) & (x > 0)
    assert np.array_equal(np.signbit(got[zero & ~fault]),
                          np.signbit(exp[zero & ~fault]))
    assert not np.signbit(exp[fault]).any()
    assert np.signbit(got[fault]).all()
    return fault


@pytest.mark.parametrize("double_buffered", [False, True])
@pytest.mark.parametrize("shape", [(8, 1 << 13), (3, 2 * 5003)])
def test_copy_twin_is_bit_equal(double_buffered, shape):
    x = torch.from_numpy(_normal(shape, 1))
    got = roofline.hbm_copy(x, double_buffered=double_buffered)
    assert got.data_ptr() != x.data_ptr()
    assert got.dtype == x.dtype and got.shape == x.shape
    assert np.array_equal(got.numpy().view(np.uint32),
                          x.numpy().view(np.uint32))


@pytest.mark.parametrize("c,w,tile", [(8, 1 << 13, 1 << 10),
                                      (2, 1 << 16, 1 << 15)])
def test_atan2_twin_matches_the_tpu_body(c, w, tile):
    x = _normal((c, w), 2)
    x[0, :64] = 0.0                          # zeros of both signs in y and x
    x[0, 64:128] = -0.0
    x[1, tile // 2:tile // 2 + 32] = -0.0
    got = roofline.atan2_halves(torch.from_numpy(x), tile).numpy()
    exp = _tpu_body(x, tile)
    assert got.shape == (c, w // 2)
    assert np.max(np.abs(got.astype(np.float64) - exp)) <= ATOL
    _hold_zeros(got, exp, *_halves(x, tile))
    y, xx = _halves(x, tile)
    f64 = np.arctan2(y.astype(np.float64), xx.astype(np.float64))
    assert np.max(np.abs(got - f64)) <= ATOL
    assert np.array_equal(np.signbit(got), np.signbit(f64))


def test_atan2_signed_zero_table_matches_the_tpu_body():
    """Every pairing of +-0, +-1 and +-2.5 as (y, x), in tiles of 8."""
    v = np.float32([0.0, -0.0, 1.0, -1.0, 2.5, -2.5])
    y, x = (a.ravel() for a in np.meshgrid(v, v, indexing="ij"))
    n = 40                                   # 36 pairs, padded
    y = np.concatenate([y, np.ones(n - len(y), np.float32)])
    x = np.concatenate([x, np.ones(n - len(x), np.float32)])
    arr = np.stack([y.reshape(1, -1, 4), x.reshape(1, -1, 4)], axis=2)
    arr = arr.reshape(1, -1)
    got = roofline.atan2_halves(torch.from_numpy(arr), 8).numpy()
    exp = _tpu_body(arr, 8)
    assert np.max(np.abs(got - exp)) <= ATOL
    fault = _hold_zeros(got, exp, *_halves(arr, 8))
    assert fault.sum() == 2                  # (-0, 1) and (-0, 2.5)
    ieee = np.arctan2(y[:36].astype(np.float64), x[:36].astype(np.float64))
    assert np.array_equal(np.signbit(got[0, :36]), np.signbit(ieee))
    assert np.max(np.abs(got[0, :36] - ieee)) <= ATOL


@pytest.mark.parametrize("case", ["odd tile", "tile not dividing",
                                  "non-contiguous", "float64", "1-d",
                                  "meta device"])
def test_wrappers_raise(case):
    x = torch.zeros((2, 16))
    if case == "odd tile":
        with pytest.raises(ValueError, match="even"):
            roofline.atan2_halves(torch.zeros((2, 14)), 7)
        return
    if case == "tile not dividing":
        with pytest.raises(ValueError, match="divide"):
            roofline.atan2_halves(x, 6)
        return
    bad = {"non-contiguous": torch.zeros((16, 2)).t(),
           "float64": x.double(), "1-d": torch.zeros(32),
           "meta device": torch.zeros((2, 16), device="meta")}[case]
    for fn in (roofline.hbm_copy_serial, roofline.hbm_copy_double_buffered,
               lambda t: roofline.atan2_halves(t, 8)):
        with pytest.raises(ValueError):
            fn(bad)


def test_twins_count_no_launch():
    before = (roofline.hbm_copy_serial.launches,
              roofline.hbm_copy_double_buffered.launches,
              roofline.atan2_halves.launches)
    x = torch.from_numpy(_normal((2, 64), 3))
    roofline.hbm_copy(x)
    roofline.hbm_copy(x, True)
    roofline.atan2_halves(x, 16)
    assert (roofline.hbm_copy_serial.launches,
            roofline.hbm_copy_double_buffered.launches,
            roofline.atan2_halves.launches) == before


def test_ring_overlap_arithmetic():
    """Two CTAs, three slabs each: each later slab's load [issue, landed]
    against the store of the slab before it [issue, read]."""
    t = np.zeros((6, 4), np.int64)
    for s in range(6):
        j = s // 2
        base = 100 * j
        t[s] = (base, base + 60, base + 70, base + 90)
    ov = roofline.ring_overlap(t, 2)
    # slab j's load [100j, 100j + 60] against slab j-1's store
    # [100(j-1) + 70, 100(j-1) + 90]: no overlap
    assert ov["slab_pairs"] == 4 and ov["overlap_ns"] == 0
    t[2:, 0] -= 40                # loads issued 40 ns earlier: [60, 160]
    ov = roofline.ring_overlap(t, 2)  # against the store [70, 90]: 20 ns
    assert ov["overlap_ns"] == 4 * 20
    assert ov["load_ns"] == 4 * 100
    assert ov["overlap_share"] == pytest.approx(0.2)


def test_roofline_source_is_built_and_bound():
    """csrc/roofline.cu is among the sources nvcc builds at first use and
    exports every function the wrappers bind; the shipped rings' constants
    in the source are the mirror's (R1 one load ahead, R2 stages - 1),
    and the sweep's instances sit in a measurement build chip_smoke.py
    does not build."""
    assert "roofline" in cudabuild.SOURCES
    src = (cudabuild.CSRC / "roofline.cu").read_text()
    for fn in ("lr_hbm_copy", "lr_hbm_copy_ring_ctas",
               "lr_atan2_halves", "lr_error_string"):
        assert f" {fn}(" in src, fn
    for name, ring in (("R1", roofline.R1), ("R2", roofline.R2)):
        assert (f"k{name}StageKiB = {ring.stage_bytes // 1024}, "
                f"k{name}Stages = {ring.stages}, "
                f"k{name}CtasPerSm = {ring.ctas_per_sm};") in src, name
        assert (f"constexpr bool k{name}EvictFirst = "
                f"{str(ring.evict_first).lower()}, k{name}Dynamic = "
                f"{str(ring.dynamic).lower()};") in src, name
    assert roofline.R1.ahead == 1
    assert roofline.R2.ahead == roofline.R2.stages - 1 >= 2
    assert ("launch_ring<kR1StageKiB, kR1Stages, 1, kR1EvictFirst, "
            "kR1Dynamic>") in src
    assert ("launch_ring<kR2StageKiB, kR2Stages, kR2Stages - 1, "
            "kR2EvictFirst,\n                     kR2Dynamic>") in src
    assert "cp.async.bulk.global.shared::cta.bulk_group" in src
    assert "cp.async.bulk.wait_group.read" in src
    assert "atan2f(" in src
    assert cudabuild.PROBES["roofline_sweep"] == ("roofline",
                                                  ("-DLR_ROOFLINE_SWEEP",))
    smoke = (cudabuild.CSRC.parent.parent / "chip_smoke.py").read_text()
    assert 'cudabuild.build(cudabuild.SOURCES + ("wbfm_parts",))' in smoke


@pytest.mark.parametrize("name", ["bench", "bench_roofline", "bench_blocks",
                                  "bench_scaling", "bench_realtime",
                                  "bench_multihost", "entry",
                                  "dryrun_multichip"])
def test_entry_points_need_a_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    fn = {"bench": bench.run, "bench_roofline": bench_roofline.run,
          "bench_blocks": bench_blocks.run, "bench_scaling": bench_scaling.run,
          "bench_realtime": bench_realtime.run_realtime,
          "bench_multihost": bench_multihost.run, "entry": entry.entry,
          "dryrun_multichip": lambda: entry.dryrun_multichip(8)}[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()


def test_bench_roofline_on_the_cpu_names_its_device():
    """The object's structure at a tiny size; the CPU run names its device
    and reports no power limit (its numbers are no card's)."""
    obj = bench_roofline.run(device="cpu", c=2, t=1 << 14, m=32, pll_n=256,
                             reps=1, bench_chunk=1 << 13, bench_file=1 << 14,
                             resident_s=0.05)
    hw = obj["hardware_measured"]
    assert obj["device"] == hw["device"] == "cpu"
    assert obj["power_limit_w"] is None
    for key in ("hbm_copy_serial_GBps", "hbm_copy_double_buffered_GBps",
                "hbm_copy_copy__GBps", "tensor_core_bf16_TFLOPs",
                "atan2_GSps"):
        assert hw[key] > 0
    assert hw["hbm_copy_bytes"] == 2 * 2 * (2 << 14) * 4
    names = [r["name"] for r in obj["rows"]]
    assert names[0].startswith("flagship") and names[1].startswith("PLL") \
        and names[2].startswith("file_resident")
    flag = obj["rows"][0]
    assert flag["bytes_per_sample"] == 8.5
    assert flag["fir_flops_per_sample"] == flag["fir_flops_per_output"] / 8
    assert flag["fir_flops_per_output"] == 2 * 3 * 8 * 8 * flag["ksp"]
    assert obj["rows"][2]["h2d_copies"] == 0


# -- the copies' launch plan and ring protocol (the mirror) ------------------

_STAGES = st.sampled_from([64, 256, 16 << 10, 32 << 10, 64 << 10])


@settings(max_examples=60, deadline=None)
@given(stage=_STAGES, slabs=st.integers(0, 40), extra=st.integers(0, 63),
       sms=st.integers(1, 6), per_sm=st.integers(1, 4))
def test_copy_plan_copies_every_byte_once(stage, slabs, extra, sms, per_sm):
    """Every byte of the array lies in exactly one slab's bulk bytes or in
    the tail, every slab on exactly one CTA when they are dealt, and the
    grid is the CTAs an SM times the SMs, no more than the slabs."""
    nbytes = 4 * ((slabs * stage + 4 * extra) // 4)
    ring = roofline.Ring(stage, 2, 1, per_sm, True, False)
    plan = roofline.copy_plan(nbytes, ring, sms)
    n = plan["n_slabs"]
    assert n == -(-nbytes // stage)
    assert plan["grid"] == min(n, per_sm * sms)
    walked = sorted(s for mine in plan["slabs"] for s in mine)
    assert walked == list(range(n))
    for c, mine in enumerate(plan["slabs"]):
        assert mine == [c + j * plan["grid"] for j in range(len(mine))]
    hits = np.zeros(nbytes, np.int64)
    for s, b in enumerate(plan["bytes"]):
        assert b % 16 == 0 and 0 <= b <= stage
        hits[s * stage:s * stage + b] += 1
    hits[plan["tail"].start:plan["tail"].stop] += 1
    assert np.all(hits == 1)
    assert len(plan["tail"]) == nbytes % 16 < 16


def _check_ring(events, ring, nbytes, sms):
    """The invariants of a launch of the ring: in each CTA a stage is
    reloaded only after the store of its last slab has read it and been
    handed back, at most ``ahead`` loads are in flight, a store takes a
    slab only after its load landed, each wait saw the phase the kernel's
    parity names, and the loader ends once; over the grid every slab is
    loaded once and every slab with bulk bytes stored once.  Returns the
    most loads a CTA had in flight."""
    n = ring.stages
    plan = roofline.copy_plan(nbytes, ring, sms)
    grid, total, bulk = plan["grid"], plan["n_slabs"], plan["bytes"]
    most = 0
    loaded, stored = [], []
    for cta in range(grid):
        mine = [s for c, kind, _, s, _, _ in events
                if c == cta and kind == "load"]
        if not ring.dynamic:
            assert mine == plan["slabs"][cta]
        seen, in_flight = {}, 0
        for i, (c, kind, j, s, stage, phase) in enumerate(events):
            if c != cta or kind == "reset":
                continue
            assert stage == j % n
            seen.setdefault((kind, j), i)
            if kind == "end":
                assert j == len(mine) and s == -1
                continue
            assert s == mine[j]
            has = bulk[s] > 0
            if kind == "load":
                if j >= n:
                    prev = j - n
                    assert ("handback", prev) in seen
                    if bulk[mine[prev]]:
                        assert ("read", prev) in seen
                    assert phase == j // n      # empty: handbacks so far
                in_flight += has
                most = max(most, in_flight)
            elif kind == "land":
                in_flight -= 1
            elif kind == "acquire":
                assert phase == j // n + 1      # full: this use's phase
                if has:
                    assert ("land", j) in seen
            elif kind == "store":
                assert ("acquire", j) in seen
                stored.append(s)
            elif kind == "read":
                assert ("store", j) in seen
            elif kind == "handback":
                if has:
                    assert ("read", j) in seen
                assert phase == j // n
        assert sum(1 for e in events if e[0] == cta and e[1] == "end") == 1
        assert mine[:1] == [cta]               # the first slab is the CTA's
        loaded += mine
    assert sorted(loaded) == list(range(total))
    resets = [i for i, e in enumerate(events) if e[1] == "reset"]
    if ring.dynamic:                           # once, after every end
        ends = [i for i, e in enumerate(events) if e[1] == "end"]
        assert len(resets) == 1 and resets[0] > max(ends)
        # the claims: a slab each past the CTAs' first, one past the end
        # each CTA
        assert events[resets[0]][3] == (total - grid) + grid
    else:
        assert not resets
    assert sorted(stored) == [s for s in range(total) if bulk[s]]
    assert most <= ring.ahead
    return most


@settings(max_examples=80, deadline=None)
@given(stage=st.sampled_from([64, 256, 16 << 10]), stages=st.integers(2, 6),
       ahead_frac=st.floats(0, 1), slabs=st.integers(1, 30),
       extra=st.integers(0, 15), sms=st.integers(1, 5),
       dynamic=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_ring_protocol_holds_in_any_order(stage, stages, ahead_frac, slabs,
                                          extra, sms, dynamic, seed):
    """The mirror of the loaders and storers over any (stage size, stages,
    loads ahead), slabs dealt or claimed, and any order of the
    asynchronous completions: no stage is reloaded before its store has
    read it, no more loads are in flight than the ring allows, every slab
    is copied once, and the ring never deadlocks."""
    ahead = 1 + int(ahead_frac * (stages - 2))
    ring = roofline.Ring(stage, stages, ahead, 1, True, dynamic)
    nbytes = 4 * ((slabs * stage - 4 * extra) // 4)
    _check_ring(roofline.simulate_ring(nbytes, ring, sms, seed), ring,
                nbytes, sms)


@settings(max_examples=40, deadline=None)
@given(slabs=st.integers(1, 40), seed=st.integers(0, 2 ** 16))
def test_r1_never_has_two_loads_in_flight(slabs, seed):
    """R1's shipped ring (one load ahead) has one load in flight a CTA at
    most, R2's up to its stages - 1, over a random order of completions."""
    for ring in (roofline.R1, roofline.R2):
        nbytes = slabs * ring.stage_bytes - 8
        most = _check_ring(roofline.simulate_ring(nbytes, ring, 1, seed),
                           ring, nbytes, 1)
        assert most <= ring.ahead
        if ring is roofline.R1:
            assert most == 1


def test_ring_fills_r2_and_keeps_r1_serial():
    """On one CTA, R2 reaches its stages - 1 loads in flight in some order
    of completions and R1 never more than one."""
    for ring in (roofline.R1, roofline.R2):
        one = dataclasses.replace(ring, ctas_per_sm=1)
        nbytes = 20 * ring.stage_bytes
        most = max(_check_ring(roofline.simulate_ring(nbytes, one, 1, seed),
                               one, nbytes, 1) for seed in range(20))
        assert most == ring.ahead


@pytest.mark.parametrize("stages", [2, 3, 4, 6])
def test_stage_use_is_the_kernels_formula(stages):
    """The mirror's stage and parities are the kernel's expressions, and
    the source waits with those expressions."""
    for j in range(5 * stages):
        st_, full, empty = roofline.stage_use(j, stages)
        assert st_ == j % stages
        assert full == (j // stages) & 1
        assert empty == (None if j < stages else (j // stages - 1) & 1)
    src = (cudabuild.CSRC / "roofline.cu").read_text()
    assert "mbar_wait(full + stage, static_cast<uint32_t>((j / kStages) & 1))" \
        in src
    assert ("mbar_wait(empty + stage, static_cast<uint32_t>((j / kStages "
            "- 1) & 1))") in src
    assert "constexpr int kLag = kStages - kAhead - 1;" in src


@pytest.mark.parametrize("ring", ["R1", "R2"])
@pytest.mark.parametrize("per_sm", [1, 2, 4])
def test_edge_shapes_reach_the_schedule_edges(ring, per_sm):
    """Each edge shape reaches the edge it is named for on the grid it is
    made for."""
    r = getattr(roofline, ring)
    grid = per_sm * roofline.SMS
    for name, (c, w) in roofline.edge_shapes(r, grid).items():
        assert w % 2 == 0
        nbytes = 4 * c * w
        plan = roofline.copy_plan(nbytes, dataclasses.replace(
            r, ctas_per_sm=per_sm))
        n, last = plan["n_slabs"], plan["bytes"][-1]
        assert {"fewer slabs than CTAs": 1 < n < grid,
                "slabs no multiple of the grid": n > grid and n % grid,
                "partial last slab": n > grid and 0 < last < r.stage_bytes,
                "bytes no multiple of 16": nbytes % 16 and last == 16,
                "last slab under 16 bytes": nbytes % 16 and last == 0,
                "single slab": n == 1 and nbytes % 16 == 0,
                "tail alone": n == 1 and last == 0}[name], name


def test_ring_overlap_counts_any_store_of_the_cta():
    """One CTA: load j [100j, 100j + 60] and its store [100j + 70, 100j +
    140]; the load overlaps the store of the slab before for 40 ns.  With
    the stores reading 100 ns longer, the stores of the two slabs before
    both cover parts of each load: their union counts, each nanosecond
    once."""
    t = np.zeros((4, 4), np.int64)
    for j in range(4):
        t[j] = (100 * j, 100 * j + 60, 100 * j + 70, 100 * j + 140)
    ov = roofline.ring_overlap(t, 1)
    assert ov == {"load_ns": 180, "overlap_ns": 120,
                  "overlap_share": pytest.approx(2 / 3), "slab_pairs": 3}
    t[:, 3] += 100
    # store j-1 [100j - 30, 100j + 140] covers the load; store j-2
    # [100j - 130, 100j + 40] adds nothing new
    assert roofline.ring_overlap(t, 1)["overlap_ns"] == 3 * 60
    t[0, 3] = 0                    # slab 0's store not recorded
    ov = roofline.ring_overlap(t, 1)
    assert ov["slab_pairs"] == 2 and ov["load_ns"] == 120


def test_ring_overlap_reads_the_recorded_cta():
    """A trace with a fifth column (the CTA, as the kernel records it)
    groups slabs by it, each CTA's in the order its loads were issued,
    whatever the slab numbers."""
    four = np.zeros((6, 4), np.int64)
    for s in range(6):
        base = 100 * (s // 2)
        four[s] = (base, base + 60, base + 70, base + 90)
    four[2:, 0] -= 40
    five = np.zeros((6, 5), np.int64)
    five[:, :4] = four[[1, 0, 3, 2, 5, 4]]  # CTA 1's slabs first
    five[:, 4] = [1, 0, 1, 0, 1, 0]
    assert roofline.ring_overlap(five, 2) == roofline.ring_overlap(four, 2)
    shuffled = five[[4, 1, 2, 5, 0, 3]]
    assert roofline.ring_overlap(shuffled, 2) == roofline.ring_overlap(
        four, 2)


def test_ring_overlap_counts_overlapping_stores_once():
    """Two stores in flight over the same span of a load count once, and
    a store that ended before a load counts nothing."""
    t = np.array([[0, 10, 10, 200],       # store 0 in flight to 200
                  [20, 100, 110, 150],    # load 1 [20, 100]: store 0 all of it
                  [120, 300, 305, 310]],  # load 2 [120, 300]: 0 to 200,
                 np.int64)                # 1 to 150, union 80
    ov = roofline.ring_overlap(t, 1)
    assert ov["overlap_ns"] == 80 + 80
    assert ov["load_ns"] == 80 + 180 and ov["slab_pairs"] == 2


def test_bench_roofline_keys_are_unchanged():
    """Timing the copies and atan2 back to back leaves the object's keys
    as they were."""
    obj = bench_roofline.run(device="cpu", c=2, t=1 << 14, m=16, pll_n=128,
                             reps=1, bench_chunk=1 << 12,
                             bench_file=1 << 13, resident_s=0.02)
    assert sorted(obj) == ["device", "hardware_measured", "method",
                           "power_limit_w", "rows"]
    hw = obj["hardware_measured"]
    assert sorted(hw) == [
        "atan2_GSps", "device", "hbm_copy_bytes", "hbm_copy_copy__GBps",
        "hbm_copy_double_buffered_GBps", "hbm_copy_serial_GBps", "ms",
        "power_limit_w", "tensor_core_bf16_TFLOPs", "tensor_core_bf16_types"]
    assert sorted(hw["ms"]) == ["atan2", "copy_", "hbm_copy_double_buffered",
                                "hbm_copy_serial", "matmul_bf16"]
    assert sorted(obj["rows"][0]) == [
        "binding_resource", "byte_roofline_GSps_at_R2",
        "byte_roofline_GSps_at_sheet", "bytes_per_sample", "decimation",
        "direct_fir_flops_per_sample_one_pass", "fir_flops_per_output",
        "fir_flops_per_sample", "fraction_of_R2_byte_roofline",
        "fraction_of_sheet_byte_roofline", "ksp", "measured_GSps", "ms",
        "name", "nt", "shape", "taps", "tf32_roofline_GSps_at_sheet"]
    assert sorted(obj["rows"][1]) == ["MSps", "binding_resource", "ms", "n",
                                      "name", "params"]


@pytest.mark.parametrize("n", [1, 5])
def test_batch_ms_times_back_to_back_calls(n):
    """common.batch_ms calls the function n times after its warm-up and
    returns the time over n (the host clock on the CPU)."""
    calls = []
    ms = common.batch_ms(lambda: calls.append(1), torch.device("cpu"), n,
                         warmup=2)
    assert len(calls) == n + 2 and ms >= 0
