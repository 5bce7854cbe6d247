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

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from luaradio_tpu.ops.pll import _atan2  # noqa: E402
from luaradio_tpu_torch.benchmarks import (bench, bench_blocks,  # noqa: E402
                                           bench_multihost, bench_realtime,
                                           bench_roofline, bench_scaling,
                                           entry)
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
    exports every function the wrappers bind."""
    assert "roofline" in cudabuild.SOURCES
    src = (cudabuild.CSRC / "roofline.cu").read_text()
    for fn in ("lr_hbm_copy", "lr_hbm_copy_ring_ctas",
               "lr_atan2_halves", "lr_error_string"):
        assert f" {fn}(" in src, fn
    assert f"kSlab = {roofline.SLAB // 1024} * 1024" in src
    assert "cp.async.bulk.global.shared::cta.bulk_group" in src
    assert "atan2f(" in src


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
