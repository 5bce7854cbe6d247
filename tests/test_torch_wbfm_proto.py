"""The flagship kernel taken apart, S4 (luaradio_tpu_torch/ops/
wbfm_proto.py), against the TPU body of scratch/wbfm_proto.py, its
refusals and its entry point (benchmarks/wbfm_proto.py) on the CPU.

``make_proto`` is loaded by tests/test_torch_window.py's ``load_scratch``
(its ``pl.pallas_call`` interprets) and run at C = 2, T = 4096, tile
1024 on the script's taps (120 Hann-windowed sinc + 8 zeros), D = 8, a
random carry.  Bounds:
* the FIR stages at every precision JAX computes as the TPU does
  (highest, sel3, sel3cat, sel2, split22, two, two_hi): 2e-5 * scale,
  the reference's tolerance (the runs: 1.9e-7 at fp32, up to 1.6e-6
  where a bf16 split of m rounds on either side of a boundary because
  atan2f and the body's ``_atan2`` differ by an ulp);
* ``dma_only`` and ``deint_only``: bit for bit (a copy, and one sum of
  the same rounded floats);
* ``no_fir``: 5e-7 rad, the bound of atan2f against ``_atan2``
  (tests/test_torch_roofline.py);
* ``default``: JAX on the CPU computes Precision.DEFAULT in fp32 where
  the TPU takes one bf16 pass, and the port keeps the TPU's meaning; so
  it is held at 2e-5 * scale against the body with its ``split3_dot``
  given the TPU's meaning of ``default`` (one bf16 pass of both
  operands), and the JAX CPU run is shown to differ."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from luaradio_tpu_torch.benchmarks import wbfm_proto as bench  # noqa: E402
from luaradio_tpu_torch.ops import cudabuild, wbfm_proto  # noqa: E402
from tests.test_torch_window import load_scratch  # noqa: E402

C, T, TILE, D = 2, 4096, 1024, 8
TOL, ATAN2_TOL = 2e-5, 5e-7


def _body():
    return load_scratch("wbfm_proto")


def _inputs(k=128, seed=0, t=T):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, 2 * t)).astype(np.float32)
    carry = rng.standard_normal((C, 2 * k)).astype(np.float32)
    taps = bench.proto_taps() if k == 128 else rng.standard_normal(
        k).astype(np.float32) / k
    return x, carry, taps


def _tpu(m, x, carry, taps, tile=TILE, block=128, deint="highest",
         fir="highest", stage="full", inv_gain=1.0, d=D):
    f = m.make_proto(taps, d, inv_gain, tile=tile, block=block,
                     deint_prec=deint, fir_prec=fir, stage=stage)
    new_carry, out = f(jnp.asarray(carry), jnp.asarray(x))
    return np.asarray(new_carry), np.asarray(out)


def _port(x, carry, taps, tile=TILE, block=128, deint="highest",
          fir="highest", stage="full", inv_gain=1.0, d=D):
    new_carry, out = wbfm_proto.wbfm_proto(
        torch.from_numpy(carry), torch.from_numpy(x), torch.from_numpy(taps),
        d, inv_gain, tile, block, deint, fir, stage)
    return new_carry.numpy(), out.numpy()


def _scaled_err(got, exp):
    return float(np.max(np.abs(got - exp))) / max(1.0, float(
        np.max(np.abs(exp))))


@pytest.mark.parametrize("deint,fir", [
    ("highest", "highest"), ("sel3", "split22"), ("sel3cat", "two"),
    ("sel3", "two"), ("sel3cat", "split22"), ("sel3", "sel3"),
    ("sel3cat", "sel3cat"), ("sel2", "sel2"), ("split22", "split22"),
    ("highest", "two_hi")])
def test_full_matches_the_tpu_body(deint, fir):
    x, carry, taps = _inputs()
    jc, jo = _tpu(_body(), x, carry, taps, deint=deint, fir=fir,
                  inv_gain=0.7)
    pc, po = _port(x, carry, taps, deint=deint, fir=fir, inv_gain=0.7)
    assert po.shape == jo.shape == (C, T // D)
    assert np.array_equal(pc, jc)
    assert _scaled_err(po, jo) <= TOL


@pytest.mark.parametrize("stage,deint", [
    ("dma_only", "highest"), ("deint_only", "highest"),
    ("deint_only", "sel3"), ("deint_only", "sel2"), ("no_fir", "sel3cat"),
    ("no_deint", "highest")])
def test_stages_match_the_tpu_body(stage, deint):
    x, carry, taps = _inputs(seed=1)
    _, jo = _tpu(_body(), x, carry, taps, deint=deint, fir="two",
                 stage=stage)
    _, po = _port(x, carry, taps, deint=deint, fir="two", stage=stage)
    assert po.shape == jo.shape == (C, T // D)
    if stage in ("dma_only", "deint_only"):
        assert np.array_equal(po.view(np.uint32), jo.view(np.uint32))
    elif stage == "no_fir":
        assert np.max(np.abs(po - jo)) <= ATAN2_TOL
    else:
        assert _scaled_err(po, jo) <= TOL


def test_default_matches_the_body_with_the_tpus_meaning():
    m = _body()
    x, carry, taps = _inputs(seed=2)
    _, cpu_default = _tpu(m, x, carry, taps, deint="default", fir="default")
    split3_dot = m.split3_dot

    def tpu_default(a, s, prec):
        if prec == "default":                     # one bf16 pass
            return jax.lax.dot_general(
                a.astype(jnp.bfloat16), s.astype(jnp.bfloat16),
                dimension_numbers=(((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
        return split3_dot(a, s, prec)
    m.split3_dot = tpu_default
    _, jo = _tpu(m, x, carry, taps, deint="default", fir="default")
    _, po = _port(x, carry, taps, deint="default", fir="default")
    assert _scaled_err(po, jo) <= TOL
    assert _scaled_err(po, cpu_default) > 100 * TOL
    _, jo = _tpu(m, x, carry, taps, deint="default", stage="deint_only")
    _, po = _port(x, carry, taps, deint="default", stage="deint_only")
    assert np.array_equal(po.view(np.uint32), jo.view(np.uint32))


def test_chained_calls_equal_one_call():
    """The carry a call returns continues the stream: two chunks of T
    equal one of 2T, for every stage."""
    x, carry, taps = _inputs(seed=3, t=2 * T)
    for stage in wbfm_proto.STAGES:
        args = dict(deint="sel3", fir="split22", stage=stage)
        c1, a = _port(np.ascontiguousarray(x[:, :2 * T]), carry, taps,
                      **args)
        _, b = _port(np.ascontiguousarray(x[:, 2 * T:]), c1, taps, **args)
        _, whole = _port(x, carry, taps, **args)
        assert np.array_equal(np.concatenate([a, b], 1), whole), stage


@pytest.mark.parametrize("case", ["unknown precision", "tile vs block",
                                  "taps too long for two",
                                  "window not in rows of 128",
                                  "taps too long for the frame"])
def test_raises_where_make_proto_raises(case):
    """Each case fails in the TPU body (at make_proto or when traced) and
    in the port."""
    kw = {"unknown precision": dict(fir="high"),
          "tile vs block": dict(tile=1536, block=128),
          "taps too long for two": dict(k=256, fir="two", stage="dma_only"),
          "window not in rows of 128": dict(k=100, stage="deint_only"),
          "taps too long for the frame": dict(block=8)}[case]
    x, carry, taps = _inputs(k=kw.pop("k", 128))
    if "tile" in kw:
        x = np.ascontiguousarray(x[:, :2 * 3 * 1536])
    with pytest.raises(Exception):
        _tpu(_body(), x, carry, taps, **kw)
    with pytest.raises(ValueError):
        _port(x, carry, taps, **kw)


@pytest.mark.parametrize("case", ["stage", "T vs tile", "tile vs K",
                                  "float64", "carry shape", "taps 2-D",
                                  "devices differ", "meta device"])
def test_wrapper_raises(case):
    x, carry, taps = (torch.from_numpy(a) for a in _inputs())
    args = [carry, x, taps, D, 1.0, TILE, 128, "highest", "highest", "full"]
    if case == "stage":
        args[9] = "fir_only"
    elif case == "T vs tile":
        args[5] = 3 * 1024
    elif case == "tile vs K":
        args[5] = 64
    elif case == "float64":
        args[1] = x.double()
    elif case == "carry shape":
        args[0] = carry[:, :128].contiguous()
    elif case == "taps 2-D":
        args[2] = taps.reshape(2, 64)
    elif case == "devices differ":
        args[2] = taps.to("meta")
    else:
        args[:3] = [a.to("meta") for a in args[:3]]
    with pytest.raises(ValueError):
        wbfm_proto.wbfm_proto(*args)


def test_twin_counts_no_launch():
    before = wbfm_proto.wbfm_proto.launches
    _port(*_inputs())
    assert wbfm_proto.wbfm_proto.launches == before


def test_source_is_built_and_bound():
    assert "wbfm_proto" in cudabuild.SOURCES
    src = (cudabuild.CSRC / "wbfm_proto.cu").read_text()
    assert " lr_wbfm_proto(" in src and " lr_error_string(" in src
    assert "__float2bfloat16_rn" in src and "atan2f(" in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src


def test_ports_new_modules_import_nothing_from_scratch():
    import ast
    for name in ("ops/window.py", "ops/pll_ablate.py", "ops/wbfm_proto.py",
                 "benchmarks/dma_window.py", "benchmarks/pll_ablate.py",
                 "benchmarks/wbfm_proto.py"):
        tree = ast.parse((cudabuild.CSRC.parent / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            elif isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            else:
                continue
            assert not any(m.split(".")[0] in ("scratch", "jax",
                                               "luaradio_tpu")
                           for m in mods), (name, mods)


def test_entry_point_on_the_cpu_names_its_device():
    rec = bench.run("cpu", c=2, t=8192, tile=1024, reps=1)
    assert rec["device"] == "cpu" and rec["power_limit_w"] is None
    assert rec["prod_GSps"] > 0
    for name, _, _, stage, _ in bench.VARIANTS:
        assert rec[f"{name}_GSps"] > 0
        assert (f"{name}_rel_err" in rec) == (stage == "full")
    for name in ("v2_sel3_fir22", "v3_sel3cat_fir2", "v3_sel3_fir2",
                 "v3_sel3cat_fir22", "v3_sel3cat_fir2_t32k", "p_highest",
                 "p_two_hi"):
        assert rec[f"{name}_rel_err"] <= TOL, name


def test_entry_point_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run()


@pytest.mark.parametrize("k,d,tile,block,deint,fir", [
    (256, 4, 2048, 128, "sel3", "split22"),
    (128, 5, 1280, 128, "sel2", "sel3"),
    (128, 8, 768, 32, "highest", "split22"),
    (128, 8, 2048, 256, "sel3cat", "two")])
def test_other_shapes_match_the_tpu_body(k, d, tile, block, deint, fir):
    """Taps, decimations, tiles and blocks other than the script's: the
    kernel's band for u = K/D of 64 and 26 (5 and 3 k-steps), its
    CUDA-core sum where a CTA's outputs are no multiple of 128 (tile/D =
    96), a block of 256 for the body + tail FIR."""
    rng = np.random.default_rng(k + d + tile)
    t = 3 * tile
    x = rng.standard_normal((C, 2 * t)).astype(np.float32)
    carry = rng.standard_normal((C, 2 * k)).astype(np.float32)
    taps = (rng.standard_normal(k) / k).astype(np.float32)
    _, jo = _tpu(_body(), x, carry, taps, d=d, tile=tile, block=block,
                 deint=deint, fir=fir)
    _, po = _port(x, carry, taps, d=d, tile=tile, block=block, deint=deint,
                  fir=fir)
    assert po.shape == jo.shape == (C, t // d)
    assert _scaled_err(po, jo) <= TOL
