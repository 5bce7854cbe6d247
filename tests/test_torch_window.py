"""The windowed gather S8 (luaradio_tpu_torch/ops/window.py) against the
TPU body of scratch/pallas_dma_test.py, its refusals and its entry point
(benchmarks/dma_window.py) on the CPU.

The scratch scripts run TPU code (or set the JAX cache) when imported, so
:func:`load_scratch` (also used by tests/test_torch_pll_ablate.py and
tests/test_torch_wbfm_proto.py) takes only their imports, definitions and
constant assignments through ``ast``; the tests then call the bodies with
``pallas_call(..., interpret=True)``.  S8's body reads its module globals
``head`` and ``tile``, which each case sets; the call is the script's
(:43-53) at the case's shape.  The twin must equal JAX exactly."""

import ast
import functools
import pathlib
import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from luaradio_tpu_torch.benchmarks import dma_window  # noqa: E402
from luaradio_tpu_torch.ops import cudabuild, window  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def load_scratch(name: str) -> types.ModuleType:
    """scratch/<name>.py's imports, functions and constant assignments (no
    call on the right), without ``jax.config.update`` or any other
    statement, as a module whose ``pl.pallas_call`` interprets."""
    path = ROOT / "scratch" / f"{name}.py"
    tree = ast.parse(path.read_text())
    keep = [node for node in tree.body
            if isinstance(node, (ast.Import, ast.ImportFrom,
                                 ast.FunctionDef))
            or (isinstance(node, ast.Assign) and not any(
                isinstance(n, ast.Call) for n in ast.walk(node.value)))]
    mod = types.ModuleType(f"scratch_{name}")
    mod.__file__ = str(path)
    exec(compile(ast.Module(body=keep, type_ignores=[]), str(path), "exec"),
         mod.__dict__)
    mod.pl = types.SimpleNamespace(
        **{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    mod.pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    return mod


def _tpu_gather(x: np.ndarray, carry: np.ndarray, tile: int) -> np.ndarray:
    """scratch/pallas_dma_test.py's pallas_call (:43-53) at x's shape."""
    m = load_scratch("pallas_dma_test")
    c, head = carry.shape
    m.head, m.tile = head, tile
    nt = x.shape[1] // (2 * tile)
    out = m.pl.pallas_call(
        m._kernel, grid=(nt,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((c, head + 2 * tile), lambda i: (0, i),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((c, nt * (head + 2 * tile)),
                                       jnp.float32),
        scratch_shapes=[pltpu.VMEM((c, head + 2 * tile), jnp.float32),
                        pltpu.SemaphoreType.DMA],
    )(jnp.asarray(x), jnp.asarray(carry))
    return np.asarray(out)


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_loader_keeps_the_bodies_and_drops_the_runs():
    m = load_scratch("pallas_dma_test")
    assert (m.C, m.head, m.tile, m.NT) == (8, 512, 8192, 4)
    assert callable(m._kernel)
    assert not hasattr(m, "out") and not hasattr(m, "x")


@pytest.mark.parametrize("c,head,tile,nt", [(2, 512, 1024, 3),
                                            (3, 256, 512, 2),
                                            (1, 128, 256, 5)])
def test_twin_equals_the_tpu_body(c, head, tile, nt):
    x = _normal((c, 2 * tile * nt), 1)
    carry = _normal((c, head), 2)
    exp = _tpu_gather(x, carry, tile)
    got = window.window_gather(torch.from_numpy(x), torch.from_numpy(carry),
                               tile).numpy()
    assert got.shape == exp.shape == (c, nt * (head + 2 * tile))
    assert np.array_equal(got.view(np.uint32), exp.view(np.uint32))


def test_twin_is_the_unfold_of_the_stream():
    """Window i = [carry | x][2 tile i : 2 tile i + W], also where the
    halo is longer than a tile (it then reaches into the carry)."""
    x, carry = _normal((2, 4 * 3), 3), _normal((2, 10), 4)
    got = window.window_gather(torch.from_numpy(x), torch.from_numpy(carry),
                               2).numpy()
    xc = np.concatenate([carry, x], 1)
    w = 10 + 4
    for i in range(3):
        assert np.array_equal(got[:, i * w:(i + 1) * w],
                              xc[:, 4 * i:4 * i + w])


@pytest.mark.parametrize("case", ["float64", "1-d", "non-contiguous",
                                  "rows differ", "tile not dividing",
                                  "zero tile", "meta device"])
def test_wrapper_raises(case):
    x, carry = torch.zeros((2, 16)), torch.zeros((2, 4))
    args = {"float64": (x.double(), carry, 4),
            "1-d": (torch.zeros(16), carry, 4),
            "non-contiguous": (torch.zeros((16, 2)).t(), carry, 4),
            "rows differ": (x, torch.zeros((3, 4)), 4),
            "tile not dividing": (x, carry, 3),
            "zero tile": (x, carry, 0),
            "meta device": (torch.zeros((2, 16), device="meta"),
                            torch.zeros((2, 4), device="meta"), 4)}[case]
    with pytest.raises(ValueError):
        window.window_gather(*args)


def test_twin_counts_no_launch():
    before = window.window_gather.launches
    window.window_gather(torch.zeros((1, 8)), torch.zeros((1, 2)), 2)
    assert window.window_gather.launches == before


def test_source_is_built_and_bound():
    assert "window" in cudabuild.SOURCES
    src = (cudabuild.CSRC / "window.cu").read_text()
    assert " lr_window_gather(" in src and " lr_error_string(" in src
    assert '#include "window.cuh"' in src
    assert '#include "window.cuh"' in (cudabuild.CSRC /
                                       "wbfm_proto.cu").read_text()


def test_entry_point_prints_the_scripts_lines_on_the_cpu():
    lines = []
    rec = dma_window.run("cpu", c=2, head=512, tile=1024, nt=3,
                         flagship_nt=6, reps=1, emit=lines.append)
    assert rec["ok"] and rec["device"] == "cpu"
    assert rec["power_limit_w"] is None
    assert lines[:3] == [f"tile {i}: head err per ch [0. 0.]  body err max "
                         f"0.0e+00" for i in range(3)]
    assert lines[3] == "OK" and lines[-1] == "OK"
    flag = rec["flagship"]
    assert flag["bytes"] == 4 * (2 * 2 * 1024 * 6 + 2 * 512
                                 + 2 * 6 * (512 + 2048))
    assert flag["ms"] > 0 and flag["library_ms"] > 0
    assert "r2_GBps" not in flag               # the card's rate only


def test_entry_point_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dma_window.run()
