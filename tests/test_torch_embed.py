"""The C embedding API hosting the port (luaradio_tpu_torch/utils/embed.py):
the host's C compiler builds native/src/embed.c and the port's lifecycle
program (csrc/embed_lifecycle.c) into luaradio_tpu_torch/_build/, and the
program drives a graph of the port on the CPU through the C API: the error
paths (a script that raises, a script with no ``top``, start with no graph),
then start, status running, wait, status stopped and stop on a finite
graph, start and stop on an endless one.  The finite graph's output must
equal the same graph run from Python."""

import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu_torch.utils import embed  # noqa: E402


@pytest.fixture(scope="module")
def built():
    if shutil.which("cc") is None and shutil.which("gcc") is None:
        pytest.skip("no C compiler on this machine")
    return embed.build()


def test_build_is_keyed_and_reused(built):
    lib, prog = built
    assert lib.exists() and prog.exists()
    assert lib.parent == embed.BUILD_DIR
    assert embed.paths() == (lib, prog)
    mtime = lib.stat().st_mtime_ns
    assert embed.build() == (lib, prog)
    assert lib.stat().st_mtime_ns == mtime       # not built again


def test_lifecycle_on_the_cpu_through_the_c_api(built, tmp_path):
    out = tmp_path / "audio.f32"
    r = embed.run_lifecycle("cpu", str(out), timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.splitlines()
    assert lines[0] == f"version: {tl.version}"
    assert "running: 1" in lines and "running after wait: 0" in lines
    assert "running after stop: 0" in lines
    assert lines[-1] == "embed API lifecycle OK"

    # the same graph run from Python on the same capture
    ref = tmp_path / "ref.f32"
    top = tl.CompositeBlock()
    top.connect(tl.IQFileSource(f"{out}.iq", "f32le", 1e6),
                tl.FrequencyDiscriminatorBlock(1.25),
                tl.LowpassFilterBlock(64, 1e5), tl.DownsamplerBlock(4),
                tl.RealFileSink(str(ref), "f32le"))
    top.run(device="cpu")
    got = np.fromfile(out, np.float32)
    assert got.shape == ((1 << 20) // 4,)
    assert np.array_equal(got, np.fromfile(ref, np.float32))
    # a constant 0.05 rad/sample: 0.05 / (2 pi 1.25) after the filter
    assert abs(float(np.median(got)) - 0.05 / (2 * np.pi * 1.25)) < 1e-4


def test_lifecycle_rejects_a_bad_device(built, tmp_path):
    """A graph that cannot start (an unknown device) surfaces its error
    through the C API: the program exits non-zero naming the step."""
    r = embed.run_lifecycle("nodevice", str(tmp_path / "x.f32"),
                            timeout=240)
    assert r.returncode == 1
    assert "FAIL" in r.stderr and "nodevice" in r.stderr
