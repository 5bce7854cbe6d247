"""The bench graphs' sources of the port: ZeroSource against the JAX
package's, UniformRandomSource against the properties its users rely on
(a seed's stream is reproducible, values lie in range, the distribution is
uniform, chunks continue the stream), and IQFileSource's device-resident
ring against the streamed path and the JAX package's resident run."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu_torch.blocks.sources import files as port_files  # noqa: E402
from luaradio_tpu_torch.core.runtime import Runner  # noqa: E402


def _generate(mod, src, lengths):
    if mod is tl:
        src.device = torch.device("cpu")
    src.differentiate([])
    src.initialize()
    st, ys = src.init_state(), []
    for n in lengths:
        st, y = src.generate(st, n)
        ys.append(np.asarray(y))
    return ys


@pytest.mark.parametrize("kind", ["ComplexFloat32", "Float32", "Byte",
                                  "Bit"])
def test_zero_source_matches_jax(kind):
    got = _generate(tl, tl.ZeroSource(getattr(tl, kind), 1e3), [1000, 24])
    exp = _generate(jl, jl.ZeroSource(getattr(jl, kind), 1e3), [1000, 24])
    for g, e in zip(got, exp):
        assert g.dtype == e.dtype and g.shape == e.shape
        assert np.array_equal(g, e)
    assert tl.NullSource is tl.ZeroSource


def _random(kind, seed=None, lengths=(4096,), range=None):
    src = tl.UniformRandomSource(getattr(tl, kind), 1e3, range=range,
                                 seed=seed)
    return _generate(tl, src, lengths)


KINDS = {  # kind -> (dtype, default low, default high, continuous)
    "ComplexFloat32": (np.complex64, -1.0, 1.0, True),
    "Float32": (np.float32, -1.0, 1.0, True),
    "Byte": (np.uint8, 0, 255, False),
    "Bit": (np.uint8, 0, 1, False),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_uniform_random_is_reproducible_for_a_seed(kind):
    a = _random(kind, seed=5, lengths=(1000, 3000))
    b = _random(kind, seed=5, lengths=(1000, 3000))
    c = _random(kind, seed=6, lengths=(1000, 3000))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])
    # the state is carried: the second chunk continues the stream
    assert not np.array_equal(a[0], a[1][:1000])
    assert np.array_equal(_random(kind, lengths=(10,))[0],
                          _random(kind, seed=0, lengths=(10,))[0])


def _parts(y):
    return [y.real, y.imag] if np.iscomplexobj(y) else [y]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_uniform_random_is_in_range_and_uniform(kind):
    """Every value in range (continuous: [a, b); integer: [a, b]); over
    2^20 samples the mean and variance of each part within 5 sigma of the
    uniform distribution's, and every integer value drawn."""
    dtype, lo, hi, continuous = KINDS[kind]
    n = 1 << 20
    y = _random(kind, seed=1, lengths=(n,))[0]
    assert y.dtype == dtype and y.shape == (n,)
    for v in _parts(y):
        v = v.astype(np.float64)
        if continuous:
            assert v.min() >= lo and v.max() < hi
            mean, var = (lo + hi) / 2, (hi - lo) ** 2 / 12
            m4 = (hi - lo) ** 4 / 80
        else:
            assert v.min() >= lo and v.max() <= hi
            assert len(np.unique(v)) == hi - lo + 1
            k = np.arange(lo, hi + 1, dtype=np.float64)
            mean = k.mean()
            var = ((k - mean) ** 2).mean()
            m4 = ((k - mean) ** 4).mean()
        assert abs(v.mean() - mean) < 5 * np.sqrt(var / n)
        # the sample variance is centred on the sample mean: its second
        # moment's 5 sigma, plus the squared 5 sigma of the mean
        assert abs(v.var() - var) < 5 * np.sqrt((m4 - var ** 2) / n) \
            + 25 * var / n


@pytest.mark.parametrize("kind,rng", [("Float32", (2.0, 3.5)),
                                      ("ComplexFloat32", (-0.25, 0.0)),
                                      ("Byte", (10, 20))])
def test_uniform_random_takes_a_range(kind, rng):
    y = _random(kind, seed=2, lengths=(1 << 16,), range=rng)[0]
    for v in _parts(y):
        assert v.min() >= rng[0]
        assert v.max() < rng[1] if KINDS[kind][3] else v.max() <= rng[1]
    with pytest.raises(ValueError, match="unsupported data type"):
        tl.UniformRandomSource(tl.types.object_type("X"), 1e3)


# -- the device-resident ring -------------------------------------------------

CHUNK = 1000


def _write(tmp_path, fmt, n):
    """A capture of n samples (n not a multiple of the chunk) in ``fmt``."""
    rng = np.random.default_rng(n)
    z = (0.8 * np.exp(2j * np.pi * rng.random(n))).astype(np.complex64)
    path = str(tmp_path / f"cap.{fmt}")
    if fmt == "u8":
        np.clip(np.round(z.view(np.float32) * 127.5 + 127.5), 0,
                255).astype(np.uint8).tofile(path)
    else:
        z.view(np.float32).tofile(path)
    return path


def _ring_graph(mod, path, fmt, resident, chunks):
    """Repeating IQ file -> ComplexConjugate (an exact device block) ->
    collector, for ``chunks`` chunks of CHUNK; returns (samples, runner)."""
    class Collect(mod.SinkBlock):
        def __init__(self):
            super().__init__()
            self.got = []
            self.add_type_signature([mod.Input("in", mod.ComplexFloat32)],
                                    [])

        def process(self, x):
            self.got.append(np.array(x))
    top = mod.CompositeBlock()
    sink = Collect()
    top.connect(mod.IQFileSource(path, fmt, 1e6, repeat_on_eof=True,
                                 resident=resident),
                mod.ComplexConjugateBlock(), sink)
    if mod is jl:
        top.run(chunk_size=CHUNK, max_chunks=chunks)
        return np.concatenate(sink.got), None
    runner = Runner(top, chunk_size=CHUNK, device="cpu")
    runner.run(max_chunks=chunks)
    return np.concatenate(sink.got), runner


@pytest.mark.parametrize("fmt,n", [("u8", 2347), ("f32le", 1618)])
def test_resident_ring_equals_streamed(tmp_path, fmt, n):
    """Over several wraps of a file whose length does not divide the
    chunk: the resident graph equals the streamed one exactly and makes no
    host-to-device copy; both agree with the JAX package's resident run
    within 1.2e-7 (the JAX package's jitted u8 conversion lands one
    float32 ulp off its host path, ROADMAP queue 3)."""
    path = _write(tmp_path, fmt, n)
    chunks = 3 * n // CHUNK + 2
    res, rrun = _ring_graph(tl, path, fmt, None, chunks)
    stream, srun = _ring_graph(tl, path, fmt, False, chunks)
    assert res.shape == stream.shape == (chunks * CHUNK,)
    assert np.array_equal(res, stream)
    assert rrun._resident_srcs and not srun._resident_srcs
    assert rrun.h2d_copies == 0 and srun.h2d_copies == chunks
    exp, _ = _ring_graph(jl, path, fmt, True, chunks)
    assert exp.shape == res.shape
    assert np.max(np.abs(res - exp)) <= 1.2e-7
    # the ring repeats the file: sample i is sample i mod n
    assert np.array_equal(res[n:2 * n], res[:n])


def test_resident_read_is_a_view(tmp_path):
    path = _write(tmp_path, "f32le", 2500)
    src = tl.IQFileSource(path, "f32le", 1e6, repeat_on_eof=True)
    src.device = torch.device("cpu")
    src.differentiate([])
    assert src.resident_setup(CHUNK)
    ring = src._res_buf
    assert ring.shape == (2500 + CHUNK,)
    for _ in range(7):
        w = src.resident_read(CHUNK)
        assert w.shape == (CHUNK,)
        assert w.untyped_storage().data_ptr() == \
            ring.untyped_storage().data_ptr()
    src.cleanup()


def test_resident_eligibility(tmp_path, monkeypatch):
    """No ring without repeat_on_eof or with resident=False; the size gate
    refuses a file over the budget before decoding it; resident=True on a
    source that cannot have the ring raises."""
    path = _write(tmp_path, "u8", 3000)

    def src(**kw):
        s = tl.IQFileSource(path, "u8", 1e6, **kw)
        s.device = torch.device("cpu")
        s.differentiate([])
        return s
    assert not src().resident_setup(CHUNK)
    assert not src(repeat_on_eof=True, resident=False).resident_setup(CHUNK)
    monkeypatch.setattr(port_files, "RESIDENT_BUDGET", 2 * 3000 - 1)

    def no_decode(self):
        raise AssertionError("decoded a file over the budget")
    monkeypatch.setattr(tl.IQFileSource, "_decode_all", no_decode)
    assert not src(repeat_on_eof=True).resident_setup(CHUNK)
    with pytest.raises(ValueError, match="resident=True"):
        _ring_graph(tl, path, "u8", True, 2)
    monkeypatch.undo()
    # within the budget it is taken; feeding a host block it is not
    assert src(repeat_on_eof=True).resident_setup(CHUNK)
    top = tl.CompositeBlock()
    top.connect(tl.IQFileSource(path, "u8", 1e6, repeat_on_eof=True),
                tl.IQFileSink(str(tmp_path / "out.iq"), "f32le"))
    runner = Runner(top, chunk_size=CHUNK, device="cpu")
    runner.run(max_chunks=2)
    assert not runner._resident_srcs
