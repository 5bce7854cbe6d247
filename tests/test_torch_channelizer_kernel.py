"""The channelizer kernel's CPU side (ops/channelizer.py, csrc/channelizer.cu):
the twin that the CPU path runs against the JAX ChannelizerBlock at the
band's (100, 16), the bank's (64, 8) and small shapes, chunk by chunk with
the state carried (one chunk ragged and shorter than C q) and over a batch
of 3 rows; the kernel's DFT factorisation and tables, in the kernel's
order of stages, against the definition; its plan, ``fits`` and shared
memory at the band's and the bank example's shapes; planted faults
reading false; the wrapper's checks.  The kernel itself runs only on a
card (tests/test_torch_channelizer_cuda.py).

Tolerances: 1e-5 of the output's scale against JAX (float32 sums in
another order, as tests/test_torch_bank.py); the factorised DFT within
2e-6 of the float64 definition's scale (its tables are float32).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import luaradio_tpu as jl  # noqa: E402
import luaradio_tpu_torch as tl  # noqa: E402
from luaradio_tpu_torch.ops import channelizer  # noqa: E402

SHAPES = [(100, 16), (64, 8), (8, 16), (7, 4), (2, 8)]
TOL = 1e-5


def _block(mod, c, q):
    b = mod.ChannelizerBlock(c, q)
    if mod is tl:
        b.device = torch.device("cpu")
    b.differentiate([mod.ComplexFloat32])
    b.input_rate = 1e6
    b.initialize()
    return b


def _noise(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def _gap(got, exp):
    """Largest deviation over the reference's scale."""
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape, (got.shape, exp.shape)
    return float(np.abs(got.astype(np.complex128) - exp).max()
                 / max(1e-30, float(np.abs(exp).max())))


def _chunks(c, q):
    """Three chunks: whole outputs, a ragged one shorter than C q, and
    whole again."""
    return (c * 40, c * q // 2 + 3, c * 37)


def _run_twin(c, q, x, state, plant=None):
    branch = _block(tl, c, q)._branch
    st, out = torch.from_numpy(state), []
    for part in np.split(x, np.cumsum(_chunks(c, q))[:-1], axis=-1):
        if plant == "zeroed":
            st = torch.zeros_like(st)
        st, y = channelizer.channelize(
            st, torch.from_numpy(np.ascontiguousarray(part)), branch)
        out.append(y.numpy())
    y = np.concatenate(out, -1)
    if plant == "mirrored":
        y = y[..., (-np.arange(c)) % c, :]
    return st.numpy(), y


def _run_jax(c, q, x, state):
    jb = _block(jl, c, q)
    st, out = jnp.asarray(state), []
    for part in np.split(x, np.cumsum(_chunks(c, q))[:-1], axis=-1):
        st, y = jb.process(st, jnp.asarray(part))
        out.append(np.asarray(y))
    return np.asarray(st), np.concatenate(out, -1)


@pytest.mark.parametrize("rows", [None, 3])
@pytest.mark.parametrize("c,q", SHAPES)
def test_twin_matches_jax_with_state_carried(c, q, rows):
    """Three chunks, the second ragged and shorter than C q, the state
    carried: the outputs within 1e-5, the new state equal; on one row and
    on a batch of 3 rows with states of their own."""
    rng = np.random.default_rng(c * 100 + q)
    lead = () if rows is None else (rows,)
    x = _noise(rng, lead + (sum(_chunks(c, q)),))
    state = np.zeros(c * q, np.complex64) if rows is None else \
        _noise(rng, lead + (c * q,))
    st, y = _run_twin(c, q, x, state)
    jst, jy = _run_jax(c, q, x, state)
    assert y.shape == lead + (c, sum(_chunks(c, q)) // c)
    assert _gap(y, jy) < TOL
    np.testing.assert_array_equal(st, jst)


@pytest.mark.parametrize("c,q", SHAPES)
def test_twin_is_the_blocks_stock_path(c, q):
    """The wrapper on the CPU is the twin bit for bit, and the block's
    output is the wrapper's."""
    rng = np.random.default_rng(c + q)
    blk = _block(tl, c, q)
    x = torch.from_numpy(_noise(rng, c * 50))
    s0 = blk.init_state()
    st, y = blk.process(s0, x)
    rst, ry = channelizer.channelize_reference(s0, x, blk._branch)
    assert torch.equal(y, ry) and torch.equal(st, rst)


def _factored(v, c, tw):
    """The kernel's DFT in its order of stages, in float64: b length-a DFTs
    over v[b p1 + p2], each times e^{2 pi i c1 p2 / C} into row b c1 + p2,
    then a length-b DFTs over those rows into channel c1 + a c2; roots and
    twiddles read from ``tw`` where the kernel reads them."""
    a, b = channelizer.radices(c)
    tw = tw.astype(np.complex128)
    ra, rb, twid = tw[:a], tw[a:a + b], tw[a + b:]
    z = np.empty_like(v)
    for p2 in range(b):
        for c1 in range(a):
            z[b * c1 + p2] = twid[c1 * b + p2] * sum(
                v[b * p1 + p2] * ra[(c1 * p1) % a] for p1 in range(a))
    y = np.empty_like(v)
    for c1 in range(a):
        for c2 in range(b):
            y[c1 + a * c2] = sum(z[b * c1 + p2] * rb[(c2 * p2) % b]
                                 for p2 in range(b))
    return y


@pytest.mark.parametrize("c", [100, 64, 8, 7, 2, 12, 256])
def test_factored_dft_is_the_inverse_dft(c):
    """The kernel's two stages with its tables give the unnormalised
    inverse DFT across branches (ifft * C)."""
    rng = np.random.default_rng(c)
    v = (rng.standard_normal((c, 5)) + 1j * rng.standard_normal((c, 5)))
    assert _gap(_factored(v, c, channelizer.tables(c)),
                np.fft.ifft(v, axis=0) * c) < 2e-6


def test_tables_are_the_roots_in_float64_rounded():
    a, b = channelizer.radices(100)
    tw = channelizer.tables(100)
    assert tw.dtype == np.complex64 and tw.shape == (a + b + a * b,)
    exact = np.exp(2j * np.pi * np.array(
        [k / a for k in range(a)] + [k / b for k in range(b)]
        + [(c1 * p2) / 100 for c1 in range(a) for p2 in range(b)]))
    np.testing.assert_array_equal(tw, exact.astype(np.complex64))


def _zeroed(c, q, x):
    return _gap(_run_twin(c, q, x, np.zeros(c * q, np.complex64),
                          "zeroed")[1],
                _run_jax(c, q, x, np.zeros(c * q, np.complex64))[1])


def _mirrored(c, q, x):
    return _gap(_run_twin(c, q, x, np.zeros(c * q, np.complex64),
                          "mirrored")[1],
                _run_jax(c, q, x, np.zeros(c * q, np.complex64))[1])


def _twiddle_flipped(c, q, x):
    tw = channelizer.tables(c)
    a, b = channelizer.radices(c)
    tw[a + b + 1 * b + 1] = np.conj(tw[a + b + 1 * b + 1])
    v = np.random.default_rng(1).standard_normal((c, 5)) + 0j
    return _gap(_factored(v, c, tw), np.fft.ifft(v, axis=0) * c)


@pytest.mark.parametrize("plant", [_zeroed, _mirrored, _twiddle_flipped])
@pytest.mark.parametrize("c,q", [(100, 16), (64, 8)])
def test_planted_faults_read_false(plant, c, q):
    """The state zeroed each chunk, the channels mirrored (c <-> C - c),
    one twiddle's sign flipped: each leaves its tolerance."""
    x = _noise(np.random.default_rng(7), sum(_chunks(c, q)))
    assert plant(c, q, x) > 100 * TOL


def test_radices_and_fits():
    assert [channelizer.radices(c) for c in (100, 64, 8, 7, 2, 12, 256)] \
        == [(10, 10), (8, 8), (2, 4), (1, 7), (1, 2), (3, 4), (16, 16)]
    for c, q in SHAPES + [(16, 8), (256, 8)]:
        assert channelizer.fits(c, q), (c, q)
    # a radix above 16 (17, 2 x 17, a prime), too many taps, one channel
    for c, q in ((17, 8), (34, 4), (257, 2), (100, 200), (1, 8), (8, 0)):
        assert not channelizer.fits(c, q), (c, q)


@pytest.mark.parametrize("c,q,m,want", [
    # the band cell's chunk: 8 192 000 samples, 81 920 outputs a channel
    (100, 16, 81920, channelizer.Plan(10, 10, 32, 264, 2, 108960)),
    # the bank-mono chunk (64 x 16 384) and the wideband example's (16 x
    # 16 384)
    (64, 8, 16384, channelizer.Plan(8, 8, 64, 256, 2, 108672)),
    (16, 8, 16384, channelizer.Plan(4, 4, 64, 256, 2, 27200)),
    # a chunk of a few tiles: one block a tile
    (100, 16, 100, channelizer.Plan(10, 10, 32, 4, 2, 108960)),
    # no whole output: one block, for the new state
    (100, 16, 0, channelizer.Plan(10, 10, 32, 1, 2, 108960)),
])
def test_plan_and_shared_memory(c, q, m, want):
    """Tiles of 32 at the band's shape (64 would leave one block an SM:
    185 760 bytes), 64 at the bank's; as many blocks as two an SM on 132
    SMs (an H100 SXM), or as there are tiles."""
    assert channelizer.plan(c, q, m, 1, 132) == want
    assert channelizer.smem_bytes(100, 16, 64) == 185760


def test_plan_counts_every_rows_tiles():
    assert channelizer.plan(100, 16, 320, 3, 132).grid == 30
    assert channelizer.plan(64, 8, 100, 2, 132).grid == 4


@pytest.mark.parametrize("sms,grid", [(132, 264), (114, 228), (1, 2)])
def test_plan_sizes_the_grid_by_the_cards_sms(sms, grid):
    """Two blocks an SM on a card of ``sms`` SMs (an H100 SXM, an H100
    PCIe, one SM), the band's tiles outnumbering them all."""
    assert channelizer.plan(100, 16, 81920, 1, sms).grid == grid


def test_wrapper_checks():
    c, q = 8, 4
    br = torch.zeros((c, q))
    s = torch.zeros(c * q, dtype=torch.complex64)
    x = torch.zeros(c * 10, dtype=torch.complex64)
    with pytest.raises(ValueError, match="x: want"):
        channelizer.channelize(s, x.to(torch.complex128), br)
    with pytest.raises(ValueError, match="x: want"):
        channelizer.channelize(s, torch.zeros((2, c * 10),
                                              dtype=torch.complex64).T, br)
    with pytest.raises(ValueError, match="branch: want"):
        channelizer.channelize(s, x, br.double())
    with pytest.raises(ValueError, match="state: want"):
        channelizer.channelize(s[:-1], x, br)
    with pytest.raises(ValueError, match="unsupported device"):
        channelizer.channelize(s.to("meta"), x.to("meta"), br.to("meta"))


def test_block_runs_a_shape_the_kernel_does_not_take():
    """C 17 (a radix above 16) does not fit the kernel, so a card would
    keep the stock path for it; the block runs it as the twin."""
    blk = _block(tl, 17, 4)
    assert not channelizer.fits(17, 4)
    rng = np.random.default_rng(17)
    x = torch.from_numpy(_noise(rng, 17 * 30))
    st, y = blk.process(blk.init_state(), x)
    rst, ry = channelizer.channelize_reference(blk.init_state(), x,
                                               blk._branch)
    assert torch.equal(y, ry) and torch.equal(st, rst)


@pytest.mark.parametrize("c", [17, 8])
def test_stock_chunks_counts_only_a_cards_chunks(c):
    """``stock_chunks`` counts a CUDA card's chunks on the stock path: on
    the CPU neither a shape the kernel refuses (C 17) nor one it takes
    (C 8) moves it."""
    blk = _block(tl, c, 4)
    n0 = tl.ChannelizerBlock.stock_chunks
    blk.process(blk.init_state(),
                torch.from_numpy(_noise(np.random.default_rng(c), c * 30)))
    assert tl.ChannelizerBlock.stock_chunks == n0
