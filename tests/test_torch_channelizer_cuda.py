"""The channelizer kernel (csrc/channelizer.cu) on a CUDA card against its
twin (ops/channelizer.py channelize_reference, the stock path, on the same
card), at the FM band cell's (C 100, q 16), the AM band cell's (117, 16:
odd radices 9 x 13) and the bank's (64, 8) shapes: a chunk, a ragged
chunk shorter than C q after it (the state carried), and a batch of 3
rows with states of their own.  The new state must equal the twin's and
every channel lie within 2e-6 of that channel's full scale (float32 sums
in another order: the branch FIRs by fused multiply-adds, the DFT in two
stages of 10, 9 x 13 or 8 against cuFFT).  Skipped without a card; on
the card (this file imports no JAX; the conftest does, so it is left
out):

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_channelizer_cuda.py
"""

import pytest
import torch

from luaradio_tpu_torch.blocks.signal.channelizer import ChannelizerBlock
from luaradio_tpu_torch.ops import channelizer


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _noise(gen, shape, dev):
    return torch.randn(shape, generator=gen, device=dev,
                       dtype=torch.complex64)


@pytest.mark.cuda
@pytest.mark.parametrize("c,q", [(100, 16), (117, 16), (64, 8)])
def test_kernel_matches_twin(dev, c, q):
    blk = ChannelizerBlock(c, q)
    blk.device = dev
    blk.initialize()
    gen = torch.Generator(device=dev).manual_seed(c * 100 + q)
    k = c * q
    cases = [(torch.zeros(k, dtype=torch.complex64, device=dev),
              _noise(gen, (c * 4096,), dev)),
             (None, _noise(gen, (k // 2 + 3,), dev)),
             (_noise(gen, (3, k), dev), _noise(gen, (3, c * 1000), dev))]
    st = None
    for state, x in cases:
        state = st if state is None else state
        n0 = channelizer.channelize.launches
        st, y = channelizer.channelize(state, x, blk._branch)
        rst, ry = channelizer.channelize_reference(state, x, blk._branch)
        torch.cuda.synchronize()
        assert channelizer.channelize.launches == n0 + 1
        assert y.shape == ry.shape == x.shape[:-1] + (c, x.shape[-1] // c)
        assert torch.equal(st, rst.contiguous())
        scale = ry.abs().amax(-1, keepdim=True).clamp_min(1e-30)
        assert ((y - ry).abs() / scale).max().item() < 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("c,q,stock", [(100, 16, 0), (17, 4, 1)])
def test_block_counts_a_chunk_on_the_stock_path(dev, c, q, stock):
    """A shape the kernel takes launches it; one it refuses (C 17, a radix
    above 16) runs the stock path, counted in ``stock_chunks``."""
    blk = ChannelizerBlock(c, q)
    blk.device = dev
    blk.initialize()
    gen = torch.Generator(device=dev).manual_seed(c)
    n0, s0 = channelizer.channelize.launches, ChannelizerBlock.stock_chunks
    blk.process(blk.init_state(), _noise(gen, (c * 64,), dev))
    assert ChannelizerBlock.stock_chunks - s0 == stock
    assert channelizer.channelize.launches - n0 == 1 - stock
