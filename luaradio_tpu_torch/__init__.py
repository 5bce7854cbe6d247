"""luaradio_tpu_torch — the PyTorch + CUDA port of luaradio_tpu.

The same flow-graph model as the JAX package (typed blocks, composites,
exact-rational rate propagation, streaming state carried across chunks),
with device blocks running as torch tensor code on a CUDA card and the TPU
package's Pallas kernels rewritten as CUDA kernels (csrc/).  Entry points
run on the card unless the caller passes ``device="cpu"``.

The port holds the rx_wbfm receiver end to end, mono and stereo: IQ file
source, tuner, WBFM mono and stereo demodulators (the PLL and its three
tiers, the vector pilot), downsampler, WAV/IQ/benchmark sinks, the graph
optimizer, the runtime, the hand-fused flagship step, and the
application dispatcher and CLI for rx_wbfm (``python -m
luaradio_tpu_torch.cli``).
"""

__version__ = "0.1.0"

from luaradio_tpu_torch import types  # noqa: F401
from luaradio_tpu_torch.blocks import *  # noqa: F401,F403
from luaradio_tpu_torch.composites import *  # noqa: F401,F403
from luaradio_tpu_torch.core import (Block, CompositeBlock,  # noqa: F401
                                     HostBlock, HostSourceBlock, Input,
                                     Output, SignalBlock, SignalSourceBlock,
                                     SinkBlock, SourceBlock)
from luaradio_tpu_torch.types import (Bit, Byte, ComplexFloat32,  # noqa: F401
                                      Float32)
