"""luaradio_tpu_torch — the PyTorch + CUDA port of luaradio_tpu.

The same flow-graph model as the JAX package (typed blocks, composites,
exact-rational rate propagation, streaming state carried across chunks),
with device blocks running as torch tensor code on a CUDA card and the TPU
package's Pallas kernels rewritten as CUDA kernels (csrc/).  Entry points
run on the card unless the caller passes ``device="cpu"``.

This slice holds the rx_wbfm mono receiver end to end: IQ file source,
tuner, WBFM mono demodulator, downsampler, WAV/IQ/benchmark sinks, the
graph optimizer, the runtime, and the hand-fused flagship step.
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
