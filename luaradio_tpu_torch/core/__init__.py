from luaradio_tpu_torch.core.block import (Block, HostBlock,  # noqa: F401
                                           HostSourceBlock, Input, Output,
                                           SignalBlock, SignalSourceBlock,
                                           SinkBlock, SourceBlock)
from luaradio_tpu_torch.core.composite import CompositeBlock  # noqa: F401
