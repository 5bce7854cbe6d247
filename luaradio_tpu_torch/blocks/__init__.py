from luaradio_tpu_torch.blocks import signal, sinks, sources
from luaradio_tpu_torch.blocks.signal import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.sinks import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.sources import *  # noqa: F401,F403

__all__ = signal.__all__ + sinks.__all__ + sources.__all__
