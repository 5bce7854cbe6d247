from luaradio_tpu_torch.blocks.sources import files, signal
from luaradio_tpu_torch.blocks.sources.files import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.sources.signal import *  # noqa: F401,F403

__all__ = files.__all__ + signal.__all__
