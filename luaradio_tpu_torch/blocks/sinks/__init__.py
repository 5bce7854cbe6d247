from luaradio_tpu_torch.blocks.sinks import files, misc
from luaradio_tpu_torch.blocks.sinks.files import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.sinks.misc import *  # noqa: F401,F403

__all__ = files.__all__ + misc.__all__
