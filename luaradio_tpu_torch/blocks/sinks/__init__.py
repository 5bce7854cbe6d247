from luaradio_tpu_torch.blocks.sinks import (audio, files, misc, network,
                                             plot, sdr)
from luaradio_tpu_torch.blocks.sinks.audio import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.sinks.files import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.sinks.misc import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.sinks.network import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.sinks.plot import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.sinks.sdr import *  # noqa: F401,F403

__all__ = (audio.__all__ + files.__all__ + misc.__all__ + network.__all__
           + plot.__all__ + sdr.__all__)
