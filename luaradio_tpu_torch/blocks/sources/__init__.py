from luaradio_tpu_torch.blocks.sources import (bank, files, network, sdr,
                                               signal)
from luaradio_tpu_torch.blocks.sources.bank import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.sources.files import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.sources.network import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.sources.sdr import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.sources.signal import *  # noqa: F401,F403

__all__ = (bank.__all__ + files.__all__ + network.__all__ + sdr.__all__
           + signal.__all__)
