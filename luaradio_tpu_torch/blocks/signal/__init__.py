from luaradio_tpu_torch.blocks.signal import (carrier, channelizer,
                                              digital, filtering, math,
                                              modem, sampling)
from luaradio_tpu_torch.blocks.signal.carrier import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.signal.channelizer import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.signal.digital import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.signal.filtering import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.signal.math import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.signal.modem import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.signal.sampling import *  # noqa: F401,F403

__all__ = (carrier.__all__ + channelizer.__all__ + digital.__all__
           + filtering.__all__ + math.__all__ + modem.__all__
           + sampling.__all__)
