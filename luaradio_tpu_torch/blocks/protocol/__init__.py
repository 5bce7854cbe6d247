from luaradio_tpu_torch.blocks.protocol.ax25 import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.protocol.ert import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.protocol.pocsag import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.protocol.rds import *  # noqa: F401,F403
from luaradio_tpu_torch.blocks.protocol.varicode import *  # noqa: F401,F403
