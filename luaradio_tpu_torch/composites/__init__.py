from luaradio_tpu_torch.composites import am, fm, receivers, resampling
from luaradio_tpu_torch.composites.am import *  # noqa: F401,F403
from luaradio_tpu_torch.composites.fm import *  # noqa: F401,F403
from luaradio_tpu_torch.composites.receivers import *  # noqa: F401,F403
from luaradio_tpu_torch.composites.resampling import *  # noqa: F401,F403

__all__ = am.__all__ + fm.__all__ + receivers.__all__ + resampling.__all__
