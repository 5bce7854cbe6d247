from luaradio_tpu_torch.composites import fm, resampling
from luaradio_tpu_torch.composites.fm import *  # noqa: F401,F403
from luaradio_tpu_torch.composites.resampling import *  # noqa: F401,F403

__all__ = fm.__all__ + resampling.__all__
