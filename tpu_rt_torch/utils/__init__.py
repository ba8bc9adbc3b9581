"""utils layer of tpu_rt_torch (see the package docstring)."""

from .checkpoint import (  # noqa: F401
    load_checkpoint,
    load_checkpoint_with_mesh,
    save_checkpoint,
)
from .config import RenderSettings  # noqa: F401
from .profiling import FrameStats, sync, torch_trace  # noqa: F401
