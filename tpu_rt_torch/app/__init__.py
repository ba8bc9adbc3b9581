"""app layer of tpu_rt_torch: the interactive runtime, its previews, panel
logic, denoiser bank, Qt GUI and launcher (see the package docstring)."""

from .denoiser import Denoiser  # noqa: F401
from .interaction import (  # noqa: F401
    CameraController,
    ObjectDragger,
    RayTracerInteraction,
    RenderMode,
    RenderStateManager,
    SceneManager,
)
from .preview import PreviewRenderer  # noqa: F401
from .utils import FrameRateLimiter  # noqa: F401
