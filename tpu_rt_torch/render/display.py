"""Display pipeline over the device-resident accumulator.

Counterpart of ``tpu_rt/render/display.py:display_stack`` without the
denoiser bank: Reinhard tone map, percentile enhance, and the optional
uint8 quantization, stacked as (2, H, W, 3) so the interactive loop pulls
one array per displayed frame.
"""

from __future__ import annotations

import torch

from .frame import enhance_contrast, tone_map

#: stack row layout: [display, enhanced]
DISPLAY, ENHANCED = 0, 1


def display_stack(
    acc: torch.Tensor,
    exposure: float,
    *,
    linear: bool = False,
    enhance: bool = True,
    methods: tuple[str, ...] = (),
    as_uint8: bool = False,
) -> torch.Tensor:
    """(H, W, 3) accumulator -> (2, H, W, 3) stacked views.

    Row 0 is the tone-mapped display, row 1 the percentile-enhanced view
    (== row 0 when ``enhance`` is False). ``linear=True`` takes a linear
    accumulator (``gamma=False`` batches) and applies the sqrt gamma and
    clamp first. ``as_uint8`` quantizes on the device (round half to even,
    as the JAX package). Denoiser ``methods`` raise until ``ops/post.py``
    is ported."""
    if methods:
        raise NotImplementedError(
            f"denoisers {methods!r} are not ported to tpu_rt_torch yet "
            "(ROADMAP.md: Queue 1, post/denoisers)")
    if linear:
        acc = torch.clamp(torch.sqrt(torch.clamp_min(acc, 0.0)), 0.0, 1.0)
    disp = tone_map(acc, exposure)
    stack = torch.stack([disp, enhance_contrast(disp) if enhance else disp])
    if as_uint8:
        stack = torch.round(torch.clamp(stack, 0.0, 1.0) * 255.0).to(
            torch.uint8)
    return stack
