"""Display pipeline over the device-resident accumulator.

Counterpart of ``tpu_rt/render/display.py``: optional linear -> gamma,
Reinhard tone map, percentile enhance, every selected denoiser
(``ops/post.py``) and the optional uint8 quantization, stacked so the
interactive loop pulls one array per displayed frame. With
``grid_scale`` > 1 the denoisers run on the image downsampled by that factor
and their results tile into one quad plane (the GUI's 2x2 comparison grid),
which :func:`unpack_grid` slices back apart.
"""

from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..ops import post
from .frame import enhance_contrast, tone_map

#: stack row layout: [display, enhanced, *methods] (grid_scale == 1)
#: or [display, enhanced, denoiser-quad] (grid_scale > 1 with methods)
DISPLAY, ENHANCED = 0, 1


#: the color-only denoisers a stack (and ``app/denoiser.py``) can apply
STACKABLE = ("bilateral", "nlmeans", "gaussian", "median")


def _apply_method(m: str, img: torch.Tensor, **kw) -> torch.Tensor:
    """Denoiser ``m`` at the reference's defaults, each overridable by
    its keyword (``d``, ``sigma_color``, ``sigma_space``, ``h``,
    ``template_window_size``, ``search_window_size``, ``kernel_size``,
    ``sigma``)."""
    if m == "bilateral":
        return post.bilateral_filter(img, d=kw.get("d", 9),
                                     sigma_color=kw.get("sigma_color", 75),
                                     sigma_space=kw.get("sigma_space", 75))
    if m == "nlmeans":
        return post.nlmeans(
            img, h=kw.get("h", 10),
            template_window_size=kw.get("template_window_size", 7),
            search_window_size=kw.get("search_window_size", 21))
    if m == "gaussian":
        return post.gaussian_blur(img, ksize=kw.get("kernel_size", 5),
                                  sigma=kw.get("sigma", 1.0))
    if m == "median":
        return post.median_blur(img, ksize=kw.get("kernel_size", 5))
    raise ValueError(f"unknown stackable denoiser {m!r}")


def display_stack(
    acc: torch.Tensor,
    exposure: float,
    *,
    linear: bool = False,
    enhance: bool = True,
    methods: tuple[str, ...] = (),
    as_uint8: bool = False,
    grid_scale: int = 1,
) -> torch.Tensor:
    """(H, W, 3) accumulator -> stacked views in [0, 1].

    Row 0 is the tone-mapped display, row 1 the percentile-enhanced view
    (== row 0 when ``enhance`` is False). With ``grid_scale == 1`` rows 2+
    are the denoised views in ``methods`` order (at :func:`_apply_method`'s
    defaults, which ``app/denoiser.py:Denoiser`` shares); with ``grid_scale > 1`` and 1-4 methods,
    row 2 is one quad plane tiling the views of the image downsampled by
    ``grid_scale`` (a box mean), row-major. ``linear=True`` takes a linear
    accumulator (``gamma=False`` batches) and applies the sqrt gamma and
    clamp first. ``as_uint8`` quantizes on the device (round half to even,
    as the JAX package)."""
    img = acc
    if linear:
        img = torch.clamp(vm.sqrt(torch.clamp_min(img, 0.0)), 0.0, 1.0)
    disp = tone_map(img, exposure)
    outs = [disp, enhance_contrast(disp) if enhance else disp]
    if methods and grid_scale > 1:
        if len(methods) > 4:
            raise ValueError("grid_scale packing holds at most 4 methods")
        g = int(grid_scale)
        h, w = disp.shape[0], disp.shape[1]
        hg, wg = h // g, w // g
        small = disp[: hg * g, : wg * g, :].reshape(
            hg, g, wg, g, 3).mean(dim=(1, 3))
        quad = torch.zeros_like(disp)
        for i, m in enumerate(methods):
            r, c = divmod(i, 2)
            quad[r * hg:(r + 1) * hg, c * wg:(c + 1) * wg] = _apply_method(
                m, small)
        outs.append(quad)
    else:
        for m in methods:
            outs.append(_apply_method(m, disp))
    stack = torch.stack(outs)
    if as_uint8:
        stack = torch.round(torch.clamp(stack, 0.0, 1.0) * 255.0).to(
            torch.uint8)
    return stack


def unpack_grid(quad, methods: tuple[str, ...], grid_scale: int) -> dict:
    """Host-side inverse of the quad packing: slice the (H, W, 3) quad
    plane back into per-method images (each (H//g, W//g, 3), row-major
    2x2 order). Works on tensors and numpy arrays."""
    g = int(grid_scale)
    hg, wg = quad.shape[0] // g, quad.shape[1] // g
    out = {}
    for i, m in enumerate(methods):
        r, c = divmod(i, 2)
        out[m] = quad[r * hg:(r + 1) * hg, c * wg:(c + 1) * wg]
    return out
