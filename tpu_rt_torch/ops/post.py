"""Post-processing on the device: the denoiser bank.

Counterpart of ``tpu_rt/ops/post.py``: bilateral, NL-means, gaussian and
median filters in the semantics of the reference's OpenCV bank, plus the
AOV-guided joint bilateral, with the same uint8 roundtrip (the filters work
on the image quantized to uint8 by truncation and return [0, 1] floats).

Every filter is built from shifted slices, elementwise ops and sums, as the
JAX package builds it, never from ``torch.nn.functional.conv2d``: cuDNN
convolutions run in TF32 on the card by default, which would change the
gaussian's rounding and so its uint8 values. Borders are ``jnp.pad``'s
"reflect" (reflect-101) and "edge", gathered by index so a pad may be
longer than the image, as there. The filters run on the device of the
image they get.
"""

from __future__ import annotations

import numpy as np
import torch


def _recip(c: float) -> float:
    """The f32 reciprocal of a constant divisor: XLA compiles the JAX
    package's division by a constant as a multiplication by it, so the port
    multiplies too and gets the same bits."""
    return float(np.float32(1.0) / np.float32(c))


def _to_u8f(image: torch.Tensor) -> torch.Tensor:
    """[0,1] float -> quantized uint8 values held in f32, by truncation, as
    the reference's ``(clip(image, 0, 1) * 255).astype(np.uint8)``."""
    return torch.floor(torch.clamp(image, 0.0, 1.0) * 255.0)


def _from_u8f(u8: torch.Tensor) -> torch.Tensor:
    return torch.clamp(u8, 0.0, 255.0) * _recip(255.0)


def _pad_index(n: int, before: int, after: int, mode: str,
               device) -> torch.Tensor:
    """Source index of each of the ``before + n + after`` padded positions
    of an axis of length ``n``: ``"reflect"`` is ``jnp.pad``'s reflect-101,
    periodic with period 2(n-1) for pads past the edge, ``"edge"`` clamps."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge" or n == 1:
        return i.clamp(0, n - 1)
    m = torch.remainder(i, 2 * (n - 1))
    return torch.where(m < n, m, 2 * (n - 1) - m)


def _pad_hw(x: torch.Tensor, rows, cols, mode: str) -> torch.Tensor:
    """``jnp.pad(x, (rows, cols[, (0, 0)]), mode=mode)`` of an (H, W) or
    (H, W, C) tensor, ``mode`` "reflect" or "edge", for pads of any size:
    torch's own reflect padding refuses a pad as long as the axis."""
    x = x.index_select(0, _pad_index(x.shape[0], *rows, mode, x.device))
    return x.index_select(1, _pad_index(x.shape[1], *cols, mode, x.device))


def _gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel: exp(-(i-c)^2 / (2 sigma^2)), normalized.
    sigma <= 0 follows cv2's default sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    c = (ksize - 1) / 2
    xs = np.arange(ksize, dtype=np.float64)
    k = np.exp(-((xs - c) ** 2) / (2 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(image: torch.Tensor, ksize: int = 5,
                  sigma: float = 1.0) -> torch.Tensor:
    """Separable gaussian with reflect-101 border (cv2.GaussianBlur)."""
    k = [float(w) for w in _gaussian_kernel1d(ksize, float(sigma))]
    r = ksize // 2
    u8 = _to_u8f(image)
    h, w = u8.shape[0], u8.shape[1]
    x = _pad_hw(u8, (r, r), (0, 0), "reflect")
    x = sum(k[i] * x[i:i + h] for i in range(ksize))
    x = _pad_hw(x, (0, 0), (r, r), "reflect")
    x = sum(k[i] * x[:, i:i + w] for i in range(ksize))
    return _from_u8f(torch.round(x))


def median_blur(image: torch.Tensor, ksize: int = 5) -> torch.Tensor:
    """k x k median with replicate border (cv2.medianBlur)."""
    r = ksize // 2
    u8 = _to_u8f(image)
    h, w = u8.shape[0], u8.shape[1]
    x = _pad_hw(u8, (r, r), (r, r), "edge")
    stack = torch.stack(
        [x[i:i + h, j:j + w] for i in range(ksize) for j in range(ksize)],
        dim=-1)  # (h, w, 3, k*k)
    med = torch.sort(stack, dim=-1).values[..., (ksize * ksize) // 2]
    return _from_u8f(med)


def bilateral_filter(image: torch.Tensor, d: int = 9,
                     sigma_color: float = 75.0,
                     sigma_space: float = 75.0) -> torch.Tensor:
    """Joint range/space filter, cv2.bilateralFilter semantics.

    Circular window of radius d//2; range weight from the L1 color distance
    on uint8 values; one weight shared by all channels; reflect-101 border.
    """
    radius = d // 2
    color_coeff = -0.5 / (sigma_color * sigma_color)
    space_coeff = -0.5 / (sigma_space * sigma_space)

    u8 = _to_u8f(image)
    h, w = u8.shape[0], u8.shape[1]
    x = _pad_hw(u8, (radius, radius), (radius, radius), "reflect")

    num = torch.zeros_like(u8)
    den = torch.zeros(u8.shape[:2], dtype=u8.dtype, device=u8.device)
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            rr = i * i + j * j
            if rr > radius * radius:
                continue  # circular window, like cv2
            shifted = x[radius + i:radius + i + h, radius + j:radius + j + w]
            l1 = torch.sum(torch.abs(shifted - u8), dim=-1)
            wgt = torch.exp(rr * space_coeff + (l1 * l1) * color_coeff)
            num = num + shifted * wgt[..., None]
            den = den + wgt
    return _from_u8f(num / den[..., None])


def joint_bilateral(
    image: torch.Tensor,
    normal: torch.Tensor,
    depth: torch.Tensor,
    d: int = 9,
    sigma_color: float = 75.0,
    sigma_space: float = 75.0,
    sigma_normal: float = 0.25,
    sigma_depth: float = 0.08,
) -> torch.Tensor:
    """Feature-guided (joint) bilateral filter over the render AOVs.

    The space x color-range weights of :func:`bilateral_filter` times
    first-hit geometry similarity: normal agreement ``(1 - n.n')`` and
    relative depth difference, so noise smooths within a surface while
    silhouettes and creases stay sharp. ``normal``: (h, w, 3) unit vectors
    (zeros on a miss); ``depth``: (h, w) hit distance (``T_MAX`` on a miss,
    whose weight against a hit then underflows to 0, as in the JAX
    package).
    """
    radius = d // 2
    color_coeff = -0.5 / (sigma_color * sigma_color)
    space_coeff = -0.5 / (sigma_space * sigma_space)
    normal_coeff = -0.5 / (sigma_normal * sigma_normal)
    depth_coeff = -0.5 / (sigma_depth * sigma_depth)

    u8 = _to_u8f(image)
    h, w = u8.shape[0], u8.shape[1]
    pad = ((radius, radius), (radius, radius))
    x = _pad_hw(u8, *pad, "reflect")
    nrm = _pad_hw(normal.to(torch.float32), *pad, "reflect")
    dep = _pad_hw(depth.to(torch.float32), *pad, "reflect")
    dep_c = dep[radius:radius + h, radius:radius + w]
    nrm_c = nrm[radius:radius + h, radius:radius + w]

    num = torch.zeros_like(u8)
    den = torch.zeros(u8.shape[:2], dtype=u8.dtype, device=u8.device)
    for i in range(-radius, radius + 1):
        for j in range(-radius, radius + 1):
            rr = i * i + j * j
            if rr > radius * radius:
                continue
            sl_y = slice(radius + i, radius + i + h)
            sl_x = slice(radius + j, radius + j + w)
            shifted = x[sl_y, sl_x]
            l1 = torch.sum(torch.abs(shifted - u8), dim=-1)
            ndot = torch.sum(nrm[sl_y, sl_x] * nrm_c, dim=-1)
            nterm = torch.square(1.0 - torch.clamp(ndot, -1.0, 1.0))
            zrel = (dep[sl_y, sl_x] - dep_c) / (torch.abs(dep_c) + 1e-3)
            wgt = torch.exp(rr * space_coeff + (l1 * l1) * color_coeff
                            + nterm * normal_coeff
                            + torch.square(zrel) * depth_coeff)
            num = num + shifted * wgt[..., None]
            den = den + wgt
    return _from_u8f(num / den[..., None])


def nlmeans(image: torch.Tensor, h: float = 10.0,
            template_window_size: int = 7,
            search_window_size: int = 21) -> torch.Tensor:
    """Non-local means on RGB.

    For each search offset: the squared-difference image, box-filtered over
    the template window through an f32 integral image (the patch SSD at
    every pixel at once), mapped to a weight
    exp(-max(ssd/n, 0) / h^2).
    The offsets stream through a Python loop of eager ops.
    """
    t_r = template_window_size // 2
    s_r = search_window_size // 2
    npix = template_window_size * template_window_size * 3

    u8 = _to_u8f(image)
    hh, ww = u8.shape[0], u8.shape[1]
    pad = s_r + t_r
    x = _pad_hw(u8, (pad, pad), (pad, pad), "reflect")

    def box(img2d):
        """Centered template-window box sum via the integral image: with
        pad (r+1, r), ``cs[y+k] - cs[y]`` covers original rows y-r .. y+r."""
        r = t_r
        k = template_window_size
        p = _pad_hw(img2d, (r + 1, r), (r + 1, r), "edge")
        cs = torch.cumsum(torch.cumsum(p, 0), 1)
        return cs[k:, k:] - cs[:-k, k:] - cs[k:, :-k] + cs[:-k, :-k]

    center = x[pad:pad + hh, pad:pad + ww]
    num = torch.zeros_like(u8)
    den = torch.zeros((hh, ww), dtype=u8.dtype, device=u8.device)
    inv_h2 = 1.0 / (h * h)
    inv_npix = _recip(npix)
    for i in range(-s_r, s_r + 1):
        for j in range(-s_r, s_r + 1):
            shifted = x[pad + i:pad + i + hh, pad + j:pad + j + ww]
            sq = torch.sum((shifted - center) ** 2, dim=-1)
            ssd = box(sq) * inv_npix
            wgt = torch.exp(-torch.clamp_min(ssd, 0.0) * inv_h2)
            num = num + shifted * wgt[..., None]
            den = den + wgt
    return _from_u8f(num / den[..., None])
