"""Image filters (counterpart of ``squidpy_tpu/ops/filters.py``): the
separable gaussian blur on the device, and the host luminance conversion.

``gaussian_blur`` is JAX's ``_sep_conv2d``: ``symmetric`` padding (scipy's
``reflect``: the edge sample repeats), then two depthwise 1-D convolutions,
along y and then x, as ``F.conv2d`` with ``groups=c`` in float32 with TF32
off. It is a library convolution, not a hand-written kernel: it does
O(pixels x taps) work once, and stays listed in ROADMAP.md (B7) as a
candidate for one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from squidpy_torch._device import get_device, to_host

__all__ = ["gaussian_blur", "rgb2gray"]


def _gaussian_kernel(sigma: float, truncate: float = 4.0) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _symmetric_index(n: int, r: int, device: torch.device) -> torch.Tensor:
    """Source rows of numpy's ``symmetric`` padding by ``r`` of an axis of n."""
    m = torch.arange(-r, n + r, device=device) % (2 * n)
    return torch.where(m < n, m, 2 * n - 1 - m)


def _sep_conv2d(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``img`` (y, x, c) float32 blurred by the 1-D ``kernel`` along y then x."""
    ksize = kernel.numel()
    r = ksize // 2
    h, w, c = img.shape
    x = img.index_select(0, _symmetric_index(h, r, img.device)).index_select(1, _symmetric_index(w, r, img.device))
    x = x.permute(2, 0, 1).unsqueeze(0).contiguous()  # NCHW
    ky = kernel.view(1, 1, ksize, 1).expand(c, 1, ksize, 1).contiguous()
    kx = kernel.view(1, 1, 1, ksize).expand(c, 1, 1, ksize).contiguous()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=False, allow_tf32=False):
        x = F.conv2d(x, ky, groups=c)
        x = F.conv2d(x, kx, groups=c)
    return x[0].permute(1, 2, 0)


def gaussian_blur(img: np.ndarray, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """Gaussian smoothing of a ``(y, x[, c])`` image (reflect boundary)."""
    src = np.asarray(img)
    if sigma <= 0:
        return img
    squeeze = src.ndim == 2
    t = torch.from_numpy(np.ascontiguousarray(src if src.dtype in (np.uint8, np.float32) else src.astype(np.float32)))
    t = t.to(get_device()).to(torch.float32)
    if squeeze:
        t = t[:, :, None]
    k = torch.from_numpy(_gaussian_kernel(sigma, truncate)).to(t.device)
    out = to_host(_sep_conv2d(t, k))
    return out[:, :, 0] if squeeze else out


def rgb2gray(img: np.ndarray) -> np.ndarray:
    """ITU-R 601 luminance conversion (skimage ``rgb2gray`` weights)."""
    # f32 throughout: slide-sized host math in f64 forfeits SIMD and doubles
    # peak memory; the luminance weights lose nothing meaningful at f32
    src = np.asarray(img)
    arr = src.astype(np.float32, copy=False)
    owned = arr is not src  # astype copied, so in-place ops cannot leak out
    # ndim guard matters: per-z slices arrive with a singleton channel axis
    # squeezed, so a 2D (y, x) array must not have its x-extent read as a
    # channel count (and a width-3 2D array must not silently "convert")
    if arr.ndim < 3 or arr.shape[-1] != 3:
        raise ValueError(
            f"Expected an RGB image with 3 channels in the last axis, found shape `{arr.shape}`."
        )
    if arr.max() > 1.0:
        if owned:
            arr /= np.float32(255.0)
        else:
            arr = arr / np.float32(255.0)
    return arr @ np.array([0.2125, 0.7154, 0.0721], dtype=np.float32)
