"""Image processing: smoothing, grayscale conversion, custom callables
(counterpart of ``squidpy_tpu/im/_process.py``).

API parity with the reference's im/_process.py:23-149. Gaussian smoothing
runs as a separable convolution on the device
(:mod:`squidpy_torch.ops.filters`) instead of scipy/dask-image.
"""

from __future__ import annotations

import logging
from collections.abc import Callable, Mapping, Sequence
from types import MappingProxyType
from typing import Any

import numpy as np

from squidpy_torch._constants._constants import Processing
from squidpy_torch._constants._pkg_constants import Key
from squidpy_torch.im._container import ImageContainer
from squidpy_torch.ops.filters import gaussian_blur, rgb2gray
from squidpy_torch._device import NDArrayA

logger = logging.getLogger(__name__)

__all__ = ["process"]


def process(
    img: ImageContainer,
    layer: str | None = None,
    library_id: str | Sequence[str] | None = None,
    method: str | Callable[..., NDArrayA] = "smooth",
    chunks: int | None = None,
    lazy: bool = False,
    layer_added: str | None = None,
    channel_dim: str | None = None,
    copy: bool = False,
    apply_kwargs: Mapping[str, Any] = MappingProxyType({}),
    **kwargs: Any,
) -> ImageContainer | None:
    """Process an image layer: ``'smooth'`` (device gaussian), ``'gray'``
    (luminance), or any custom callable. New layer name follows the
    reference's ``'{layer}_{method}'`` convention."""
    layer = img._get_layer(layer)
    method_enum = Processing(method) if isinstance(method, (str, Processing)) else method
    layer_new = Key.img.process(method_enum, layer, layer_added=layer_added)

    if callable(method_enum):
        callback = lambda arr, **kw: np.asarray(method_enum(arr, **kw))  # noqa: E731
    elif method_enum == Processing.SMOOTH:
        sigma = kwargs.pop("sigma", 1)
        if isinstance(sigma, (list, tuple)):
            sigma = sigma[0]

        def callback(arr: NDArrayA, **kw: Any) -> NDArrayA:
            return gaussian_blur(arr, float(sigma)).astype(arr.dtype)

    elif method_enum == Processing.GRAY:
        def callback(arr: NDArrayA, **kw: Any) -> NDArrayA:
            return rgb2gray(arr)

    else:
        raise NotImplementedError(f"Method `{method_enum}` is not yet implemented.")

    fn: Any = callback
    if library_id is not None:
        fn = dict.fromkeys(img._get_library_ids(library_id), callback)

    logger.info("Processing image using `%s` method", method_enum)
    res = img.apply(fn, layer=layer, copy=True, fn_kwargs=kwargs)

    if copy:
        return res.rename(layer, layer_new)
    img._layers[layer_new] = res[layer]
    return None
