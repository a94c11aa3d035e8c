"""Host decorators of the public API (copy of ``squidpy_tpu/utils/_utils.py``
``deprecated_params``)."""

from __future__ import annotations

import warnings
from collections.abc import Callable
from functools import wraps
from typing import Any, TypeVar

__all__ = ["deprecated_params"]

T = TypeVar("T")


def deprecated_params(params: dict[str, str]):  # noqa: ANN201
    """Warn when a deprecated keyword argument is passed (and drop it)."""

    def decorator(fn: Callable[..., T]) -> Callable[..., T]:
        @wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> T:
            for p, version in params.items():
                if p in kwargs:
                    warnings.warn(
                        f"`{p}` is deprecated since {version} and has no effect in squidpy_torch.",
                        FutureWarning,
                        stacklevel=2,
                    )
                    kwargs.pop(p)
            return fn(*args, **kwargs)

        return wrapper

    return decorator
