"""Host decorators of the public API (copy of ``squidpy_tpu/utils/_utils.py``
``deprecated_params``) and the import of optional packages."""

from __future__ import annotations

import importlib
import warnings
from collections.abc import Callable
from functools import wraps
from typing import Any, TypeVar

__all__ = ["deprecated_params", "optional_import"]

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


def optional_import(name: str, purpose: str) -> Any:
    """Import the optional package ``name`` (pandas, h5py, PIL), which the
    containers, h5ad I/O and readers need and a GPU host may lack;
    raise ``ImportError`` naming it and what needed it."""
    try:
        return importlib.import_module(name)
    except ImportError as err:
        raise ImportError(f"{purpose} needs the `{name}` package, which is not installed.") from err
