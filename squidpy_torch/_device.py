"""Device policy and host/device helpers (counterpart of ``squidpy_tpu/utils/_utils.py``).

The device is explicit. The module default is ``cuda``; ``set_device("cpu")``
selects the CPU, either for good or, used as a context manager, for the
``with`` block. Asking for ``cuda`` on a machine without a card raises
``RuntimeError``: nothing silently continues on the CPU.
"""

from __future__ import annotations

import threading
from collections.abc import Iterator
from contextlib import contextmanager
from typing import Any

import numpy as np
import torch

NDArrayA = np.ndarray

__all__ = ["NDArrayA", "assert_positive", "full_float32", "get_device", "set_device", "to_host"]

_DEVICE = torch.device("cuda")

# the TF32 switch is process-wide; graphs built in threads (library_key with
# n_jobs > 1) must not restore it under each other's products
_TF32_LOCK = threading.Lock()


def _checked(device: torch.device) -> torch.device:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "squidpy_torch is set to run on `cuda`, but no CUDA device is available; "
            "call `squidpy_torch.set_device('cpu')` to run on the CPU."
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device `{device}`; expected `cuda` or `cpu`.")
    return device


class set_device:  # noqa: N801 - a function-like name, usable as a context manager
    """Select the device every ``squidpy_torch`` function runs on.

    ``set_device("cpu")`` switches for the rest of the process;
    ``with set_device("cpu"):`` switches for the block and restores the
    previous device on exit.
    """

    def __init__(self, device: str | torch.device) -> None:
        global _DEVICE
        self._previous = _DEVICE
        _DEVICE = _checked(torch.device(device))

    def __enter__(self) -> torch.device:
        return _DEVICE

    def __exit__(self, *exc: Any) -> None:
        global _DEVICE
        _DEVICE = self._previous


def get_device() -> torch.device:
    """The selected device; raises ``RuntimeError`` for ``cuda`` without a card."""
    return _checked(_DEVICE)


@contextmanager
def full_float32() -> Iterator[None]:
    """Matrix products in full float32 (TF32 off) for the block, under
    :data:`_TF32_LOCK`: the switch is process-wide."""
    with _TF32_LOCK:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def to_host(x: torch.Tensor, dtype: Any = None) -> np.ndarray:
    """Device-to-host copy as a numpy array, optionally cast to ``dtype``."""
    out = x.detach().cpu().numpy()
    return out.astype(dtype) if dtype is not None else out


def assert_positive(value: float, *, name: str) -> None:
    if value <= 0:
        raise ValueError(f"Expected `{name}` to be positive, found `{value}`.")
