"""Argument validators of the ported slice (copy of ``squidpy_tpu/utils/_validators.py``)."""

from __future__ import annotations

from collections.abc import Sequence
from typing import Any

__all__ = ["assert_in_range", "assert_non_negative", "check_tuple_needles"]


def check_tuple_needles(
    needles: Sequence[tuple[Any, Any]],
    haystack: Sequence[Any],
    msg: str,
    reraise: bool = True,
) -> Sequence[tuple[Any, Any]]:
    filtered = []
    for needle in needles:
        if not isinstance(needle, Sequence) or len(needle) != 2:
            raise ValueError(f"Expected a pair, found `{needle}`.")
        a, b = needle
        if a not in haystack or b not in haystack:
            if reraise:
                raise ValueError(msg.format(needle))
            continue
        filtered.append((a, b))
    return filtered


def assert_non_negative(value: float, *, name: str) -> None:
    if value < 0:
        raise ValueError(f"Expected `{name}` to be non-negative, found `{value}`.")


def assert_in_range(value: float, minn: float, maxx: float, *, name: str) -> None:
    if not (minn <= value <= maxx):
        raise ValueError(f"Expected `{name}` to be in interval `[{minn}, {maxx}]`, found `{value}`.")
