"""Enum machinery with readable errors (copy of ``squidpy_tpu/_constants/_utils.py``)."""

from __future__ import annotations

from enum import Enum, EnumMeta
from typing import Any


class PrettyEnumMeta(EnumMeta):
    def __call__(cls, value: Any, *args: Any, **kwargs: Any) -> Any:  # noqa: D102
        try:
            return super().__call__(value, *args, **kwargs)
        except ValueError:
            valid = [repr(m.value) for m in cls]  # type: ignore[var-annotated]
            raise ValueError(
                f"Invalid option `{value!r}` for `{cls.__name__}`. Valid options are: `[{', '.join(valid)}]`."
            ) from None


class ModeEnum(str, Enum, metaclass=PrettyEnumMeta):
    """String enum whose members stringify to their value."""

    def __str__(self) -> str:
        return str(self.value)

    @property
    def s(self) -> str:
        """The string value."""
        return str(self.value)

    @property
    def v(self) -> Any:
        """The raw value."""
        return self.value
