"""Host utilities of the ported slice."""

from squidpy_torch.utils._stats import multipletests

__all__ = ["multipletests"]
