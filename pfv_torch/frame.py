"""Frame geometry helpers (counterpart of pfv_tpu/frame.py)."""

from __future__ import annotations


def pad16(x: int) -> int:
    """Dimension padded up to a whole number of 16-pixel macroblocks."""
    return x + (16 - x % 16) % 16
