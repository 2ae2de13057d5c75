"""Integer 8x8 inverse DCT on int32 tensors (counterpart of pfv_tpu/ops/dct.py).

Bit-exact to the PFV reference: wrapping int32 arithmetic, and divisions by
powers of two that truncate toward zero (quirk Q3), not arithmetic shifts.
"""

from __future__ import annotations

import torch

FP_BITS = 8


def tdiv_pow2(x: torch.Tensor, k: int) -> torch.Tensor:
    """Signed int32 division by 2**k, truncating toward zero."""
    bias = (x >> 31) & ((1 << k) - 1)
    return (x + bias) >> k


def idct8_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse 1-D transform along `dim` (length 8), int32 in and out."""
    c0, d4, c2, d6, c1, d5, c3, d7 = x.unbind(dim)
    c4 = d4
    c5 = d5 + d6
    c7 = d5 - d6
    c6 = d7
    b4 = c4 + c5
    b5 = c4 - c5
    b6 = c6 + c7
    b7 = c6 - c7
    b0 = c0 + c1
    b1 = c0 - c1
    b2 = c2 + tdiv_pow2(c2, 2) + tdiv_pow2(c3, 1)
    b3 = tdiv_pow2(c2, 1) - c3 - tdiv_pow2(c3, 2)
    a4 = tdiv_pow2(b7, 2) + b4 + tdiv_pow2(b4, 2) - tdiv_pow2(b4, 4)
    a7 = tdiv_pow2(b4, 2) - b7 - tdiv_pow2(b7, 2) + tdiv_pow2(b7, 4)
    a5 = b5 - b6 + tdiv_pow2(b6, 2) + tdiv_pow2(b6, 4)
    a6 = b6 + b5 - tdiv_pow2(b5, 2) - tdiv_pow2(b5, 4)
    a0 = b0 + b2
    a1 = b1 + b3
    a2 = b1 - b3
    a3 = b0 - b2
    return torch.stack(
        [a0 + a4, a1 + a5, a2 + a6, a3 + a7, a3 - a7, a2 - a6, a1 - a5, a0 - a4],
        dim=dim,
    )


def idct8(x: torch.Tensor) -> torch.Tensor:
    """Inverse 1-D transform along the last axis (length 8)."""
    return idct8_dim(x, -1)
