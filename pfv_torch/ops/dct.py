"""Integer 8x8 forward and inverse DCT on int32 tensors (counterpart of
pfv_tpu/ops/dct.py).

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


def fdct8_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Forward 1-D transform along `dim` (length 8), int32 in and out,
    including the reference's output permutation."""
    i0, i1, i2, i3, i4, i5, i6, i7 = x.unbind(dim)
    a0 = i0 + i7
    a1 = i1 + i6
    a2 = i2 + i5
    a3 = i3 + i4
    a4 = i0 - i7
    a5 = i1 - i6
    a6 = i2 - i5
    a7 = i3 - i4
    b0 = a0 + a3
    b1 = a1 + a2
    b2 = a0 - a3
    b3 = a1 - a2
    c0 = b0 + b1
    c1 = b0 - b1
    c2 = b2 + tdiv_pow2(b2, 2) + tdiv_pow2(b3, 1)
    c3 = tdiv_pow2(b2, 1) - b3 - tdiv_pow2(b3, 2)
    b4 = tdiv_pow2(a7, 2) + a4 + tdiv_pow2(a4, 2) - tdiv_pow2(a4, 4)
    b7 = tdiv_pow2(a4, 2) - a7 - tdiv_pow2(a7, 2) + tdiv_pow2(a7, 4)
    b5 = a5 + a6 - tdiv_pow2(a6, 2) - tdiv_pow2(a6, 4)
    b6 = a6 - a5 + tdiv_pow2(a5, 2) + tdiv_pow2(a5, 4)
    c4 = b4 + b5
    c5 = b4 - b5
    c6 = b6 + b7
    c7 = b6 - b7
    return torch.stack([c0, c4, c2, c5 - c7, c1, c5 + c7, c3, c6], dim=dim)


def fdct8(x: torch.Tensor) -> torch.Tensor:
    """Forward 1-D transform along the last axis (length 8)."""
    return fdct8_dim(x, -1)


def fdct2d(m: torch.Tensor) -> torch.Tensor:
    """2-D forward DCT of (..., 8, 8) int32: rows first, then columns. The
    order matters: the truncating divisions are not linear."""
    return fdct8_dim(fdct8_dim(m, -1), -2)


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
