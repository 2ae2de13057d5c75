"""Dequantization of PFV v2.1.1 (counterpart of pfv_tpu/ops/quant.py).

Dequantize indexes the scale factor and the q-table by the zigzag slot, not
the row-major position (quirk Q1, FORMAT.md); the decode path folds both into
per-row multipliers with INV_ZIGZAG_TABLE.
"""

from __future__ import annotations

import numpy as np
import torch

# 24.8 fixed-point scale factors applied at both encode and decode.
DCT_SCALE_FACTOR = np.array(
    [
        32, 37, 34, 26, 32, 26, 34, 37,
        37, 43, 39, 31, 37, 31, 39, 43,
        34, 39, 35, 28, 34, 28, 35, 39,
        26, 31, 28, 22, 26, 22, 28, 31,
        32, 37, 34, 26, 32, 26, 34, 37,
        26, 31, 28, 22, 26, 22, 28, 31,
        34, 39, 35, 28, 34, 28, 35, 39,
        37, 43, 39, 31, 37, 31, 39, 43,
    ],
    dtype=np.int32,
)

# ZIGZAG_TABLE[i] = row-major element index written to zigzag slot i.
ZIGZAG_TABLE = np.array(
    [
        0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
        12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
        35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
        58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    ],
    dtype=np.int32,
)

# INV_ZIGZAG_TABLE[i] = zigzag slot holding row-major element i.
INV_ZIGZAG_TABLE = np.array(
    [
        0, 1, 5, 6, 14, 15, 27, 28, 2, 4, 7, 13, 16, 26, 29, 42,
        3, 8, 12, 17, 25, 30, 41, 43, 9, 11, 18, 24, 31, 40, 44, 53,
        10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
        21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63,
    ],
    dtype=np.int32,
)


def dequantize(qm: torch.Tensor, q_table: torch.Tensor) -> torch.Tensor:
    """Dequantize zigzag coefficients (..., 64) i16 -> row-major (..., 64) i32.

    out[..., i] = qm[iz] * SCALE[iz] * q[iz], iz = INV_ZIGZAG_TABLE[i]: SCALE
    and q indexed by the zigzag slot (quirk Q1). q_table broadcasts against
    qm ((64,) for one plane, (N, 1, 64) per block). The products wrap in
    int32, as the reference's release build does.
    """
    iz = torch.from_numpy(INV_ZIGZAG_TABLE).long().to(qm.device)
    scale = torch.from_numpy(DCT_SCALE_FACTOR).to(qm.device)[iz]
    val = qm[..., iz].to(torch.int32) * scale
    return val * torch.broadcast_to(q_table, qm.shape)[..., iz].to(torch.int32)
