"""Quantization and dequantization of PFV v2.1.1, and the encoder's
q-tables (counterpart of pfv_tpu/ops/quant.py).

Quantize indexes the scale factor and the q-table by the row-major position
of the coefficient it writes to a zigzag slot; dequantize indexes them by the
zigzag slot. The two disagree at 56 of 64 positions, and the format needs
the asymmetry (quirk Q1, FORMAT.md).
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

# Base quantization tables.
Q_TABLE_INTRA = np.array(
    [
        8, 16, 19, 22, 26, 27, 29, 34,
        16, 16, 22, 24, 27, 29, 34, 37,
        19, 22, 26, 27, 29, 34, 34, 38,
        22, 22, 26, 27, 29, 34, 37, 40,
        22, 26, 27, 29, 32, 35, 40, 48,
        26, 27, 29, 32, 35, 40, 48, 58,
        26, 27, 29, 34, 38, 46, 56, 69,
        27, 29, 35, 38, 46, 56, 69, 83,
    ],
    dtype=np.int32,
)

Q_TABLE_INTER = np.full(64, 16, dtype=np.int32)

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


def trunc_div(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Signed integer division truncating toward zero (Rust `/`), d > 0."""
    return torch.div(n, d, rounding_mode="trunc")


Q_MAX = 65535  # the largest divisor the format's u16 q-tables hold


def reciprocals(q_table) -> np.ndarray:
    """R = ceil(2^31 / q) as uint32, for divisors 1 <= q <= Q_MAX (host
    values, any shape): what kernel K6 multiplies by instead of dividing
    (`trunc_div_by_reciprocal`). Raises ValueError outside that range."""
    q = np.asarray(q_table, dtype=np.int64)
    if q.size and (q.min() < 1 or q.max() > Q_MAX):
        raise ValueError(f"q-table entries must be in 1..{Q_MAX}, got "
                         f"{int(q.min())}..{int(q.max())}")
    return ((2**31 + q - 1) // q).astype(np.uint32)


def trunc_div_by_reciprocal(n: torch.Tensor, recip: torch.Tensor) -> torch.Tensor:
    """`trunc_div(n, q)` as kernel K6 computes it, for -32768 <= n <= 32767
    (an int32 shifted right by 16) and recip = `reciprocals(q)` as int64:
    sign(n) * ((2 |n| * R) >> 32), no division. n * R / 2^31 exceeds n / q
    by less than 2^-16 < 1 / q, so the floor is that of |n| / q."""
    mag = (2 * n.abs().to(torch.int64) * recip) >> 32
    return (torch.sign(n) * mag).to(n.dtype)


def _numerators(m: torch.Tensor, q_table: torch.Tensor):
    """What `quantize` divides, in zigzag order: (m[idx] * SCALE[idx]) >> 16
    and q[idx] as int32, idx = ZIGZAG_TABLE."""
    idx = torch.from_numpy(ZIGZAG_TABLE).long().to(m.device)
    scale = torch.from_numpy(DCT_SCALE_FACTOR).to(m.device)[idx]
    n = (m[..., idx] * scale) >> 16
    return n, torch.broadcast_to(q_table, m.shape)[..., idx].to(torch.int32)


def quantize(m: torch.Tensor, q_table: torch.Tensor) -> torch.Tensor:
    """Quantize row-major DCT coefficients (..., 64) i32 -> zigzag (..., 64) i16.

    out[..., i] = ((m[idx] * SCALE[idx]) >> 16) / q[idx], idx = ZIGZAG_TABLE[i]:
    SCALE and q indexed by the row-major position (quirk Q1). The shift
    floors and the division truncates, two different roundings. q_table
    broadcasts against m.
    """
    return trunc_div(*_numerators(m, q_table)).to(torch.int16)


def quantize_by_reciprocal(m: torch.Tensor, q_table: torch.Tensor) -> torch.Tensor:
    """`quantize` dividing as kernel K6 does, by `trunc_div_by_reciprocal`
    (q_table entries in 1..Q_MAX): what the tests hold to `quantize`."""
    n, d = _numerators(m, q_table)
    recip = torch.from_numpy(reciprocals(d.cpu().numpy()).astype(np.int64)).to(m.device)
    return trunc_div_by_reciprocal(n, recip).to(torch.int16)


def derive_q_tables(quality: int) -> dict[str, np.ndarray]:
    """The encoder's four (64,) int32 q-tables for quality 0..=10.

    float32 numpy math, op for op as the reference encoder, and its
    truncating cast: max(base * quality * 0.25 {* 0.5 for luma}, 1.0).
    Quality is inverted (quirk Q4): higher is coarser.
    """
    if not 0 <= quality <= 10:
        raise ValueError("quality must be in 0..=10")
    qscale = np.float32(quality) * np.float32(0.25)

    def derive(base: np.ndarray, lum_scale: bool) -> np.ndarray:
        x = base.astype(np.float32) * qscale
        if lum_scale:
            x = x * np.float32(0.5)
        return np.maximum(x, np.float32(1.0)).astype(np.int32)

    return {
        "intra_l": derive(Q_TABLE_INTRA, True),
        "intra_c": derive(Q_TABLE_INTRA, False),
        "inter_l": derive(Q_TABLE_INTER, True),
        "inter_c": derive(Q_TABLE_INTER, False),
    }
