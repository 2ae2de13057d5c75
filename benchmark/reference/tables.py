"""The format's constant tables (FORMAT.md; pfv-rs `dct.rs`, `common.rs`)
and the encoder's q-tables (`enc.rs:48-51`)."""

from __future__ import annotations

import numpy as np

DCT_SCALE_FACTOR = np.array([
    32, 37, 34, 26, 32, 26, 34, 37, 37, 43, 39, 31, 37, 31, 39, 43,
    34, 39, 35, 28, 34, 28, 35, 39, 26, 31, 28, 22, 26, 22, 28, 31,
    32, 37, 34, 26, 32, 26, 34, 37, 26, 31, 28, 22, 26, 22, 28, 31,
    34, 39, 35, 28, 34, 28, 35, 39, 37, 43, 39, 31, 37, 31, 39, 43,
], dtype=np.int64)

Q_TABLE_INTRA = np.array([
    8, 16, 19, 22, 26, 27, 29, 34, 16, 16, 22, 24, 27, 29, 34, 37,
    19, 22, 26, 27, 29, 34, 34, 38, 22, 22, 26, 27, 29, 34, 37, 40,
    22, 26, 27, 29, 32, 35, 40, 48, 26, 27, 29, 32, 35, 40, 48, 58,
    26, 27, 29, 34, 38, 46, 56, 69, 27, 29, 35, 38, 46, 56, 69, 83,
], dtype=np.int64)

Q_TABLE_INTER = np.full(64, 16, dtype=np.int64)

# ZIGZAG[i]: the row-major element written to zigzag slot i
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int64)

# INV_ZIGZAG[i]: the zigzag slot that holds row-major element i
INV_ZIGZAG = np.argsort(ZIGZAG)

INTRA_QIDX = (0, 1, 1)  # the q-table indices an encoder writes for Y, U, V
INTER_QIDX = (2, 3, 3)


def q_tables(quality: int) -> np.ndarray:
    """(4, 64) int64: intra-luma, intra-chroma, inter-luma, inter-chroma,
    max(1, base * quality * 0.25 (* 0.5 for luma)) in float32, truncated."""
    qscale = np.float32(quality) * np.float32(0.25)
    out = []
    for base in (Q_TABLE_INTRA, Q_TABLE_INTER):
        for luma in (True, False):
            v = base.astype(np.float32) * qscale
            if luma:
                v = v * np.float32(0.5)
            out.append(np.maximum(v, np.float32(1.0)).astype(np.int64))
    return np.stack(out)


def skip_threshold(quality: int) -> np.float32:
    """The encoder's skip rule: SSD <= (quality * 1.5)^2 * 256, float32."""
    px = np.float32(quality) * np.float32(1.5)
    return px * px * np.float32(256.0)


def pad16(x: int) -> int:
    return x + (16 - x % 16) % 16


def plane_dims(width: int, height: int):
    """[(rows, cols)] of the padded Y, U and V planes (4:2:0)."""
    c = (pad16(height // 2), pad16(width // 2))
    return [(pad16(height), pad16(width)), c, c]
