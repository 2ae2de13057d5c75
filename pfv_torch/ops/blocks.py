"""Macroblock layout transforms (counterpart of pfv_tpu/ops/blocks.py).

plane <-> (N, 16, 16) macroblocks in raster order <-> (N, 4, 8, 8)
subblocks in [top-left, top-right, bottom-left, bottom-right] order, each
8x8 row-major. Pure reshapes and permutes.
"""

from __future__ import annotations

import numpy as np
import torch


def pad_dim(x: int, m: int = 16) -> int:
    """Padded size: x + (m - x % m) % m."""
    return x + (m - x % m) % m


def plane_to_blocks(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H/16 * W/16, 16, 16) macroblocks in raster order,
    contiguous (for a plane one block high the reshape alone is a strided
    view, which the kernels refuse)."""
    h, w = plane.shape
    if h % 16 or w % 16:
        raise ValueError(f"plane {h}x{w} is not whole 16x16 blocks")
    return plane.reshape(h // 16, 16, w // 16, 16).permute(0, 2, 1, 3).reshape(
        -1, 16, 16).contiguous()


def blocks_to_plane(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, 16, 16) raster-order macroblocks -> (h, w) plane."""
    if h % 16 or w % 16:
        raise ValueError(f"plane {h}x{w} is not whole 16x16 blocks")
    return blocks.reshape(h // 16, w // 16, 16, 16).permute(0, 2, 1, 3).reshape(h, w)


def blocks_to_subblocks(blocks: torch.Tensor) -> torch.Tensor:
    """(N, 16, 16) -> (N, 4, 8, 8), subblocks in [TL, TR, BL, BR] order."""
    n = blocks.shape[0]
    return blocks.reshape(n, 2, 8, 2, 8).permute(0, 1, 3, 2, 4).reshape(n, 4, 8, 8)


def subblocks_to_blocks(sub: torch.Tensor) -> torch.Tensor:
    """(N, 4, 8, 8) [TL, TR, BL, BR] -> (N, 16, 16)."""
    n = sub.shape[0]
    return sub.reshape(n, 2, 2, 8, 8).permute(0, 1, 3, 2, 4).reshape(n, 16, 16)


def block_grid(h: int, w: int) -> tuple[int, int]:
    """(blocks_high, blocks_wide) for a padded plane."""
    return h // 16, w // 16


def block_origins(h: int, w: int) -> tuple[np.ndarray, np.ndarray]:
    """Raster-order (by*16, bx*16) int32 pixel origins of each macroblock."""
    bh, bw = block_grid(h, w)
    by, bx = np.meshgrid(np.arange(bh), np.arange(bw), indexing="ij")
    return (by.reshape(-1) * 16).astype(np.int32), (bx.reshape(-1) * 16).astype(np.int32)
