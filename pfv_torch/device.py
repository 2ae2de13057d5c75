"""Whole-plane decode steps on one device (counterpart of the decode half of
pfv_tpu/device.py).

Each step decodes every macroblock of one padded plane: K5 turns the
coefficients into blocks, K7 places them into the output plane, taking
the window of the reference plane for P blocks. The output may be a strided
view of a fused canvas; it never overlaps the reference. The encode halves
come with the encoder.
"""

from __future__ import annotations

import torch

from pfv_torch.kernels.mc import mc_reconstruct
from pfv_torch.ops.blocks import block_origins
from pfv_torch.ops.iframe import decode_blocks_best
from pfv_torch.ops.pframe import decode_delta_blocks


def origins_for(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Raster-order (by, bx) int32 block origins of an (h, w) plane."""
    return tuple(torch.from_numpy(o).to(device) for o in block_origins(h, w))


def iframe_decode_plane(coeffs, q_table, like, by, bx, out=None) -> torch.Tensor:
    """(N, 256) i16 coeffs -> padded (H, W) u8 plane shaped like `like`
    (written into `out` if given). K7 places the blocks in intra mode, so
    its motion inputs are zeros and `like` is not read."""
    n = coeffs.shape[0]
    blocks = decode_blocks_best(coeffs.view(n, 4, 64), q_table)
    zero = torch.zeros(n, dtype=torch.int8, device=coeffs.device)
    return mc_reconstruct(blocks, like, by, bx, zero, zero, zero.view(torch.uint8),
                          True, out)


def pframe_decode_plane(coeffs, mvx, mvy, has_coeff, ref_plane, q_table, by, bx,
                        out=None) -> torch.Tensor:
    """(N, 256) i16 coeffs + (N,) int8 motion and u8 coded flags ->
    reconstructed padded (H, W) u8 plane (written into `out` if given)."""
    n = coeffs.shape[0]
    return decode_delta_blocks(coeffs.view(n, 4, 64), q_table, ref_plane, by, bx,
                               mvy, mvx, has_coeff, out)
