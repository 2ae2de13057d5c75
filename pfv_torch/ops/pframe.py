"""P-frame block decode (counterpart of the decode half of
pfv_tpu/ops/pframe.py).

The JAX package's `mc_mode="mxu"` (one-hot matmul windows) works around the
TPU's slow gathers and is not ported: kernel K7 reads each window with an
indexed load.
"""

from __future__ import annotations

import torch

from pfv_torch.ops.iframe import decode_blocks_best


def apply_residuals(res_u8: torch.Tensor, pred_blocks: torch.Tensor) -> torch.Tensor:
    """Reconstruct: clamp(pred + (res - 128) * 2, 0, 255) as uint8."""
    d = (res_u8.to(torch.int32) - 128) * 2
    return torch.clamp(pred_blocks.to(torch.int32) + d, 0, 255).to(torch.uint8)


def decode_delta_blocks(coeffs, q_table, ref_plane, by, bx, mv_y, mv_x,
                        has_coeff, out=None) -> torch.Tensor:
    """Decode (N, 4, 64) delta coeffs through K5 + K7 into a plane.

    Each block takes the window of `ref_plane` at its origin (by, bx) plus
    its motion vector; a block with coefficients adds its decoded residual
    (clamp(win + (res - 128) * 2)), the others pass the window through.
    Skipped blocks carry zero coefficients, which K5 decodes to values that
    K7 discards. Unlike the JAX function, which returns the (N, 16, 16)
    blocks, the blocks land at their origins in the returned plane: `out`
    if given (same shape as `ref_plane`, never overlapping it), else a new
    one.
    """
    from pfv_torch.kernels.mc import mc_reconstruct

    res = decode_blocks_best(coeffs, q_table)
    return mc_reconstruct(res, ref_plane, by, bx, mv_y, mv_x, has_coeff,
                          False, out)
