"""P-frame block encode and decode (counterpart of pfv_tpu/ops/pframe.py).

The JAX package's `mc_mode="mxu"` (one-hot matmul windows) works around the
TPU's slow gathers and is not ported: kernel K7 reads each window with an
indexed load.
"""

from __future__ import annotations

import numpy as np
import torch

from pfv_torch.ops.blocks import blocks_to_subblocks
from pfv_torch.ops.dct import FP_BITS, fdct2d, tdiv_pow2
from pfv_torch.ops.iframe import decode_blocks_best
from pfv_torch.ops.motion import motion_search
from pfv_torch.ops.quant import quantize


def calc_residuals(cur_blocks: torch.Tensor, pred_blocks: torch.Tensor) -> torch.Tensor:
    """(cur - pred).clamp(-255, 255) as int32."""
    d = cur_blocks.to(torch.int32) - pred_blocks.to(torch.int32)
    return torch.clamp(d, -255, 255)


def encode_delta_blocks(residuals: torch.Tensor, q_table: torch.Tensor) -> torch.Tensor:
    """Encode (N, 16, 16) int32 residuals -> (N, 4, 64) int16 coeffs: per
    subblock (x / 2) << 8 (truncating division), the 2-D forward DCT,
    quantize."""
    m = fdct2d(tdiv_pow2(blocks_to_subblocks(residuals), 1) << FP_BITS)
    return quantize(m.reshape(m.shape[0], 4, 64), q_table)


def skip_threshold(quality: int) -> np.float32:
    """The skip threshold min_err = (quality * 1.5)^2 * 256, in float32 as
    the reference computes it: a block whose best SSD is not above it is
    sent without coefficients."""
    px_err = np.float32(quality) * np.float32(1.5)
    return np.float32(px_err * px_err * np.float32(256.0))


def encode_plane_delta(cur_blocks: torch.Tensor, ref_plane: torch.Tensor,
                       by: torch.Tensor, bx: torch.Tensor, q_table: torch.Tensor,
                       min_err: np.float32):
    """Inter-encode one plane's (N, 16, 16) u8 macroblocks against the
    reconstructed previous plane: motion search, skip when the best SSD is
    not above `min_err` (float32), K6's delta entry for the coefficients.

    Returns (coeffs (N, 4, 64) i16, mv_x (N,) i32, mv_y (N,) i32,
    has_coeff (N,) bool). Coefficients are computed for every block;
    skipped blocks' are dropped when muxing.
    """
    from pfv_torch.kernels.fdct import fdct_blocks

    mv_x, mv_y, best_err, best_win = motion_search(cur_blocks, ref_plane, by, bx)
    has_coeff = best_err.to(torch.float32) > float(min_err)
    return fdct_blocks(cur_blocks, q_table, best_win), mv_x, mv_y, has_coeff


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
