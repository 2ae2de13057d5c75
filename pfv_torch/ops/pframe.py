"""P-frame block encode and decode (counterpart of pfv_tpu/ops/pframe.py).

The JAX package's `mc_mode="mxu"` (one-hot matmul windows) works around the
TPU's slow gathers and is not ported: kernel K7 reads each window with an
indexed load. The per-plane entries that run the kernels,
`encode_plane_delta` and `decode_delta_blocks`, are in `device.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from pfv_torch.ops.blocks import blocks_to_subblocks
from pfv_torch.ops.dct import FP_BITS, fdct2d, tdiv_pow2
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


def apply_residuals(res_u8: torch.Tensor, pred_blocks: torch.Tensor) -> torch.Tensor:
    """Reconstruct: clamp(pred + (res - 128) * 2, 0, 255) as uint8."""
    d = (res_u8.to(torch.int32) - 128) * 2
    return torch.clamp(pred_blocks.to(torch.int32) + d, 0, 255).to(torch.uint8)
