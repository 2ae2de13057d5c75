"""I-frame block encode and decode (counterpart of pfv_tpu/ops/iframe.py).

Coefficients are (N, 4, 64) int16: N macroblocks in raster order, 4
subblocks [TL, TR, BL, BR], 64 zigzag-order coefficients, i.e. the
bitstream's 256 coefficients per block.
"""

from __future__ import annotations

import torch

from pfv_torch.ops.blocks import blocks_to_subblocks, subblocks_to_blocks
from pfv_torch.ops.dct import FP_BITS, fdct2d, idct8_dim
from pfv_torch.ops.quant import dequantize, quantize


def encode_blocks(blocks: torch.Tensor, q_table: torch.Tensor) -> torch.Tensor:
    """Intra-encode (N, 16, 16) uint8 macroblocks -> (N, 4, 64) int16 coeffs:
    per subblock (px - 128) << 8, the 2-D forward DCT, quantize."""
    sub = blocks_to_subblocks(blocks.to(torch.int32))
    m = fdct2d((sub - 128) << FP_BITS)
    return quantize(m.reshape(m.shape[0], 4, 64), q_table)


def decode_blocks(coeffs: torch.Tensor, q_table: torch.Tensor) -> torch.Tensor:
    """Intra-decode (N, 4, 64) int16 coeffs -> (N, 16, 16) uint8 macroblocks."""
    return decode_blocks_i32(coeffs, q_table).to(torch.uint8)


def decode_blocks_i32(coeffs: torch.Tensor, q_table: torch.Tensor) -> torch.Tensor:
    """decode_blocks keeping the (0..255) pixels in int32: per subblock
    dequantize, 2-D inverse DCT (columns, then rows), (x >> 8) + 128
    clamped to 0..255."""
    n = coeffs.shape[0]
    m = dequantize(coeffs, q_table).view(n, 4, 8, 8)
    m = idct8_dim(idct8_dim(m, 2), 3)
    return subblocks_to_blocks(torch.clamp((m >> FP_BITS) + 128, 0, 255))
