"""K5, dequantize + 2-D integer iDCT + clamp (csrc/idct_kernel.cu), and its
plain version.

`decode_blocks` maps (N, 4, 64) int16 zigzag coefficients and a (64,) int32
q-table to (N, 16, 16) u8 macroblocks, exactly as `ops.iframe.decode_blocks`
does. A CPU tensor goes to `decode_blocks_plain`; a CUDA tensor launches the
kernel or raises. It is the port's form of the JAX package's per-plane
`decode_blocks_pallas`; the decoders and the encoders run the frame step
(kernels/frame_step.py) in its place.
"""

from __future__ import annotations

import torch

from pfv_torch.ops.iframe import decode_blocks as decode_blocks_plain

__all__ = ["decode_blocks", "decode_blocks_plain"]


def _check(coeffs, q_table):
    if coeffs.dtype != torch.int16 or coeffs.dim() != 3 or tuple(coeffs.shape[1:]) != (4, 64):
        raise ValueError(f"expected (N, 4, 64) int16 coefficients, got "
                         f"{coeffs.dtype} {tuple(coeffs.shape)}")
    if q_table.dtype != torch.int32 or tuple(q_table.shape) != (64,):
        raise ValueError(f"expected a (64,) int32 q-table, got "
                         f"{q_table.dtype} {tuple(q_table.shape)}")
    if q_table.device != coeffs.device:
        raise ValueError("coefficients and q-table must be on one device")
    if not (coeffs.is_contiguous() and q_table.is_contiguous()):
        raise ValueError("coefficients and q-table must be contiguous")


def decode_blocks(coeffs: torch.Tensor, q_table: torch.Tensor) -> torch.Tensor:
    """(N, 4, 64) int16 zigzag coefficients -> (N, 16, 16) u8 macroblocks."""
    _check(coeffs, q_table)
    if coeffs.device.type == "cpu":
        return decode_blocks_plain(coeffs, q_table)
    if coeffs.device.type != "cuda":
        raise ValueError(f"no iDCT kernel for device {coeffs.device}")
    from pfv_torch.kernels import build

    n = coeffs.shape[0]
    out = torch.empty((n, 16, 16), dtype=torch.uint8, device=coeffs.device)
    if n:
        rc = build.launch("pfv_idct_blocks", coeffs.device, coeffs.data_ptr(),
                          q_table.data_ptr(), out.data_ptr(), 4 * n)
        if rc:
            raise RuntimeError(f"iDCT kernel launch failed: CUDA error {rc}")
        build.count(decode_blocks)
    return out


decode_blocks.launches = 0
