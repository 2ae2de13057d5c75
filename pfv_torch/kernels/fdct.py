"""K6, forward DCT + quantization (csrc/fdct_kernel.cu), and its plain
version.

`fdct_blocks` maps (N, 16, 16) u8 macroblocks and a (64,) int32 q-table to
(N, 4, 64) int16 zigzag coefficients. Without `win` it is the intra encode,
`ops.iframe.encode_blocks`; with `win`, the motion search's (N, 16, 16) u8
winning windows, it is the delta encode,
`ops.pframe.encode_delta_blocks(calc_residuals(blocks, win), q)`. A CPU
tensor goes to the plain versions; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from pfv_torch.ops.iframe import encode_blocks as encode_blocks_plain
from pfv_torch.ops.pframe import calc_residuals, encode_delta_blocks

__all__ = ["encode_blocks_plain", "encode_delta_blocks_plain", "fdct_blocks",
           "fdct_blocks_plain"]


def encode_delta_blocks_plain(blocks: torch.Tensor, win: torch.Tensor,
                              q_table: torch.Tensor) -> torch.Tensor:
    """The delta entry in plain PyTorch: residuals, then their encode."""
    return encode_delta_blocks(calc_residuals(blocks, win), q_table)


def fdct_blocks_plain(blocks: torch.Tensor, q_table: torch.Tensor,
                      win: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of `fdct_blocks`."""
    if win is None:
        return encode_blocks_plain(blocks, q_table)
    return encode_delta_blocks_plain(blocks, win, q_table)


def _check(blocks, q_table, win):
    for name, t in (("blocks", blocks), ("win", win)):
        if t is None:
            continue
        if t.dtype != torch.uint8 or t.dim() != 3 or tuple(t.shape[1:]) != (16, 16):
            raise ValueError(f"expected (N, 16, 16) uint8 {name}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"{name} must be contiguous and 4-byte aligned")
    if win is not None and win.shape != blocks.shape:
        raise ValueError(f"win {tuple(win.shape)} is not shaped like blocks "
                         f"{tuple(blocks.shape)}")
    if q_table.dtype != torch.int32 or tuple(q_table.shape) != (64,):
        raise ValueError(f"expected a (64,) int32 q-table, got {q_table.dtype} "
                         f"{tuple(q_table.shape)}")
    if not q_table.is_contiguous():
        raise ValueError("q-table must be contiguous")
    if any(t is not None and t.device != blocks.device for t in (q_table, win)):
        raise ValueError("all inputs must be on one device")


def fdct_blocks(blocks: torch.Tensor, q_table: torch.Tensor,
                win: torch.Tensor | None = None) -> torch.Tensor:
    """(N, 16, 16) u8 blocks (and windows) -> (N, 4, 64) int16 zigzag
    coefficients."""
    _check(blocks, q_table, win)
    if blocks.device.type == "cpu":
        return fdct_blocks_plain(blocks, q_table, win)
    if blocks.device.type != "cuda":
        raise ValueError(f"no forward-DCT kernel for device {blocks.device}")
    from pfv_torch.kernels import build

    lib = build.lib()
    n = blocks.shape[0]
    out = torch.empty((n, 4, 64), dtype=torch.int16, device=blocks.device)
    if n:
        rc = lib.pfv_fdct_blocks(
            blocks.data_ptr(), None if win is None else win.data_ptr(),
            q_table.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream(blocks.device).cuda_stream)
        if rc:
            raise RuntimeError(f"forward-DCT kernel launch failed: CUDA error {rc}")
        fdct_blocks.launches += 1
    return out


fdct_blocks.launches = 0
