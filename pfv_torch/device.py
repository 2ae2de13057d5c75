"""Whole-plane encode and decode steps on one device (counterpart of
pfv_tpu/device.py).

Each decode step decodes every macroblock of one padded plane: K5 turns the
coefficients into blocks, K7 places them into the output plane, taking
the window of the reference plane for P blocks. The output may be a strided
view of a fused canvas; it never overlaps the reference. Each encode step
encodes every macroblock of a plane (K6, after the motion search for P)
and reconstructs it in the loop through the decode step, so the
reconstruction the next frame is predicted from never leaves the device.
"""

from __future__ import annotations

import numpy as np
import torch

from pfv_torch.kernels.mc import mc_reconstruct
from pfv_torch.ops.blocks import block_origins, plane_to_blocks
from pfv_torch.ops.iframe import decode_blocks_best, encode_blocks_best
from pfv_torch.ops.pframe import decode_delta_blocks, encode_plane_delta


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


def iframe_encode_plane(plane, q_table, by, bx, out=None):
    """Padded (H, W) u8 plane -> ((N, 256) i16 coeffs, its (H, W) u8
    reconstruction, written into `out` if given)."""
    coeffs = encode_blocks_best(plane_to_blocks(plane), q_table)
    coeffs = coeffs.view(coeffs.shape[0], 256)
    return coeffs, iframe_decode_plane(coeffs, q_table, plane, by, bx, out)


def pframe_encode_plane(plane, ref_plane, q_table, min_err, by, bx, out=None):
    """Inter-encode one padded plane against the reconstructed previous
    plane `ref_plane`.

    Returns (coeffs (N, 256) i16, mv_x (N,) int8, mv_y (N,) int8,
    has_coeff (N,) bool, recon (H, W) u8, written into `out` if given;
    `out` must not overlap `ref_plane`).
    """
    coeffs, mv_x, mv_y, has_coeff = encode_plane_delta(
        plane_to_blocks(plane), ref_plane, by, bx, q_table, min_err)
    n = coeffs.shape[0]
    mv_x, mv_y = mv_x.to(torch.int8), mv_y.to(torch.int8)
    recon = decode_delta_blocks(coeffs, q_table, ref_plane, by, bx, mv_y, mv_x,
                                has_coeff.to(torch.uint8), out)
    return coeffs.view(n, 256), mv_x, mv_y, has_coeff, recon


def plane_mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared error between two u8 planes, float32 (encoder PSNR)."""
    d = a.to(torch.float32) - b.to(torch.float32)
    return torch.mean(d * d)


def pad_plane_host(plane: np.ndarray, pad_h: int, pad_w: int, clear: int,
                   device) -> torch.Tensor:
    """An unpadded host plane padded to (pad_h, pad_w) with `clear`, as a
    tensor on `device`."""
    h, w = plane.shape
    out = np.full((pad_h, pad_w), clear, dtype=np.uint8)
    out[:h, :w] = plane
    return torch.from_numpy(out).to(device)
