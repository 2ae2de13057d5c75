"""Whole-plane encode and decode steps on one device (counterpart of
pfv_tpu/device.py).

Each decode step decodes every macroblock of one padded plane in one
launch of the frame step (kernels/frame_step.py, one descriptor): the
blocks land in the output plane in raster order, P blocks from the window
of the reference plane. The output may be a strided view of a fused canvas;
it never overlaps the reference. Each encode step encodes every macroblock
of a plane (K6, after the motion search for P) and reconstructs it in the
loop through the decode step, so the reconstruction the next frame is
predicted from never leaves the device.
"""

from __future__ import annotations

import numpy as np
import torch

from pfv_torch.kernels.frame_step import FrameStep, plane_layout
from pfv_torch.ops.blocks import block_origins, plane_to_blocks
from pfv_torch.ops.iframe import encode_blocks_best
from pfv_torch.ops.pframe import encode_plane_delta


def origins_for(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Raster-order (by, bx) int32 block origins of an (h, w) plane."""
    return tuple(torch.from_numpy(o).to(device) for o in block_origins(h, w))


def plane_step(q_table, h: int, w: int, device) -> FrameStep:
    """The frame step of one padded (h, w) plane over one (64,) q-table
    (host values): the decode steps' and the encoders' in-loop step."""
    if isinstance(q_table, torch.Tensor):
        q_table = q_table.cpu().numpy()
    return FrameStep(np.asarray(q_table).reshape(1, 64), plane_layout(h, w), device)


def iframe_decode_plane(coeffs, step: FrameStep, out) -> torch.Tensor:
    """(N, 256) i16 coeffs -> the padded (H, W) u8 plane `out`, through
    `step` (a `plane_step`)."""
    return step(coeffs, None, (0,), None, out)


def pframe_decode_plane(coeffs, mvx, mvy, has_coeff, ref_plane, step: FrameStep,
                        out) -> torch.Tensor:
    """(N, 256) i16 coeffs + (N,) int8 motion and u8 coded flags -> the
    reconstructed padded (H, W) u8 plane `out` (never overlapping
    `ref_plane`), through `step` (a `plane_step`)."""
    return step(coeffs, (mvy, mvx, has_coeff), (0,), ref_plane, out)


def iframe_encode_plane(plane, q_table, by, bx, out=None, step=None):
    """Padded (H, W) u8 plane -> ((N, 256) i16 coeffs, its (H, W) u8
    reconstruction, written into `out` if given). by, bx: the raster
    origins, which the decode step implies; `step`: the plane's
    `plane_step` over q_table, made here when not given (an encoder makes
    it once)."""
    del by, bx
    coeffs = encode_blocks_best(plane_to_blocks(plane), q_table)
    coeffs = coeffs.view(coeffs.shape[0], 256)
    if out is None:
        out = torch.empty_like(plane, memory_format=torch.contiguous_format)
    if step is None:
        step = plane_step(q_table, *plane.shape, plane.device)
    return coeffs, iframe_decode_plane(coeffs, step, out)


def pframe_encode_plane(plane, ref_plane, q_table, min_err, by, bx, out=None,
                        step=None):
    """Inter-encode one padded plane against the reconstructed previous
    plane `ref_plane`.

    Returns (coeffs (N, 256) i16, mv_x (N,) int8, mv_y (N,) int8,
    has_coeff (N,) bool, recon (H, W) u8, written into `out` if given;
    `out` must not overlap `ref_plane`). `step` as `iframe_encode_plane`'s.
    """
    coeffs, mv_x, mv_y, has_coeff = encode_plane_delta(
        plane_to_blocks(plane), ref_plane, by, bx, q_table, min_err)
    n = coeffs.shape[0]
    coeffs = coeffs.view(n, 256)
    mv_x, mv_y = mv_x.to(torch.int8), mv_y.to(torch.int8)
    if out is None:
        out = torch.empty_like(ref_plane, memory_format=torch.contiguous_format)
    if step is None:
        step = plane_step(q_table, *plane.shape, plane.device)
    recon = pframe_decode_plane(coeffs, mv_x, mv_y, has_coeff.view(torch.uint8),
                                ref_plane, step, out)
    return coeffs, mv_x, mv_y, has_coeff, recon


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
