"""Whole-plane and whole-frame encode and decode steps on one device
(counterpart of pfv_tpu/device.py).

Each decode step decodes every macroblock of one padded plane in one
launch of the frame step (kernels/frame_step.py, one descriptor): the
blocks land in the output plane in raster order, P blocks from the window
of the reference plane. The output may be a strided view of a fused canvas;
it never overlaps the reference. The per-plane encode steps encode every
macroblock of a plane (K6's per-plane entry, after the motion search for P)
and reconstruct it through the decode step. The block entries below them
(`encode_blocks_best`, `decode_blocks_best`, `encode_plane_delta`,
`decode_delta_blocks`) run the kernels on a CUDA tensor and their plain
versions (`ops/`) on a CPU one.

The encoders work a frame at a time, through a `FrameEncoder`: the
reconstruction lives in two fused canvases that swap, and a frame costs, for
a P-frame, one launch of the motion search (kernels/motion.py, K8: Y, U and
V against views of the previous canvas), then one launch of the frame-encode
step (kernels/fdct.py, K6: Y, U and V) and one of the frame step, which
reconstructs the frame exactly as a decoder will. The reconstruction the
next frame is predicted from never leaves the device. The source planes go
up as they come and are padded to whole macroblocks on the device
(`upload_padded`).
"""

from __future__ import annotations

import numpy as np
import torch

from pfv_torch.frame import Geometry, canvas_layout, canvas_planes
from pfv_torch.kernels.fdct import FrameEncode, fdct_blocks
from pfv_torch.kernels.frame_step import FrameStep, plane_layout
from pfv_torch.kernels.idct import decode_blocks
from pfv_torch.kernels.mc import mc_reconstruct
from pfv_torch.kernels.motion import MotionSearch
from pfv_torch.ops.blocks import block_origins, plane_to_blocks
from pfv_torch.ops.motion import motion_search

QT_KEYS = ("intra_l", "intra_c", "inter_l", "inter_c")  # the container's order
INTRA_Q, INTER_Q = (0, 1, 1), (2, 3, 3)  # q-table indices of (Y, U, V)
PLANE_CLEAR = (0, 128, 128)  # what pads (Y, U, V) to whole macroblocks


def origins_for(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Raster-order (by, bx) int32 block origins of an (h, w) plane."""
    return tuple(torch.from_numpy(o).to(device) for o in block_origins(h, w))


def plane_step(q_table, h: int, w: int, device) -> FrameStep:
    """The frame step of one padded (h, w) plane over one (64,) q-table
    (host values): the per-plane decode steps'."""
    if isinstance(q_table, torch.Tensor):
        q_table = q_table.cpu().numpy()
    return FrameStep(np.asarray(q_table).reshape(1, 64), plane_layout(h, w), device)


def encode_blocks_best(blocks: torch.Tensor, q_table: torch.Tensor) -> torch.Tensor:
    """`ops.iframe.encode_blocks` through kernel K6 (kernels/fdct.py): the
    kernel on a CUDA tensor, the plain version on a CPU one."""
    return fdct_blocks(blocks, q_table)


def decode_blocks_best(coeffs: torch.Tensor, q_table: torch.Tensor) -> torch.Tensor:
    """`ops.iframe.decode_blocks` through kernel K5 (kernels/idct.py): the
    kernel on a CUDA tensor, the plain version on a CPU one."""
    return decode_blocks(coeffs, q_table)


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
    mv_x, mv_y, best_err, best_win = motion_search(cur_blocks, ref_plane, by, bx)
    has_coeff = best_err.to(torch.float32) > float(min_err)
    return fdct_blocks(cur_blocks, q_table, best_win), mv_x, mv_y, has_coeff


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
    res = decode_blocks_best(coeffs, q_table)
    return mc_reconstruct(res, ref_plane, by, bx, mv_y, mv_x, has_coeff,
                          False, out)


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


def iframe_encode_plane(plane, q_table, by, bx):
    """Padded (H, W) u8 plane -> ((N, 256) i16 coeffs, its (H, W) u8
    reconstruction). by, bx: the raster origins, which the decode step
    implies."""
    del by, bx
    coeffs = encode_blocks_best(plane_to_blocks(plane), q_table)
    coeffs = coeffs.view(coeffs.shape[0], 256)
    out = torch.empty_like(plane, memory_format=torch.contiguous_format)
    step = plane_step(q_table, *plane.shape, plane.device)
    return coeffs, iframe_decode_plane(coeffs, step, out)


def pframe_encode_plane(plane, ref_plane, q_table, min_err, by, bx):
    """Inter-encode one padded plane against the reconstructed previous
    plane `ref_plane`.

    Returns (coeffs (N, 256) i16, mv_x (N,) int8, mv_y (N,) int8,
    has_coeff (N,) bool, recon (H, W) u8).
    """
    coeffs, mv_x, mv_y, has_coeff = encode_plane_delta(
        plane_to_blocks(plane), ref_plane, by, bx, q_table, min_err)
    n = coeffs.shape[0]
    coeffs = coeffs.view(n, 256)
    mv_x, mv_y = mv_x.to(torch.int8), mv_y.to(torch.int8)
    out = torch.empty_like(ref_plane, memory_format=torch.contiguous_format)
    step = plane_step(q_table, *plane.shape, plane.device)
    recon = pframe_decode_plane(coeffs, mv_x, mv_y, has_coeff.view(torch.uint8),
                                ref_plane, step, out)
    return coeffs, mv_x, mv_y, has_coeff, recon


class FrameEncoder:
    """Encodes one frame at a time on `device` and reconstructs it in the
    loop, in three steps that can be timed apart: `search` (the motion
    search of a P-frame, one launch for Y, U and V), `transform` (the
    frame-encode step, one launch) and `reconstruct` (the frame step, one
    launch, then the canvases swap); `iframe` and `pframe` run them in
    order.

    g: the stream's geometry; qtables: `ops.quant.derive_q_tables`' dict;
    min_err: `ops.pframe.skip_threshold`'s value. A frame's `sources` are its
    three padded (Y, U, V) u8 planes on the device, `coeffs` the (nb, 256)
    i16 buffer its coefficients go to (zeros in blocks without
    coefficients), `motion` the (mvy, mvx, has_coeff) (nb,) int8, int8, uint8
    rows a P-frame's block headers go to. `check` holds them to the kernels
    once; the steps run unchecked."""

    def __init__(self, g: Geometry, qtables: dict, min_err, device):
        self.g = g
        self.min_err = float(min_err)
        qt = np.stack([qtables[k] for k in QT_KEYS])
        layout = canvas_layout(g)
        self.encode = FrameEncode(qt, layout, device)
        self.step = FrameStep(qt, layout, device)
        self.motion = MotionSearch(layout, self.min_err, device)
        self.device = self.step.device
        # the reconstructed previous frame (Y 0, U and V 128 before the
        # first), and the canvas the next frame is reconstructed into
        self.prev = torch.zeros((g.chh, g.cw), dtype=torch.uint8, device=self.device)
        self.prev[g.ly0:, :2 * g.lcw] = 128
        self.back = torch.empty_like(self.prev)

    def check(self, sources, coeffs, motion) -> None:
        """Raise ValueError unless the buffers of a P-frame (and so of an
        I-frame) fit the three kernels."""
        self.motion.check(sources, self.prev, motion)
        self.encode.check(sources, motion, INTER_Q, self.prev, coeffs)
        self.step.check(coeffs, motion, INTER_Q, self.prev, self.back)

    def planes(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Views of the padded (Y, U, V) planes of the reconstructed previous
        frame."""
        return canvas_planes(self.g, self.prev)

    def search(self, sources, motion) -> None:
        """K8: the motion search of every plane against the previous
        reconstruction: the winners' vectors and the coded flags (best SSD
        above min_err, in float32) into `motion`."""
        self.motion.launch(sources, self.prev, motion)

    def transform(self, sources, motion, coeffs) -> None:
        """K6: the frame's coefficients into `coeffs`; motion None for an
        I-frame."""
        self.encode.launch(sources, motion, INTRA_Q if motion is None else INTER_Q,
                           self.prev, coeffs)

    def reconstruct(self, coeffs, motion) -> None:
        """The in-loop frame step: what a decoder makes of `coeffs` becomes
        the previous frame."""
        self.step.launch(coeffs, motion, INTRA_Q if motion is None else INTER_Q,
                         self.prev, self.back)
        self.prev, self.back = self.back, self.prev

    def iframe(self, sources, coeffs) -> None:
        self.transform(sources, None, coeffs)
        self.reconstruct(coeffs, None)

    def pframe(self, sources, coeffs, motion) -> None:
        self.search(sources, motion)
        self.transform(sources, motion, coeffs)
        self.reconstruct(coeffs, motion)


def plane_mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean squared error between two u8 planes, float32 (encoder PSNR)."""
    d = a.to(torch.float32) - b.to(torch.float32)
    return torch.mean(d * d)


def padded_shapes(g: Geometry) -> tuple[tuple[int, int], ...]:
    """The padded (rows, columns) of the (Y, U, V) planes."""
    return (g.ly0, g.lyw), (g.lc0, g.lcw), (g.lc0, g.lcw)


def pad_planes(g: Geometry, planes, out=None) -> list[torch.Tensor]:
    """Unpadded (Y, U, V) u8 planes (..., h, w) on a device -> the planes
    padded to whole macroblocks on that device, Y with 0, U and V with 128:
    plain tensor copies. A plane that needs no padding is returned as it
    is. out: three padded planes whose padding holds the clear value
    already; then a plane that needs padding is copied into its own.
    `planes` may be an iterator: each plane is let go once it is copied."""
    res = []
    for i, (p, (ph, pw), clear) in enumerate(zip(planes, padded_shapes(g), PLANE_CLEAR)):
        if p.dtype != torch.uint8:
            raise ValueError(f"plane {i} must be uint8, not {p.dtype}")
        h, w = p.shape[-2:]
        if (h, w) == (ph, pw):
            res.append(p)
            continue
        dst = out[i] if out is not None else torch.full(
            (*p.shape[:-2], ph, pw), clear, dtype=torch.uint8, device=p.device)
        dst[..., :h, :w] = p
        res.append(dst)
    return res


def upload_padded(g: Geometry, planes, device, out=None) -> list[torch.Tensor]:
    """Unpadded (Y, U, V) host planes (..., h, w) -> padded u8 planes on
    `device`: each plane goes up as it comes, one copy, and is padded there
    (`pad_planes`) before the next goes up, so the card holds one unpadded
    plane at a time. A plane of another type than uint8 is refused."""
    up = (torch.from_numpy(np.ascontiguousarray(p)).to(device) for p in planes)
    return pad_planes(g, up, out)
