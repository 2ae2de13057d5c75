"""K6, the frame-encode step: forward DCT + quantization of every macroblock
of a frame in one launch (csrc/fdct_kernel.cu), and its plain version.

A `FrameEncode` encodes the macroblocks of one to three padded planes of a
frame: it is built once per layout (the planes' blocks in the frame's
raster-order blocks and their places in the reconstruction canvas, `PlaneAt`
as the frame step's) and q-tables. A call takes the padded source planes
(2-D u8, unit column stride, 16-byte aligned rows; they may be three
tensors), for a P-frame the (mvy, mvx, has_coeff) header rows and the
previous reconstruction canvas, one q-table index per plane, and the
(nb, 256) i16 buffer the zigzag coefficients go to. A P-block is predicted
from the window of its plane at its origin plus its vector (the frame
step's rule for vectors that leave the plane) and a block without
coefficients gets zeros.

`fdct_blocks` is the per-plane entry: (N, 16, 16) u8 macroblocks and a (64,)
int32 q-table -> (N, 4, 64) int16 zigzag coefficients. Without `win` it is
the intra encode, `ops.iframe.encode_blocks`; with `win`, (N, 16, 16) u8
prediction windows, it is the delta encode,
`ops.pframe.encode_delta_blocks(calc_residuals(blocks, win), q)`. The kernel
takes the blocks as a plane 16 pixels wide.

A CPU tensor goes to the plain versions; a CUDA tensor launches the kernel
or raises. The kernel divides by multiplying with `ops.quant.reciprocals`,
exact for q-table entries in 1..`ops.quant.Q_MAX`; both entries refuse others.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pfv_torch.kernels.frame_step import (ALIGN, MAX_PLANES, _extent, _ptr,
                                          checked_layout, plane_origins)
from pfv_torch.ops.blocks import plane_to_blocks
from pfv_torch.ops.iframe import encode_blocks as encode_blocks_plain
from pfv_torch.ops.motion import gather_predictions
from pfv_torch.ops.pframe import calc_residuals, encode_delta_blocks
from pfv_torch.ops.quant import reciprocals

__all__ = ["FrameEncode", "encode_blocks_plain", "encode_delta_blocks_plain",
           "fdct_blocks", "fdct_blocks_plain", "frame_encode_plain"]


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


def frame_encode_plain(sources, motion, qtables, qidx, layout, prev, out,
                       origins=None) -> torch.Tensor:
    """The plain PyTorch version of a frame-encode step: per plane,
    `fdct_blocks_plain` on the blocks of its source and, for a P-frame, on
    the windows `gather_predictions` takes from its previous plane, times
    has_coeff. qtables (nq, 64) int32; layout: `PlaneAt`s; origins: per
    plane the raster (by, bx) int32 origins, made here when not given.
    Returns out."""
    if origins is None and motion is not None:
        origins = plane_origins(layout, prev.device)
    for i, (p, qi, src) in enumerate(zip(layout, qidx, sources)):
        n = p.blocks
        sl = slice(p.first, p.first + n)
        blocks = plane_to_blocks(src[:p.h, :p.w])
        q = qtables[int(qi)].to(src.device)
        if motion is None:
            out[sl] = fdct_blocks_plain(blocks, q).view(n, 256)
            continue
        by, bx = origins[i]
        mvy, mvx, hc = (t[sl] for t in motion)
        win = gather_predictions(p.view(prev), by, bx, mvy, mvx)
        torch.mul(fdct_blocks_plain(blocks, q, win).view(n, 256), (hc != 0)[:, None],
                  out=out[sl])
    return out


class FrameEncode:
    """The frame-encode step of one layout over (nq, 64) q-tables (host
    values in 1..Q_MAX), on `device`.

    `check` holds a call's tensors to the layout, `launch` runs the step
    unchecked, a call does both. `FrameEncode.launches` counts kernel
    launches."""

    launches = 0

    def __init__(self, qtables, layout, device):
        qt = np.ascontiguousarray(qtables, dtype=np.int32).reshape(-1, 64)
        self.layout = checked_layout(layout)
        recip = reciprocals(qt)  # raises on a q-table the multiply is not exact for
        self.nq = qt.shape[0]
        self.qtables = torch.from_numpy(qt)  # the plain version's, on the host
        self.recip = torch.from_numpy(recip.view(np.int32)).to(device)
        self.device = self.recip.device  # with its index: "cuda" -> "cuda:0"
        self.blocks = max(p.first + p.blocks for p in self.layout)
        self.extent = (max(p.row + p.h for p in self.layout),
                       max(p.col + p.w for p in self.layout))
        self._desc = (ctypes.c_longlong * (5 * len(self.layout)))(
            *(v for p in self.layout for v in p))
        self._origins = None

    def check(self, sources, motion, qidx, prev, out) -> None:
        """Raise ValueError unless the call fits the layout: one source per
        plane, 2-D uint8 of at least the plane's size, unit column stride,
        16-byte aligned rows; motion None (an I-frame) or (mvy, mvx,
        has_coeff) (>= blocks,) int8, int8, uint8, contiguous, and then
        prev, a 2-D uint8 canvas holding the layout, unit column stride,
        16-byte aligned rows; one q index per plane below nq; out
        (>= blocks, 256) int16, contiguous, 16-byte aligned, apart from every
        input; all on the step's device."""
        if len(sources) != len(self.layout):
            raise ValueError(f"expected {len(self.layout)} source planes, got "
                             f"{len(sources)}")
        planes = [(f"source {i}", t, (p.h, p.w))
                  for i, (t, p) in enumerate(zip(sources, self.layout))]
        tensors = [out]
        if motion is not None:
            if len(motion) != 3:
                raise ValueError("motion must be (mvy, mvx, has_coeff)")
            for t, dtype in zip(motion, (torch.int8, torch.int8, torch.uint8)):
                if t.dtype != dtype or t.dim() != 1 or t.shape[0] < self.blocks \
                        or not t.is_contiguous():
                    raise ValueError(f"expected contiguous (>= {self.blocks},) {dtype} "
                                     f"block headers, got {t.dtype} {tuple(t.shape)}")
            if prev is None:
                raise ValueError("a P-frame encode needs the previous canvas")
            planes.append(("prev", prev, self.extent))
            tensors += motion
        for name, t, (h, w) in planes:
            if t.dtype != torch.uint8 or t.dim() != 2 or t.stride(1) != 1 \
                    or t.shape[0] < h or t.shape[1] < w:
                raise ValueError(f"{name} must be 2-D uint8 of at least {(h, w)} with "
                                 f"unit column stride, got {t.dtype} {tuple(t.shape)} "
                                 f"{t.stride()}")
            if t.data_ptr() % ALIGN or t.stride(0) % ALIGN:
                raise ValueError(f"{name}'s rows must be 16-byte aligned")
        if out.dtype != torch.int16 or out.dim() != 2 or out.shape[1] != 256 \
                or out.shape[0] < self.blocks:
            raise ValueError(f"expected a (>= {self.blocks}, 256) int16 output, got "
                             f"{out.dtype} {tuple(out.shape)}")
        if not out.is_contiguous() or out.data_ptr() % ALIGN:
            raise ValueError("the output must be contiguous and 16-byte aligned")
        if len(qidx) != len(self.layout) or not all(0 <= int(q) < self.nq for q in qidx):
            raise ValueError(f"q indices {list(qidx)}: one per plane, below {self.nq}")
        tensors += [t for _, t, _ in planes]
        if any(t.device != self.device for t in tensors):
            raise ValueError(f"all inputs must be on the step's device {self.device}")
        o0, o1 = out.data_ptr(), out.data_ptr() + 2 * out.numel()
        for name, t, _ in planes:
            if t.untyped_storage().data_ptr() == out.untyped_storage().data_ptr():
                t0, t1 = _extent(t)
                if t0 < o1 and o0 < t1:
                    raise ValueError(f"the output overlaps {name}")

    def __call__(self, sources, motion, qidx, prev, out) -> torch.Tensor:
        self.check(sources, motion, qidx, prev, out)
        return self.launch(sources, motion, qidx, prev, out)

    def launch(self, sources, motion, qidx, prev, out) -> torch.Tensor:
        """The step on inputs that `check` passes; returns out."""
        if out.device.type == "cpu":
            return frame_encode_plain(sources, motion, self.qtables, qidx, self.layout,
                                      prev, out, self._plain_origins())
        if out.device.type != "cuda":
            raise ValueError(f"no frame-encode kernel for device {out.device}")
        from pfv_torch.kernels import build

        pad = MAX_PLANES - len(self.layout)
        q = [int(v) for v in qidx] + [0] * pad
        src = [t.data_ptr() for t in sources] + [None] * pad
        strides = [t.stride(0) for t in sources] + [0] * pad
        mvy, mvx, hc = (None,) * 3 if motion is None else motion
        rc = build.launch(
            "pfv_frame_encode", out.device, *src, *strides, _ptr(mvy), _ptr(mvx),
            _ptr(hc), int(motion is None), self.recip.data_ptr(), *q,
            None if motion is None else prev.data_ptr(),
            0 if motion is None else prev.stride(0), out.data_ptr(), self._desc,
            len(self.layout))
        if rc:
            raise RuntimeError(f"frame-encode kernel launch failed: CUDA error {rc}")
        build.count(FrameEncode)
        return out

    def _plain_origins(self):
        if self._origins is None:
            self._origins = plane_origins(self.layout)
        return self._origins


def _check(blocks, q_table, win):
    for name, t in (("blocks", blocks), ("win", win)):
        if t is None:
            continue
        if t.dtype != torch.uint8 or t.dim() != 3 or tuple(t.shape[1:]) != (16, 16):
            raise ValueError(f"expected (N, 16, 16) uint8 {name}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % ALIGN:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
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
    coefficients. Reads the q-table's values (a synchronize on a CUDA
    tensor): the encoders' per-frame path is `FrameEncode`."""
    _check(blocks, q_table, win)
    if blocks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no forward-DCT kernel for device {blocks.device}")
    n = blocks.shape[0]
    qt = q_table.cpu().numpy()
    if blocks.device.type == "cpu":
        reciprocals(qt)  # the same refusal as on the card
        return fdct_blocks_plain(blocks, q_table, win)
    out = torch.empty((n, 4, 64), dtype=torch.int16, device=blocks.device)
    if n:
        step = FrameEncode(qt, [(0, 0, 0, 16 * n, 16)], blocks.device)
        motion = None
        if win is not None:  # the windows as a plane of their own, no vectors
            zero = torch.zeros(n, dtype=torch.int8, device=blocks.device)
            motion = (zero, zero, torch.ones(n, dtype=torch.uint8, device=blocks.device))
        step.launch((blocks.view(16 * n, 16),), motion, (0,),
                    None if win is None else win.view(16 * n, 16), out.view(n, 256))
        from pfv_torch.kernels import build

        build.count(fdct_blocks)
    return out


fdct_blocks.launches = 0
