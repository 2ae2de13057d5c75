"""The frame step, K5 + K7 as one kernel (csrc/frame_step_kernel.cu), and
its plain version.

A `FrameStep` decodes the macroblocks of one to three padded planes of a
frame in one launch: dequantize, iDCT and clamp each block that needs its
residual, then place it at its raster origin, intra or from the window of
the previous frame (`kernels.mc`'s rule: coded clamp(win + (res-128)*2),
skipped win). It is built once per layout, the planes' places in a canvas
(`PlaneAt`), and q-tables; a call takes a frame's (nb, 256) i16
coefficients, its (mvy, mvx, has_coeff) header rows or None for an I-frame,
one q-table index per plane, and the previous and output canvases (2-D u8,
unit column stride, never overlapping). The streaming decoder and the
encoders' in-loop reconstruction pass the three planes of their fused
canvases, one launch per frame; the per-plane decode steps of `device.py`
one plane of its own.

A CPU tensor runs `frame_step_plain` (K5's and K7's plain versions plane by
plane); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from pfv_torch.kernels.idct import decode_blocks_plain
from pfv_torch.kernels.mc import mc_reconstruct_plain
from pfv_torch.ops.blocks import block_origins
from pfv_torch.ops.quant import DCT_SCALE_FACTOR, INV_ZIGZAG_TABLE

MAX_PLANES = 3
ALIGN = 16  # bytes: 16-byte coefficient loads and canvas rows


class PlaneAt(NamedTuple):
    """A padded plane's place: its first block in the frame's coefficients
    and header rows, the canvas row and column of its origin, its height and
    width (multiples of 16)."""

    first: int
    row: int
    col: int
    h: int
    w: int

    @property
    def blocks(self) -> int:
        return (self.h // 16) * (self.w // 16)

    def view(self, canvas: torch.Tensor) -> torch.Tensor:
        return canvas[self.row:self.row + self.h, self.col:self.col + self.w]


def plane_layout(h: int, w: int) -> tuple[PlaneAt]:
    """The layout of one (h, w) plane that is its own canvas."""
    return (PlaneAt(0, 0, 0, h, w),)


def plane_origins(layout, device="cpu") -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Per plane of a layout the raster (by, bx) int32 origins of its blocks,
    on `device`: what the plain versions index with."""
    return [tuple(torch.from_numpy(o).to(device) for o in block_origins(p.h, p.w))
            for p in layout]


def checked_layout(layout) -> tuple[PlaneAt, ...]:
    """The layout as `PlaneAt`s; raises ValueError unless it is 1 to
    MAX_PLANES planes of whole 16x16 blocks at 16-byte aligned columns."""
    layout = tuple(PlaneAt(*p) for p in layout)
    if not 1 <= len(layout) <= MAX_PLANES:
        raise ValueError(f"a frame's kernels take 1 to {MAX_PLANES} planes, "
                         f"got {len(layout)}")
    for p in layout:
        if p.h <= 0 or p.w <= 0 or p.h % 16 or p.w % 16 or min(p) < 0 or p.col % ALIGN:
            raise ValueError(f"{p} is not a plane of whole 16x16 blocks at "
                             "a 16-byte aligned column")
    return layout


def multipliers(qtables) -> np.ndarray:
    """(nq, 64) q-tables -> (nq, 64) int32 dequantization multipliers at the
    row-major position: mul[t][ZIGZAG[k]] = SCALE[k] * q_t[k] (quirk Q1)."""
    qt = np.asarray(qtables, dtype=np.int32).reshape(-1, 64)
    return np.ascontiguousarray((qt * DCT_SCALE_FACTOR)[:, INV_ZIGZAG_TABLE])


def _extent(t: torch.Tensor):
    """[first, last) byte addresses of a 2-D u8 view with unit column stride."""
    start = t.data_ptr()
    return start, start + (t.shape[0] - 1) * t.stride(0) + t.shape[1]


def _ptr(t):
    return None if t is None else t.data_ptr()


class FrameStep:
    """The frame step of one layout over (nq, 64) q-tables, on `device`.

    `check` holds a call's tensors to the layout, `launch` runs the step
    unchecked, a call does both. `FrameStep.launches` counts kernel
    launches."""

    launches = 0

    def __init__(self, qtables, layout, device):
        qt = np.ascontiguousarray(qtables, dtype=np.int32).reshape(-1, 64)
        self.layout = checked_layout(layout)
        self.nq = qt.shape[0]
        self.qtables = torch.from_numpy(qt)  # the plain version's, on the host
        self.mul = torch.from_numpy(multipliers(qt)).to(device)
        self.device = self.mul.device  # with its index: "cuda" -> "cuda:0"
        self.blocks = max(p.first + p.blocks for p in self.layout)
        self.extent = (max(p.row + p.h for p in self.layout),
                       max(p.col + p.w for p in self.layout))
        self._desc = (ctypes.c_longlong * (5 * len(self.layout)))(
            *(v for p in self.layout for v in p))
        self._origins = None

    def check(self, coeffs, motion, qidx, prev, out) -> None:
        """Raise ValueError unless the call fits the layout: coeffs
        (>= blocks, 256) int16, contiguous and 16-byte aligned; motion None
        (an I-frame) or (mvy, mvx, has_coeff) (>= blocks,) int8, int8, uint8,
        contiguous; one q index per plane below nq; out, and for a P-frame
        prev, 2-D uint8 canvases holding the layout, unit column stride,
        16-byte aligned rows, apart from each other; all on the step's
        device."""
        if coeffs.dtype != torch.int16 or coeffs.dim() != 2 or coeffs.shape[1] != 256 \
                or coeffs.shape[0] < self.blocks:
            raise ValueError(f"expected (>= {self.blocks}, 256) int16 coefficients, "
                             f"got {coeffs.dtype} {tuple(coeffs.shape)}")
        if not coeffs.is_contiguous() or coeffs.data_ptr() % ALIGN:
            raise ValueError("coefficients must be contiguous and 16-byte aligned")
        tensors = [coeffs]
        if motion is not None:
            if len(motion) != 3:
                raise ValueError("motion must be (mvy, mvx, has_coeff)")
            for t, dtype in zip(motion, (torch.int8, torch.int8, torch.uint8)):
                if t.dtype != dtype or t.dim() != 1 or t.shape[0] < self.blocks \
                        or not t.is_contiguous():
                    raise ValueError(f"expected contiguous (>= {self.blocks},) {dtype} "
                                     f"block headers, got {t.dtype} {tuple(t.shape)}")
            if prev is None:
                raise ValueError("a P-frame step needs the previous canvas")
            tensors += motion
        if len(qidx) != len(self.layout) or not all(0 <= int(q) < self.nq for q in qidx):
            raise ValueError(f"q indices {list(qidx)}: one per plane, below {self.nq}")
        self.check_canvases(None if motion is None else prev, out)
        if any(t.device != self.device for t in tensors):
            raise ValueError(f"all inputs must be on the step's device {self.device}")

    def check_canvases(self, prev, out) -> None:
        """Raise ValueError unless out (and prev, when given) hold the
        layout as `check` says, on the step's device."""
        for name, t in (("out", out), ("prev", prev)):
            if t is None:
                continue
            if t.device != self.device:
                raise ValueError(f"{name} is on {t.device}, the step on {self.device}")
            if t.dtype != torch.uint8 or t.dim() != 2 or t.stride(1) != 1 \
                    or t.shape[0] < self.extent[0] or t.shape[1] < self.extent[1]:
                raise ValueError(f"{name} must be a 2-D uint8 canvas of at least "
                                 f"{self.extent} with unit column stride, got "
                                 f"{t.dtype} {tuple(t.shape)} {t.stride()}")
            if t.data_ptr() % ALIGN or t.stride(0) % ALIGN:
                raise ValueError(f"{name}'s rows must be 16-byte aligned")
        if prev is not None and prev.untyped_storage().data_ptr() == \
                out.untyped_storage().data_ptr():
            (a0, a1), (b0, b1) = _extent(prev), _extent(out)
            if a0 < b1 and b0 < a1:
                raise ValueError("out overlaps prev: a frame step never runs in place")

    def __call__(self, coeffs, motion, qidx, prev, out) -> torch.Tensor:
        self.check(coeffs, motion, qidx, prev, out)
        return self.launch(coeffs, motion, qidx, prev, out)

    def launch(self, coeffs, motion, qidx, prev, out) -> torch.Tensor:
        """The step on inputs that `check` passes; returns out."""
        if coeffs.device.type == "cpu":
            return frame_step_plain(coeffs, motion, self.qtables, qidx, self.layout,
                                    prev, out, self._plain_origins())
        if coeffs.device.type != "cuda":
            raise ValueError(f"no frame-step kernel for device {coeffs.device}")
        from pfv_torch.kernels import build

        q = [int(v) for v in qidx] + [0] * (MAX_PLANES - len(qidx))
        mvy, mvx, hc = (None,) * 3 if motion is None else motion
        rc = build.launch(
            "pfv_frame_step", coeffs.device, coeffs.data_ptr(), _ptr(mvy), _ptr(mvx),
            _ptr(hc), int(motion is None), self.mul.data_ptr(), *q,
            None if motion is None else prev.data_ptr(),
            0 if motion is None else prev.stride(0), out.data_ptr(), out.stride(0),
            self._desc, len(self.layout))
        if rc:
            raise RuntimeError(f"frame-step kernel launch failed: CUDA error {rc}")
        build.count(FrameStep)
        return out

    def _plain_origins(self):
        if self._origins is None:
            self._origins = plane_origins(self.layout)
        return self._origins


def frame_step_plain(coeffs, motion, qtables, qidx, layout, prev, out,
                     origins=None) -> torch.Tensor:
    """The plain PyTorch version of a frame step: per plane, K5's plain
    version on its blocks, then K7's, which places them in `out`. qtables
    (nq, 64) int32; layout: `PlaneAt`s; origins: per plane the raster (by,
    bx) int32 origins, made here when not given. Returns out."""
    if origins is None:
        origins = plane_origins(layout, coeffs.device)
    for p, qi, (by, bx) in zip(layout, qidx, origins):
        n = p.blocks
        sl = slice(p.first, p.first + n)
        res = decode_blocks_plain(coeffs[sl].view(n, 4, 64),
                                  qtables[int(qi)].to(coeffs.device))
        o = p.view(out)
        if motion is None:
            zero = torch.zeros(n, dtype=torch.int8, device=coeffs.device)
            mc_reconstruct_plain(res, o, by, bx, zero, zero, zero.view(torch.uint8),
                                 True, o)
        else:
            mvy, mvx, hc = (t[sl] for t in motion)
            mc_reconstruct_plain(res, p.view(prev), by, bx, mvy, mvx, hc, False, o)
    return out
