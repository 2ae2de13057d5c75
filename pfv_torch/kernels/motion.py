"""K8, the encoder's motion search: the four-step search of every macroblock
of a P-frame in one launch (csrc/motion_kernel.cu), and its plain version.

A `MotionSearch` searches the macroblocks of one to three padded planes of a
frame against the planes of the previous reconstruction: it is built once
per layout (the planes' blocks in the frame's raster-order blocks and their
places in the reconstruction canvas, `PlaneAt` as the frame step's) and skip
threshold. A call takes the padded source planes (2-D u8, unit column
stride, 16-byte aligned rows; they may be three tensors), the previous
reconstruction canvas and the (mvy, mvx, has_coeff) header rows it writes:
per block the winner's vector (window origin minus block origin, |v| <= 15)
and whether its squared error, in float32, is above the threshold. What the
search computes is `ops.motion.motion_search`'s contract.

A CPU tensor goes to the plain version, `ops.motion.motion_search` plane by
plane; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from pfv_torch.kernels.frame_step import (ALIGN, MAX_PLANES, _extent, checked_layout,
                                           plane_origins)
from pfv_torch.ops.blocks import plane_to_blocks
from pfv_torch.ops.motion import motion_search

__all__ = ["MotionSearch", "motion_search_plain"]

# The largest row stride the kernel takes is MAX_STRIDE - 1 bytes: it keeps
# strides in 32-bit ints (csrc/motion_kernel.cu, kMaxStride).
MAX_STRIDE = 1 << 25


def motion_search_plain(sources, prev, layout, min_err, motion, origins=None):
    """The plain PyTorch version of a frame's motion search: per plane,
    `ops.motion.motion_search` of the blocks of its source against its view
    of `prev`; the vectors and `float32(best_err) > min_err` go to the plane's
    rows of motion = (mvy, mvx, has_coeff). layout: `PlaneAt`s; origins: per
    plane the raster (by, bx) int32 origins, made here when not given.
    Returns motion."""
    mvy, mvx, hc = motion
    if origins is None:
        origins = plane_origins(layout, prev.device)
    for p, src, (by, bx) in zip(layout, sources, origins):
        sl = slice(p.first, p.first + p.blocks)
        mx, my, err, _ = motion_search(plane_to_blocks(src[:p.h, :p.w]), p.view(prev),
                                       by, bx)
        mvx[sl], mvy[sl] = mx, my
        hc[sl] = err.to(torch.float32) > float(min_err)
    return motion


class MotionSearch:
    """The motion search of one layout with the skip threshold `min_err`, on
    `device`.

    `check` holds a call's tensors to the layout, `launch` runs the search
    unchecked, a call does both. `MotionSearch.launches` counts kernel
    launches."""

    launches = 0

    def __init__(self, layout, min_err, device):
        self.layout = checked_layout(layout)
        self.min_err = float(min_err)
        self.device = torch.empty(0, device=device).device  # with its index
        self.blocks = max(p.first + p.blocks for p in self.layout)
        self.extent = (max(p.row + p.h for p in self.layout),
                       max(p.col + p.w for p in self.layout))
        self._desc = (ctypes.c_longlong * (5 * len(self.layout)))(
            *(v for p in self.layout for v in p))
        self._origins = None

    def check(self, sources, prev, motion) -> None:
        """Raise ValueError unless the call fits the layout: one source per
        plane and prev, a canvas holding the layout, each 2-D uint8 of at
        least its size, unit column stride, 16-byte aligned rows of a
        stride below MAX_STRIDE; motion
        (mvy, mvx, has_coeff) (>= blocks,) int8, int8, uint8, contiguous,
        apart from each other and from every input; all on the search's
        device."""
        if len(sources) != len(self.layout):
            raise ValueError(f"expected {len(self.layout)} source planes, got "
                             f"{len(sources)}")
        if prev is None:
            raise ValueError("a motion search needs the previous canvas")
        if len(motion) != 3:
            raise ValueError("motion must be (mvy, mvx, has_coeff)")
        planes = [(f"source {i}", t, (p.h, p.w))
                  for i, (t, p) in enumerate(zip(sources, self.layout))]
        planes.append(("prev", prev, self.extent))
        for name, t, (h, w) in planes:
            if t.dtype != torch.uint8 or t.dim() != 2 or t.stride(1) != 1 \
                    or t.shape[0] < h or t.shape[1] < w:
                raise ValueError(f"{name} must be 2-D uint8 of at least {(h, w)} with "
                                 f"unit column stride, got {t.dtype} {tuple(t.shape)} "
                                 f"{t.stride()}")
            if t.stride(0) >= MAX_STRIDE:
                raise ValueError(f"{name}'s row stride {t.stride(0)} is not below "
                                 f"{MAX_STRIDE}")
            if t.data_ptr() % ALIGN or t.stride(0) % ALIGN:
                raise ValueError(f"{name}'s rows must be 16-byte aligned")
        for t, dtype in zip(motion, (torch.int8, torch.int8, torch.uint8)):
            if t.dtype != dtype or t.dim() != 1 or t.shape[0] < self.blocks \
                    or not t.is_contiguous():
                raise ValueError(f"expected contiguous (>= {self.blocks},) {dtype} "
                                 f"block headers, got {t.dtype} {tuple(t.shape)}")
        if any(t.device != self.device for t in (*motion, *(t for _, t, _ in planes))):
            raise ValueError(f"all inputs must be on the search's device {self.device}")
        rows = [(t.data_ptr(), t.data_ptr() + t.numel()) for t in motion]
        spans = rows + [_extent(t) for _, t, _ in planes]
        for i, (a0, a1) in enumerate(rows):
            if any(a0 < b1 and b0 < a1 for b0, b1 in spans[i + 1:]):
                raise ValueError("a header row overlaps another row or an input")

    def __call__(self, sources, prev, motion):
        self.check(sources, prev, motion)
        return self.launch(sources, prev, motion)

    def launch(self, sources, prev, motion):
        """The search on inputs that `check` passes; returns motion."""
        if prev.device.type == "cpu":
            return motion_search_plain(sources, prev, self.layout, self.min_err, motion,
                                       self._plain_origins())
        if prev.device.type != "cuda":
            raise ValueError(f"no motion-search kernel for device {prev.device}")
        from pfv_torch.kernels import build

        pad = MAX_PLANES - len(self.layout)
        src = [t.data_ptr() for t in sources] + [None] * pad
        strides = [t.stride(0) for t in sources] + [0] * pad
        mvy, mvx, hc = motion
        rc = build.launch(
            "pfv_motion_search", prev.device, *src, *strides, prev.data_ptr(),
            prev.stride(0), mvy.data_ptr(), mvx.data_ptr(), hc.data_ptr(), self.min_err,
            self._desc, len(self.layout))
        if rc:
            raise RuntimeError(f"motion-search kernel launch failed: CUDA error {rc}")
        build.count(MotionSearch)
        return motion

    def _plain_origins(self):
        if self._origins is None:
            self._origins = plane_origins(self.layout)
        return self._origins
