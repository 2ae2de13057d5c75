"""Frame geometry and the VideoFrame container (counterpart of
pfv_tpu/frame.py).

4:2:0 planar YCbCr: chroma is half size along each axis; planes are uint8
numpy arrays (H, W) on the host. On the device the three padded planes of a
frame live in one fused (chh, cw) u8 canvas: Y at rows [0, ly0), columns
[0, lyw); U at rows [ly0, chh), columns [0, lcw); V at the same rows,
columns [lcw, 2*lcw).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from pfv_torch.ops.color import double_plane, reduce_plane, rgb_to_yuv, yuv_to_rgb


def pad16(x: int) -> int:
    """Dimension padded up to a whole number of 16-pixel macroblocks."""
    return x + (16 - x % 16) % 16


class Geometry(NamedTuple):
    """Frame and fused-canvas geometry of one stream."""

    width: int
    height: int
    ly0: int  # padded luma rows = first chroma canvas row
    lyw: int  # padded luma width
    lc0: int  # padded chroma rows
    lcw: int  # padded chroma width = first V canvas column
    cw: int   # canvas width
    chh: int  # canvas height
    gly: int  # luma stripes (16 rows each)

    @property
    def gch(self) -> int:
        return self.chh // 16

    @property
    def gcw(self) -> int:
        return self.cw // 16

    @property
    def guw(self) -> int:
        """U's block columns in a chroma stripe; V's start there."""
        return self.lcw // 16

    @property
    def yb(self) -> int:
        return (self.ly0 // 16) * (self.lyw // 16)

    @property
    def cb(self) -> int:
        return (self.lc0 // 16) * (self.lcw // 16)

    @property
    def nb(self) -> int:
        return self.yb + 2 * self.cb


def geometry(width: int, height: int) -> Geometry:
    ly0, lyw = pad16(height), pad16(width)
    lc0, lcw = pad16(height // 2), pad16(width // 2)
    return Geometry(width, height, ly0, lyw, lc0, lcw,
                    cw=max(lyw, 2 * lcw), chh=ly0 + lc0, gly=ly0 // 16)


def canvas_planes(g: Geometry, canvas):
    """Views of the padded (Y, U, V) planes of a (..., chh, cw) canvas."""
    c = canvas[..., g.ly0:, :]
    return (canvas[..., :g.ly0, :g.lyw], c[..., :g.lcw],
            c[..., g.lcw:2 * g.lcw])


def initial_canvas(g: Geometry, device) -> torch.Tensor:
    """The framebuffer before a stream's first frame, as a (chh, cw) u8
    canvas on `device`: Y 0, U and V 128, zeros outside the planes."""
    c = torch.zeros((g.chh, g.cw), dtype=torch.uint8, device=device)
    c[g.ly0:, :2 * g.lcw] = 128
    return c


def canvas_layout(g: Geometry):
    """The (Y, U, V) planes' places in the canvas, as `canvas_planes` cuts
    them: (first block in the frame's raster-order blocks, origin row, origin
    column, padded height, padded width) each."""
    return ((0, 0, 0, g.ly0, g.lyw), (g.yb, g.ly0, 0, g.lc0, g.lcw),
            (g.yb + g.cb, g.ly0, g.lcw, g.lc0, g.lcw))


def slice_yuv(g: Geometry, canvas):
    """Views of the unpadded (..., H, W) Y and (..., H/2, W/2) U, V planes."""
    h, w = g.height, g.width
    y, u, v = canvas_planes(g, canvas)
    return y[..., :h, :w], u[..., :h // 2, :w // 2], v[..., :h // 2, :w // 2]


@dataclass
class VideoFrame:
    """A 4:2:0 video frame: Y at (height, width), U and V at half size
    along each axis. `new` fills chroma with 128 (neutral); `from_planes`
    takes full-resolution chroma and point-decimates it (quirk Q11)."""

    width: int
    height: int
    plane_y: np.ndarray
    plane_u: np.ndarray
    plane_v: np.ndarray

    @classmethod
    def new(cls, width: int, height: int) -> "VideoFrame":
        if width % 2 or height % 2:
            raise ValueError(f"{width}x{height}: dimensions must be even")
        return cls(width, height, np.zeros((height, width), dtype=np.uint8),
                   np.full((height // 2, width // 2), 128, dtype=np.uint8),
                   np.full((height // 2, width // 2), 128, dtype=np.uint8))

    @classmethod
    def new_padded(cls, width: int, height: int) -> "VideoFrame":
        """Planes independently padded to multiples of 16."""
        ch, cw = pad16(height // 2), pad16(width // 2)
        return cls(width, height,
                   np.zeros((pad16(height), pad16(width)), dtype=np.uint8),
                   np.full((ch, cw), 128, dtype=np.uint8),
                   np.full((ch, cw), 128, dtype=np.uint8))

    @classmethod
    def from_planes(cls, width: int, height: int, plane_y: np.ndarray,
                    plane_u: np.ndarray, plane_v: np.ndarray) -> "VideoFrame":
        """Full-resolution planes; chroma is point-decimated."""
        for p in (plane_y, plane_u, plane_v):
            if p.shape != (height, width):
                raise ValueError(f"plane {p.shape} is not {(height, width)}")
        return cls(width, height, np.asarray(plane_y, dtype=np.uint8),
                   reduce_plane(np.asarray(plane_u, dtype=np.uint8)).copy(),
                   reduce_plane(np.asarray(plane_v, dtype=np.uint8)).copy())

    @classmethod
    def from_rgb(cls, rgb: np.ndarray) -> "VideoFrame":
        """(H, W, 3) uint8 RGB -> 4:2:0 frame (JPEG YCbCr, float32)."""
        h, w, _ = rgb.shape
        y, u, v = (p.numpy() for p in rgb_to_yuv(torch.from_numpy(np.asarray(rgb))))
        return cls.from_planes(w, h, y, u, v)

    def to_rgb(self) -> np.ndarray:
        """-> (H, W, 3) uint8 RGB, chroma doubled by nearest neighbour."""
        h, w = self.height, self.width
        u, v = (double_plane(torch.from_numpy(np.ascontiguousarray(p)))[:h, :w]
                for p in (self.plane_u, self.plane_v))
        return yuv_to_rgb(torch.from_numpy(np.ascontiguousarray(self.plane_y)),
                          u, v).numpy()
