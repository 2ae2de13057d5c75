"""YCbCr <-> RGB conversion and 4:2:0 chroma resampling (counterpart of
pfv_tpu/ops/color.py).

float32 math with the reference's operation order (JPEG constants), then
Rust's saturating `as u8`: clamp to [0, 255], truncate toward zero. Chroma
resampling is point sampling, not averaging (quirk Q11).
"""

from __future__ import annotations

import numpy as np
import torch

_F = torch.float32
# 0-dim float32 tensors, so each product rounds the constant exactly as the
# reference's f32 literals do
_RV, _GU, _GV, _BU = (torch.tensor(c, dtype=_F)
                      for c in (1.402, 0.344136, 0.714136, 1.772))
_YR, _YG, _YB, _UR, _UG, _VG, _VB, _HALF = (
    torch.tensor(c, dtype=_F)
    for c in (0.299, 0.587, 0.114, 0.168736, 0.331264, 0.418688, 0.081312, 0.5))


def _sat(x: torch.Tensor) -> torch.Tensor:
    """Rust `f32 as u8`: saturate to [0, 255], truncate toward zero."""
    return torch.clamp(x, 0.0, 255.0).to(torch.int32)


def rgb_channels(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Full-resolution u8 Y/U/V -> saturated (R, G, B) as int32 tensors."""
    yf = y.to(_F)
    uf = u.to(_F) - 128.0
    vf = v.to(_F) - 128.0
    r = yf + _RV * vf
    g = (yf - _GU * uf) - _GV * vf
    b = yf + _BU * uf
    return _sat(r), _sat(g), _sat(b)


def yuv_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full-resolution u8 Y/U/V planes -> (..., 3) u8 RGB."""
    return torch.stack(rgb_channels(y, u, v), dim=-1).to(torch.uint8)


def rgb_to_yuv(rgb: torch.Tensor):
    """(..., 3) u8 RGB -> full-resolution (Y, U, V) u8 planes."""
    r, g, b = (rgb[..., i].to(_F) for i in range(3))
    y = (_YR * r + _YG * g) + _YB * b
    u = ((128.0 - _UR * r) - _UG * g) + _HALF * b
    v = ((128.0 + _HALF * r) - _VG * g) - _VB * b
    return tuple(_sat(p).to(torch.uint8) for p in (y, u, v))


def rgb_to_yuv_np(rgb: np.ndarray):
    """numpy twin of rgb_to_yuv (the same float32 math and saturating
    cast), for host-side synthesis of source frames."""
    r, g, b = (rgb[..., i].astype(np.float32) for i in range(3))
    f = np.float32
    y = (f(0.299) * r) + (f(0.587) * g) + (f(0.114) * b)
    u = f(128.0) - (f(0.168736) * r) - (f(0.331264) * g) + (f(0.5) * b)
    v = f(128.0) + (f(0.5) * r) - (f(0.418688) * g) - (f(0.081312) * b)
    return tuple(np.clip(np.trunc(p), 0.0, 255.0).astype(np.uint8) for p in (y, u, v))


def reduce_plane(plane: torch.Tensor) -> torch.Tensor:
    """Half size by point sampling every 2nd pixel of the last two axes."""
    return plane[..., ::2, ::2]


def double_plane(plane: torch.Tensor) -> torch.Tensor:
    """Double size by nearest neighbour along the last two axes."""
    return plane.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
