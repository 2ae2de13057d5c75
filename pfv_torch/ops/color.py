"""YCbCr -> RGB conversion (counterpart of pfv_tpu/ops/color.py).

float32 math with the reference's operation order (JPEG constants), then
Rust's saturating `as u8`: clamp to [0, 255], truncate toward zero.
"""

from __future__ import annotations

import torch

_F = torch.float32
# 0-dim float32 tensors, so each product rounds the constant exactly as the
# reference's f32 literals do
_RV, _GU, _GV, _BU = (torch.tensor(c, dtype=_F)
                      for c in (1.402, 0.344136, 0.714136, 1.772))


def rgb_channels(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Full-resolution u8 Y/U/V -> saturated (R, G, B) as int32 tensors."""
    yf = y.to(_F)
    uf = u.to(_F) - 128.0
    vf = v.to(_F) - 128.0
    r = yf + _RV * vf
    g = (yf - _GU * uf) - _GV * vf
    b = yf + _BU * uf

    def sat(x):
        return torch.clamp(x, 0.0, 255.0).to(torch.int32)

    return sat(r), sat(g), sat(b)


def yuv_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full-resolution u8 Y/U/V planes -> (..., 3) u8 RGB."""
    return torch.stack(rgb_channels(y, u, v), dim=-1).to(torch.uint8)
