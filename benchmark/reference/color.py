"""4:2:0 planes -> packed RGBA words (pfv-rs `frame.rs`): chroma upsampled
by nearest neighbour (quirk Q11), JPEG constants in float32 with the
reference's operation order, Rust's saturating `as u8` (clamp to [0, 255],
truncate), bytes R, G, B, A = 255 in memory order."""

from __future__ import annotations

import torch

_F = torch.float32


def _c(x: float, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=_F, device=dev)


def rgba_words(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, height: int,
               width: int) -> torch.Tensor:
    """Padded (Y, U, V) planes of one frame -> (height, width) int32 RGBA."""
    dev = y.device
    rows = torch.arange(height, device=dev) // 2
    cols = torch.arange(width, device=dev) // 2
    yf = y[:height, :width].to(_F)
    uf = u[rows][:, cols].to(_F) - 128.0
    vf = v[rows][:, cols].to(_F) - 128.0
    r = yf + _c(1.402, dev) * vf
    g = (yf - _c(0.344136, dev) * uf) - _c(0.714136, dev) * vf
    b = yf + _c(1.772, dev) * uf
    r, g, b = (torch.clamp(x, 0.0, 255.0).to(torch.int32) for x in (r, g, b))
    return r | (g << 8) | (b << 16) | -(1 << 24)
