"""Seeded synthetic source clips for the encoder: the generator of the
program's `synth_rgb_frame` (a moving gradient, a translating textured
rectangle, a bouncing ball and mild noise) in PyTorch on any device, its
texture and noise drawn from a torch.Generator seeded from the run's seed,
then RGB -> 4:2:0 YCbCr in float32 (JPEG constants, saturating cast,
chroma point-decimated, quirk Q11)."""

from __future__ import annotations

import numpy as np
import torch


def _f(x: float, dev) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=dev)


def rgb_frame(t: int, width: int, height: int, tex: torch.Tensor, gen) -> torch.Tensor:
    """Frame t, (H, W, 3) float32 before the cast."""
    dev = tex.device
    yy, xx = torch.meshgrid(torch.arange(height, device=dev, dtype=torch.float32),
                            torch.arange(width, device=dev, dtype=torch.float32),
                            indexing="ij")
    r = 96 + 64 * torch.sin(0.013 * xx + 0.05 * t)
    g = 96 + 64 * torch.sin(0.017 * yy - 0.04 * t)
    b = 96 + 64 * torch.sin(0.011 * (xx + yy) + 0.03 * t)
    img = torch.stack([r, g, b], -1)
    rx = int(40 + 3.0 * t) % max(1, width - 96) if width > 96 else 0
    ry = int(30 + 1.5 * t) % max(1, height - 64) if height > 64 else 0
    rh, rw = min(64, height - ry), min(96, width - rx)
    img[ry:ry + rh, rx:rx + rw] = tex[:rh, :rw]
    bx = width / 2 + (width / 2 - 40) * np.sin(0.11 * t)
    by = height / 2 + (height / 2 - 40) * np.sin(0.07 * t + 1.0)
    ball = (xx - bx) ** 2 + (yy - by) ** 2 < 30.0 ** 2
    img[ball] = torch.tensor([230.0, 40.0, 40.0], device=dev)
    img += 2.0 * torch.randn(img.shape, generator=gen, device=dev)
    return img.clamp(0, 255).to(torch.uint8)


def rgb_to_yuv420(rgb: torch.Tensor):
    """(H, W, 3) u8 -> (Y (H, W), U, V (H/2, W/2)) u8."""
    dev = rgb.device
    r, g, b = (rgb[..., i].to(torch.float32) for i in range(3))
    y = (_f(0.299, dev) * r) + (_f(0.587, dev) * g) + (_f(0.114, dev) * b)
    u = _f(128.0, dev) - (_f(0.168736, dev) * r) - (_f(0.331264, dev) * g) + (_f(0.5, dev) * b)
    v = _f(128.0, dev) + (_f(0.5, dev) * r) - (_f(0.418688, dev) * g) - (_f(0.081312, dev) * b)
    y, u, v = (torch.clamp(torch.trunc(p), 0.0, 255.0).to(torch.uint8) for p in (y, u, v))
    return y, u[::2, ::2], v[::2, ::2]


def clip_planes(width: int, height: int, frames: int, seed: int, clip: int, device):
    """Clip `clip` of seed `seed`: (Y (F, H, W), U, V (F, H/2, W/2)) u8 numpy
    arrays in host memory, frames t = clip * frames ... on."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed((seed * 7_919 + clip * 104_729 + 1) % (1 << 63))
    tex = torch.randint(0, 255, (64, 96, 3), generator=gen, device=dev).to(torch.float32)
    tex = (tex + tex.roll(1, 0) + tex.roll(1, 1) + tex.roll(2, 1)) / 4
    planes = [[], [], []]
    for t in range(clip * frames, (clip + 1) * frames):
        for out, p in zip(planes, rgb_to_yuv420(rgb_frame(t, width, height, tex, gen))):
            out.append(p)
    return tuple(torch.stack(p).cpu().numpy() for p in planes)
