"""K2, canvas -> packed RGBA (csrc/rgba_kernel.cu), and its plain version.

A CPU tensor goes to `canvas_rgba_plain`; a CUDA tensor launches the kernel
or raises. The kernel takes any height, width and V column: it picks its
vector path (8 pixels of two rows per thread) where width % 4 == 0,
cw % 8 == 0, lc1 % 4 == 0 and the pointers are aligned, and goes pixel by
pixel elsewhere.
"""

from __future__ import annotations

import torch

from pfv_torch.ops.color import rgb_channels

_ALPHA = -(1 << 24)  # 0xFF000000 as int32


def _check(canvases, height: int, width: int, ly0: int, lc1: int):
    if canvases.dtype != torch.uint8 or canvases.dim() != 3:
        raise ValueError(f"expected (F, chh, cw) uint8 canvases, got "
                         f"{canvases.dtype} {tuple(canvases.shape)}")
    if not canvases.is_contiguous():
        raise ValueError("canvases must be contiguous")
    _, chh, cw = canvases.shape
    if not (0 < height <= ly0 and ly0 + (height + 1) // 2 <= chh
            and 0 < width <= cw and lc1 + (width + 1) // 2 <= cw):
        raise ValueError(f"{height}x{width} frame with chroma at row {ly0}, "
                         f"V column {lc1} does not fit a {chh}x{cw} canvas")


def canvas_rgba(canvases, height: int, width: int, ly0: int,
                lc1: int) -> torch.Tensor:
    """(F, chh, cw) u8 canvases -> (F, height, width) uint32 RGBA words
    (bytes R, G, B, A=255). Y is at rows [0, ly0), U and V below it, V
    starting at column lc1."""
    _check(canvases, height, width, ly0, lc1)
    if canvases.device.type == "cpu":
        return canvas_rgba_plain(canvases, height, width, ly0, lc1)
    if canvases.device.type != "cuda":
        raise ValueError(f"no RGBA kernel for device {canvases.device}")
    from pfv_torch.kernels import build

    nf, chh, cw = canvases.shape
    out = torch.empty((nf, height, width), dtype=torch.int32,
                      device=canvases.device)
    if nf:
        rc = build.launch("pfv_canvas_rgba", canvases.device, canvases.data_ptr(),
                          out.data_ptr(), nf, chh, cw, height, width, ly0, lc1)
        if rc:
            raise RuntimeError(f"RGBA kernel launch failed: CUDA error {rc}")
        build.count(canvas_rgba)
    return out.view(torch.uint32)


canvas_rgba.launches = 0


def canvas_rgba_plain(canvases, height: int, width: int, ly0: int,
                      lc1: int) -> torch.Tensor:
    """The plain PyTorch version of `canvas_rgba`."""
    dev = canvases.device
    half_x = torch.arange(width, device=dev) // 2
    crow = canvases[:, ly0 + torch.arange(height, device=dev) // 2]
    r, g, b = rgb_channels(canvases[:, :height, :width], crow[:, :, half_x],
                           crow[:, :, lc1 + half_x])
    return (r | (g << 8) | (b << 16) | _ALPHA).view(torch.uint32)
