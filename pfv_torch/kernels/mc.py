"""K7, motion-compensated reconstruction (csrc/mc_kernel.cu), and its plain
version.

`mc_reconstruct` places each (16, 16) block b of `res` at its origin
(by[b], bx[b]) of the output plane. Its pixels come, by mode:
  2 = intra (`is_intra`): the decoded block itself;
  1 = coded (has_coeff[b] != 0): clamp(win + (res - 128) * 2, 0, 255);
  0 = skip: win,
where win is the (16, 16) window of `ref` at (by + mv_y, bx + mv_x), a
start outside the plane placed as `lax.dynamic_slice` places it
(ops.motion.gather_predictions). The output
never overlaps `ref`: a block's window may cover other blocks' outputs. A
CPU tensor goes to `mc_reconstruct_plain`; a CUDA tensor launches the kernel
or raises. It is the port's form of the JAX package's per-plane
`mc_reconstruct_pallas`; the decoders and the encoders run the frame step
(kernels/frame_step.py) in its place.
"""

from __future__ import annotations

import torch

from pfv_torch.ops.motion import gather_predictions
from pfv_torch.ops.pframe import apply_residuals


def _extent(t: torch.Tensor):
    """[first, last) byte addresses a 2-D view with unit column stride spans."""
    start = t.data_ptr()
    return start, start + (t.shape[0] - 1) * t.stride(0) + t.shape[1]


def _check(res, ref, by, bx, mv_y, mv_x, has_coeff, out):
    n = res.shape[0]
    if res.dtype != torch.uint8 or res.dim() != 3 or tuple(res.shape[1:]) != (16, 16):
        raise ValueError(f"expected (N, 16, 16) uint8 blocks, got {res.dtype} "
                         f"{tuple(res.shape)}")
    if not res.is_contiguous():
        raise ValueError("blocks must be contiguous")
    for name, t in (("ref", ref), ("out", out)):
        if t.dtype != torch.uint8 or t.dim() != 2 or t.stride(1) != 1:
            raise ValueError(f"{name} must be a 2-D uint8 plane with unit column "
                             f"stride, got {t.dtype} {tuple(t.shape)} {t.stride()}")
    h, w = ref.shape
    if h % 16 or w % 16 or h <= 0 or w <= 0 or tuple(out.shape) != (h, w):
        raise ValueError(f"ref {tuple(ref.shape)} and out {tuple(out.shape)} must "
                         "be one shape of whole 16x16 blocks")
    want = ((by, torch.int32), (bx, torch.int32), (mv_y, torch.int8),
            (mv_x, torch.int8), (has_coeff, torch.uint8))
    for t, dtype in want:
        if t.dtype != dtype or tuple(t.shape) != (n,) or not t.is_contiguous():
            raise ValueError(f"expected contiguous ({n},) {dtype}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if any(t.device != res.device for t in (ref, out, by, bx, mv_y, mv_x, has_coeff)):
        raise ValueError("all inputs must be on one device")
    (a0, a1), (b0, b1) = _extent(ref), _extent(out)
    if ref.untyped_storage().data_ptr() == out.untyped_storage().data_ptr() \
            and a0 < b1 and b0 < a1:
        raise ValueError("out overlaps ref: motion compensation never runs in place")


def mc_reconstruct(res, ref, by, bx, mv_y, mv_x, has_coeff, is_intra: bool,
                   out=None) -> torch.Tensor:
    """Reconstruct the blocks into `out` (a new plane shaped like `ref`
    unless given; a strided canvas view will do) and return it.

    res (N, 16, 16) u8: K5's decoded blocks; ref (H, W) u8: the previous
    padded plane; by, bx (N,) int32 block origins; mv_y, mv_x (N,) int8;
    has_coeff (N,) u8; is_intra: every block takes mode 2.
    """
    if out is None:
        out = torch.empty_like(ref, memory_format=torch.contiguous_format)
    _check(res, ref, by, bx, mv_y, mv_x, has_coeff, out)
    if res.device.type == "cpu":
        return mc_reconstruct_plain(res, ref, by, bx, mv_y, mv_x, has_coeff,
                                    is_intra, out)
    if res.device.type != "cuda":
        raise ValueError(f"no motion-compensation kernel for device {res.device}")
    from pfv_torch.kernels import build

    n = res.shape[0]
    if n:
        rc = build.launch(
            "pfv_mc_reconstruct", res.device, res.data_ptr(), ref.data_ptr(),
            ref.stride(0), ref.shape[0], ref.shape[1], by.data_ptr(), bx.data_ptr(),
            mv_y.data_ptr(), mv_x.data_ptr(), has_coeff.data_ptr(), int(bool(is_intra)),
            out.data_ptr(), out.stride(0), n)
        if rc:
            raise RuntimeError(f"motion-compensation kernel launch failed: "
                               f"CUDA error {rc}")
        build.count(mc_reconstruct)
    return out


mc_reconstruct.launches = 0


def mc_reconstruct_plain(res, ref, by, bx, mv_y, mv_x, has_coeff,
                         is_intra: bool, out=None) -> torch.Tensor:
    """The plain PyTorch version of `mc_reconstruct`."""
    if out is None:
        out = torch.empty_like(ref, memory_format=torch.contiguous_format)
    if is_intra:
        blocks = res
    else:
        pred = gather_predictions(ref, by, bx, mv_y, mv_x)
        coded = (has_coeff != 0)[:, None, None]
        blocks = torch.where(coded, apply_residuals(res, pred), pred)
    r = torch.arange(16, device=res.device)
    out[(by.long()[:, None] + r)[:, :, None], (bx.long()[:, None] + r)[:, None, :]] = blocks
    return out
