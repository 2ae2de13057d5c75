"""K3 and K4, the dense-input frame steps (csrc/dense_step_kernel.cu), and
their plain versions.

Both decode frames of the fused canvas layout as K1 does, from dense
coefficients (B, 64, row_span) int16 (row r = row-major slot, column
s*2*scp + lane of stripe s; `dataloader.densify_pstep` makes them):
- `seq_frames_dense` (K3) decodes a whole clip, one launch per frame on
  the current stream; frame f predicts from canvas f-1 of its own output;
- `step_frames_batched` (K4) makes one step for a batch of B frames, each
  from its own previous canvas (the GOPs of one stream side by side), one
  launch. Its batch axis may be strided, so step l of (G, L, ...) tensors is
  passed as views.
A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from pfv_torch.kernels.step import lanes_per_stripe, reconstruct

MAX_ROW_SPAN = 1 << 24
MAX_BATCH = 65535  # the grid's z extent


def _items_contiguous(t: torch.Tensor) -> bool:
    """Each t[b] is contiguous; the batch axis may have any stride."""
    want, step = [], 1
    for n in reversed(t.shape[1:]):
        want.append(step)
        step *= n
    return list(t.stride()[1:]) == want[::-1]


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two (B, chh, cw) u8 batches of canvases share a byte. Items
    of one stride s interleave without a shared byte when the offset
    between the batches, modulo s, leaves a whole item on either side."""
    if a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr():
        return False
    n, s = a[0].numel(), a.stride(0)
    a0, b0 = a.data_ptr(), b.data_ptr()
    if a0 + (a.shape[0] - 1) * s + n <= b0 or b0 + (b.shape[0] - 1) * b.stride(0) + n <= a0:
        return False
    if b.stride(0) == s and s >= n:
        return not n <= (b0 - a0) % s <= s - n
    return True


def _check(coeffs, dy, dx, hc, ftype, qmul, chh: int, cw: int, gly: int,
           prev=None, out=None):
    b = ftype.shape[0] if ftype.dim() == 1 else -1
    gch, gcw = chh // 16, cw // 16
    if chh % 16 or cw % 16 or chh <= 0 or cw <= 0 or not 0 <= gly <= gch:
        raise ValueError(f"canvas {chh}x{cw} with {gly} luma stripes is not "
                         "whole 16x16 blocks")
    row_span = gch * lanes_per_stripe(cw)
    if row_span >= MAX_ROW_SPAN:
        raise ValueError(f"row span {row_span} of a {cw}-wide canvas is not "
                         f"below {MAX_ROW_SPAN}")
    want = [(coeffs, torch.int16, (b, 64, row_span)), (dy, torch.int8, (b, gch, gcw)),
            (dx, torch.int8, (b, gch, gcw)), (hc, torch.uint8, (b, gch, gcw)),
            (ftype, torch.int32, (b,)), (qmul, torch.int32, (2, 2, 64))]
    want += [(t, torch.uint8, (b, chh, cw)) for t in (prev, out) if t is not None]
    for t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"expected {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != coeffs.device or not _items_contiguous(t):
            raise ValueError("inputs must be on one device, each batch item "
                             "contiguous")
    if not qmul.is_contiguous() or dy.stride(0) != dx.stride(0) or dy.stride(0) != hc.stride(0):
        raise ValueError("dy, dx and hc must share their batch stride")
    if b > MAX_BATCH:
        raise ValueError(f"batch of {b} frames is above {MAX_BATCH}")
    if prev is not None and b and _overlap(prev, out):
        raise ValueError("out overlaps prev: a frame step never runs in place")
    return row_span


def _stripes(frame_coeffs, chh: int) -> torch.Tensor:
    """(64, row_span) int16 -> (gch, 64, 2*scp) int32, stripe-major."""
    gch = chh // 16
    return frame_coeffs.view(64, gch, -1).transpose(0, 1).contiguous().to(torch.int32)


def seq_frames_dense(coeffs, dy, dx, hc, ftype, qmul, chh: int, cw: int,
                     gly: int) -> torch.Tensor:
    """Decode the clip to (F, chh, cw) u8 canvases.

    coeffs (F, 64, row_span) int16, row_span = gch*2*scp; dy, dx
    (F, gch, gcw) int8 and hc (F, gch, gcw) u8: per-block motion and coded
    maps in canvas order; ftype (F,) int32 (1 = intra, anything else P);
    qmul (2, 2, 64) int32 multipliers [I/P][luma/chroma][row-major r]; gly:
    luma stripes. Frame 0 must be intra. All contiguous.
    """
    row_span = _check(coeffs, dy, dx, hc, ftype, qmul, chh, cw, gly)
    if not all(t.is_contiguous() for t in (coeffs, dy, dx, hc, ftype)):
        raise ValueError("all inputs must be contiguous")
    if coeffs.device.type == "cpu":
        return seq_frames_dense_plain(coeffs, dy, dx, hc, ftype, qmul, chh, cw, gly)
    if coeffs.device.type != "cuda":
        raise ValueError(f"no dense step kernel for device {coeffs.device}")
    from pfv_torch.kernels import build

    lib = build.lib()
    out = torch.empty((ftype.shape[0], chh, cw), dtype=torch.uint8,
                      device=coeffs.device)
    stream = torch.cuda.current_stream(coeffs.device).cuda_stream
    ptrs = [t.data_ptr() for t in (coeffs, dy, dx, hc, ftype, qmul, out)]
    for f in range(ftype.shape[0]):
        rc = lib.pfv_dense_seq_frame(*ptrs, f, chh, cw, gly, row_span, stream)
        if rc:
            raise RuntimeError(f"dense step kernel launch failed: CUDA error {rc}")
        seq_frames_dense.launches += 1
    return out


seq_frames_dense.launches = 0


def seq_frames_dense_plain(coeffs, dy, dx, hc, ftype, qmul, chh: int, cw: int,
                           gly: int) -> torch.Tensor:
    """The plain PyTorch version of `seq_frames_dense`, frame by frame."""
    out = torch.empty((ftype.shape[0], chh, cw), dtype=torch.uint8,
                      device=coeffs.device)
    for f, ft in enumerate(ftype.tolist()):
        out[f] = reconstruct(_stripes(coeffs[f], chh), qmul, gly, ft == 1,
                             out[f - 1] if f else None, dy[f], dx[f], hc[f])
    return out


def step_frames_batched(prev, coeffs, dy, dx, hc, ftype, qmul, chh: int,
                        cw: int, gly: int, out=None) -> torch.Tensor:
    """One frame step for each of B frames -> (B, chh, cw) u8 canvases,
    written into `out` when it is given (it must not overlap `prev`).

    prev (B, chh, cw) u8: each frame's previous canvas; the other inputs as
    `seq_frames_dense`'s with B frames. The batch axis of every tensor but
    qmul may be strided; each item is contiguous.
    """
    if out is None:
        out = torch.empty((ftype.shape[0], chh, cw), dtype=torch.uint8,
                          device=coeffs.device)
    row_span = _check(coeffs, dy, dx, hc, ftype, qmul, chh, cw, gly, prev, out)
    if coeffs.device.type == "cpu":
        return step_frames_batched_plain(prev, coeffs, dy, dx, hc, ftype, qmul,
                                         chh, cw, gly, out)
    if coeffs.device.type != "cuda":
        raise ValueError(f"no dense step kernel for device {coeffs.device}")
    from pfv_torch.kernels import build

    lib = build.lib()
    batch = ftype.shape[0]
    if batch:
        rc = lib.pfv_dense_step_batch(
            prev.data_ptr(), prev.stride(0), coeffs.data_ptr(), coeffs.stride(0),
            dy.data_ptr(), dx.data_ptr(), hc.data_ptr(), dy.stride(0),
            ftype.data_ptr(), ftype.stride(0), qmul.data_ptr(), out.data_ptr(),
            out.stride(0), batch, chh, cw, gly, row_span,
            torch.cuda.current_stream(coeffs.device).cuda_stream)
        if rc:
            raise RuntimeError(f"dense step kernel launch failed: CUDA error {rc}")
        step_frames_batched.launches += 1
    return out


step_frames_batched.launches = 0


def step_frames_batched_plain(prev, coeffs, dy, dx, hc, ftype, qmul, chh: int,
                              cw: int, gly: int, out=None) -> torch.Tensor:
    """The plain PyTorch version of `step_frames_batched`."""
    if out is None:
        out = torch.empty((ftype.shape[0], chh, cw), dtype=torch.uint8,
                          device=coeffs.device)
    for b, ft in enumerate(ftype.tolist()):
        out[b] = reconstruct(_stripes(coeffs[b], chh), qmul, gly, ft == 1,
                             prev[b], dy[b], dx[b], hc[b])
    return out
