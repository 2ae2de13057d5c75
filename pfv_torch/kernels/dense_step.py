"""K3 and K4, the dense-input frame steps (csrc/dense_step_kernel.cu), and
their plain versions.

Both decode frames of the fused canvas layout as K1 does, from dense
coefficients (..., 64, row_span) int16 (row r = row-major slot, column
s*2*scp + lane of stripe s; `dataloader.densify_pstep` makes them):
- `seq_frames_dense` (K3) decodes a whole clip, or one chunk of it, one
  host call and one launch per frame; frame f predicts from canvas f-1 of
  its own output, frame 0 from `prev` (zeros without one);
- `step_gops` (K4) decodes G GOPs of L frames side by side, one host call
  and one launch per step of all G GOPs; the leading (G, L) axes may be
  strided, so the GOPs are read and written in place; a single step is a
  call on [:, l:l+1] views with `prev`.
Every frame dequantizes with its own multipliers of Y, U and V (qmul
(..., 3, 64)). Each call checks its inputs once; launches after a call's first use
programmatic dependent launch. A CPU tensor goes to the plain version; a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from pfv_torch.kernels.step import check_planes, lanes_per_stripe, reconstruct

MAX_ROW_SPAN = 1 << 24
MAX_BATCH = 65535  # the grid's z extent
ALIGN = 16  # bytes: 16-byte coefficient loads and canvas rows


def _items_contiguous(t: torch.Tensor, lead: int) -> bool:
    """Each item t[i] (i over the `lead` leading axes) is contiguous; the
    leading axes may have any stride."""
    want, step = [], 1
    for n in reversed(t.shape[lead:]):
        want.append(step)
        step *= n
    return list(t.stride()[lead:]) == want[::-1]


def _aligned(t: torch.Tensor, lead: int) -> bool:
    """Every item of t starts on an ALIGN-byte boundary."""
    strides = t.stride()[:lead]
    return t.data_ptr() % ALIGN == 0 and all(
        s * t.element_size() % ALIGN == 0 for n, s in zip(t.shape, strides) if n > 1)


def _distinct_items(t: torch.Tensor, lead: int) -> bool:
    """No two items of t (over the leading axes) share a byte."""
    dims = sorted((s, n) for n, s in zip(t.shape[:lead], t.stride()[:lead]) if n > 1)
    extent = t[(0,) * lead].numel()
    for s, n in dims:
        if s < extent:
            return False
        extent = s * n
    return True


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
           guw: int, prev=None, out=None):
    """Check a call once, whatever its number of frames: the batch shape
    is ftype's, (F,) or (G, L). Every item contiguous, the maps sharing
    their batch strides, coefficients and canvases 16-byte aligned, the
    canvases of `out` distinct and apart from `prev` ((G, chh, cw), or
    (1, chh, cw) for (F,)), all on one device. Returns row_span."""
    lead = ftype.dim()
    bs = tuple(ftype.shape)
    gch, gcw = chh // 16, cw // 16
    check_planes(chh, cw, gly, guw)
    if lead not in (1, 2):
        raise ValueError(f"ftype must be (F,) or (G, L), got {bs}")
    row_span = gch * lanes_per_stripe(cw)
    if row_span >= MAX_ROW_SPAN:
        raise ValueError(f"row span {row_span} of a {cw}-wide canvas is not "
                         f"below {MAX_ROW_SPAN}")
    want = [(coeffs, torch.int16, bs + (64, row_span), lead),
            (dy, torch.int8, bs + (gch, gcw), lead),
            (dx, torch.int8, bs + (gch, gcw), lead),
            (hc, torch.uint8, bs + (gch, gcw), lead),
            (ftype, torch.int32, bs, lead), (qmul, torch.int32, bs + (3, 64), lead)]
    if prev is not None:
        want.append((prev, torch.uint8, (bs[0] if lead == 2 else 1, chh, cw), 1))
    if out is not None:
        want.append((out, torch.uint8, bs + (chh, cw), lead))
    for t, dtype, shape, n in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"expected {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != coeffs.device or not _items_contiguous(t, n):
            raise ValueError("inputs must be on one device, each batch item "
                             "contiguous")
    if dy.stride()[:lead] != dx.stride()[:lead] or dy.stride()[:lead] != hc.stride()[:lead]:
        raise ValueError("dy, dx and hc must share their batch strides")
    for t, _, _, n in want[:1] + want[6:]:
        if not _aligned(t, n):
            raise ValueError(f"every item must start on a {ALIGN}-byte boundary")
    if bs[0] > MAX_BATCH:
        raise ValueError(f"batch of {bs[0]} frames is above {MAX_BATCH}")
    if out is not None and out.numel() and not _distinct_items(out, lead):
        raise ValueError("two canvases of out share bytes")
    if prev is not None and out is not None and out.numel():
        steps = [out[:, l] for l in range(bs[1])] if lead == 2 else [out]
        if any(_overlap(prev, o) for o in steps):
            raise ValueError("out overlaps prev: a frame step never runs in place")
    return row_span


def _stripes(frame_coeffs, chh: int) -> torch.Tensor:
    """(64, row_span) int16 -> (gch, 64, 2*scp) int32, stripe-major."""
    gch = chh // 16
    return frame_coeffs.view(64, gch, -1).transpose(0, 1).contiguous().to(torch.int32)


def _build_for(t: torch.Tensor):
    """The kernels' build module; raises unless t is on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"no dense step kernel for device {t.device}")
    from pfv_torch.kernels import build

    return build


def seq_frames_dense(coeffs, dy, dx, hc, ftype, qmul, chh: int, cw: int,
                     gly: int, guw: int, prev=None, out=None) -> torch.Tensor:
    """Decode the clip to (F, chh, cw) u8 canvases, written into `out` when
    it is given: one host call, F launches.

    coeffs (F, 64, row_span) int16, row_span = gch*2*scp; dy, dx
    (F, gch, gcw) int8 and hc (F, gch, gcw) u8: per-block motion and coded
    maps in canvas order; ftype (F,) int32 (1 = intra, anything else P);
    qmul (F, 3, 64) int32: frame f's multipliers of Y, U and V [row-major
    r]; gly: luma stripes; guw: U's block columns in a chroma stripe; prev:
    the (chh, cw) u8 canvas frame 0 predicts from (zeros when None), which
    the call before on the same stream may still be writing. All contiguous.
    """
    if ftype.dim() != 1:
        raise ValueError(f"ftype must be (F,), got {tuple(ftype.shape)}")
    if out is None:
        out = torch.empty(tuple(ftype.shape) + (chh, cw), dtype=torch.uint8,
                          device=coeffs.device)
    row_span = _check(coeffs, dy, dx, hc, ftype, qmul, chh, cw, gly, guw,
                      None if prev is None else prev[None], out)
    if not all(t.is_contiguous() for t in (coeffs, dy, dx, hc, ftype, qmul, out)):
        raise ValueError("all inputs must be contiguous")
    if coeffs.device.type == "cpu":
        return seq_frames_dense_plain(coeffs, dy, dx, hc, ftype, qmul, chh, cw, gly,
                                      guw, prev, out)
    build = _build_for(coeffs)
    frames = ftype.shape[0]
    rc = build.launch("pfv_dense_seq_clip", coeffs.device,
                      *(t.data_ptr() for t in (coeffs, dy, dx, hc, ftype, qmul)),
                      prev.data_ptr() if prev is not None else None, out.data_ptr(),
                      frames, chh, cw, gly, guw, row_span)
    if rc:
        raise RuntimeError(f"dense step kernel launch failed: CUDA error {rc}")
    build.count(seq_frames_dense, frames)
    return out


seq_frames_dense.launches = 0


def seq_frames_dense_plain(coeffs, dy, dx, hc, ftype, qmul, chh: int, cw: int,
                           gly: int, guw: int, prev=None, out=None) -> torch.Tensor:
    """The plain PyTorch version of `seq_frames_dense`, frame by frame."""
    if out is None:
        out = torch.empty((ftype.shape[0], chh, cw), dtype=torch.uint8,
                          device=coeffs.device)
    for f, ft in enumerate(ftype.tolist()):
        out[f] = reconstruct(_stripes(coeffs[f], chh), qmul[f], gly, guw, ft == 1,
                             out[f - 1] if f else prev, dy[f], dx[f], hc[f])
    return out


def step_gops(coeffs, dy, dx, hc, ftype, qmul, chh: int, cw: int, gly: int,
              guw: int, prev=None, out=None) -> torch.Tensor:
    """Decode G GOPs of L frames side by side -> (G, L, chh, cw) u8
    canvases, written into `out` when it is given: one host call, L
    launches. Step l decodes frame l of every GOP from frame l-1 of the
    same GOP; step 0 from `prev` (G, chh, cw) u8, or from zeros.

    coeffs (G, L, 64, row_span) int16, dy, dx, hc (G, L, gch, gcw), ftype
    (G, L) int32, qmul (G, L, 3, 64) int32: as `seq_frames_dense`'s per
    frame. The two leading axes of every tensor may be strided (dy, dx and
    hc alike); each frame is contiguous, and coefficients and canvases
    16-byte aligned.
    """
    if ftype.dim() != 2:
        raise ValueError(f"ftype must be (G, L), got {tuple(ftype.shape)}")
    if out is None:
        out = torch.empty(tuple(ftype.shape) + (chh, cw), dtype=torch.uint8,
                          device=coeffs.device)
    row_span = _check(coeffs, dy, dx, hc, ftype, qmul, chh, cw, gly, guw, prev, out)
    if coeffs.device.type == "cpu":
        return step_gops_plain(coeffs, dy, dx, hc, ftype, qmul, chh, cw, gly, guw,
                               prev, out)
    build = _build_for(coeffs)
    gops, steps = ftype.shape
    if gops and steps:
        rc = build.launch(
            "pfv_dense_gops", coeffs.device, prev.data_ptr() if prev is not None else None,
            prev.stride(0) if prev is not None else 0,
            coeffs.data_ptr(), *coeffs.stride()[:2], dy.data_ptr(), dx.data_ptr(),
            hc.data_ptr(), *dy.stride()[:2], ftype.data_ptr(), *ftype.stride(),
            qmul.data_ptr(), *qmul.stride()[:2], out.data_ptr(), *out.stride()[:2],
            gops, steps, chh, cw, gly, guw, row_span)
        if rc:
            raise RuntimeError(f"dense step kernel launch failed: CUDA error {rc}")
        build.count(step_gops, steps)
    return out


step_gops.launches = 0


def step_gops_plain(coeffs, dy, dx, hc, ftype, qmul, chh: int, cw: int, gly: int,
                    guw: int, prev=None, out=None) -> torch.Tensor:
    """The plain PyTorch version of `step_gops`, step by step."""
    gops, steps = ftype.shape
    if out is None:
        out = torch.empty((gops, steps, chh, cw), dtype=torch.uint8,
                          device=coeffs.device)
    if prev is None:
        prev = torch.zeros((gops, chh, cw), dtype=torch.uint8, device=coeffs.device)
    for l in range(steps):
        step_frames_batched_plain(prev, coeffs[:, l], dy[:, l], dx[:, l], hc[:, l],
                                  ftype[:, l], qmul[:, l], chh, cw, gly, guw, out[:, l])
        prev = out[:, l]
    return out


def step_frames_batched_plain(prev, coeffs, dy, dx, hc, ftype, qmul, chh: int,
                              cw: int, gly: int, guw: int, out=None) -> torch.Tensor:
    """One frame step for each of B frames -> (B, chh, cw) u8 canvases,
    written into `out` when it is given: the plain version of one step of
    `step_gops`, each frame from its explicit previous canvas prev[b].

    prev (B, chh, cw) u8; the other inputs as `seq_frames_dense`'s with B
    frames.
    """
    if out is None:
        out = torch.empty((ftype.shape[0], chh, cw), dtype=torch.uint8,
                          device=coeffs.device)
    for b, ft in enumerate(ftype.tolist()):
        out[b] = reconstruct(_stripes(coeffs[b], chh), qmul[b], gly, guw, ft == 1,
                             prev[b], dy[b], dx[b], hc[b])
    return out
