"""K1, the frame-step kernel (csrc/step_kernel.cu), and its plain version.

`step_frames` decodes a whole clip into (F, chh, cw) u8 canvases of the
fused layout (Y on top, U | V side by side below): one host call, one
kernel launch per frame on the tensors' device and its current stream; frame
f reads canvas f-1 of the output it is writing, frame 0 a starting canvas
(zeros without one). Every frame dequantizes with its own multipliers for
Y, U and V. A CPU tensor goes to `step_frames_plain`, the same computation
in plain PyTorch ops; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from pfv_torch.ops.dct import FP_BITS, idct8_dim


def lanes_per_stripe(cw: int) -> int:
    """2*scp: coefficient lanes of one 16-row stripe (4 per macroblock,
    padded to a multiple of 256) — the tile demux's lane space."""
    return 2 * ((2 * (cw // 16) + 127) // 128 * 128)


def check_planes(chh: int, cw: int, gly: int, guw: int) -> None:
    """Raise ValueError unless the canvas is whole 16x16 blocks, with gly
    luma stripes and U's guw block columns inside it."""
    gch, gcw = chh // 16, cw // 16
    if (chh % 16 or cw % 16 or chh <= 0 or cw <= 0 or not 0 <= gly <= gch
            or not 0 <= 2 * guw <= gcw):
        raise ValueError(f"canvas {chh}x{cw} with {gly} luma stripes and {guw} U "
                         "block columns is not whole 16x16 blocks")


def _check(units, coff, dy, dx, hc, ftype, qmul, chh, cw, gly, guw, prev):
    f = ftype.shape[0]
    gch, gcw = chh // 16, cw // 16
    check_planes(chh, cw, gly, guw)
    if lanes_per_stripe(cw) > 1024:
        raise ValueError(f"canvas width {cw} is too wide for 10-bit unit lanes")
    want = [
        (units, torch.int32, None), (coff, torch.int32, (f * gch + 1,)),
        (dy, torch.int8, (f, gch, gcw)), (dx, torch.int8, (f, gch, gcw)),
        (hc, torch.uint8, (f, gch, gcw)), (ftype, torch.int32, (f,)),
        (qmul, torch.int32, (f, 3, 64)),
    ]
    if prev is not None:
        want.append((prev, torch.uint8, (chh, cw)))
        if prev.data_ptr() % 16:
            raise ValueError("prev must start on a 16-byte boundary")
    for t, dtype, shape in want:
        if t.dtype != dtype or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"expected {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != units.device or not t.is_contiguous():
            raise ValueError("all inputs must be contiguous, on one device")
    if units.dim() != 2:
        raise ValueError(f"units must be (chunks, chunk), got {tuple(units.shape)}")


def step_frames(units, coff, dy, dx, hc, ftype, qmul, chh: int, cw: int,
                gly: int, guw: int, prev=None) -> torch.Tensor:
    """Decode the clip to (F, chh, cw) u8 canvases.

    units (NC, C) int32: the tile demux's u32 unit words; coff (F*gch + 1,)
    int32: chunk offsets per (frame, stripe) tile; dy, dx (F, gch, gcw) int8
    and hc (F, gch, gcw) u8: per-block motion and coded maps in canvas
    order; ftype (F,) int32 (1 = intra, anything else P); qmul (F, 3, 64)
    int32: frame f's dequant multipliers of Y, U and V [row-major r]; gly:
    luma stripes; guw: U's block columns in a chroma stripe (V's start
    there); prev: the (chh, cw) u8 canvas frame 0 predicts from, zeros when
    None. The frames after the first launch with programmatic dependent
    launch; the first waits for all earlier work on the stream.
    """
    _check(units, coff, dy, dx, hc, ftype, qmul, chh, cw, gly, guw, prev)
    if units.device.type == "cpu":
        return step_frames_plain(units, coff, dy, dx, hc, ftype, qmul, chh,
                                 cw, gly, guw, prev)
    if units.device.type != "cuda":
        raise ValueError(f"no step kernel for device {units.device}")
    from pfv_torch.kernels import build

    frames = ftype.shape[0]
    out = torch.empty((frames, chh, cw), dtype=torch.uint8, device=units.device)
    ptrs = [t.data_ptr() for t in (units, coff, dy, dx, hc, ftype, qmul)]
    rc = build.launch("pfv_step_clip", units.device, *ptrs,
                      prev.data_ptr() if prev is not None else None, out.data_ptr(),
                      frames, chh, cw, gly, guw, units.shape[1])
    if rc:
        raise RuntimeError(f"step kernel launch failed: CUDA error {rc}")
    build.count(step_frames, frames)
    return out


step_frames.launches = 0


def _residual(coef, qrows, cw: int) -> torch.Tensor:
    """(gch, 64, L) int32 coefficients, (gch, 64, L) multipliers ->
    (gch*16, cw) int32 pixels: dequant, iDCT (columns, then rows), merge."""
    gch, _, lanes = coef.shape
    m = (coef * qrows).view(gch, 8, 8, lanes)
    m = idct8_dim(idct8_dim(m, 1), 2)
    px = torch.clamp((m >> FP_BITS) + 128, 0, 255)
    # lane l = 4*gc + 2*sr + sc, pixel (i, j) -> row 8*sr + i, col 16*gc + 8*sc + j
    px = px.view(gch, 8, 8, lanes // 4, 2, 2).permute(0, 4, 1, 3, 5, 2)
    return px.reshape(gch * 16, lanes * 4)[:, :cw]


def _predict(prev, dy, dx) -> torch.Tensor:
    """pred[y, c] = prev[y + dy, c + dx] with the vector of the destination
    block, 0 outside the canvas; (chh, cw) int32."""
    chh, cw = prev.shape
    dev = prev.device
    sy = torch.arange(chh, device=dev)[:, None] + dy.repeat_interleave(
        16, 0).repeat_interleave(16, 1)
    sx = torch.arange(cw, device=dev)[None, :] + dx.repeat_interleave(
        16, 0).repeat_interleave(16, 1)
    inside = (sy >= 0) & (sy < chh) & (sx >= 0) & (sx < cw)
    src = sy.clamp(0, chh - 1) * cw + sx.clamp(0, cw - 1)
    return torch.where(inside, prev.reshape(-1)[src].to(torch.int32), 0)


def plane_rows(qm, gch: int, lanes: int, gly: int, guw: int) -> torch.Tensor:
    """A frame's (3, 64) multipliers of Y, U and V -> (gch, 64, lanes): each
    lane's column of its subblock's plane (Y in the gly luma stripes; U in
    a chroma stripe's block columns below guw, V from there)."""
    dev = qm.device
    chroma = torch.arange(gch, device=dev)[:, None] >= gly
    v = torch.arange(lanes, device=dev)[None, :] // 4 >= guw
    plane = torch.where(chroma, 1 + v.long(), 0)
    return qm[plane].permute(0, 2, 1)


def reconstruct(coef, qm, gly: int, guw: int, intra: bool, prev, dy, dx,
                hc) -> torch.Tensor:
    """One frame of the plain frame steps: (gch, 64, 2*scp) int32
    coefficients of each stripe, the frame's (3, 64) multipliers of Y, U
    and V, the (gch, gcw) maps and the previous (chh, cw) canvas (None reads
    as zeros) -> the (chh, cw) u8 canvas."""
    gch, _, lanes = coef.shape
    cw = dy.shape[1] * 16
    res = _residual(coef, plane_rows(qm, gch, lanes, gly, guw), cw)
    if intra:
        return res.to(torch.uint8)
    if prev is None:
        prev = torch.zeros((gch * 16, cw), dtype=torch.uint8, device=coef.device)
    pred = _predict(prev, dy.long(), dx.long())
    coded = hc.repeat_interleave(16, 0).repeat_interleave(16, 1) != 0
    inter = torch.clamp(pred + (res - 128) * 2, 0, 255)
    return torch.where(coded, inter, pred).to(torch.uint8)


def step_frames_plain(units, coff, dy, dx, hc, ftype, qmul, chh: int, cw: int,
                      gly: int, guw: int, prev=None) -> torch.Tensor:
    """The plain PyTorch version of `step_frames`, frame by frame."""
    dev = units.device
    nf = ftype.shape[0]
    gch = chh // 16
    lanes = lanes_per_stripe(cw)
    chunk = units.shape[1]
    coff_h = coff.tolist()
    ftype_h = ftype.tolist()
    out = torch.empty((nf, chh, cw), dtype=torch.uint8, device=dev)
    for f in range(nf):
        a, b = coff_h[f * gch], coff_h[(f + 1) * gch]
        words = units[a:b].reshape(-1)
        per_tile = coff[f * gch + 1:(f + 1) * gch + 1] - coff[f * gch:(f + 1) * gch]
        tile = torch.repeat_interleave(torch.arange(gch, device=dev),
                                       per_tile * chunk)
        idx = (words >> 16) & 0xFFFF
        val = ((words & 0xFFFF) ^ 0x8000) - 0x8000
        pos = (tile * 64 + (idx >> 10)) * lanes + (idx & 1023)
        coef = torch.zeros(gch * 64 * lanes, dtype=torch.int32, device=dev)
        coef.index_add_(0, pos, val)
        out[f] = reconstruct(coef.view(gch, 64, lanes), qmul[f], gly, guw,
                             ftype_h[f] == 1, out[f - 1] if f else prev, dy[f], dx[f],
                             hc[f])
    return out
