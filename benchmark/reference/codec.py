"""Integer transforms, block decode and the encoder of PFV v2.1.1, vectorised
over blocks with PyTorch on any device (FORMAT.md "Spatial codec" and
"Encoder state"; pfv-rs `dct.rs`, `common.rs`, `enc.rs`).

All arithmetic is int64 with the format's int32 wrap after each 1-D pass
and its truncating divisions. `Arith(floor=True)` replaces every
truncating division by an arithmetic shift: the cheaper rounding a later
change might be tempted to take. It is the control of the benchmark's
comparisons and is never the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.tables import (DCT_SCALE_FACTOR, INTER_QIDX, INTRA_QIDX, INV_ZIGZAG,
                              ZIGZAG, plane_dims, skip_threshold)


def wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def wrap16(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 15)) & 0xFFFF) - (1 << 15)


class Arith:
    """The division of the transforms: truncating (the format), or floor
    (the control)."""

    def __init__(self, floor: bool = False):
        self.floor = floor

    def div(self, x: torch.Tensor, d: int) -> torch.Tensor:
        return torch.div(x, d, rounding_mode="floor" if self.floor else "trunc")

    def idct8(self, v):
        t = self.div
        c0, d4, c2, d6, c1, d5, c3, d7 = v
        c4, c5, c7, c6 = d4, d5 + d6, d5 - d6, d7
        b4, b5, b6, b7 = c4 + c5, c4 - c5, c6 + c7, c6 - c7
        b0, b1 = c0 + c1, c0 - c1
        b2 = c2 + t(c2, 4) + t(c3, 2)
        b3 = t(c2, 2) - c3 - t(c3, 4)
        a4 = t(b7, 4) + b4 + t(b4, 4) - t(b4, 16)
        a7 = t(b4, 4) - b7 - t(b7, 4) + t(b7, 16)
        a5 = b5 - b6 + t(b6, 4) + t(b6, 16)
        a6 = b6 + b5 - t(b5, 4) - t(b5, 16)
        a0, a1, a2, a3 = b0 + b2, b1 + b3, b1 - b3, b0 - b2
        return [wrap32(x) for x in (a0 + a4, a1 + a5, a2 + a6, a3 + a7,
                                    a3 - a7, a2 - a6, a1 - a5, a0 - a4)]

    def fdct8(self, v):
        t = self.div
        i0, i1, i2, i3, i4, i5, i6, i7 = v
        a0, a1, a2, a3 = i0 + i7, i1 + i6, i2 + i5, i3 + i4
        a4, a5, a6, a7 = i0 - i7, i1 - i6, i2 - i5, i3 - i4
        b0, b1, b2, b3 = a0 + a3, a1 + a2, a0 - a3, a1 - a2
        c0, c1 = b0 + b1, b0 - b1
        c2 = b2 + t(b2, 4) + t(b3, 2)
        c3 = t(b2, 2) - b3 - t(b3, 4)
        b4 = t(a7, 4) + a4 + t(a4, 4) - t(a4, 16)
        b7 = t(a4, 4) - a7 - t(a7, 4) + t(a7, 16)
        b5 = a5 + a6 - t(a6, 4) - t(a6, 16)
        b6 = a6 - a5 + t(a5, 4) + t(a5, 16)
        c4, c5, c6, c7 = b4 + b5, b4 - b5, b6 + b7, b6 - b7
        d4, d5, d6, d7 = c4, c5 + c7, c5 - c7, c6
        return [wrap32(x) for x in (c0, d4, c2, d6, c1, d5, c3, d7)]

    @staticmethod
    def _along(fn, m: torch.Tensor, dim: int) -> torch.Tensor:
        return torch.stack(fn(list(m.unbind(dim))), dim)

    def idct2d(self, m: torch.Tensor) -> torch.Tensor:
        """(..., 8, 8) row-major -> columns, then rows."""
        return self._along(self.idct8, self._along(self.idct8, m, -2), -1)

    def fdct2d(self, m: torch.Tensor) -> torch.Tensor:
        """(..., 8, 8) row-major -> rows, then columns."""
        return self._along(self.fdct8, self._along(self.fdct8, m, -1), -2)

    def decode_blocks(self, coeffs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """(n, 256) zigzag coefficients of 4 subblocks -> (n, 16, 16) int64
        pixels: dequantise by zigzag slot (quirk Q1), inverse transform,
        clamp((x >> 8) + 128)."""
        dev = coeffs.device
        iz = torch.from_numpy(INV_ZIGZAG).to(dev)
        scale = torch.from_numpy(DCT_SCALE_FACTOR).to(dev)
        zz = coeffs.reshape(-1, 4, 64).long()[..., iz]
        m = wrap32(wrap32(zz * scale[iz]) * q.to(dev).long()[iz])
        px = torch.clamp((self.idct2d(m.view(-1, 4, 8, 8)) >> 8) + 128, 0, 255)
        return subblocks_to_blocks(px)

    def encode_blocks(self, m: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """(n, 16, 16) int64 transform inputs -> (n, 256) int64 zigzag
        coefficients: forward transform, then slot i from row-major element
        ZIGZAG[i] as ((m * SCALE) >> 16) / q, truncated, cut to int16."""
        dev = m.device
        z = torch.from_numpy(ZIGZAG).to(dev)
        scale = torch.from_numpy(DCT_SCALE_FACTOR).to(dev)
        f = self.fdct2d(blocks_to_subblocks(m)).reshape(-1, 4, 64)[..., z]
        n = wrap32(f * scale[z]) >> 16
        return wrap16(torch.div(n, q.to(dev).long()[z], rounding_mode="trunc")).reshape(-1, 256)


def blocks_to_subblocks(b: torch.Tensor) -> torch.Tensor:
    """(n, 16, 16) -> (n, 4, 8, 8) in TL, TR, BL, BR order."""
    return b.reshape(-1, 2, 8, 2, 8).permute(0, 1, 3, 2, 4).reshape(-1, 4, 8, 8)


def subblocks_to_blocks(s: torch.Tensor) -> torch.Tensor:
    return s.reshape(-1, 2, 2, 8, 8).permute(0, 1, 3, 2, 4).reshape(-1, 16, 16)


def plane_to_blocks(p: torch.Tensor) -> torch.Tensor:
    h, w = p.shape
    return p.reshape(h // 16, 16, w // 16, 16).permute(0, 2, 1, 3).reshape(-1, 16, 16)


def blocks_to_plane(b: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return b.reshape(h // 16, w // 16, 16, 16).permute(0, 2, 1, 3).reshape(h, w)


def origins(h: int, w: int, dev):
    """(by, bx) pixel origins of a padded plane's blocks, raster order."""
    by, bx = torch.meshgrid(torch.arange(0, h, 16, device=dev),
                            torch.arange(0, w, 16, device=dev), indexing="ij")
    return by.reshape(-1), bx.reshape(-1)


def windows(plane: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor) -> torch.Tensor:
    """The (n, 16, 16) windows of `plane` at origins (oy, ox)."""
    r = torch.arange(16, device=plane.device)
    return plane[(oy[:, None] + r)[:, :, None], (ox[:, None] + r)[:, None, :]]


def initial_planes(width: int, height: int, dev):
    """The framebuffer before the first frame: Y 0, U and V 128."""
    return [torch.full(d, 0 if i == 0 else 128, dtype=torch.int64, device=dev)
            for i, d in enumerate(plane_dims(width, height))]


def decode_frame(planes, frame, qtables: torch.Tensor, ar: Arith):
    """One frame from its symbols -> the new [Y, U, V] padded int64 planes.
    `frame`: ftype (1 I, 2 P), qidx (3,), coeffs (nb, 256), mvx, mvy, hc
    (nb,), in stream block order."""
    ftype, qidx, *per_block = frame
    n = [(p.shape[0] // 16) * (p.shape[1] // 16) for p in planes]
    out = []
    for p, (prev, c, mx, my, h) in enumerate(zip(planes, *(t.split(n) for t in per_block))):
        ph, pw = prev.shape
        q = qtables[int(qidx[p])]
        if ftype == 1:
            out.append(blocks_to_plane(ar.decode_blocks(c, q), ph, pw))
            continue
        by, bx = origins(ph, pw, prev.device)
        pred = windows(prev, by + my.long(), bx + mx.long())
        coded = h.bool()
        if coded.any():
            res = ar.decode_blocks(c[coded], q)
            pred[coded] = torch.clamp(pred[coded] + (res - 128) * 2, 0, 255)
        out.append(blocks_to_plane(pred, ph, pw))
    return out


def motion_search(src: torch.Tensor, ref: torch.Tensor):
    """The encoder's 4-step log search (8, 4, 2, 1) of every block of padded
    plane `src` in `ref`: at each step the centre first, then the 3x3 ring
    in (my, mx) raster order, strict improvement, windows that leave the
    plane skipped. -> (mvx, mvy, err, prediction windows)."""
    h, w = ref.shape
    by, bx = origins(h, w, ref.device)
    cur = plane_to_blocks(src)
    cy, cx = by.clone(), bx.clone()
    for step in (8, 4, 2, 1):
        best = ((windows(ref, cy, cx) - cur) ** 2).sum((1, 2))
        ny, nx = cy.clone(), cx.clone()
        for my in (-1, 0, 1):
            for mx in (-1, 0, 1):
                if my == 0 and mx == 0:
                    continue
                oy, ox = cy + my * step, cx + mx * step
                ok = (oy >= 0) & (oy <= h - 16) & (ox >= 0) & (ox <= w - 16)
                err = ((windows(ref, oy.clamp(0, h - 16), ox.clamp(0, w - 16)) - cur) ** 2
                       ).sum((1, 2))
                better = ok & (err < best)
                best = torch.where(better, err, best)
                ny, nx = torch.where(better, oy, ny), torch.where(better, ox, nx)
        cy, cx = ny, nx
    return cx - bx, cy - by, best, windows(ref, cy, cx)


class Encoder:
    """The reference encoder over padded int64 planes on one device: frame
    symbols and the in-loop reconstruction (`enc.rs:237-481`)."""

    def __init__(self, width: int, height: int, qtables: np.ndarray, quality: int,
                 dev, ar: Arith | None = None):
        self.width, self.height, self.dev = width, height, dev
        self.qt = torch.from_numpy(np.asarray(qtables)).to(dev)
        self.min_err = torch.tensor(float(skip_threshold(quality)), dtype=torch.float32,
                                    device=dev)
        self.ar = ar or Arith()
        self.prev = initial_planes(width, height, dev)

    def pad(self, planes):
        """Unpadded (Y, U, V) u8 planes -> padded int64 (Y fill 0, U/V 128)."""
        out = []
        for i, (p, (h, w)) in enumerate(zip(planes, plane_dims(self.width, self.height))):
            full = torch.full((h, w), 0 if i == 0 else 128, dtype=torch.int64, device=self.dev)
            full[:p.shape[0], :p.shape[1]] = p.to(self.dev).long()
            out.append(full)
        return out

    def iframe(self, planes):
        """-> (coeffs (nb, 256), mvx, mvy, hc (nb,)) of an I-frame."""
        coeffs, recon = [], []
        for p, src in enumerate(self.pad(planes)):
            q = self.qt[INTRA_QIDX[p]]
            c = self.ar.encode_blocks((plane_to_blocks(src) - 128) << 8, q)
            coeffs.append(c)
            recon.append(blocks_to_plane(self.ar.decode_blocks(c, q), *src.shape))
        self.prev = recon
        c = torch.cat(coeffs)
        z = torch.zeros(c.shape[0], dtype=torch.int64, device=self.dev)
        return c, z, z, torch.ones_like(z)

    def pframe(self, planes):
        """-> (coeffs (nb, 256) zeros in skipped blocks, mvx, mvy, hc)."""
        out, recon = [], []
        for p, (src, ref) in enumerate(zip(self.pad(planes), self.prev)):
            q = self.qt[INTER_QIDX[p]]
            mvx, mvy, err, pred = motion_search(src, ref)
            coded = err.float() > self.min_err
            c = torch.zeros((pred.shape[0], 256), dtype=torch.int64, device=self.dev)
            rec = pred.clone()
            if coded.any():
                d = torch.clamp(plane_to_blocks(src)[coded] - pred[coded], -255, 255)
                cc = self.ar.encode_blocks(self.ar.div(d, 2) << 8, q)
                c[coded] = cc
                res = self.ar.decode_blocks(cc, q)
                rec[coded] = torch.clamp(pred[coded] + (res - 128) * 2, 0, 255)
            recon.append(blocks_to_plane(rec, *src.shape))
            out.append((c, mvx, mvy, coded.long()))
        self.prev = recon
        return tuple(torch.cat(t) for t in zip(*out))
