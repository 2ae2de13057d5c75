"""Seeded PFV streams whose statistics come from a traffic file, written by
the reference's own entropy coder, and their decode from the symbols alone.

A clip's frame f draws its symbols from a torch.Generator seeded by (seed,
clip, f), so a frame can be drawn again after the measured window without
holding the clip: `Clip.frames()` yields each frame's symbols, `Clip.write()`
the container bytes, `Clip.decoded()` the reference's planes.

The statistics (a traffic file's "stream" object):
  i_density, p_density   64 per-zigzag-slot probabilities that a coefficient
                         of an I-block / a coded P-block is nonzero
  i_magnitude, p_magnitude  64 per-slot mean magnitudes of a nonzero
                         coefficient (geometric, at least 1, at most max_abs)
  max_abs                the largest magnitude drawn
  p_coded                the share of P-blocks with coefficients
  p_moved                the share of P-blocks with a nonzero vector
  mv_abs                 16 weights of |component| 0..15 of a moved block's
                         vector; signs are even; windows are kept inside
                         the padded plane
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from reference.codec import Arith, decode_frame, initial_planes, origins
from reference.entropy import frame_payload
from reference.tables import INTER_QIDX, INTRA_QIDX, plane_dims

MAGIC, VERSION = b"PFVIDEO\0", 211


def container(width: int, height: int, fps: int, qtables: np.ndarray, payloads) -> bytes:
    """Header, q-tables, (ptype, payload) packets and the EOF packet."""
    qt = np.asarray(qtables)
    out = [MAGIC, struct.pack("<IHHHH", VERSION, width, height, fps, qt.shape[0]),
           qt.astype("<u2").tobytes()]
    out += [struct.pack("<BI", t, len(p)) + p for t, p in payloads]
    out.append(struct.pack("<BI", 0, 0))
    return b"".join(out)


def frame_seed(seed: int, clip: int, f: int) -> int:
    return (seed * 1_000_003 + clip * 65_537 + f * 7_919 + 12_345) % (1 << 63)


class Clip:
    """Clip `clip` of the stream statistics `stats` for seed `seed`: F
    frames, an I-frame every `keyframes`, q-tables `qtables` (4, 64)."""

    def __init__(self, width: int, height: int, fps: int, frames: int, keyframes: int,
                 qtables: np.ndarray, stats: dict, seed: int, clip: int, device):
        self.width, self.height, self.fps = width, height, fps
        self.n, self.keyframes = frames, keyframes
        self.qtables = np.asarray(qtables)
        self.stats, self.seed, self.clip = stats, seed, clip
        self.dev = torch.device(device)
        dims = plane_dims(width, height)
        self.nb = sum((h // 16) * (w // 16) for h, w in dims)
        # the vectors that keep each block's window inside its padded plane
        bounds = []
        for h, w in dims:
            by, bx = origins(h, w, self.dev)
            bounds.append((-bx, w - 16 - bx, -by, h - 16 - by))
        self.bounds = [torch.cat(b) for b in zip(*bounds)]
        self._f32 = dict(dtype=torch.float32, device=self.dev)
        self.density = {t: torch.tensor(stats[f"{t}_density"], **self._f32) for t in "ip"}
        self.magnitude = {t: torch.tensor(stats[f"{t}_magnitude"], **self._f32) for t in "ip"}
        w = torch.tensor(stats["mv_abs"], **self._f32)
        self.mv_abs = w / w.sum()

    def _coeffs(self, gen, kind: str, n: int) -> torch.Tensor:
        shape = (n, 4, 64)
        u = torch.rand(shape, generator=gen, **self._f32)
        nz = u < self.density[kind]
        p = 1.0 / self.magnitude[kind].clamp(min=1.0)
        u = 1.0 - torch.rand(shape, generator=gen, **self._f32)
        mag = 1 + torch.floor(torch.log(u) / torch.log1p(-p.clamp(max=1 - 1e-7)))
        mag = torch.where(p >= 1.0, 1.0, mag).clamp(max=self.stats["max_abs"])
        sign = torch.where(torch.rand(shape, generator=gen, **self._f32) < 0.5, -1, 1)
        return torch.where(nz, mag.long() * sign, 0).view(n, 256)

    def frame(self, f: int):
        """Frame f's symbols: (ftype, qidx, coeffs (nb, 256) int64, mvx,
        mvy, hc (nb,) int64)."""
        gen = torch.Generator(device=self.dev).manual_seed(frame_seed(self.seed, self.clip, f))
        nb, st = self.nb, self.stats
        zero = torch.zeros(nb, dtype=torch.long, device=self.dev)
        if f % self.keyframes == 0:
            return 1, INTRA_QIDX, self._coeffs(gen, "i", nb), zero, zero, zero + 1
        hc = (torch.rand(nb, generator=gen, **self._f32) < st["p_coded"]).long()
        moved = torch.rand(nb, generator=gen, **self._f32) < st["p_moved"]
        comp = torch.multinomial(self.mv_abs, 2 * nb, replacement=True, generator=gen)
        sign = torch.where(torch.rand(2 * nb, generator=gen, **self._f32) < 0.5, -1, 1)
        mvx, mvy = (comp * sign).view(2, nb)
        mvx = torch.where(moved & (mvx == 0) & (mvy == 0), 1, mvx)
        lo_x, hi_x, lo_y, hi_y = self.bounds
        mvx = torch.where(moved, torch.minimum(torch.maximum(mvx, lo_x), hi_x), 0)
        mvy = torch.where(moved, torch.minimum(torch.maximum(mvy, lo_y), hi_y), 0)
        coeffs = self._coeffs(gen, "p", nb) * hc[:, None]
        return 2, INTER_QIDX, coeffs, mvx, mvy, hc

    def frames(self):
        for f in range(self.n):
            yield self.frame(f)

    def write(self) -> bytes:
        """The clip as a .pfv container."""
        payloads = []
        for ftype, qidx, coeffs, mvx, mvy, hc in self.frames():
            motion = None if ftype == 1 else (mvx, mvy, hc)
            payloads.append((ftype, frame_payload(coeffs, qidx, motion)))
        return container(self.width, self.height, self.fps, self.qtables, payloads)

    def decoded(self, ar: Arith | None = None):
        """Yields each frame's padded [Y, U, V] int64 planes, decoded from
        the symbols by the reference (`ar`: the control's arithmetic)."""
        ar = ar or Arith()
        qt = torch.from_numpy(self.qtables).to(self.dev)
        planes = initial_planes(self.width, self.height, self.dev)
        for fr in self.frames():
            planes = decode_frame(planes, fr, qt, ar)
            yield planes
