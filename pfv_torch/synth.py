"""Build .pfv streams from packets, without an encoder: seeded random
streams, and containers for packets cut from other streams
(dec.split_packets). Uses only the shared C++ runtime, so it runs where JAX
is not installed."""

from __future__ import annotations

import struct

import numpy as np

from pfv_torch import runtime
from pfv_torch.frame import geometry
from pfv_torch.ops.blocks import block_origins


def container(width: int, height: int, qtables: np.ndarray, packets,
              fps: int = 30) -> bytes:
    """A PFV stream: the 20-byte header, the (nq, 64) q-tables, the
    (ptype, payload) packets and the EOF packet."""
    qtables = np.asarray(qtables)
    out = [b"PFVIDEO\0", struct.pack("<IHHHH", 211, width, height, fps,
                                     qtables.shape[0]),
           qtables.astype("<u2").tobytes()]
    out += [struct.pack("<BI", t, len(p)) + bytes(p) for t, p in packets]
    out.append(struct.pack("<BI", 0, 0))
    return b"".join(out)


def random_stream(width: int, height: int, frames: int, seed: int,
                  keyframes: int = 1 << 30, fps: int = 30) -> bytes:
    """Frames of seeded random sparse coefficients (about one slot in twenty
    nonzero, |v| <= 60): an I-frame every `keyframes` frames from the first,
    P-frames between them with random coded flags and random motion vectors
    of |v| <= 12 that keep every window inside its padded plane. Four random
    q-tables; I-frames use (0, 1, 1), P-frames (2, 3, 3)."""
    rng = np.random.default_rng(seed)
    g = geometry(width, height)
    qtables = rng.integers(1, 40, size=(4, 64))

    planes = [(g.ly0, g.lyw), (g.lc0, g.lcw), (g.lc0, g.lcw)]
    lo_x, hi_x, lo_y, hi_y = (np.concatenate(p) for p in zip(*[
        (-bx, w - 16 - bx, -by, h - 16 - by)
        for (h, w), (by, bx) in ((hw, block_origins(*hw)) for hw in planes)]))
    packets = []
    for f in range(frames):
        coeffs = rng.integers(-60, 61, size=(g.nb, 256))
        coeffs[rng.random(coeffs.shape) > 0.05] = 0
        if f % keyframes == 0:
            packets.append((1, runtime.encode_iframe_payload(coeffs, (0, 1, 1))))
            continue
        mvx = np.clip(rng.integers(-12, 13, g.nb), lo_x, hi_x).astype(np.int8)
        mvy = np.clip(rng.integers(-12, 13, g.nb), lo_y, hi_y).astype(np.int8)
        hc = (rng.random(g.nb) < 0.5).astype(np.uint8)
        packets.append((2, runtime.encode_pframe_payload(coeffs, mvx, mvy, hc,
                                                         (2, 3, 3))))
    return container(width, height, qtables, packets, fps)
