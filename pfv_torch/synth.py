"""Synthetic inputs, made where JAX is not installed.

Source frames: numpy copies of pfv_tpu/utils/synth.py (`synth_rgb_frame`,
`synth_yuv_frame`, `synth_pan_clip`), frame for frame the same, so the port
can rebuild the sources of the committed corpora. Streams without an
encoder: seeded random streams from runtime payloads, and containers for
packets cut from other streams (dec.split_packets).
"""

from __future__ import annotations

import struct

import numpy as np

from pfv_torch import runtime
from pfv_torch.frame import canvas_layout, geometry
from pfv_torch.ops.blocks import block_origins
from pfv_torch.ops.color import rgb_to_yuv_np


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
                  keyframes: int = 1 << 30, fps: int = 30, max_mv: int = 12,
                  coded=(0.5,), qidx=None) -> bytes:
    """Frames of seeded random sparse coefficients (about one slot in twenty
    nonzero, |v| <= 60): an I-frame every `keyframes` frames from the first,
    P-frames between them with random coded flags (P-frame k codes a block
    with probability coded[k % len(coded)]) and random motion vectors of
    |v| <= max_mv (at most 63, the format's), cut so that every window stays
    inside its padded plane, as the demux demands. Four random q-tables;
    frame f takes the (Y, U, V) q-table indices qidx[f % len(qidx)] where
    `qidx` is given, else (0, 1, 1) for an I-frame and (2, 3, 3) for a
    P-frame."""
    rng = np.random.default_rng(seed)
    g = geometry(width, height)
    qtables = rng.integers(1, 40, size=(4, 64))

    planes = [(g.ly0, g.lyw), (g.lc0, g.lcw), (g.lc0, g.lcw)]
    lo_x, hi_x, lo_y, hi_y = (np.concatenate(p) for p in zip(*[
        (-bx, w - 16 - bx, -by, h - 16 - by)
        for (h, w), (by, bx) in ((hw, block_origins(*hw)) for hw in planes)]))
    packets, n_p = [], 0
    for f in range(frames):
        coeffs = rng.integers(-60, 61, size=(g.nb, 256))
        coeffs[rng.random(coeffs.shape) > 0.05] = 0
        q = qidx[f % len(qidx)] if qidx else None
        if f % keyframes == 0:
            packets.append((1, runtime.encode_iframe_payload(coeffs, q or (0, 1, 1))))
            continue
        mvx = np.clip(rng.integers(-max_mv, max_mv + 1, g.nb), lo_x, hi_x).astype(np.int8)
        mvy = np.clip(rng.integers(-max_mv, max_mv + 1, g.nb), lo_y, hi_y).astype(np.int8)
        hc = (rng.random(g.nb) < coded[n_p % len(coded)]).astype(np.uint8)
        n_p += 1
        packets.append((2, runtime.encode_pframe_payload(coeffs, mvx, mvy, hc,
                                                         q or (2, 3, 3))))
    return container(width, height, qtables, packets, fps)


# Streams at the frame steps' edges: widths whose last 512-column block is
# partial (528, 1936), K1's widest (4096), the narrowest dense width (4112),
# height 16, vectors as long as the planes allow, and P-frames with no coded
# block, with every block coded, and with half coded, in turn.
EDGE_STREAMS = {"528x48": (528, 48, 7), "1936x32": (1936, 32, 6),
                "4096x16": (4096, 16, 6), "4112x16": (4112, 16, 8)}


def edge_stream(name: str, seed: int = 41) -> bytes:
    """The EDGE_STREAMS stream `name`: a keyframe every 4 frames, |mv| up
    to 63, P-frames coding no block, every block, then half of them."""
    w, h, f = EDGE_STREAMS[name]
    return random_stream(w, h, f, seed, keyframes=4, max_mv=63, coded=(0.0, 1.0, 0.5))


def synth_rgb_frame(t: int, width: int, height: int, seed: int = 1234) -> np.ndarray:
    """Frame t of the deterministic synthetic clip, (H, W, 3) uint8: a
    moving gradient, a translating textured rectangle, a bouncing ball and
    mild seeded noise."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)

    r = 96 + 64 * np.sin(0.013 * xx + 0.05 * t)
    g = 96 + 64 * np.sin(0.017 * yy - 0.04 * t)
    b = 96 + 64 * np.sin(0.011 * (xx + yy) + 0.03 * t)
    img = np.stack([r, g, b], axis=-1)

    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 255, size=(64, 96, 3)).astype(np.float32)
    tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1) + np.roll(tex, 2, 1)) / 4
    rx = int(40 + 3.0 * t) % max(1, width - 96) if width > 96 else 0
    ry = int(30 + 1.5 * t) % max(1, height - 64) if height > 64 else 0
    rh, rw = min(64, height - ry), min(96, width - rx)
    img[ry : ry + rh, rx : rx + rw] = tex[:rh, :rw]

    bx = width / 2 + (width / 2 - 40) * np.sin(0.11 * t)
    by = height / 2 + (height / 2 - 40) * np.sin(0.07 * t + 1.0)
    mask = (xx - bx) ** 2 + (yy - by) ** 2 < 30.0**2
    img[mask] = np.array([230.0, 40.0, 40.0])

    nrng = np.random.default_rng(seed * 100003 + t)
    img += nrng.normal(0.0, 2.0, size=img.shape).astype(np.float32)

    return np.clip(img, 0, 255).astype(np.uint8)


def synth_yuv_frame(t: int, width: int, height: int, seed: int = 1234):
    """Frame t as 4:2:0 (Y, U, V) uint8 planes, chroma point-decimated
    (quirk Q11)."""
    y, u, v = rgb_to_yuv_np(synth_rgb_frame(t, width, height, seed))
    return y, u[::2, ::2].copy(), v[::2, ::2].copy()


def synth_pan_clip(n_frames: int, width: int, height: int, seed: int = 99,
                   dx: int = 3, dy: int = 1, t0: int = 0):
    """Frames t0 .. t0+n_frames of the panning-camera clip as 4:2:0
    (F, H, W) and (F, H/2, W/2) x2 uint8 stacks: a fixed world of
    multi-octave value noise seen through a window that moves (dx, dy)
    pixels per frame."""
    rng = np.random.default_rng(seed)
    wh, ww = height + 256, width + 256
    world = np.full((wh, ww, 3), 128.0, dtype=np.float32)
    for scale, amp in ((64, 48.0), (32, 28.0), (16, 16.0), (8, 9.0), (4, 5.0)):
        g = rng.normal(0, amp, size=(wh // scale + 3, ww // scale + 3, 3))
        g = g.repeat(scale, axis=0).repeat(scale, axis=1)
        for axis in (0, 1):  # box blur at the octave's own scale
            g = (g + np.roll(g, scale // 2, axis) +
                 np.roll(g, -(scale // 2), axis)) / 3
        world += g[:wh, :ww]
    world += rng.normal(0, 2.5, size=(wh, ww, 3))
    world = np.clip(world, 0, 255)

    ys, us, vs = [], [], []
    for t in range(t0, t0 + n_frames):
        ox = (16 + dx * t) % (ww - width)
        oy = (16 + dy * t) % (wh - height)
        y, u, v = rgb_to_yuv_np(world[oy : oy + height, ox : ox + width].astype(np.uint8))
        ys.append(y)
        us.append(u[::2, ::2].copy())
        vs.append(v[::2, ::2].copy())
    return np.stack(ys), np.stack(us), np.stack(vs)


SEARCH_STRESS = ("shifts", "mirror ties", "largest error", "edges")


def _smooth_plane(h: int, w: int, rng) -> np.ndarray:
    yy, xx = np.mgrid[:h, :w]
    return (128 + 50 * np.sin(xx / 13.0) + 50 * np.sin(yy / 11.0 + xx / 29.0)
            + rng.integers(0, 5, size=(h, w))).astype(np.uint8)


def _moved_blocks(prev: np.ndarray, vectors) -> np.ndarray:
    """A source whose block b is prev's window at the block's origin plus
    vectors[b] (dx, dy), the window's origin clamped into the plane."""
    h, w = prev.shape
    by, bx = block_origins(h, w)
    src = np.empty_like(prev)
    for y0, x0, (dx, dy) in zip(by, bx, vectors):
        y, x = min(max(y0 + dy, 0), h - 16), min(max(x0 + dx, 0), w - 16)
        src[y0:y0 + 16, x0:x0 + 16] = prev[y:y + 16, x:x + 16]
    return src


def search_stress(kind: str, h: int, w: int, seed: int = 0):
    """(source, previous) (h, w) uint8 planes (multiples of 16) that stress
    a motion search's corners, from a seed:
      "shifts": smooth planes, source block b the previous plane moved by
        vector 32 b mod 961 of the 31 x 31 vectors (-15..15)^2, so that a
        plane of 31 blocks or more sees every dx and every dy, and one of
        961 or more every vector: the walk ends at every column phase;
      "mirror ties": every row of the previous plane has period 16 and is
        symmetric about each block's middle, and each source block the mean
        of the windows 4 to its left and right (mirror images of each
        other), so that ring candidates of steps 8 and 4 tie and the lower
        priority must win;
      "largest error": a source of 255 over a previous plane of 0: every
        error is 16 * 16 * 255^2 = 16,646,400;
      "edges": smooth planes, each source block the previous plane moved
        15 pixels out towards the nearer edge in x and in y, so that walks
        press against every edge of the plane."""
    rng = np.random.default_rng(seed)
    by, bx = block_origins(h, w)
    if kind == "shifts":
        prev = _smooth_plane(h, w, rng)
        k = 32 * np.arange(by.shape[0]) % 961
        return _moved_blocks(prev, zip(k % 31 - 15, k // 31 - 15)), prev
    if kind == "mirror ties":
        half = rng.integers(0, 256, size=(h, 8), dtype=np.uint8)
        prev = np.tile(np.concatenate([half, half[:, ::-1]], axis=1), (1, w // 16))
        left = _moved_blocks(prev, [(-4, 0)] * by.shape[0]).astype(np.int32)
        right = _moved_blocks(prev, [(4, 0)] * by.shape[0]).astype(np.int32)
        return ((left + right) // 2).astype(np.uint8), prev
    if kind == "largest error":
        return np.full((h, w), 255, np.uint8), np.zeros((h, w), np.uint8)
    if kind == "edges":
        prev = _smooth_plane(h, w, rng)
        vectors = zip(np.where(bx + 8 < w / 2, -15, 15), np.where(by + 8 < h / 2, -15, 15))
        return _moved_blocks(prev, vectors), prev
    raise ValueError(f"unknown search stress {kind!r}; expected one of {SEARCH_STRESS}")


def search_stress_canvas(kind: str, width: int, height: int, seed: int = 0):
    """`search_stress` on each plane of a width x height frame's fused
    canvas (U's right edge beside V's left): (the three padded source
    planes, the previous canvas, its other bytes random)."""
    g = geometry(width, height)
    prev = np.random.default_rng(seed).integers(0, 256, size=(g.chh, g.cw), dtype=np.uint8)
    sources = []
    for i, (_, row, col, h, w) in enumerate(canvas_layout(g)):
        src, plane = search_stress(kind, h, w, seed + 1 + i)
        prev[row:row + h, col:col + w] = plane
        sources.append(src)
    return sources, prev
