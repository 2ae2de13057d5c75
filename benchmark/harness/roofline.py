"""Frozen roofline arithmetic of the port's kernels: the least time each
launch could take on one H100, the larger of the bytes it must move at the
HBM peak and the operations it must run at the integer (or float32) issue
rate of `peaks.json`, counted for what the benchmark's own inputs need.

The counts are copied from the program's `chip_smoke.py` (`bound`,
`*_OPS`, `step_bound`, `frame_encode_bound`, `motion_search_bound`,
`least_candidates`) and no longer follow it.
Operations, counted from the CUDA sources at the time of the copy: one
8-point transform is 36 adds, 12 truncating divisions (mask, add, shift)
and 6 sign extractions; an inverse-transformed coefficient is a
dequantisation, a column and a row pass, then shift, offset, two clamps and
the byte pack (one more where a dense coefficient is widened); a forward-
transformed one the residual (6 per 4 pixels), the widening (2), two
passes, scale, shift, magnitude, reciprocal multiply (2), sign (2) and
pack; a P-block row costs 4 funnel shifts where the window is not 4-byte
aligned and a 24-operation select where the block is coded; a coefficient
unit costs 4; a colour-converted pixel 15 float32 operations; 16 pixels of
a motion-search candidate 9.

Per-frame work comes from the drivers as dicts: ftype (1 I, 2 P), nb
(blocks), decoded (blocks inverse-transformed), coded (coded P-blocks),
shifted (P-blocks whose vector's x is not a multiple of 4), nonzeros
(nonzero coefficients). A kernel's share divides its bound per launch made
by the profiler's device time per launch it saw, never by the calls.
"""

from __future__ import annotations

import json
import os

DCT8_OPS = 36 + 3 * 12 + 6
IDCT_OPS = 1 + 2 * DCT8_OPS / 8 + 5
FDCT_OPS = 4 + 2 * DCT8_OPS / 8 + 8
SHIFT_OPS, SELECT_OPS, UNIT_OPS, RGBA_OPS = 4, 24, 4, 15
SEARCH_OPS = 4 + 4 + 1

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as _f:
    PEAKS = json.load(_f)


def pad16(x: int) -> int:
    return x + (16 - x % 16) % 16


def canvas(width: int, height: int):
    """(chh, cw, planes [(rows, cols)]) of the fused Y | U V canvas."""
    ly0, lyw, lc0, lcw = pad16(height), pad16(width), pad16(height // 2), pad16(width // 2)
    return ly0 + lc0, max(lyw, 2 * lcw), [(ly0, lyw), (lc0, lcw), (lc0, lcw)]


def bound_s(nbytes: float, ops: float, kind: str = "int") -> float:
    return max(nbytes / PEAKS["hbm_bytes_per_s"], ops / PEAKS[f"{kind}_ops_per_s"])


def _rows(fr) -> float:
    return 16 * (SHIFT_OPS * fr["shifted"] + SELECT_OPS * fr["coded"])


def k1(fr, width: int, height: int) -> float:
    """K1 (step_kernel.cu), one launch per frame: each nonzero coefficient
    read once as a 4-byte unit word, the (3, 64) int32 multipliers and,
    for a P-frame, the 3-byte header of each block read once, the canvas
    written once."""
    chh, cw, _ = canvas(width, height)
    head = 3 * fr["nb"] if fr["ftype"] == 2 else 0
    nbytes = 4 * fr["nonzeros"] + 768 + head + chh * cw
    ops = IDCT_OPS * 256 * fr["decoded"] + _rows(fr) + UNIT_OPS * fr["nonzeros"]
    return bound_s(nbytes, ops)


def k3(fr, width: int, height: int) -> float:
    """K3 (dense_step_kernel.cu), one launch per frame: the dense
    coefficients of each decoded block (512 B), the multipliers, the header
    of each block, the canvas written once; one more operation per
    coefficient for the widening."""
    chh, cw, _ = canvas(width, height)
    nbytes = 512 * fr["decoded"] + 768 + 3 * fr["nb"] + chh * cw
    ops = (IDCT_OPS + 1) * 256 * fr["decoded"] + _rows(fr)
    return bound_s(nbytes, ops)


def k2(frames, width: int, height: int) -> float:
    """K2 (rgba_kernel.cu), one launch per clip: the canvases read once,
    4 bytes per pixel written, RGBA_OPS float32 operations per pixel."""
    chh, cw, _ = canvas(width, height)
    px = width * height * len(frames)
    return bound_s(chh * cw * len(frames) + 4 * px, RGBA_OPS * px, "fp32")


def k6(fr, width: int, height: int) -> float:
    """K6 (fdct_kernel.cu), one launch per encoded frame: the source read
    once (1 B a pixel), the coefficients written (512 B a block), for a
    P-frame the header of each block and the window of each coded block;
    FDCT_OPS per coefficient of a transformed block."""
    px = 256 * fr["nb"]
    extra = 3 * fr["nb"] + 256 * fr["decoded"] if fr["ftype"] == 2 else 0
    return bound_s(px + 512 * fr["nb"] + extra, FDCT_OPS * 256 * fr["decoded"])


def least_candidates(width: int, height: int) -> int:
    """Candidates a search sums whatever the data: per block the first
    centre, then at each of the four steps the ring's candidates inside
    the plane while the centre stays at the block's origin."""
    total = 0
    for h, w in canvas(width, height)[2]:
        nby, nbx = h // 16, w // 16
        total += nby * nbx + 4 * ((3 * nbx - 2) * (3 * nby - 2) - nby * nbx)
    return total


def k8(fr, width: int, height: int) -> float:
    """K8 (motion_kernel.cu), one launch per P-frame: the source and the
    previous planes read once, the 3 B header of each block written;
    SEARCH_OPS per 16 pixels, 16 times, of each candidate summed."""
    return bound_s(2 * 256 * fr["nb"] + 3 * fr["nb"],
                   16 * SEARCH_OPS * least_candidates(width, height))


PER_FRAME = {"k1": k1, "k3": k3, "k6": k6, "k8": k8}
PER_CALL = {"k2": k2}
P_FRAMES_ONLY = {"k8"}


def mean_bound_s(name: str, work: dict) -> float | None:
    """The mean bound per launch that the window made of kernel `name`:
    `work` holds width, height and calls, a list of (count, [per-frame
    dicts]) for the clips or frame runs the window decoded or encoded."""
    w, h = work["width"], work["height"]
    total = n = 0.0
    for count, frames in work["calls"]:
        if name in PER_CALL:
            total, n = total + count * PER_CALL[name](frames, w, h), n + count
            continue
        for fr in frames:
            if name in P_FRAMES_ONLY and fr["ftype"] != 2:
                continue
            total, n = total + count * PER_FRAME[name](fr, w, h), n + count
    return total / n if n else None
