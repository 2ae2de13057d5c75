"""Motion search for encode and motion-compensated prediction for decode
(counterpart of pfv_tpu/ops/motion.py).

The JAX package's one-hot MXU window extraction (`block_patches`,
`onehot_windows`) works around the TPU's slow gathers and is not ported:
each candidate window is an indexed load from a strided (unfold) view of
the reference plane.
"""

from __future__ import annotations

import numpy as np
import torch

# Candidate offsets in priority order: the centre first (tested first), then
# the 3x3 neighbourhood in the reference's loop order (my outer, mx inner).
_CAND_MX = np.array([0, -1, 0, 1, -1, 1, -1, 0, 1], dtype=np.int32)
_CAND_MY = np.array([0, -1, -1, -1, 0, 0, 1, 1, 1], dtype=np.int32)
_I32_MAX = int(np.iinfo(np.int32).max)


def motion_search(cur_blocks: torch.Tensor, ref_plane: torch.Tensor,
                  by: torch.Tensor, bx: torch.Tensor):
    """Four-step log search (steps 8, 4, 2, 1, one after the other) for
    every macroblock of a plane at once.

    cur_blocks (N, 16, 16) u8 source blocks; ref_plane (H, W) u8 padded
    reference plane; by, bx (N,) int32 block origins. Returns (mv_x, mv_y)
    (N,) int32 (window origin minus block origin, |v| <= 15), best_err (N,)
    int32 (the winner's SSD) and best_win (N, 16, 16) u8 (its window).

    Exactness: SSDs are summed in int32 (< 2^24, so exact); the score
    err * 16 + priority makes the first minimum win, as the reference's
    strict `err < best` scan in candidate order does; a candidate whose
    window leaves the plane is skipped, not clamped. Its start is moved to
    the block's own origin before the load (which is always in the plane,
    so no index leaves the view) and its score masked.
    """
    h, w = ref_plane.shape
    dev = ref_plane.device
    cur = cur_blocks.to(torch.int32)[:, None]
    windows = ref_plane.unfold(0, 16, 1).unfold(1, 16, 1)  # (H-15, W-15, 16, 16) view
    oy, ox = by.to(torch.int32), bx.to(torch.int32)
    cand_mx, cand_my = (torch.from_numpy(c).to(dev) for c in (_CAND_MX, _CAND_MY))
    prio = torch.arange(9, dtype=torch.int32, device=dev)
    rows = torch.arange(oy.shape[0], device=dev)
    cy, cx = oy, ox
    for step in (8, 4, 2, 1):
        cand_x = cx[:, None] + cand_mx * step  # (N, 9)
        cand_y = cy[:, None] + cand_my * step
        valid = (cand_x >= 0) & (cand_x <= w - 16) & (cand_y >= 0) & (cand_y <= h - 16)
        sy = torch.where(valid, cand_y, oy[:, None]).long()
        sx = torch.where(valid, cand_x, ox[:, None]).long()
        wins = windows[sy, sx]  # (N, 9, 16, 16) u8
        diff = cur - wins.to(torch.int32)
        err = (diff * diff).sum(dim=(-1, -2), dtype=torch.int32)
        score = torch.where(valid, err * 16 + prio, _I32_MAX)
        best = score.argmin(dim=1)
        cx, cy = cand_x[rows, best], cand_y[rows, best]
        best_err, best_win = err[rows, best], wins[rows, best]
    return cx - ox, cy - oy, best_err, best_win


def gather_predictions(ref_plane: torch.Tensor, by: torch.Tensor,
                       bx: torch.Tensor, mv_y: torch.Tensor,
                       mv_x: torch.Tensor) -> torch.Tensor:
    """(N, 16, 16) windows of `ref_plane` at (by + mv_y, bx + mv_x).

    Motion vectors widen to int32 before the add. A start outside the plane
    goes where `lax.dynamic_slice` (the JAX package's gather) puts it: a
    negative start counts from the end of the axis, as in Python, then the
    start clamps to [0, H-16] x [0, W-16]. The decoders validate vectors
    first, so only unvalidated input reaches either rule.
    """
    h, w = ref_plane.shape

    def start(o, mv, n):
        s = o.to(torch.int32) + mv.to(torch.int32)
        return torch.clamp(torch.where(s < 0, s + n, s), 0, n - 16)

    y, x = start(by, mv_y, h), start(bx, mv_x, w)
    r = torch.arange(16, device=ref_plane.device)
    return ref_plane[(y.long()[:, None] + r)[:, :, None],
                     (x.long()[:, None] + r)[:, None, :]]
