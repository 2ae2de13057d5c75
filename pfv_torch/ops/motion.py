"""Motion-compensated prediction for decode (counterpart of the decode half
of pfv_tpu/ops/motion.py)."""

from __future__ import annotations

import torch


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
