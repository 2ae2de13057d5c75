"""The encode cells' K8 and K6 bounds follow the cell's own geometry: in
`uhd2160.encode` each per-frame bound is the work of a 3840x2160 frame,
counted here by hand from its blocks, and no count of the 1080p cell's."""

import pytest
import torch

from harness import main as hm
from harness import roofline
from harness.drivers import _frame_work

# (block rows, block columns) of the padded Y, U and V planes
BLOCKS = {(3840, 2160): [(135, 240), (68, 120), (68, 120)],
          (1920, 1080): [(68, 120), (34, 60), (34, 60)]}


def _work(w: int, h: int, coded: int):
    """The Encode driver's per-frame work of an I-frame and two P-frames
    with `coded` coded blocks, one clip encoded three times."""
    nb = sum(r * c for r, c in BLOCKS[(w, h)])
    coeffs = torch.zeros((nb, 256), dtype=torch.int16)
    zero = torch.zeros(nb, dtype=torch.int64)
    hc = zero.clone()
    hc[:coded] = 1
    frames = [_frame_work((1, None, coeffs, zero, zero, torch.ones_like(zero)), nb)]
    frames += [_frame_work((2, None, coeffs, zero, zero, hc), nb)] * 2
    return nb, {"width": w, "height": h, "calls": [(3, frames)]}


def _by_hand(w: int, h: int, coded: int):
    """(K8's bound per P-frame, K6's mean bound per frame) from the blocks."""
    nb = sum(r * c for r, c in BLOCKS[(w, h)])
    peaks = roofline.PEAKS
    cands = sum(r * c + 4 * ((3 * c - 2) * (3 * r - 2) - r * c) for r, c in BLOCKS[(w, h)])
    k8 = max((2 * 256 + 3) * nb / peaks["hbm_bytes_per_s"],
             16 * roofline.SEARCH_OPS * cands / peaks["int_ops_per_s"])
    k6_i = max(768 * nb / peaks["hbm_bytes_per_s"],
               roofline.FDCT_OPS * 256 * nb / peaks["int_ops_per_s"])
    k6_p = max((768 * nb + 3 * nb + 256 * coded) / peaks["hbm_bytes_per_s"],
               roofline.FDCT_OPS * 256 * coded / peaks["int_ops_per_s"])
    return k8, (k6_i + 2 * k6_p) / 3


def test_k8_and_k6_bounds_at_2160p_come_from_its_own_geometry():
    _, cell, cfg, _ = hm.load_spec("uhd2160.encode")
    w, h = cfg["width"], cfg["height"]
    assert (w, h) == (3840, 2160) and cell["chips"] == 1
    nb, work = _work(w, h, coded=531)
    assert nb == 48720
    k8, k6 = _by_hand(w, h, coded=531)
    assert roofline.mean_bound_s("k8", work) == pytest.approx(k8, rel=1e-12)
    assert roofline.mean_bound_s("k6", work) == pytest.approx(k6, rel=1e-12)
    _, hd = _work(1920, 1080, coded=531)
    for name in ("k8", "k6"):
        ratio = roofline.mean_bound_s(name, work) / roofline.mean_bound_s(name, hd)
        assert 3.5 < ratio < 4.5, (name, ratio)  # 48,720 blocks a frame against 12,240
