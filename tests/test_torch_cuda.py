"""Tests that need a CUDA card: each hand-written kernel against its plain
PyTorch version on the card, and the decode against the scalar reference.
They skip without a card. They need no JAX; where it is not installed,
skip tests/conftest.py (which imports it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from pfv_torch import dataloader as tdl
from pfv_torch import runtime
from pfv_torch.kernels.rgba import canvas_rgba, canvas_rgba_plain
from pfv_torch.kernels.step import step_frames, step_frames_plain

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIPS = [".bench_cache/corpus_512x384_q2_161f.pfv",
         "tests/data/clip_136x90_q3_8f.pfv"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("path", CLIPS)
def test_step_kernel_matches_plain_and_reference(cuda, path):
    data = open(os.path.join(ROOT, path), "rb").read()
    g, args = tdl.upload(tdl.demux_host(data), cuda)
    before = step_frames.launches
    got = step_frames(*args, g.chh, g.cw, g.gly)
    assert step_frames.launches - before == args[5].shape[0]
    assert torch.equal(got, step_frames_plain(*args, g.chh, g.cw, g.gly))
    _, ry, ru, rv, _ = runtime.ref_decode(data)
    for p, r in zip(tdl.slice_yuv(g, got), (ry, ru, rv)):
        assert np.array_equal(p.cpu().numpy(), r)


@pytest.mark.parametrize("w,h", [(1920, 1080), (136, 90)])
def test_rgba_kernel_matches_plain_on_random_canvases(cuda, w, h):
    g = tdl.geometry(w, h)
    canv = torch.from_numpy(np.random.default_rng(w).integers(
        0, 256, size=(2, g.chh, g.cw), dtype=np.uint8))
    # (Y, U, V) = (77, 28, 228): G is 40 unfused and 39 with an FMA
    canv[0, 0, 0], canv[0, g.ly0, 0], canv[0, g.ly0, g.lcw] = 77, 28, 228
    canv = canv.to(cuda)
    got = canvas_rgba(canv, h, w, g.ly0, g.lcw).view(torch.int32)
    assert torch.equal(got, canvas_rgba_plain(canv, h, w, g.ly0, g.lcw)
                       .view(torch.int32))
    assert (int(got[0, 0, 0]) >> 8) & 255 == 40


def test_kernels_raise_on_mixed_devices(cuda):
    data = open(os.path.join(ROOT, CLIPS[1]), "rb").read()
    g, args = tdl.upload(tdl.demux_host(data), cuda)
    with pytest.raises(ValueError):
        step_frames(args[0], args[1].cpu(), *args[2:], g.chh, g.cw, g.gly)
