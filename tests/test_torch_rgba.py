"""K2's plain version (pfv_torch.kernels.rgba): against the JAX package's
Pallas canvas -> RGBA kernel in interpret mode on decoded canvases, and
against an independent numpy float32 reference on canvases made from a
numpy seed. All comparisons are exact.

Random canvases are not fed to the Pallas kernel: on the CPU, XLA contracts
its `y - a*u - b*v` into a fused multiply-add, which the reference's
unfused f32 math does not do, and a few (Y, U, V) triples then round the
other way, e.g. (77, 28, 228): G = 40 unfused, 39 fused. Decoded content
(the JAX package's own test_rgba.py inputs) does not reach such triples."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pfv_torch.dataloader import decode_canvases, geometry
from pfv_torch.kernels.rgba import canvas_rgba, canvas_rgba_plain
from pfv_tpu.encoding import encode_video
from pfv_tpu.ops.pallas.rgb_kernel import make_canvas_rgba
from pfv_tpu.utils.synth import synth_yuv_frame


def _words(rgba: torch.Tensor) -> np.ndarray:
    return rgba.view(torch.int32).numpy().view(np.uint32)


def _rgba_np(canv, h, w, ly0, lc1):
    """Unfused float32 numpy reference: point-sampled 4:2:0, the
    reference's op order, Rust `as u8` saturation."""
    f = np.float32
    xs, ys = np.arange(w) // 2, ly0 + np.arange(h) // 2
    y = canv[:, :h, :w].astype(f)
    u = canv[:, ys][:, :, xs].astype(f) - f(128)
    v = canv[:, ys][:, :, lc1 + xs].astype(f) - f(128)
    r = y + f(1.402) * v
    g = (y - f(0.344136) * u) - f(0.714136) * v
    b = y + f(1.772) * u

    def sat(x):
        return np.clip(np.trunc(x), 0, 255).astype(np.uint32)

    return sat(r) | sat(g) << 8 | sat(b) << 16 | np.uint32(0xFF000000)


@pytest.mark.parametrize("w,h", [(128, 96), (640, 96)])
def test_rgba_plain_matches_pallas(w, h):
    ys, us, vs = map(np.stack, zip(*[synth_yuv_frame(t, w, h) for t in range(5)]))
    data = encode_video(ys, us, vs, 30, 3, keyframes=3)
    g, canv = decode_canvases(data, device="cpu")
    conv = make_canvas_rgba(h, w, g.chh, g.cw, g.ly0, g.lcw, interpret=True)
    want = np.asarray(conv(canv.numpy()))
    got = canvas_rgba_plain(canv, h, w, g.ly0, g.lcw)
    assert got.dtype == torch.uint32 and tuple(got.shape) == want.shape
    assert np.array_equal(_words(got), want)
    # the wrapper takes the plain version for a CPU tensor, without a launch
    before = canvas_rgba.launches
    assert np.array_equal(_words(canvas_rgba(canv, h, w, g.ly0, g.lcw)), want)
    assert canvas_rgba.launches == before


@pytest.mark.parametrize("w,h", [(128, 96), (640, 96), (136, 90), (134, 90), (132, 90),
                                 (136, 89), (131, 77)])
def test_rgba_plain_matches_unfused_f32(w, h):
    """Also where the kernel leaves its vector path: w % 4 != 0, w % 8 == 4,
    an odd height, an odd width."""
    g = geometry(w, h)
    canv = np.random.default_rng(w + h).integers(
        0, 256, size=(3, g.chh, g.cw), dtype=np.uint8)
    canv[0, 0, 0], canv[0, g.ly0, 0], canv[0, g.ly0, g.lcw] = 77, 28, 228
    got = _words(canvas_rgba_plain(torch.from_numpy(canv), h, w, g.ly0, g.lcw))
    assert np.array_equal(got, _rgba_np(canv, h, w, g.ly0, g.lcw))
    assert (got[0, 0, 0] >> 8) & 255 == 40


@pytest.mark.parametrize("w,h,ly0,lc1", [(100, 90, 96, 70), (131, 77, 96, 67),
                                         (96, 64, 64, 48)])
def test_rgba_plain_with_a_v_column_anywhere(w, h, ly0, lc1):
    """Canvases of a layout of their own: V columns that are not 4-byte
    aligned, and one that is."""
    canv = np.random.default_rng(w + lc1).integers(0, 256, size=(2, 160, 208),
                                                   dtype=np.uint8)
    got = _words(canvas_rgba(torch.from_numpy(canv), h, w, ly0, lc1))
    assert np.array_equal(got, _rgba_np(canv, h, w, ly0, lc1))


def test_rgba_rejects_what_the_kernel_cannot_take():
    g = geometry(128, 96)
    canv = torch.zeros((2, g.chh, g.cw), dtype=torch.uint8)
    with pytest.raises(ValueError):
        canvas_rgba(canv.to(torch.int32), 96, 128, g.ly0, g.lcw)
    with pytest.raises(ValueError):
        canvas_rgba(canv, 96, 128, g.ly0, g.cw)  # V column past the canvas
    with pytest.raises(ValueError):
        canvas_rgba(canv[:, :, ::2], 96, 64, g.ly0, 32)  # not contiguous
