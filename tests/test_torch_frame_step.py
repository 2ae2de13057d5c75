"""The frame step's plain version (pfv_torch.kernels.frame_step: K5 + K7 in
one step over the planes of a canvas) against the JAX package's per-plane
decode (pfv_tpu.device.iframe_decode_plane / pframe_decode_plane, run with
PFV_PALLAS=1 so that the iDCT goes through the Pallas kernel in interpret
mode), against K5's and K7's plain versions plane by plane with vectors
that leave the planes, and in its one-plane (encoder) form against
device.decode_delta_blocks; then its wrapper's refusals and the
staging buffer the streaming decoder feeds it from. Inputs come from numpy
seeds; every comparison is exact."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pfv_torch import runtime as truntime
from pfv_torch.dec import FrameDecoder
from pfv_torch.device import decode_delta_blocks, plane_step
from pfv_torch.frame import canvas_layout, canvas_planes, geometry
from pfv_torch.kernels.frame_step import (FrameStep, PlaneAt, frame_step_plain,
                                          multipliers, plane_layout)
from pfv_torch.kernels.idct import decode_blocks_plain
from pfv_torch.kernels.mc import mc_reconstruct_plain
from pfv_torch.ops import iframe as tiframe
from pfv_torch.ops.blocks import block_origins, blocks_to_plane
from pfv_torch.ops.quant import dequantize
from pfv_tpu import device as jdevice
from pfv_tpu.ops.pallas import idct_kernel
from pfv_tpu.ops.pallas.idct_kernel import decode_blocks_pallas

GEOMETRIES = [(96, 64), (136, 90), (48, 16)]
QIDX = (1, 3, 0)  # per plane (Y, U, V): U and V on different tables
SENTINEL = 7


def _frame(w, h, seed, intra, lim=64, in_plane=True):
    """A frame of geometry w x h: (geometry, (nb, 256) i16 coefficients,
    (mvy, mvx, hc) or None, (4, 64) q-tables, previous canvas, output
    canvas filled with SENTINEL). Vectors in [-lim, lim), kept in their
    planes when `in_plane`."""
    rng = np.random.default_rng(seed)
    g = geometry(w, h)
    coeffs = rng.integers(-300, 300, size=(g.nb, 256))
    coeffs[rng.random(coeffs.shape) < 0.8] = 0
    coeffs = coeffs.astype(np.int16)
    qtables = rng.integers(1, 60, size=(4, 64)).astype(np.int32)
    prev = rng.integers(0, 256, size=(g.chh, g.cw), dtype=np.uint8)
    out = np.full((g.chh, g.cw), SENTINEL, dtype=np.uint8)
    motion = None
    if not intra:
        mvy, mvx = (rng.integers(-lim, lim, g.nb) for _ in range(2))
        if in_plane:
            for first, _, _, ph, pw in canvas_layout(g):
                by, bx = block_origins(ph, pw)
                sl = slice(first, first + len(by))
                mvy[sl] = np.clip(mvy[sl], -by, ph - 16 - by)
                mvx[sl] = np.clip(mvx[sl], -bx, pw - 16 - bx)
        hc = (rng.random(g.nb) < 0.6).astype(np.uint8)
        motion = tuple(torch.from_numpy(a) for a in (mvy.astype(np.int8),
                                                     mvx.astype(np.int8), hc))
    return (g, torch.from_numpy(coeffs), motion, qtables, torch.from_numpy(prev),
            torch.from_numpy(out))


def _step(g, qtables, coeffs, motion, prev, out):
    return FrameStep(qtables, canvas_layout(g), "cpu")(coeffs, motion, QIDX, prev, out)


def _outside_untouched(g, out):
    mask = torch.ones_like(out, dtype=torch.bool)
    for view in canvas_planes(g, mask):
        view.fill_(False)
    return bool((out[mask] == SENTINEL).all())


@pytest.mark.parametrize("intra", [True, False], ids=["I", "P"])
@pytest.mark.parametrize("w,h", GEOMETRIES)
def test_frame_step_matches_jax_pallas_per_plane(w, h, intra, monkeypatch):
    g, coeffs, motion, qtables, prev, out = _frame(w, h, w + h + intra, intra)
    _step(g, qtables, coeffs, motion, prev, out)
    assert _outside_untouched(g, out)

    monkeypatch.setenv("PFV_PALLAS", "1")
    traced = []

    def counted(c, q):
        traced.append(c.shape)
        return decode_blocks_pallas(c, q)

    monkeypatch.setattr(idct_kernel, "decode_blocks_pallas", counted)
    jitted = (jdevice.iframe_decode_plane, jdevice.pframe_decode_plane)
    for fn in jitted:  # trace afresh, so that PFV_PALLAS takes effect
        fn.clear_cache()
    try:
        for (first, *_), o, p, qi in zip(canvas_layout(g), canvas_planes(g, out),
                                          canvas_planes(g, prev), QIDX):
            sl = slice(first, first + (o.shape[0] // 16) * (o.shape[1] // 16))
            c, q = coeffs[sl].numpy(), qtables[qi]
            if intra:
                want = jdevice.iframe_decode_plane(c, q, p.numpy())
            else:
                by, bx = block_origins(*o.shape)
                mvy, mvx, hc = (t[sl].numpy() for t in motion)
                want = jdevice.pframe_decode_plane(c, mvx, mvy, hc, np.array(p), q, by, bx)
            assert np.array_equal(o.numpy(), np.asarray(want))
    finally:
        for fn in jitted:
            fn.clear_cache()
    assert traced  # the Pallas iDCT ran


@pytest.mark.parametrize("intra", [True, False], ids=["I", "P"])
@pytest.mark.parametrize("w,h", GEOMETRIES)
def test_frame_step_matches_k5_k7_with_vectors_leaving_the_planes(w, h, intra):
    g, coeffs, motion, qtables, prev, out = _frame(w, h, 2 * w + h, intra,
                                                   in_plane=False)
    if not intra:  # the int8 field's whole range: windows leave every side
        rng = np.random.default_rng(w)
        motion = tuple(torch.from_numpy(rng.integers(-128, 128, g.nb).astype(np.int8))
                       for _ in range(2)) + motion[2:]
    _step(g, qtables, coeffs, motion, prev, out)
    assert _outside_untouched(g, out)
    for (first, _, _, ph, pw), o, p, qi in zip(canvas_layout(g), canvas_planes(g, out),
                                               canvas_planes(g, prev), QIDX):
        n = (ph // 16) * (pw // 16)
        sl = slice(first, first + n)
        res = decode_blocks_plain(coeffs[sl].view(n, 4, 64), torch.from_numpy(qtables[qi]))
        by, bx = (torch.from_numpy(a) for a in block_origins(ph, pw))
        zero = torch.zeros(n, dtype=torch.int8)
        mvy, mvx, hc = (zero, zero, zero.view(torch.uint8)) if intra else \
            (t[sl] for t in motion)
        want = mc_reconstruct_plain(res, p, by, bx, mvy, mvx, hc, intra)
        assert torch.equal(o, want)


@pytest.mark.parametrize("intra", [True, False], ids=["I", "P"])
@pytest.mark.parametrize("w,h", GEOMETRIES)
def test_one_plane_form_matches_decode_delta_blocks(w, h, intra):
    g, coeffs, motion, qtables, prev, _ = _frame(w, h, w * h, intra)
    ph, pw = g.ly0, g.lyw
    n = g.yb
    ref = prev[:ph, :pw].contiguous()
    step = plane_step(qtables[2], ph, pw, "cpu")
    mvy, mvx, hc = (None,) * 3 if intra else (t[:n].contiguous() for t in motion)
    got = step(coeffs[:n], None if intra else (mvy, mvx, hc), (0,), ref,
               torch.empty_like(ref))
    q = torch.from_numpy(qtables[2])
    if intra:
        want = blocks_to_plane(tiframe.decode_blocks(coeffs[:n].view(n, 4, 64), q), ph, pw)
    else:
        by, bx = (torch.from_numpy(a) for a in block_origins(ph, pw))
        want = decode_delta_blocks(coeffs[:n].view(n, 4, 64), q, ref, by, bx,
                                   mvy, mvx, hc)
    assert torch.equal(got, want)


def test_multipliers_are_the_dequantization():
    rng = np.random.default_rng(5)
    qt = rng.integers(1, 65536, size=(3, 64)).astype(np.int32)
    one = torch.zeros((1, 64), dtype=torch.int16)
    for t in range(3):
        for k in range(64):  # a unit coefficient in zigzag slot k
            one.zero_()
            one[0, k] = 1
            deq = dequantize(one, torch.from_numpy(qt[t]))
            assert int(deq.sum()) == multipliers(qt)[t][deq[0].nonzero()[0, 0]]


@pytest.mark.parametrize("bad", ["in_place", "overlap", "coeff_dtype", "short_coeffs",
                                 "motion_dtype", "no_prev", "out_dtype", "small_out",
                                 "q_index", "q_count", "misaligned", "meta_device"])
def test_frame_step_refuses_bad_inputs(bad):
    g, coeffs, motion, qtables, prev, out = _frame(96, 64, 9, False)
    qidx, device = QIDX, "cpu"
    if bad == "in_place":
        out = prev
    elif bad == "overlap":
        big = torch.zeros((g.chh + 16, g.cw), dtype=torch.uint8)
        prev, out = big[:g.chh], big[16:]
    elif bad == "coeff_dtype":
        coeffs = coeffs.to(torch.int32)
    elif bad == "short_coeffs":
        coeffs = coeffs[:-1]
    elif bad == "motion_dtype":
        motion = (motion[0].to(torch.int32),) + motion[1:]
    elif bad == "no_prev":
        prev = None
    elif bad == "out_dtype":
        out = out.to(torch.int16)
    elif bad == "small_out":
        out = out[:, :-16]
    elif bad == "q_index":
        qidx = (0, 1, 4)
    elif bad == "q_count":
        qidx = (0, 1)
    elif bad == "misaligned":
        out = torch.zeros((g.chh, g.cw + 8), dtype=torch.uint8)[:, 8:]
    else:  # a device that is neither the CPU nor CUDA (an I-frame: no prev)
        device = "meta"
        coeffs, out = coeffs.to(device), out.to(device)
        motion = prev = None
    step = FrameStep(qtables, canvas_layout(g), device)
    with pytest.raises(ValueError):
        step(coeffs, motion, qidx, prev, out)


def test_layouts_refused():
    with pytest.raises(ValueError):
        FrameStep(np.ones(64), [PlaneAt(0, 0, 0, 16, 24)], "cpu")  # not whole blocks
    with pytest.raises(ValueError):
        FrameStep(np.ones(64), [PlaneAt(0, 0, 8, 16, 16)], "cpu")  # unaligned column
    with pytest.raises(ValueError):
        FrameStep(np.ones(64), plane_layout(16, 16) * 4, "cpu")  # four planes


def test_frame_step_plain_makes_its_own_origins():
    g, coeffs, motion, qtables, prev, out = _frame(48, 16, 3, False)
    want = _step(g, qtables, coeffs, motion, prev, out.clone())
    got = frame_step_plain(coeffs, motion, torch.from_numpy(qtables), QIDX,
                           [PlaneAt(*p) for p in canvas_layout(g)], prev, out)
    assert torch.equal(got, want)


def test_runtime_decodes_into_given_arrays():
    """The entropy decoders' `out` option writes what they return anew."""
    g = geometry(64, 48)
    rng = np.random.default_rng(6)
    coeffs = rng.integers(-50, 50, size=(g.nb, 256)).astype(np.int16)
    coeffs[rng.random(coeffs.shape) < 0.9] = 0
    mvx, mvy = (rng.integers(-2, 3, g.nb).astype(np.int8) for _ in range(2))
    hc = (rng.random(g.nb) < 0.5).astype(np.uint8)
    ipay = truntime.encode_iframe_payload(coeffs, (0, 1, 1))
    ppay = truntime.encode_pframe_payload(coeffs, mvx, mvy, hc, (2, 3, 3))
    buf = np.full((g.nb, 256), 99, dtype=np.int16)
    got = truntime.decode_iframe_payload(ipay, g.nb, out=buf)
    assert got[0].base is buf or np.shares_memory(got[0], buf)
    assert np.array_equal(buf, truntime.decode_iframe_payload(ipay, g.nb)[0])
    outs = (buf, np.empty(g.nb, np.int8), np.empty(g.nb, np.int8), np.empty(g.nb, np.uint8))
    got = truntime.decode_pframe_payload(ppay, g.nb, out=outs)
    for a, b, o in zip(got, truntime.decode_pframe_payload(ppay, g.nb), outs + (None,)):
        assert np.array_equal(a, b)
        if o is not None:
            assert np.shares_memory(a, o)
    with pytest.raises(ValueError):
        truntime.decode_iframe_payload(ipay, g.nb, out=buf[:, :128])


def test_frame_decoder_stages_into_one_buffer():
    """FrameDecoder: the entropy decoder writes the staging buffer, one copy
    brings it to `coeffs` and `motion`, one step decodes the frame."""
    g = geometry(64, 48)
    rng = np.random.default_rng(7)
    coeffs = rng.integers(-50, 50, size=(g.nb, 256)).astype(np.int16)
    coeffs[rng.random(coeffs.shape) < 0.9] = 0
    mvx = np.zeros(g.nb, np.int8)
    mvy = np.ones(g.nb, np.int8)
    mvy[g.yb - 4:g.yb] = -1  # the last block row of Y keeps its window in the plane
    mvy[g.yb + g.cb - 2:g.yb + g.cb] = -1
    mvy[g.nb - 2:] = -1
    hc = (rng.random(g.nb) < 0.5).astype(np.uint8)
    qt = rng.integers(1, 30, size=(4, 64)).astype(np.int32)
    fd = FrameDecoder(g, qt, "cpu")
    prev = fd.initial_canvas()
    frame = fd.upload(fd.entropy(2, truntime.encode_pframe_payload(
        coeffs, mvx, mvy, hc, (2, 3, 1))))
    assert frame == (False, (2, 3, 1))
    assert torch.equal(fd.coeffs, torch.from_numpy(coeffs * hc[:, None]))
    for t, a in zip(fd.motion, (mvy, mvx, hc)):
        assert np.array_equal(t.numpy().view(a.dtype), a)
    out = torch.empty_like(prev)
    fd.planes(frame, out, prev)
    want = FrameStep(qt, canvas_layout(g), "cpu")(
        torch.from_numpy(coeffs * hc[:, None]),
        tuple(torch.from_numpy(a) for a in (mvy, mvx, hc)), (2, 3, 1), prev, out.clone())
    assert torch.equal(out, want)
