"""Tests that need a CUDA card: each hand-written kernel against its plain
PyTorch version on the card, the decode (whole-clip by each route, the
streaming Decoder, the committed corpora at full length) against the scalar
reference, the launches of each path, the dense route's peak memory at 8K
UHD, the encode on the card against the encode on the CPU and against the
committed corpora's bytes, and the command-line tool on the card.
They skip without a card. They need no JAX; where it is not installed,
skip tests/conftest.py (which imports it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import io
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from pfv_torch import dataloader as tdl
from pfv_torch import runtime, synth
from pfv_torch import Encoder, VideoFrame
from pfv_torch.dec import Decoder, split_packets
from pfv_torch.encoding import encode_video
from pfv_torch.kernels.dense_step import (seq_frames_dense, seq_frames_dense_plain,
                                          step_frames_batched_plain, step_gops,
                                          step_gops_plain)
from pfv_torch.frame import canvas_layout, canvas_planes, initial_canvas
from pfv_torch.kernels.fdct import FrameEncode, fdct_blocks, fdct_blocks_plain
from pfv_torch.kernels.frame_step import FrameStep, plane_layout
from pfv_torch.kernels.idct import decode_blocks, decode_blocks_plain
from pfv_torch.kernels.mc import mc_reconstruct, mc_reconstruct_plain
from pfv_torch.kernels.motion import MAX_STRIDE, MotionSearch, motion_search_plain
from pfv_torch.kernels.rgba import canvas_rgba, canvas_rgba_plain
from pfv_torch.kernels.step import step_frames, step_frames_plain
from pfv_torch.ops.blocks import block_origins
from pfv_torch.ops.color import double_plane, yuv_to_rgb

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIPS = [".bench_cache/corpus_512x384_q2_161f.pfv",
         "tests/data/clip_136x90_q3_8f.pfv",
         ".bench_cache/corpus_1920x1080_q2_120f.pfv",
         ".bench_cache/corpus_1920x1080_q2_120f_pan.pfv"]
# the committed corpora's sources (width, height, frames, generator), which
# the JAX package's encoder wrote at quality 2, 30 fps, a keyframe every 60
CORPORA = {CLIPS[0]: (512, 384, 161, "std"), CLIPS[2]: (1920, 1080, 120, "std"),
           CLIPS[3]: (1920, 1080, 120, "pan")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _decode_counters():
    return (step_frames, canvas_rgba, seq_frames_dense, step_gops, FrameStep, decode_blocks,
            mc_reconstruct)


@pytest.mark.parametrize("path", CLIPS)
def test_step_kernel_matches_plain_and_reference(cuda, path):
    """K1 against its plain version and the reference over the whole clip;
    then the whole-clip entries: RGBA equal to K2's plain version of those
    canvases, the checksums to the reference's, K1 once per frame and K2
    once per RGBA call, nothing else."""
    data = open(os.path.join(ROOT, path), "rb").read()
    g, args = tdl.upload(tdl.demux_host(data), cuda)
    f = args[5].shape[0]
    before = step_frames.launches
    got = step_frames(*args, g.chh, g.cw, g.gly, g.guw)
    assert step_frames.launches - before == f
    assert torch.equal(got, step_frames_plain(*args, g.chh, g.cw, g.gly, g.guw))
    _, ry, ru, rv, _ = runtime.ref_decode(data)
    for p, r in zip(tdl.slice_yuv(g, got), (ry, ru, rv)):
        assert np.array_equal(p.cpu().numpy(), r)
    before = [fn.launches for fn in _decode_counters()]
    rgba = tdl.decode_video_rgba(data, device="cuda")
    sums = tdl.decode_video_checksums(data, device="cuda")
    assert [fn.launches - b for fn, b in zip(_decode_counters(), before)] \
        == [2 * f, 1, 0, 0, 0, 0, 0]
    want = canvas_rgba_plain(got, g.height, g.width, g.ly0, g.lcw)
    assert torch.equal(rgba.view(torch.int32), want.view(torch.int32))
    assert torch.equal(sums.cpu(), tdl.plane_checksums(*map(torch.from_numpy, (ry, ru, rv))))


@pytest.mark.parametrize("w,h", [(1920, 1080), (136, 90), (134, 90), (140, 89),
                                 (131, 77), (8, 2), (6, 3)])
def test_rgba_kernel_matches_plain_on_random_canvases(cuda, w, h):
    """Widths with w % 8 == 0 (the vector path alone), w % 8 == 4 (its
    one-by-one tail), w % 4 != 0 and odd (all one by one), odd heights (a
    last row without a partner)."""
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


@pytest.mark.parametrize("w,h,ly0,lc1", [(100, 90, 96, 70), (104, 51, 64, 53),
                                         (96, 64, 64, 48)])
def test_rgba_kernel_with_a_v_column_anywhere(cuda, w, h, ly0, lc1):
    """V columns that are not 4-byte aligned (one by one) and one that is,
    in canvases of a layout of their own, one of them sliced so that its
    first byte is not 8-byte aligned."""
    rng = np.random.default_rng(w + lc1)
    canv = torch.from_numpy(rng.integers(0, 256, size=(4, 160, 208),
                                         dtype=np.uint8)).to(cuda)
    for c in (canv, canv.view(-1)[160 * 208 - 4:-4].view(3, 160, 208)):
        got = canvas_rgba(c, h, w, ly0, lc1).view(torch.int32)
        assert torch.equal(got, canvas_rgba_plain(c, h, w, ly0, lc1).view(torch.int32))


def test_kernels_raise_on_mixed_devices(cuda):
    data = open(os.path.join(ROOT, CLIPS[1]), "rb").read()
    g, args = tdl.upload(tdl.demux_host(data), cuda)
    with pytest.raises(ValueError):
        step_frames(args[0], args[1].cpu(), *args[2:], g.chh, g.cw, g.gly, g.guw)
    with pytest.raises(ValueError):
        step_frames(*args, g.chh, g.cw, g.gly, g.guw, initial_canvas(g, "cpu"))
    # K8: a source, the canvas or a header row on the host
    g = tdl.geometry(64, 48)
    src, motion, _, prev = _frame_encode_inputs(g, 1, False, cuda)
    search = MotionSearch(canvas_layout(g), 0.0, cuda)
    search(src, prev, motion)
    for bad in (([src[0].cpu(), *src[1:]], prev, motion), (src, prev.cpu(), motion),
                (src, prev, (motion[0].cpu(), *motion[1:]))):
        with pytest.raises(ValueError):
            search(*bad)


@pytest.mark.parametrize("n,lim,qmax", [(1, 800, 60), (300, 800, 60),
                                        (8160, 800, 60), (64, 16000, 65536)])
def test_idct_kernel_matches_plain(cuda, n, lim, qmax):
    rng = np.random.default_rng(n + lim)
    coeffs = rng.integers(-lim, lim, size=(n, 4, 64))
    coeffs[rng.random(coeffs.shape) < 0.7] = 0
    coeffs = torch.from_numpy(coeffs.astype(np.int16)).to(cuda)
    q = torch.from_numpy(rng.integers(1, qmax, size=64).astype(np.int32)).to(cuda)
    before = decode_blocks.launches
    got = decode_blocks(coeffs, q)
    assert decode_blocks.launches - before == 1
    assert torch.equal(got, decode_blocks_plain(coeffs, q))


@pytest.mark.parametrize("intra", [False, True])
def test_mc_kernel_matches_plain_into_a_canvas_view(cuda, intra):
    h, w = 96, 160
    rng = np.random.default_rng(7)
    by, bx = (torch.from_numpy(o).to(cuda) for o in block_origins(h, w))
    n = by.shape[0]
    canvas = torch.from_numpy(rng.integers(0, 256, size=(2, h + 16, w + 32),
                                           dtype=np.uint8)).to(cuda)
    ref, out = canvas[0, 16:, 32:], canvas[1, 16:, 32:]
    res = torch.from_numpy(rng.integers(0, 256, size=(n, 16, 16),
                                        dtype=np.uint8)).to(cuda)
    # unvalidated vectors: windows that leave the plane clamp like the plain one
    mvy, mvx = (torch.from_numpy(rng.integers(-40, 41, n).astype(np.int8)).to(cuda)
                for _ in range(2))
    hc = torch.from_numpy((rng.random(n) < 0.5).astype(np.uint8)).to(cuda)
    want = mc_reconstruct_plain(res, ref, by, bx, mvy, mvx, hc, intra)
    edge = canvas[1, :16].clone()
    before = mc_reconstruct.launches
    mc_reconstruct(res, ref, by, bx, mvy, mvx, hc, intra, out)
    assert mc_reconstruct.launches - before == 1
    assert torch.equal(out, want) and torch.equal(canvas[1, :16], edge)


@pytest.mark.parametrize("path", CLIPS)
def test_decoder_matches_reference(cuda, path):
    """advance_frame to the end, the frame step once per frame; then reset
    and decode_all, the whole-clip path, K1 once per frame."""
    data = open(os.path.join(ROOT, path), "rb").read()
    n, ry, ru, rv, _ = runtime.ref_decode(data)
    before = (FrameStep.launches, decode_blocks.launches, mc_reconstruct.launches)
    got = []
    dec = Decoder(io.BytesIO(data), device="cuda")
    while dec.advance_frame(got.append):
        pass
    assert len(got) == n
    assert (FrameStep.launches - before[0], decode_blocks.launches - before[1],
            mc_reconstruct.launches - before[2]) == (n, 0, 0)
    dec.reset()
    before = (step_frames.launches, FrameStep.launches)
    again = dec.decode_all()
    assert len(again) == n
    assert (step_frames.launches - before[0], FrameStep.launches - before[1]) == (n, 0)
    for i, f in enumerate(got + again):
        for p, r in zip((f.plane_y, f.plane_u, f.plane_v), (ry[i % n], ru[i % n], rv[i % n])):
            assert np.array_equal(p, r)


def test_fallback_stream_runs_k5_k7_and_not_k1(cuda):
    """The per-frame path (`decode_frames`, which the whole-clip routes are
    held to): the frame step (K5 + K7 as one kernel) once per frame, K1,
    K3, K5 and K7 never. The whole-clip decode of the same stream, a
    leading P-frame, takes K3 from the starting canvas, once per frame."""
    info, packets = split_packets(synth.random_stream(4112, 32, 4, seed=12))
    data = synth.container(4112, 32, info["qtables"], packets[1:])
    route = tdl.choose_route(data)
    assert (route.kind, route.leading_p) == ("dense", True)
    counters = (step_frames, seq_frames_dense, decode_blocks, mc_reconstruct, FrameStep)
    before = [fn.launches for fn in counters]
    _, frames = tdl.decode_frames(data, device="cuda")
    assert [fn.launches - b for fn, b in zip(counters, before)] == [0, 0, 0, 0, 3]
    before = [fn.launches for fn in counters]
    y, u, v = tdl.decode_video_yuv(data, device="cuda")
    assert [fn.launches - b for fn, b in zip(counters, before)] == [0, 3, 0, 0, 0]
    for p, q, r in zip((y, u, v), tdl.slice_yuv(route.g, frames),
                       runtime.ref_decode(data)[1:4]):
        assert np.array_equal(p.cpu().numpy(), r) and torch.equal(p, q)


QIDX = [(0, 1, 2), (3, 2, 1), (1, 3, 0), (2, 0, 3), (0, 0, 1)]


@pytest.mark.parametrize("w,h,leading", [(512, 384, "I"), (512, 384, "P"), (4112, 64, "I"),
                                         (4112, 64, "P")])
def test_frame_steps_take_per_frame_tables_and_a_starting_canvas(cuda, w, h, leading):
    """K1 (512 wide) or K3 (4112) against the plain version, q-table indices
    per frame and plane (U != V), and with a leading P-frame from a random
    starting canvas; the whole-clip decode against the reference."""
    data = synth.random_stream(w, h, 6, seed=w + h, keyframes=4, qidx=QIDX)
    if leading == "P":
        info, packets = split_packets(data)
        data = synth.container(w, h, info["qtables"], packets[1:])
    g = tdl.geometry(w, h)
    dims = (g.chh, g.cw, g.gly, g.guw)
    prev = torch.randint(0, 256, (g.chh, g.cw), dtype=torch.uint8, device=cuda)
    if w <= 4096:
        _, args = tdl.upload(tdl.demux_host(data), cuda)
        fn, plain, n = step_frames, step_frames_plain, args[5].shape[0]
    else:
        _, (coeffs, mvx, mvy, hc, ftype, qmul) = tdl.upload_packed(
            tdl.demux_host_packed(data), device=cuda)
        args = (coeffs, *tdl.block_maps(g, mvx, mvy, hc), ftype, qmul)
        fn, plain, n = seq_frames_dense, seq_frames_dense_plain, ftype.shape[0]
    for start in (None, prev):
        before = fn.launches
        got = fn(*args, *dims, prev=start)
        assert fn.launches - before == n
        assert torch.equal(got, plain(*args, *dims, prev=start))
    for p, r in zip(tdl.decode_video_yuv(data, device="cuda"), runtime.ref_decode(data)[1:4]):
        assert np.array_equal(p.cpu().numpy(), r)


def test_chunked_dense_route_launches_k3_per_frame(cuda, monkeypatch):
    """A 4112x64 stream past the (lowered) positions cap: three chunks, K3
    once per frame, each chunk from the last canvas of the one before."""
    data = synth.random_stream(4112, 64, 8, seed=34, keyframes=5, qidx=QIDX)
    g = tdl.geometry(4112, 64)
    monkeypatch.setattr(tdl, "MAX_POSITIONS", 3 * 64 * tdl.pstep_tables(g)[2] + 1)
    route = tdl.choose_route(data)
    assert (route.kind, len(route.host)) == ("dense", 3)
    counters = (step_frames, FrameStep, seq_frames_dense, step_gops)
    before = [fn.launches for fn in counters]
    got = tdl.decode_video_yuv(data, device="cuda")
    assert [fn.launches - b for fn, b in zip(counters, before)] == [0, 0, 8, 0]
    for p, r in zip(got, runtime.ref_decode(data)[1:4]):
        assert np.array_equal(p.cpu().numpy(), r)


def _peak_bytes(fn) -> int:
    """torch.cuda.max_memory_allocated over one call of fn, less what was
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def _drain(chunks) -> None:
    """Iterate `chunks`, dropping each before the next is made."""
    for chunk in chunks:
        del chunk


def test_dense_route_holds_one_chunk_at_a_time(cuda):
    """An 8K UHD stream of 24 frames (a keyframe every 8) and its packets
    twice, 48 frames, past a chunk's 24: the dense route in two chunks, K3
    once per frame, each half equal to the 24-frame decode. The 48-frame
    decode peaks above the 24-frame one by no more than its 48 canvases and
    the second chunk's uploaded tensors (both chunks' coefficients alive at
    once would add 2.5 GB); the chunked decode of the 48 frames no higher
    than 1.25 times a whole 24-frame decode."""
    w, h = 7680, 4320
    uhd = synth.random_stream(w, h, 24, seed=3, keyframes=8)
    info, packets = split_packets(uhd)
    uhd2 = synth.container(w, h, info["qtables"], packets * 2)
    route = tdl.choose_route(uhd2)
    g = route.g
    assert route.kind == "dense"
    assert [tdl._frame_meta(c[4], g.nb)[0].size for c in route.host] == [24, 24]
    second = tdl.upload_route(route, cuda)[1]
    extra = 48 * g.chh * g.cw + sum(t.numel() * t.element_size() for t in second)
    del route, second
    peak24 = _peak_bytes(lambda: tdl.decode_video_yuv(uhd, device="cuda"))
    out, before = [], seq_frames_dense.launches
    peak48 = _peak_bytes(lambda: out.append(tdl.decode_video_yuv(uhd2, device="cuda")))
    assert seq_frames_dense.launches - before == 48
    assert peak48 - peak24 <= extra + (64 << 20)
    for p, q in zip(out.pop(), tdl.decode_video_yuv(uhd, device="cuda")):
        assert torch.equal(p[:24], q) and torch.equal(p[24:], q)
    chunked = _peak_bytes(lambda: _drain(tdl.decode_video_rgb_chunks(uhd2, 24, device="cuda")))
    whole = _peak_bytes(lambda: tdl.decode_video_rgb(uhd, device="cuda"))
    assert chunked < 1.25 * whole


def test_staging_events_record_on_the_copy_device(cuda):
    """The Decoder's and the loader's staging copies run on their device's
    stream; the event behind each must be recorded there too, also while
    another card is current (the last card while the first is current; on
    a machine with one card, that one)."""
    from pfv_torch.loader import PinnedStager

    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    data = synth.random_stream(512, 384, 5, seed=81, keyframes=3)
    assert torch.cuda.current_device() == 0
    dec = Decoder(io.BytesIO(data), device=dev)
    got = []
    while dec.advance_frame(got.append):
        pass
    assert dec._frames._copied.device == dev
    _, frames = tdl.decode_frames(data, device=dev)
    stager = PinnedStager(dev)
    (copied,) = stager([np.arange(1000, dtype=np.int32)])
    assert stager._copied.device == dev
    assert copied.device == dev and copied[999].item() == 999
    for i, (p, r) in enumerate(zip(tdl.slice_yuv(tdl.geometry(512, 384), frames),
                                   runtime.ref_decode(data)[1:4])):
        assert np.array_equal(p.cpu().numpy(), r)
        assert all(np.array_equal(getattr(f, ("plane_y", "plane_u", "plane_v")[i]), r[k])
                   for k, f in enumerate(got))


def _frame_step_inputs(g, seed, intra, cuda):
    """Random frame-step inputs of geometry g on the card: coefficients,
    vectors of the int8 field's whole range (windows leave every plane
    side) and coded flags or None, (4, 64) q-tables, prev and a sentinel
    output canvas."""
    rng = np.random.default_rng(seed)
    coeffs = rng.integers(-400, 400, size=(g.nb, 256))
    coeffs[rng.random(coeffs.shape) < 0.8] = 0
    coeffs = torch.from_numpy(coeffs.astype(np.int16)).to(cuda)
    motion = None if intra else tuple(
        torch.from_numpy(a).to(cuda) for a in (
            rng.integers(-128, 128, g.nb).astype(np.int8),
            rng.integers(-128, 128, g.nb).astype(np.int8),
            (rng.random(g.nb) < 0.5).astype(np.uint8)))
    qt = rng.integers(1, 65536, size=(4, 64)).astype(np.int32)
    prev = torch.from_numpy(rng.integers(0, 256, size=(g.chh, g.cw),
                                         dtype=np.uint8)).to(cuda)
    return coeffs, motion, qt, prev, torch.full_like(prev, 7)


@pytest.mark.parametrize("intra", [True, False], ids=["I", "P"])
@pytest.mark.parametrize("w,h", [(1920, 1080), (136, 90), (48, 16), (4112, 32)])
def test_frame_step_kernel_matches_plain(cuda, w, h, intra):
    g = tdl.geometry(w, h)
    coeffs, motion, qt, prev, out = _frame_step_inputs(g, w + h, intra, cuda)
    step = FrameStep(qt, canvas_layout(g), cuda)
    qidx = (2, 0, 3)  # U and V on different tables
    before = FrameStep.launches
    step(coeffs, motion, qidx, prev, out)
    assert FrameStep.launches - before == 1
    host = FrameStep(qt, canvas_layout(g), "cpu")
    want = host(coeffs.cpu(), None if intra else tuple(t.cpu() for t in motion), qidx,
                prev.cpu(), torch.full_like(prev.cpu(), 7))
    assert torch.equal(out.cpu(), want)
    # the one-plane form, as the per-plane decode steps call it, on V's plane
    first, row, col, ph, pw = canvas_layout(g)[2]
    one = FrameStep(qt[1:2], [(0, 0, 0, ph, pw)], cuda)
    sl = slice(first, first + (ph // 16) * (pw // 16))
    plane = torch.empty((ph, pw), dtype=torch.uint8, device=cuda)
    ref = prev[row:row + ph, col:col + pw].contiguous()
    one(coeffs[sl].contiguous(), None if intra else tuple(t[sl].contiguous() for t in motion),
        (0,), ref, plane)
    want_one = FrameStep(qt, canvas_layout(g), "cpu")(
        coeffs.cpu(), None if intra else tuple(t.cpu() for t in motion), (0, 0, 1),
        prev.cpu(), torch.zeros_like(prev.cpu()))
    assert torch.equal(plane.cpu(), want_one[row:row + ph, col:col + pw])


def test_frame_step_raises_on_mixed_devices(cuda):
    g = tdl.geometry(64, 48)
    coeffs, motion, qt, prev, out = _frame_step_inputs(g, 1, False, cuda)
    step = FrameStep(qt, canvas_layout(g), cuda)
    with pytest.raises(ValueError):
        step(coeffs.cpu(), motion, (0, 1, 1), prev, out)
    with pytest.raises(ValueError):
        step(coeffs, motion, (0, 1, 1), prev.cpu(), out)


def test_new_kernels_raise_on_mixed_devices(cuda):
    coeffs = torch.zeros((4, 4, 64), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):
        decode_blocks(coeffs, torch.ones(64, dtype=torch.int32))
    res = torch.zeros((4, 16, 16), dtype=torch.uint8, device=cuda)
    by, bx = (torch.from_numpy(o).to(cuda) for o in block_origins(32, 32))
    mv = torch.zeros(4, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        mc_reconstruct(res, torch.zeros((32, 32), dtype=torch.uint8), by, bx, mv, mv,
                       mv.view(torch.uint8), False)


@pytest.mark.parametrize("n", [1, 33, 8160])
@pytest.mark.parametrize("delta", [False, True])
def test_fdct_kernel_matches_plain(cuda, n, delta):
    rng = np.random.default_rng(n + delta)
    blocks = rng.integers(0, 256, size=(n, 16, 16), dtype=np.uint8)
    blocks[0] = 255 * (np.indices((16, 16)).sum(0) % 2)  # checker: extreme AC
    win = rng.integers(0, 256, size=(n, 16, 16), dtype=np.uint8) if delta else None
    q = torch.from_numpy(rng.integers(1, 60, size=64).astype(np.int32)).to(cuda)
    blocks = torch.from_numpy(blocks).to(cuda)
    win = None if win is None else torch.from_numpy(win).to(cuda)
    before = fdct_blocks.launches
    got = fdct_blocks(blocks, q, win)
    assert fdct_blocks.launches - before == 1
    assert got.dtype == torch.int16 and tuple(got.shape) == (n, 4, 64)
    assert torch.equal(got, fdct_blocks_plain(blocks, q, win))


def _frame_encode_inputs(g, seed, intra, cuda):
    """Random frame-encode inputs of geometry g on the card: the three
    padded source planes, vectors of the int8 field's whole range (windows
    leave every plane side) and coded flags or None, (4, 64) q-tables over
    the whole range the kernel takes, the previous canvas."""
    rng = np.random.default_rng(seed)
    shapes = ((g.ly0, g.lyw), (g.lc0, g.lcw), (g.lc0, g.lcw))
    prev = rng.integers(0, 256, size=(g.chh, g.cw), dtype=np.uint8)
    src = [rng.integers(0, 256, size=s, dtype=np.uint8) for s in shapes]
    src[0][:16, :16] = 255 * (np.indices((16, 16)).sum(0) % 2)  # checker: extreme AC
    prev[:16, :16] = 255 - src[0][:16, :16]  # and residuals at both clamps
    for s, p in zip(src[1:], tdl.slice_yuv(g, prev)[1:]):  # chroma close to prev
        s[:p.shape[0], :p.shape[1]] = np.clip(
            p.astype(np.int32) + rng.integers(-9, 10, size=p.shape), 0, 255)
    motion = None if intra else tuple(
        torch.from_numpy(a).to(cuda) for a in (
            rng.integers(-128, 128, g.nb).astype(np.int8),
            rng.integers(-128, 128, g.nb).astype(np.int8),
            (rng.random(g.nb) < 0.5).astype(np.uint8)))
    if motion is not None:
        motion[0][0] = motion[1][0] = 0
        motion[2][0] = 1
    qt = rng.integers(1, 300, size=(4, 64)).astype(np.int32)
    qt[3] = rng.choice([1, 2, 3, 255, 256, 257, 32767, 32768, 65535], size=64)
    return ([torch.from_numpy(s).to(cuda) for s in src], motion, qt,
            torch.from_numpy(prev).to(cuda))


@pytest.mark.parametrize("intra", [True, False], ids=["I", "P"])
@pytest.mark.parametrize("w,h", [(1920, 1080), (136, 90), (48, 16), (4112, 32)])
def test_frame_encode_kernel_matches_plain(cuda, w, h, intra):
    g = tdl.geometry(w, h)
    src, motion, qt, prev = _frame_encode_inputs(g, w + h, intra, cuda)
    step = FrameEncode(qt, canvas_layout(g), cuda)
    qidx = (2, 0, 3)  # U and V on different tables
    out = torch.full((g.nb, 256), 7, dtype=torch.int16, device=cuda)
    before = FrameEncode.launches
    step(src, motion, qidx, prev, out)
    assert FrameEncode.launches - before == 1
    host = FrameEncode(qt, canvas_layout(g), "cpu")
    want = host([s.cpu() for s in src], None if intra else tuple(t.cpu() for t in motion),
                qidx, prev.cpu(), torch.full((g.nb, 256), 7, dtype=torch.int16))
    assert torch.equal(out.cpu(), want)
    if not intra:  # skipped blocks are zeros, coded ones are not all zero
        coded = motion[2].cpu() != 0
        assert not want[~coded].any() and want[coded].any()
    # the source planes as views of one canvas, as strided as the previous one
    canvas = torch.empty((g.chh, g.cw), dtype=torch.uint8, device=cuda)
    views = canvas_planes(g, canvas)
    for view, s in zip(views, src):
        view.copy_(s)
    again = torch.full_like(out, 7)
    step(views, motion, qidx, prev, again)
    assert torch.equal(again, out)


def test_frame_encode_raises_on_mixed_devices(cuda):
    g = tdl.geometry(64, 48)
    src, motion, qt, prev = _frame_encode_inputs(g, 1, False, cuda)
    step = FrameEncode(qt, canvas_layout(g), cuda)
    out = torch.empty((g.nb, 256), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):
        step([src[0].cpu(), *src[1:]], motion, (0, 1, 1), prev, out)
    with pytest.raises(ValueError):
        step(src, motion, (0, 1, 1), prev.cpu(), out)
    with pytest.raises(ValueError):
        step(src, motion, (0, 1, 1), prev, out.cpu())


def _search_case(name, cuda):
    """(layout, sources, previous canvas) on the card."""
    rng = np.random.default_rng(len(name))

    def noise(shape):
        return rng.integers(0, 256, size=shape, dtype=np.uint8)

    if name.startswith("1080p "):  # the stress inputs of pfv_torch.synth on a fused canvas
        src, prev = synth.search_stress_canvas(name[6:], 1920, 1080, seed=12)
        layout = canvas_layout(tdl.geometry(1920, 1080))
    elif name.startswith("shifts "):  # one block high, one block wide
        h, w = {"shifts 1920x16": (16, 1920), "shifts 16x1088": (1088, 16)}[name]
        src, prev = synth.search_stress("shifts", h, w, seed=12)
        layout, src = plane_layout(h, w), [src]
    elif name.startswith("plane"):
        h, w = {"plane 16x16": (16, 16), "plane 16x64": (16, 64), "plane 64x16": (64, 16),
                "plane 48x32": (32, 48), "plane 4112x32": (32, 4112)}[name]
        layout, src, prev = plane_layout(h, w), [noise((h, w))], noise((h, w))
    else:
        w, h = {"frame 1920x1080": (1920, 1080), "frame 136x90": (136, 90),
                "frame 18x10": (18, 10), "flat": (136, 90), "equal": (136, 90),
                "near": (512, 384)}[name]
        g = tdl.geometry(w, h)
        layout, prev = canvas_layout(g), noise((g.chh, g.cw))
        if name == "flat":
            prev[:] = 93
            src = [np.full((p[3], p[4]), v, np.uint8) for p, v in zip(layout, (90, 100, 110))]
        elif name == "equal":
            src = [p.copy() for p in canvas_planes(g, prev)]
        elif name == "near":  # smooth planes moved by (-3, 2) plus a little noise
            yy, xx = np.mgrid[:g.chh, :g.cw]
            prev = (128 + 50 * np.sin(xx / 13.0) + 50 * np.sin(yy / 11.0 + xx / 29.0)
                    + noise(yy.shape) % 5).astype(np.uint8)
            src = [np.clip(np.roll(p, (-2, 3), axis=(0, 1)).astype(np.int32)
                           + noise(p.shape) % 7 - 3, 0, 255).astype(np.uint8)
                   for p in canvas_planes(g, prev)]
        else:
            src = [noise((p[3], p[4])) for p in layout]
    return (layout, [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in src],
            torch.from_numpy(prev).to(cuda))


LARGEST_ERR = 16 * 16 * 255 ** 2  # a source of 255 over a previous plane of 0


SEARCH_CASES = ["plane 16x16", "plane 16x64", "plane 64x16", "plane 48x32", "plane 4112x32",
                "frame 1920x1080", "frame 136x90", "frame 18x10", "flat", "equal", "near",
                "1080p shifts", "1080p mirror ties", "1080p largest error", "1080p edges",
                "shifts 1920x16", "shifts 16x1088"]


# every case at three thresholds, and the largest error just below and at its error
@pytest.mark.parametrize("name,min_err",
                         [(n, t) for n in SEARCH_CASES for t in (0.0, 2304.0, 57600.0)]
                         + [("1080p largest error", LARGEST_ERR - 1.0),
                            ("1080p largest error", float(LARGEST_ERR))])
def test_motion_search_kernel_matches_plain(cuda, name, min_err):
    layout, src, prev = _search_case(name, cuda)
    search = MotionSearch(layout, min_err, cuda)
    got, want = ([torch.full((search.blocks + 3,), 7, dtype=d, device=cuda)
                  for d in (torch.int8, torch.int8, torch.uint8)] for _ in range(2))
    before = MotionSearch.launches
    search(src, prev, got)
    assert MotionSearch.launches - before == 1
    motion_search_plain(src, prev, search.layout, min_err, want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    host = [torch.full_like(t, 7).cpu() for t in got]
    MotionSearch(layout, min_err, "cpu")([t.cpu() for t in src], prev.cpu(), host)
    for a, b in zip(got, host):
        assert torch.equal(a.cpu(), b)
    if name in ("flat", "equal", "plane 16x16"):  # every candidate ties, or is alone
        assert not got[0][:search.blocks].any() and not got[1][:search.blocks].any()
    if name == "near":
        assert ((got[0] == 2) & (got[1] == -3)).float().mean() > 0.3
    if name == "1080p shifts":  # every vector, so every column phase of a window
        assert len(set(zip(got[0].tolist(), got[1].tolist()))) == 31 * 31
    if name == "1080p largest error":  # every error is LARGEST_ERR
        assert bool((got[2][:search.blocks] == (min_err < LARGEST_ERR)).all())
    # the sources as views of one canvas, as strided as the previous one
    if len(layout) == 3:
        canvas = torch.empty_like(prev)
        views = [canvas[p[1]:p[1] + p[3], p[2]:p[2] + p[4]] for p in layout]
        for view, t in zip(views, src):
            view.copy_(t)
        again = [torch.full_like(t, 7) for t in got]
        search(views, prev, again)
        for a, b in zip(again, got):
            assert torch.equal(a, b)


@pytest.mark.parametrize("in_source", [True, False])
def test_motion_search_entry_refuses_a_stride_past_the_bound(cuda, in_source):
    """The kernel keeps row strides in 32-bit ints: its entry refuses a
    stride of MAX_STRIDE bytes or more (cudaErrorInvalidValue, 1) and
    launches nothing."""
    from pfv_torch.kernels import build

    layout, src, prev = _search_case("plane 16x16", cuda)
    search = MotionSearch(layout, 0.0, cuda)
    rows = [torch.full((1,), 7, dtype=d, device=cuda)
            for d in (torch.int8, torch.int8, torch.uint8)]
    strides = (MAX_STRIDE if in_source else src[0].stride(0),
               prev.stride(0) if in_source else MAX_STRIDE)
    rc = build.launch("pfv_motion_search", cuda, src[0].data_ptr(), None, None, strides[0],
                      0, 0, prev.data_ptr(), strides[1], *(t.data_ptr() for t in rows),
                      0.0, search._desc, 1)
    torch.cuda.synchronize()
    assert rc == 1 and all(bool((t == 7).all()) for t in rows)


def _clip(w, h, f):
    frames = [synth.synth_yuv_frame(t, w, h) for t in range(f)]
    return tuple(np.stack([p[i] for p in frames]) for i in range(3))


def _encode_counters():
    return (FrameEncode, FrameStep, MotionSearch, fdct_blocks, decode_blocks,
            mc_reconstruct, step_frames, canvas_rgba)


def test_encode_video_on_the_card_equals_the_cpu(cuda):
    w, h, f = 96, 64, 9
    y, u, v = _clip(w, h, f)
    before = [fn.launches for fn in _encode_counters()]
    got = encode_video(y, u, v, 30, 3, 4, device="cuda")
    # K6 and the in-loop frame step once per frame, K8 once per P-frame,
    # nothing else
    assert [fn.launches - b for fn, b in zip(_encode_counters(), before)] \
        == [f, f, f - 3, 0, 0, 0, 0, 0]
    assert got == encode_video(y, u, v, 30, 3, 4, device="cpu")


def test_encoder_on_the_card_equals_the_cpu(cuda):
    w, h, f = 96, 64, 9
    y, u, v = _clip(w, h, f)
    outs = {}
    for device in ("cuda", "cpu"):
        before = [fn.launches for fn in _encode_counters()]
        buf = io.BytesIO()
        with Encoder(buf, w, h, 30, 3, device=device) as enc:
            for t in range(f):
                frame = VideoFrame(w, h, y[t], u[t], v[t])
                (enc.encode_iframe if t % 4 == 0 else enc.encode_pframe)(frame)
        outs[device] = buf.getvalue()
        n, p = (f, f - 3) if device == "cuda" else (0, 0)
        assert [fn.launches - b for fn, b in zip(_encode_counters(), before)] \
            == [n, n, p, 0, 0, 0, 0, 0]
    assert outs["cuda"] == outs["cpu"] == encode_video(y, u, v, 30, 3, 4, device="cuda")


def _corpus_source(w, h, f, kind):
    """A committed corpus's source frames as (Y, U, V) uint8 stacks."""
    if kind == "pan":
        return synth.synth_pan_clip(f, w, h)
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        frames = list(pool.map(lambda t: synth.synth_yuv_frame(t, w, h), range(f)))
    return tuple(np.stack([p[i] for p in frames]) for i in range(3))


@pytest.mark.parametrize("path", list(CORPORA))
def test_encode_video_remakes_the_committed_corpus(cuda, path):
    """The corpus's source rebuilt with pfv_torch.synth and encoded whole on
    the card: the committed bytes, K6 and the in-loop frame step once per
    frame, K8 once per P-frame, nothing else."""
    w, h, f, kind = CORPORA[path]
    planes = _corpus_source(w, h, f, kind)
    before = [fn.launches for fn in _encode_counters()]
    got = encode_video(*planes, 30, 2, 60, device="cuda")
    assert [fn.launches - b for fn, b in zip(_encode_counters(), before)] \
        == [f, f, f - len(range(0, f, 60)), 0, 0, 0, 0, 0]
    assert got == open(os.path.join(ROOT, path), "rb").read()


def test_fdct_kernel_raises_on_mixed_devices(cuda):
    blocks = torch.zeros((4, 16, 16), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        fdct_blocks(blocks, torch.ones(64, dtype=torch.int32))
    with pytest.raises(ValueError):
        fdct_blocks(blocks, torch.ones(64, dtype=torch.int32, device=cuda),
                    torch.zeros((4, 16, 16), dtype=torch.uint8))


@pytest.mark.parametrize("source", ["4112x64", CLIPS[0]])
def test_k3_matches_plain_and_reference(cuda, source):
    if source == "4112x64":
        data = synth.random_stream(4112, 64, 5, seed=31)
    else:
        data = open(os.path.join(ROOT, source), "rb").read()
    g, (coeffs, mvx, mvy, hc, ftype, qmul) = tdl.upload_packed(
        tdl.demux_host_packed(data), device=cuda)
    args = (coeffs, *tdl.block_maps(g, mvx, mvy, hc), ftype, qmul, g.chh, g.cw, g.gly,
            g.guw)
    before = seq_frames_dense.launches
    got = seq_frames_dense(*args)
    assert seq_frames_dense.launches - before == ftype.shape[0]
    assert torch.equal(got, seq_frames_dense_plain(*args))
    for p, r in zip(tdl.slice_yuv(g, got), runtime.ref_decode(data)[1:4]):
        assert np.array_equal(p.cpu().numpy(), r)


def test_k4_matches_plain_over_gops(cuda):
    data = synth.random_stream(4112, 64, 7, seed=32, keyframes=3)
    g, f, per_step, qmul = tdl.upload_gops(tdl.demux_host_packed(data), 3, 3, cuda)
    assert f == 7 and per_step[4][2].tolist() == [1, 2, 2]
    prev = torch.randint(0, 256, (3, g.chh, g.cw), dtype=torch.uint8, device=cuda)
    out = torch.empty((3, 3, g.chh, g.cw), dtype=torch.uint8, device=cuda)
    first = prev.clone()
    before = step_gops.launches
    for l in range(3):
        step_gops(*(t[:, l:l + 1] for t in per_step), qmul[:, l:l + 1], g.chh, g.cw,
                  g.gly, g.guw, prev=prev, out=out[:, l:l + 1])
        args = (prev, *(t[:, l] for t in per_step), qmul[:, l], g.chh, g.cw, g.gly, g.guw)
        assert torch.equal(out[:, l], step_frames_batched_plain(*args))
        prev = out[:, l]
    assert step_gops.launches - before == 3
    canv = out.view(9, g.chh, g.cw)[:7]
    for p, r in zip(tdl.slice_yuv(g, canv), runtime.ref_decode(data)[1:4]):
        assert np.array_equal(p.cpu().numpy(), r)
    # the whole-GOP entry: one call, three launches, the same canvases
    whole = step_gops(*per_step, qmul, g.chh, g.cw, g.gly, g.guw, prev=first)
    assert step_gops.launches - before == 6
    assert torch.equal(whole, out)
    assert torch.equal(whole, step_gops_plain(*per_step, qmul, g.chh, g.cw, g.gly, g.guw,
                                              prev=first))


def test_dense_routes_launch_k3_and_k4_only(cuda):
    """Wide streams with one keyframe and with one every 4 frames: the
    dense route, K3 once per frame. K4 runs behind decode_packed_gops, one
    launch per step of its GOPs (2 GOPs of 4 frames here)."""
    counters = (step_frames, decode_blocks, mc_reconstruct, FrameStep, seq_frames_dense,
                step_gops)
    for key in (1 << 30, 4):
        data = synth.random_stream(4112, 64, 6, seed=33, keyframes=key)
        assert tdl.choose_route(data).kind == "dense"
        before = [fn.launches for fn in counters]
        got = tdl.decode_video_yuv(data, device="cuda")
        assert [fn.launches - b for fn, b in zip(counters, before)] == [0, 0, 0, 0, 6, 0]
        ref = runtime.ref_decode(data)[1:4]
        for p, r in zip(got, ref):
            assert np.array_equal(p.cpu().numpy(), r)
    before = [fn.launches for fn in counters]
    got = tdl.decode_packed_gops(tdl.demux_host_packed(data), 2, 4, "yuv", device="cuda")
    assert [fn.launches - b for fn, b in zip(counters, before)] == [0, 0, 0, 0, 0, 4]
    for p, r in zip(got, ref):
        assert np.array_equal(p.cpu().numpy(), r)


def _random_vectors(maps, seed):
    """The (dy, dx, hc) maps with dy and dx replaced by random vectors of
    the 7-bit field's whole range, so that windows leave the canvas on
    every side."""
    rng = np.random.default_rng(seed)
    dy, dx, hc = maps
    rand = [torch.from_numpy(rng.integers(-64, 64, dy.shape).astype(np.int8)).to(dy.device)
            for _ in range(2)]
    return rand[0], rand[1], hc


@pytest.mark.parametrize("name", sorted(synth.EDGE_STREAMS))
def test_frame_steps_exact_at_the_edges(cuda, name):
    """K1 (widths up to 4096) or K3 and K4 (4112) against their plain
    versions at max_abs_err 0 and the reference, on the edge streams; then
    with random vectors that leave the canvas (the plain versions only)."""
    data = synth.edge_stream(name)
    ref = runtime.ref_decode(data)[1:4]
    route = tdl.choose_route(data)
    outs = []
    if route.kind == "units":
        g, args = tdl.upload(route.host, cuda)
        dims = (g.chh, g.cw, g.gly, g.guw)
        got = step_frames(*args, *dims)
        assert torch.equal(got, step_frames_plain(*args, *dims))
        outs.append(got)
        wild = (*args[:2], *_random_vectors(args[2:5], 5), *args[5:])
        assert torch.equal(step_frames(*wild, *dims), step_frames_plain(*wild, *dims))
    else:
        assert route.kind == "dense"
        host = tdl.demux_host_packed(data)
        g, (coeffs, mvx, mvy, hc, ftype, qmul) = tdl.upload_packed(host, device=cuda)
        maps = tdl.block_maps(g, mvx, mvy, hc)
        dims = (g.chh, g.cw, g.gly, g.guw)
        got = seq_frames_dense(coeffs, *maps, ftype, qmul, *dims)
        assert torch.equal(got, seq_frames_dense_plain(coeffs, *maps, ftype, qmul, *dims))
        outs.append(got)
        wild = (coeffs, *_random_vectors(maps, 6), ftype, qmul, *dims)
        assert torch.equal(seq_frames_dense(*wild), seq_frames_dense_plain(*wild))
        gops = (-(-synth.EDGE_STREAMS[name][2] // 4), 4)  # a keyframe every 4 frames
        _, f, per_step, qmul = tdl.upload_gops(host, *gops, cuda)
        gop = step_gops(*per_step, qmul, *dims)
        assert torch.equal(gop, step_gops_plain(*per_step, qmul, *dims))
        outs.append(gop.view(-1, g.chh, g.cw)[:f])
        prev = torch.randint(0, 256, (gops[0], g.chh, g.cw), dtype=torch.uint8, device=cuda)
        wild = (per_step[0], *_random_vectors(per_step[1:4], 7), per_step[4], qmul, *dims)
        assert torch.equal(step_gops(*wild, prev=prev), step_gops_plain(*wild, prev=prev))
    for canv in outs:
        for p, r in zip(tdl.slice_yuv(g, canv), ref):
            assert np.array_equal(p.cpu().numpy(), r)


# -- the loader's side stream, the list of devices -------------------------


def _loader_clips():
    """Ten clips of three geometries, in turn."""
    return [synth.random_stream(w, h, f, seed=50 + i, keyframes=3)
            for i, (w, h, f) in enumerate([(512, 384, 9), (1920, 1080, 4), (136, 90, 7)] * 3
                                          + [(4112, 64, 6)])]


@pytest.mark.parametrize("prefetch", [1, 3])
def test_loader_on_the_card_equals_the_whole_clip_decode(cuda, prefetch):
    """The uploads run on the worker's stream while the consumer's kernels
    run: every clip must still equal its own decode, also when all results
    are kept while later clips reuse the pinned buffer and the allocator."""
    from pfv_torch import VideoDataLoader

    datas = _loader_clips()
    before = (step_frames.launches, canvas_rgba.launches)
    got = list(VideoDataLoader(datas, prefetch=prefetch, device="cuda"))
    torch.cuda.synchronize()
    frames = sum(runtime.count_frames(d) for d in datas[:-1])
    assert step_frames.launches - before[0] == frames  # the last clip is K3's
    assert canvas_rgba.launches - before[1] == len(datas)
    for g, d in zip(got, datas):
        assert g.device.type == "cuda"
        assert torch.equal(g, tdl.decode_video_rgb(d, device="cuda"))


def test_loader_early_exit_and_error_on_the_card(cuda):
    from pfv_torch import VideoDataLoader

    datas = _loader_clips()
    it = iter(VideoDataLoader(datas, device="cuda"))
    first = next(it)
    it.close()
    assert torch.equal(first, tdl.decode_video_rgb(datas[0], device="cuda"))
    with pytest.raises(ValueError):
        list(VideoDataLoader([datas[0], b"no stream, but bytes enough for a header"],
                             device="cuda"))


@pytest.mark.parametrize("devices", [["cuda"], ["cuda:0", "cuda:0"]])
def test_stream_batch_and_gop_split_on_the_card(cuda, devices):
    from pfv_torch.parallel import decode_stream_batch, decode_video_gops

    parts = [split_packets(synth.random_stream(512, 384, 6, seed=70 + s, keyframes=3))
             for s in range(4)]
    datas = [synth.container(512, 384, parts[0][0]["qtables"], p) for _, p in parts]
    shards, mean = decode_stream_batch(datas, devices)
    per = len(datas) // len(devices)
    ys = []
    for d, shard in enumerate(shards):
        for s in range(per):
            ref = runtime.ref_decode(datas[d * per + s])[1:4]
            ys.append(ref[0])
            for p, r in zip(shard, ref):
                assert np.array_equal(p[s].cpu().numpy(), r)
    assert abs(float(mean) - np.stack(ys).astype(np.float64).mean()) < 0.5
    rgb = decode_video_gops(datas[0], devices, want="rgb")
    assert torch.equal(rgb, tdl.decode_video_rgb(datas[0], device="cuda"))


def test_encode_video_gops_on_the_card_equals_encode_video(cuda):
    from pfv_torch.encoding import encode_video_gops

    planes = _clip(136, 90, 9)
    want = encode_video(*planes, 30, 3, 3, device="cpu")
    for devices in (["cuda"], ["cuda:0", "cuda:0"], ["cuda:0"] * 3):
        assert encode_video_gops(*planes, 30, 3, 3, devices=devices) == want


def test_kernels_launch_on_their_tensors_device(cuda):
    """A tensor on the second card while the first is current."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    data = synth.random_stream(512, 384, 5, seed=80, keyframes=3)
    assert torch.cuda.current_device() == 0
    got = tdl.decode_video_rgb(data, device="cuda:1")
    assert got.device == torch.device("cuda", 1)
    assert torch.equal(got.cpu(), tdl.decode_video_rgb(data, device="cuda:0").cpu())


def _ref_rgb(data: bytes) -> torch.Tensor:
    """The scalar decoder's frames as (F, H, W, 3) u8 RGB, chroma doubled by
    nearest neighbour."""
    y, u, v = (torch.from_numpy(p) for p in runtime.ref_decode(data)[1:4])
    h, w = y.shape[1:]
    return yuv_to_rgb(y, double_plane(u)[:, :h, :w], double_plane(v)[:, :h, :w])


def test_the_tool_on_the_card(cuda, tmp_path, capsys):
    """The command-line tool in-process on its default device: info, verify
    and bench --runs 3 of the 512x384 corpus; encode --synth 8, then decode
    to .npy, held to the scalar decoder."""
    from pfv_torch.cli import main

    corpus = os.path.join(ROOT, CLIPS[0])
    n = runtime.count_frames(open(corpus, "rb").read())
    pfv, npy = str(tmp_path / "synth.pfv"), str(tmp_path / "frames.npy")
    counters = (step_frames, canvas_rgba, FrameEncode, FrameStep, MotionSearch,
                seq_frames_dense)
    before = [fn.launches for fn in counters]
    for argv in (["info", corpus], ["verify", corpus], ["bench", corpus, "--runs", "3"],
                 ["encode", pfv, "--synth", "8"], ["decode", pfv, "--output", npy]):
        main(argv)
    text = capsys.readouterr().out
    # K1: verify's decode and bench's three of the corpus, then the 8 frames
    assert [fn.launches - b for fn, b in zip(counters, before)] == [4 * n + 8, 4, 8, 8, 7, 0]
    assert "512x384 @ 30 fps, 4 q-tables" in text and "3 I-frames, 158 P-frames" in text
    assert f"OK: {n} frames" in text and text.count("RUN ") == 3
    with open(pfv, "rb") as f:
        assert torch.equal(torch.from_numpy(np.load(npy)), _ref_rgb(f.read()))
