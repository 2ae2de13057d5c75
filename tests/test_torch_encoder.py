"""pfv_torch's encoder with device="cpu" (the kernels' plain versions)
against the JAX package: the motion search and the plane encode steps
against their jnp counterparts, the per-frame `FrameEncoder` of the
encoders (fused canvases, one frame-encode step and one frame step per
frame) against those plane steps, and the streaming `Encoder` and
`encode_video` byte for byte against pfv_tpu.Encoder,
pfv_tpu.encoding.encode_video and the numpy oracle encoder, on the 96x64
9-frame clip of tests/test_encoding.py. The output decodes, through the
scalar reference decoder, to the encoder's own in-loop reconstruction."""

from __future__ import annotations

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from oracle import pfv_oracle as oracle

import pfv_torch
from pfv_torch import device as tdevice
from pfv_torch import encoding as tencoding
from pfv_torch import synth
from pfv_torch.frame import canvas_layout, geometry
from pfv_torch.ops import blocks as tblocks
from pfv_torch.ops import motion as tmotion
from pfv_torch.ops import pframe as tpframe
from pfv_tpu import Encoder as JaxEncoder
from pfv_tpu import VideoFrame as JaxVideoFrame
from pfv_tpu import device as jdevice
from pfv_tpu import runtime
from pfv_tpu.encoding import encode_video as jax_encode_video
from pfv_tpu.ops import blocks as jblocks
from pfv_tpu.ops import motion as jmotion
from pfv_tpu.ops.quant import derive_q_tables

W, H, FPS, N_FRAMES = 96, 64, 30, 9


@pytest.fixture(scope="module")
def clip():
    frames = [synth.synth_yuv_frame(t, W, H) for t in range(N_FRAMES)]
    return tuple(np.stack([f[i] for f in frames]) for i in range(3))


@pytest.fixture(scope="module")
def pan():
    """Two frames of the panning clip: most blocks match at (3, 1), and the
    edge blocks have candidates that leave the plane."""
    return synth.synth_pan_clip(2, W, H)


def _frames(clip, cls):
    return [cls(W, H, clip[0][t], clip[1][t], clip[2][t]) for t in range(N_FRAMES)]


def _stream(enc_cls, clip, quality, keys, **kw):
    """Encode the clip through a streaming encoder: keys[t] True -> I,
    False -> P, None -> a dropframe in place of frame t."""
    buf = io.BytesIO()
    enc = enc_cls(buf, W, H, FPS, quality, **kw)
    frames = _frames(clip, pfv_torch.VideoFrame if enc_cls is pfv_torch.Encoder
                     else JaxVideoFrame)
    for f, key in zip(frames, keys):
        if key is None:
            enc.encode_dropframe()
        else:
            (enc.encode_iframe if key else enc.encode_pframe)(f)
    enc.finish()
    return buf.getvalue(), enc


def _oracle(clip, quality, keys):
    enc = oracle.OracleEncoder(W, H, FPS, quality)
    for t, key in enumerate(keys):
        if key is None:
            enc.encode_dropframe()
        else:
            (enc.encode_iframe if key else enc.encode_pframe)(*(p[t] for p in clip))
    return enc.finish()


def _padded(plane, clear):
    return np.array(jdevice.pad_plane_host(plane, tblocks.pad_dim(plane.shape[0]),
                                             tblocks.pad_dim(plane.shape[1]), clear))


@pytest.mark.parametrize("plane", [0, 1])
def test_motion_search_matches_jax(pan, plane):
    clear = 0 if plane == 0 else 128
    ref, cur = (_padded(pan[plane][t], clear) for t in (0, 1))
    by, bx = tblocks.block_origins(*ref.shape)
    cur_blocks = np.array(jblocks.plane_to_blocks(jnp.asarray(cur)))
    want = jmotion.motion_search(jnp.asarray(cur_blocks), jnp.asarray(ref),
                                 jnp.asarray(by), jnp.asarray(bx))
    got = tmotion.motion_search(torch.from_numpy(cur_blocks), torch.from_numpy(ref),
                                torch.from_numpy(by), torch.from_numpy(bx))
    for g, w_ in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w_))
    mvx, mvy = got[0].numpy(), got[1].numpy()
    if plane == 0:
        assert ((mvx == 3) & (mvy == 1)).mean() > 0.5  # the pan is found
    # edge blocks: every window the search took lies inside the plane
    assert (by + mvy >= 0).all() and (by + mvy <= ref.shape[0] - 16).all()
    assert (bx + mvx >= 0).all() and (bx + mvx <= ref.shape[1] - 16).all()


def test_motion_search_skips_candidates_off_the_plane():
    """A reference that matches best just outside the plane: the search
    must not clamp a leaving candidate onto the edge."""
    rng = np.random.default_rng(8)
    ref = rng.integers(0, 256, size=(32, 48), dtype=np.uint8)
    cur = np.roll(ref, (5, -7), axis=(0, 1))
    by, bx = tblocks.block_origins(32, 48)
    cur_blocks = np.array(jblocks.plane_to_blocks(jnp.asarray(cur)))
    want = jmotion.motion_search(jnp.asarray(cur_blocks), jnp.asarray(ref),
                                 jnp.asarray(by), jnp.asarray(bx))
    got = tmotion.motion_search(torch.from_numpy(cur_blocks), torch.from_numpy(ref),
                                torch.from_numpy(by), torch.from_numpy(bx))
    for g, w_ in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w_))


@pytest.mark.parametrize("quality", [0, 3, 10])
def test_plane_encode_steps_match_jax(pan, quality):
    qt = derive_q_tables(quality)
    ref, cur = (_padded(pan[0][t], 0) for t in (0, 1))
    by, bx = tblocks.block_origins(*ref.shape)
    tby, tbx = torch.from_numpy(by), torch.from_numpy(bx)
    coeffs, recon = tdevice.iframe_encode_plane(torch.from_numpy(ref),
                                                torch.from_numpy(qt["intra_l"]), tby, tbx)
    want = jdevice.iframe_encode_plane(jnp.asarray(ref), jnp.asarray(qt["intra_l"]))
    assert np.array_equal(coeffs.numpy(), np.asarray(want[0]))
    assert np.array_equal(recon.numpy(), np.asarray(want[1]))

    min_err = tpframe.skip_threshold(quality)
    got = tdevice.pframe_encode_plane(torch.from_numpy(cur), recon,
                                      torch.from_numpy(qt["inter_l"]), min_err, tby, tbx)
    want = jdevice.pframe_encode_plane(jnp.asarray(cur), want[1],
                                       jnp.asarray(qt["inter_l"]), jnp.float32(min_err),
                                       jnp.asarray(by), jnp.asarray(bx))
    for g, w_ in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w_))
    assert got[3].dtype == torch.bool and got[1].dtype == torch.int8


@pytest.mark.parametrize("quality", [0, 3, 10])
def test_frame_encoder_matches_the_plane_encode_steps(pan, quality):
    """An I-frame and a P-frame through the encoders' FrameEncoder: per
    plane the coefficients (zeros where a block is skipped), vectors, flags
    and reconstruction of `iframe_encode_plane` / `pframe_encode_plane`,
    which `test_plane_encode_steps_match_jax` holds to the JAX package."""
    qt = derive_q_tables(quality)
    min_err = tpframe.skip_threshold(quality)
    g = geometry(W, H)
    enc = tdevice.FrameEncoder(g, qt, min_err, "cpu")
    y0, u0, v0 = enc.planes()
    assert not y0.any() and (u0 == 128).all() and (v0 == 128).all()
    src = [[torch.from_numpy(_padded(pan[i][t], 0 if i == 0 else 128)) for i in range(3)]
           for t in (0, 1)]
    coeffs = torch.full((g.nb, 256), 7, dtype=torch.int16)
    headers = torch.zeros((3, g.nb), dtype=torch.int8)
    motion = (headers[0], headers[1], headers[2].view(torch.uint8))
    enc.check(src[0], coeffs, motion)
    enc.iframe(src[0], coeffs)
    recon = []
    for (first, *_), plane, got, qk in zip(canvas_layout(g), src[0], enc.planes(),
                                           ("intra_l", "intra_c", "intra_c")):
        by, bx = (torch.from_numpy(o) for o in tblocks.block_origins(*plane.shape))
        c, r = tdevice.iframe_encode_plane(plane, torch.from_numpy(qt[qk]), by, bx)
        assert torch.equal(coeffs[first:first + c.shape[0]], c) and torch.equal(got, r)
        recon.append(r)
    enc.pframe(src[1], coeffs, motion)
    skipped = 0
    for (first, *_), plane, ref, got, qk in zip(canvas_layout(g), src[1], recon,
                                                enc.planes(),
                                                ("inter_l", "inter_c", "inter_c")):
        by, bx = (torch.from_numpy(o) for o in tblocks.block_origins(*plane.shape))
        c, mx, my, coded, r = tdevice.pframe_encode_plane(
            plane, ref, torch.from_numpy(qt[qk]), min_err, by, bx)
        sl = slice(first, first + c.shape[0])
        assert torch.equal(coeffs[sl], c * coded[:, None])
        assert torch.equal(motion[0][sl], my) and torch.equal(motion[1][sl], mx)
        assert torch.equal(motion[2][sl], coded.to(torch.uint8)) and torch.equal(got, r)
        skipped += int((~coded).sum())
    assert skipped > 0 or quality == 0


@pytest.mark.parametrize("quality,interval", [(3, 4), (0, 3), (8, 9)])
def test_encoders_byte_identical_to_jax_and_oracle(clip, quality, interval):
    keys = [t % interval == 0 for t in range(N_FRAMES)]
    want = jax_encode_video(*clip, framerate=FPS, quality=quality, keyframes=interval)
    assert _oracle(clip, quality, keys) == want
    assert _stream(JaxEncoder, clip, quality, keys)[0] == want
    got = pfv_torch.encode_video(*clip, FPS, quality, interval, device="cpu")
    assert got == want
    assert _stream(pfv_torch.Encoder, clip, quality, keys, device="cpu")[0] == want


@pytest.mark.parametrize("quality", [0, 6])
@pytest.mark.parametrize("w,h", [(18, 10), (64, 32), (48, 16)])
def test_planes_one_macroblock_high_encode_like_jax(w, h, quality):
    """Planes one macroblock high (luma at 64x32's chroma, 48x16's luma;
    18x10 one block wide too): both encode entry points write the JAX
    package's bytes, a keyframe every frame and every 3."""
    f = 4
    rng = np.random.default_rng(w * h + quality)
    tex = [rng.integers(0, 256, size=(s[0] + f, s[1] + 2 * f), dtype=np.uint8)
           for s in ((h, w), (h // 2, w // 2))]
    # texture moving by (1, 2) pixels per frame
    y, u, v = (np.stack([t[k:k + s[0], 2 * k:2 * k + s[1]] for k in range(f)])
               for t, s in ((tex[0], (h, w)), (tex[1], (h // 2, w // 2)),
                            (tex[1][::-1], (h // 2, w // 2))))
    for interval in (1, 3):
        want = jax_encode_video(y, u, v, framerate=FPS, quality=quality,
                                keyframes=interval)
        assert pfv_torch.encode_video(y, u, v, FPS, quality, interval, device="cpu") == want
        buf = io.BytesIO()
        with pfv_torch.Encoder(buf, w, h, FPS, quality, device="cpu") as enc:
            for t in range(f):
                frame = pfv_torch.VideoFrame(w, h, y[t], u[t], v[t])
                (enc.encode_iframe if t % interval == 0 else enc.encode_pframe)(frame)
        assert buf.getvalue() == want


def test_explicit_keyframe_mask_and_dropframe(clip):
    mask = np.zeros(N_FRAMES, bool)
    mask[[0, 2, 7]] = True
    want = jax_encode_video(*clip, framerate=FPS, quality=3, keyframes=mask)
    assert pfv_torch.encode_video(*clip, FPS, 3, mask, device="cpu") == want
    assert _stream(pfv_torch.Encoder, clip, 3, list(mask), device="cpu")[0] == want
    # a dropframe neither moves the previous frame nor makes a frame
    keys = [True, False, None, False, True, None, False, False, False]
    got, enc = _stream(pfv_torch.Encoder, clip, 3, keys, device="cpu")
    assert got == _stream(JaxEncoder, clip, 3, keys)[0] == _oracle(clip, 3, keys)
    assert [s["type"] for s in enc.stats] == ["I", "P", "P", "I", "P", "P", "P"]


@pytest.mark.parametrize("keyframes", [4, "mask"])
def test_encode_video_in_runs_of_whole_frames_is_byte_identical(monkeypatch, keyframes):
    """`encode_video` with its compaction cut into runs of three frames,
    across the keyframes (every 4, and a mask that drops the keyframe at 4
    and adds one at 5 and 6), writes the bytes of one run and of the JAX
    package."""
    f = 10
    frames = [synth.synth_yuv_frame(t, W, H) for t in range(f)]
    src = tuple(np.stack([fr[i] for fr in frames]) for i in range(3))
    if keyframes == "mask":
        keyframes = np.isin(np.arange(f), [0, 5, 6, 8])
    one_run = pfv_torch.encode_video(*src, FPS, 3, keyframes, device="cpu")
    nb = geometry(W, H).nb
    monkeypatch.setattr(tencoding, "COMPACT_LIMIT", 3 * nb * 256 + 1)
    assert tencoding.compact_runs(f, nb) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    got = pfv_torch.encode_video(*src, FPS, 3, keyframes, device="cpu")
    assert got == one_run
    assert got == jax_encode_video(*src, framerate=FPS, quality=3, keyframes=keyframes)


@pytest.mark.parametrize("f,w,h,limit,want", [
    (192, 3840, 2160, None, 2),   # 4K: 172 frames a run, then 20
    (128, 1920, 1080, None, 1),   # 1080p: one run
    (10, 96, 64, 3, 4),
    (7, 96, 64, 1, 7),
    (5, 96, 64, 0, 5),            # a frame past the limit still makes a run
])
def test_compact_runs_cover_every_frame_once_in_order_under_the_limit(
        monkeypatch, f, w, h, limit, want):
    nb = geometry(w, h).nb
    if limit is not None:
        monkeypatch.setattr(tencoding, "COMPACT_LIMIT", limit * nb * 256 + 1)
    runs = tencoding.compact_runs(f, nb)
    assert len(runs) == want
    assert [a for a, _ in runs] == [0] + [b for _, b in runs[:-1]] and runs[-1][1] == f
    assert all(b > a for a, b in runs)
    if limit != 0:
        assert all((b - a) * nb * 256 < tencoding.COMPACT_LIMIT for a, b in runs)


def test_stats_match_jax_encoder(clip):
    keys = [t % 4 == 0 for t in range(N_FRAMES)]
    _, enc = _stream(pfv_torch.Encoder, clip, 5, keys, device="cpu")
    _, jenc = _stream(JaxEncoder, clip, 5, keys)
    for a, b in zip(enc.stats, jenc.stats):
        assert (a["type"], a["payload_bytes"], a["skip_pct"]) == \
            (b["type"], b["payload_bytes"], b["skip_pct"])
    assert len(enc.stats) == N_FRAMES and any(s["skip_pct"] > 0 for s in enc.stats)


def test_reconstruction_is_what_the_decoder_shows(clip):
    buf = io.BytesIO()
    enc = pfv_torch.Encoder(buf, W, H, FPS, 4, device="cpu")
    enc.collect_psnr = True
    recon = []
    for t, f in enumerate(_frames(clip, pfv_torch.VideoFrame)):
        (enc.encode_iframe if t % 5 == 0 else enc.encode_pframe)(f)
        recon.append([p.numpy().copy() for p in enc.reconstruction()])
    enc.finish()
    n, ry, ru, rv, _ = runtime.ref_decode(buf.getvalue())
    assert n == N_FRAMES
    for t, (y, u, v) in enumerate(recon):
        assert np.array_equal(y[:H, :W], ry[t])
        assert np.array_equal(u[:H // 2, :W // 2], ru[t])
        assert np.array_equal(v[:H // 2, :W // 2], rv[t])
    assert all(s["psnr_y"] > 30 for s in enc.stats)


def test_context_manager_and_drop_finish_the_stream(clip):
    keys = [t % 4 == 0 for t in range(N_FRAMES)]
    want = _stream(pfv_torch.Encoder, clip, 3, keys, device="cpu")[0]
    buf = io.BytesIO()
    with pfv_torch.Encoder(buf, W, H, FPS, 3, device="cpu") as enc:
        for key, f in zip(keys, _frames(clip, pfv_torch.VideoFrame)):
            (enc.encode_iframe if key else enc.encode_pframe)(f)
    assert buf.getvalue() == want
    buf = io.BytesIO()
    enc = pfv_torch.Encoder(buf, W, H, FPS, 3, device="cpu")
    enc.encode_iframe(_frames(clip, pfv_torch.VideoFrame)[0])
    del enc
    assert buf.getvalue().endswith(b"\0" * 5)
    with pytest.raises(ValueError):
        enc = pfv_torch.Encoder(io.BytesIO(), W, H, FPS, 3, device="cpu")
        enc.finish()
        enc.encode_dropframe()


def test_encode_video_timer_stages(clip):
    class Timer:
        def __init__(self):
            self.names = []

        def stage(self, name):
            import contextlib

            self.names.append(name)
            return contextlib.nullcontext()

    timer = Timer()
    got = pfv_torch.encode_video(*clip, FPS, 3, 4, timer=timer, device="cpu")
    assert got == pfv_torch.encode_video(*clip, FPS, 3, 4, device="cpu")
    assert timer.names == ["h2d upload", "device encode", "d2h fetch", "host mux"]


@pytest.mark.parametrize("case", ["quality_high", "quality_low", "odd_width",
                                  "odd_height", "chroma_shape", "first_not_key",
                                  "mask_shape", "frame_size"])
def test_value_errors(clip, case):
    y, u, v = clip
    with pytest.raises(ValueError):
        if case == "quality_high":
            pfv_torch.Encoder(io.BytesIO(), W, H, FPS, 11, device="cpu")
        elif case == "quality_low":
            pfv_torch.encode_video(y, u, v, FPS, -1, device="cpu")
        elif case == "odd_width":
            pfv_torch.Encoder(io.BytesIO(), W + 1, H, FPS, 3, device="cpu")
        elif case == "odd_height":
            pfv_torch.encode_video(y[:, :H - 1], u, v, FPS, 3, device="cpu")
        elif case == "chroma_shape":
            pfv_torch.encode_video(y, u[:, :-1], v, FPS, 3, device="cpu")
        elif case == "first_not_key":
            pfv_torch.encode_video(y, u, v, FPS, 3, np.arange(N_FRAMES) == 1,
                                   device="cpu")
        elif case == "mask_shape":
            pfv_torch.encode_video(y, u, v, FPS, 3, [True, False], device="cpu")
        else:
            enc = pfv_torch.Encoder(io.BytesIO(), W, H, FPS, 3, device="cpu")
            enc.encode_iframe(pfv_torch.VideoFrame(W - 16, H, y[0][:, 16:],
                                                   u[0][:, 8:], v[0][:, 8:]))
