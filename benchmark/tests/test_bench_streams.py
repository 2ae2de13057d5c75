"""The reference's stream writer, decoder and encoder at tiny sizes: the
writer's bytes read back to what it drew, the traffic files' statistics
are met, and the program's own decoders and encoder (witnesses only: the
reference imports nothing of them) agree with the reference."""

import json
import os

import numpy as np
import pytest
import torch

from reference.codec import Arith, Encoder
from reference.color import rgba_words
from reference.entropy import frame_payload, read_payload
from reference.sources import clip_planes
from reference.streams import Clip, container
from reference.tables import INTER_QIDX, INTRA_QIDX, q_tables

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM_TRAFFIC = ("decode_clips128", "decode_clips48")


def traffic(name):
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        return json.load(f)


def clip(w=96, h=64, frames=6, seed=2**31 + 5, stats=None, c=0):
    stats = stats or traffic("decode_clips128")["stream"]
    return Clip(w, h, 60, frames, 4, q_tables(2), stats, seed, c, "cpu")


def dense_stats():
    """The corpus's statistics with more P-blocks coded, so that tiny
    frames hold coded blocks."""
    return dict(traffic("decode_clips128")["stream"], p_coded=0.4)


@pytest.mark.parametrize("size", [(96, 64), (136, 90), (48, 32)])
def test_writer_reads_back_what_it_drew(size):
    c = clip(*size, frames=5, stats=dense_stats())
    for f in range(c.n):
        ftype, qidx, coeffs, mvx, mvy, hc = c.frame(f)
        payload = frame_payload(coeffs, qidx, None if ftype == 1 else (mvx, mvy, hc))
        got = read_payload(payload, c.nb, ftype)
        want = (coeffs, mvx, mvy, hc)
        for g, w in zip(got[:4], want):
            np.testing.assert_array_equal(g, w.numpy())
        np.testing.assert_array_equal(got[4], qidx)


def test_frames_repeat_from_the_seed_and_differ_between_clips():
    a, b, other = clip(), clip(), clip(c=1)
    for f in range(3):
        assert all(torch.equal(x, y) for x, y in zip(a.frame(f)[2:], b.frame(f)[2:]))
    assert not torch.equal(a.frame(0)[2], other.frame(0)[2])


@pytest.mark.parametrize("name", STREAM_TRAFFIC)
def test_traffic_statistics_are_met(name):
    """At 1080p, one I-frame and three P-frames: bits a pixel at the
    traffic's clip length within 5 % of the file's, the coded and moved
    shares within a few points."""
    t = traffic(name)
    frames = t["frames_per_clip"]
    c = Clip(1920, 1080, 60, frames, 64, q_tables(2), t["stream"], 7, 0, "cpu")
    sizes, coded, moved = [], [], []
    for f in range(4):
        ftype, qidx, coeffs, mvx, mvy, hc = c.frame(f)
        sizes.append(5 + len(frame_payload(coeffs, qidx, None if ftype == 1 else (mvx, mvy, hc))))
        if ftype == 2:
            coded.append(float(hc.float().mean()))
            moved.append(float(((mvx != 0) | (mvy != 0)).float().mean()))
    n_i = -(-frames // 64)
    per_frame = (n_i * sizes[0] + (frames - n_i) * np.mean(sizes[1:])) / frames
    bpp = 8 * per_frame / (1920 * 1080)
    assert abs(bpp / t["bits_per_pixel"] - 1) < 0.05, bpp
    assert abs(np.mean(coded) - t["stream"]["p_coded"]) < 0.003
    assert abs(np.mean(moved) - t["stream"]["p_moved"]) < 0.01


def test_reference_decode_matches_the_programs_decoders():
    from pfv_torch import decode_video_rgba, runtime

    for size in ((96, 64), (200, 120)):
        c = clip(*size, frames=9, stats=dense_stats())
        data = c.write()
        n, y, u, v, _ = runtime.ref_decode(data)
        planes = list(c.decoded())
        assert n == len(planes) == 9
        w, h = size
        for f, (py, pu, pv) in enumerate(planes):
            np.testing.assert_array_equal(y[f], py[:h, :w].numpy())
            np.testing.assert_array_equal(u[f], pu[:h // 2, :w // 2].numpy())
            np.testing.assert_array_equal(v[f], pv[:h // 2, :w // 2].numpy())
        rgba = decode_video_rgba(data, device="cpu").view(torch.int32)
        assert torch.equal(rgba, torch.stack([rgba_words(*p, h, w) for p in planes]))


def test_reference_encoder_matches_the_programs_encoder():
    from pfv_torch import encode_video

    w, h, frames = 64, 48, 7
    src = clip_planes(w, h, frames, seed=11, clip=0, device="cpu")
    qt = q_tables(2)
    enc = Encoder(w, h, qt, 2, "cpu")
    payloads = []
    for f in range(frames):
        planes = [torch.from_numpy(p[f]) for p in src]
        if f % 4 == 0:
            payloads.append((1, frame_payload(enc.iframe(planes)[0], INTRA_QIDX)))
        else:
            c, mvx, mvy, hc = enc.pframe(planes)
            payloads.append((2, frame_payload(c, INTER_QIDX, (mvx, mvy, hc))))
    assert container(w, h, 60, qt, payloads) == encode_video(*src, 60, 2, keyframes=4,
                                                             device="cpu")


def test_control_arithmetic_differs_from_the_format():
    c = clip(stats=dense_stats())
    exact, floored = list(c.decoded()), list(c.decoded(Arith(floor=True)))
    assert any(not torch.equal(a[0], b[0]) for a, b in zip(exact, floored))
