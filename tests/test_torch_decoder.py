"""pfv_torch's streaming Decoder with device="cpu" (the kernels' plain
versions) against the JAX package's Decoder run with PFV_PALLAS=1, so that
its iDCT goes through the Pallas kernel (interpret mode), and against the
scalar reference decoder `runtime.ref_decode`; then the decode halves of
tests/test_end_to_end.py and tests/test_robustness.py, held to the port.

Streams come from runtime payloads (pfv_torch.synth: seeded random sparse
coefficients, coded flags and in-plane motion vectors) and the committed
136x90 clip, so no encoder runs. All comparisons are exact."""

from __future__ import annotations

import io
import os
import struct

import numpy as np
import pytest

import pfv_torch
from pfv_torch import synth
from pfv_torch.dec import (Decoder, DecodeError, FormatError, StreamIOError, VersionError,
                           split_packets)
from pfv_tpu import device as jdevice
from pfv_tpu import runtime
from pfv_tpu.dec import Decoder as JaxDecoder
from pfv_tpu.frame import VideoFrame as JaxVideoFrame
from pfv_tpu.ops.pallas import idct_kernel
from pfv_tpu.ops.pallas.idct_kernel import decode_blocks_pallas

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, N_FRAMES = 96, 64, 8


def _decode(dec):
    got = []
    while dec.advance_frame(lambda f: got.append(f)):
        pass
    return got


def _planes(f):
    return f.plane_y, f.plane_u, f.plane_v


@pytest.fixture(scope="module")
def streams():
    with open(os.path.join(ROOT, "tests/data/clip_136x90_q3_8f.pfv"), "rb") as fh:
        clip = fh.read()
    return {"128x96": synth.random_stream(128, 96, 6, seed=1, keyframes=4),
            "136x90": clip}


@pytest.fixture(scope="module")
def encoded():
    """96x64, 8 frames, an I-frame every 4: the clip of test_end_to_end.py's
    geometry and layout."""
    return synth.random_stream(W, H, N_FRAMES, seed=3, keyframes=4)


@pytest.mark.parametrize("name", ["128x96", "136x90"])
def test_decoder_matches_jax_pallas_decoder_and_reference(streams, name, monkeypatch):
    data = streams[name]
    monkeypatch.setenv("PFV_PALLAS", "1")
    traced = []

    def counted(coeffs, q_table):
        traced.append(coeffs.shape)
        return decode_blocks_pallas(coeffs, q_table)

    monkeypatch.setattr(idct_kernel, "decode_blocks_pallas", counted)
    jitted = (jdevice.iframe_decode_plane, jdevice.pframe_decode_plane)
    for fn in jitted:  # trace afresh, so that PFV_PALLAS takes effect
        fn.clear_cache()
    try:
        want = _decode(JaxDecoder(io.BytesIO(data)))
    finally:
        for fn in jitted:
            fn.clear_cache()
    assert len(traced) == 4  # Y and chroma shapes, I and P planes
    got = _decode(Decoder(io.BytesIO(data), device="cpu"))
    n, ry, ru, rv, _ = runtime.ref_decode(data)
    assert len(got) == len(want) == n
    for i, (a, b) in enumerate(zip(got, want)):
        for p, q, r in zip(_planes(a), _planes(b), (ry[i], ru[i], rv[i])):
            assert p.shape == r.shape and np.array_equal(p, np.asarray(q))
            assert np.array_equal(p, r), f"frame {i}"


def test_decode_all_reset_and_second_pass(encoded):
    dec = Decoder(io.BytesIO(encoded), device="cpu")
    assert (dec.width(), dec.height(), dec.framerate()) == (W, H, 30)
    frames = dec.decode_all()
    assert len(frames) == N_FRAMES
    assert dec.advance_frame(lambda f: None) is False  # at EOF
    dec.reset()
    got = _decode(dec)
    _, ry, ru, rv, _ = runtime.ref_decode(encoded)
    for i, (a, b) in enumerate(zip(frames, got)):
        for p, q, r in zip(_planes(a), _planes(b), (ry[i], ru[i], rv[i])):
            assert np.array_equal(p, q) and np.array_equal(p, r)
    # mid-stream bulk decode is refused (P-frames need preceding state)
    dec.reset()
    dec.advance_frame(lambda f: None)
    with pytest.raises(ValueError):
        dec.decode_all()
    dec.reset()
    assert len(dec.decode_all()) == N_FRAMES


def test_drop_frames_and_reset(encoded):
    info, packets = split_packets(encoded)
    data = synth.container(W, H, info["qtables"],
                           [packets[0], (1, b""), (1, b""), packets[1]])
    dec = Decoder(io.BytesIO(data), device="cpu")
    emitted = []
    results = [dec.advance_frame(lambda f: emitted.append(f.plane_y.copy()))
               for _ in range(4)]
    # 4 frame slots: I, drop, drop, P -> only 2 callbacks (quirk Q8)
    assert results == [True] * 4 and len(emitted) == 2
    assert dec.advance_frame(lambda f: emitted.append(f.plane_y)) is False
    assert dec.advance_frame(lambda f: None) is False  # stays EOF
    dec.reset()
    again = []
    assert dec.advance_frame(lambda f: again.append(f.plane_y.copy()))
    np.testing.assert_array_equal(again[0], emitted[0])
    n, ry, _, _, _ = runtime.ref_decode(data)
    assert n == 2
    np.testing.assert_array_equal(ry[0], emitted[0])
    np.testing.assert_array_equal(ry[1], emitted[1])


def test_advance_delta_pacing():
    data = synth.random_stream(W, H, 3, seed=4)
    dec = Decoder(io.BytesIO(data), device="cpu")
    count = [0]

    def cb(f):
        count[0] += 1

    assert dec.advance_delta(1.0 / 60.0, cb)  # half a frame: nothing yet
    assert count[0] == 0
    assert dec.advance_delta(1.0 / 60.0, cb)  # a whole frame accumulated
    assert count[0] == 1
    assert dec.advance_delta(2.0 / 30.0, cb)  # two frames
    assert count[0] == 3


def test_unknown_packet_skipped(encoded):
    _, off = runtime.parse_header(encoded)
    junk = struct.pack("<BI", 99, 7) + b"JUNKDAT"
    spliced = encoded[:off] + junk + encoded[off:]
    dec = Decoder(io.BytesIO(spliced), device="cpu")
    emitted = []
    assert dec.advance_frame(lambda f: emitted.append(f))
    assert len(emitted) == 1
    _, ry, *_ = runtime.ref_decode(spliced)
    np.testing.assert_array_equal(emitted[0].plane_y, ry[0])


def test_foreign_multi_qtable_stream(encoded):
    """A header with more q-tables than an encoder writes decodes alike."""
    info, packets = split_packets(encoded)
    extra = np.arange(1, 129, 2).reshape(1, 64)
    qtables = np.concatenate([info["qtables"], extra, extra])
    foreign = synth.container(W, H, qtables, packets)
    dec = Decoder(io.BytesIO(foreign), device="cpu")
    assert dec.qtables.shape == (6, 64)
    got = [f.plane_y for f in _decode(dec)]
    n, ry, *_ = runtime.ref_decode(foreign)
    assert n == len(got) == N_FRAMES
    np.testing.assert_array_equal(np.stack(got), ry)
    ys, _, _ = pfv_torch.decode_video_yuv(foreign, device="cpu")
    np.testing.assert_array_equal(ys.numpy(), ry)


def test_stream_embedded_at_offset(encoded):
    junk = b"\x13" * 777
    reader = io.BytesIO(junk + encoded)
    reader.seek(len(junk))
    frames = Decoder(reader, device="cpu").decode_all()
    assert len(frames) == N_FRAMES
    reader.seek(len(junk))
    dec2 = Decoder(reader, device="cpu")
    got = _decode(dec2)
    assert len(got) == N_FRAMES
    for a, b in zip(frames, got):
        np.testing.assert_array_equal(a.plane_y, b.plane_y)
    dec2.reset()  # back to the first packet of the embedded stream
    assert dec2.advance_frame(lambda f: None) is True


def test_error_taxonomy(encoded):
    with pytest.raises(FormatError):
        Decoder(io.BytesIO(b"NOTPFV\0\0" + encoded[8:]), device="cpu")
    with pytest.raises(VersionError):
        Decoder(io.BytesIO(encoded[:8] + b"\xff\x00\x00\x00" + encoded[12:]),
                device="cpu")
    with pytest.raises(StreamIOError):
        Decoder(io.BytesIO(encoded[:10]), device="cpu")  # truncated header
    for cls in (FormatError, VersionError, StreamIOError):
        assert issubclass(cls, DecodeError)
    assert issubclass(StreamIOError, EOFError)
    dec = Decoder(io.BytesIO(encoded[:-30]), device="cpu")
    with pytest.raises(StreamIOError):
        _decode(dec)
    assert (pfv_torch.Decoder, pfv_torch.DecodeError, pfv_torch.CODEC_VERSION) == (
        Decoder, DecodeError, 211)


def _small_clip():
    return synth.random_stream(64, 48, 4, seed=40)


def test_fuzz_bitflips_never_crash():
    """Single-byte corruptions either decode, equal to the scalar decoder
    wherever it decodes too, or raise cleanly."""
    data = bytearray(_small_clip())
    rng = np.random.default_rng(40)
    outcomes = {"ok": 0, "error": 0}
    for _ in range(200):
        pos = int(rng.integers(0, len(data)))
        old = data[pos]
        data[pos] = int(rng.integers(0, 256))
        blob = bytes(data)
        try:
            got = _decode(Decoder(io.BytesIO(blob), device="cpu"))
            outcomes["ok"] += 1
        except (DecodeError, ValueError, EOFError):
            outcomes["error"] += 1
            got = None
        finally:
            data[pos] = old
        if got is not None:
            try:
                n, ry, ru, rv, _ = runtime.ref_decode(blob)
            except ValueError:
                continue
            assert n == len(got)
            for i, f in enumerate(got):
                for p, r in zip(_planes(f), (ry[i], ru[i], rv[i])):
                    assert np.array_equal(p, r)
    assert outcomes["ok"] + outcomes["error"] == 200
    assert outcomes["ok"] > 0  # many flips land in coefficients and decode


def test_fuzz_truncations_never_crash():
    data = _small_clip()
    for cut in range(1, len(data), max(1, len(data) // 60)):
        try:
            _decode(Decoder(io.BytesIO(data[:cut]), device="cpu"))
        except (DecodeError, ValueError, EOFError):
            pass


def test_hostile_oob_motion_vector_rejected():
    """A motion vector whose window leaves the padded plane is refused."""
    g = pfv_torch.frame.geometry(64, 48)
    iframe = runtime.encode_iframe_payload(np.zeros((g.nb, 256), np.int16), (0, 1, 1))
    mvx = np.zeros(g.nb, dtype=np.int8)
    mvx[0] = -64  # block 0 sits at the origin: the window starts at x=-64
    pframe = runtime.encode_pframe_payload(
        np.zeros((g.nb, 256), np.int16), mvx, np.zeros(g.nb, np.int8),
        np.zeros(g.nb, np.uint8), (2, 3, 3))
    data = synth.container(64, 48, np.ones((4, 64), np.int32),
                           [(1, iframe), (2, pframe)])
    with pytest.raises(ValueError):
        runtime.ref_decode(data, emit=False)
    with pytest.raises(StreamIOError, match="motion vector out of bounds"):
        _decode(Decoder(io.BytesIO(data), device="cpu"))
    with pytest.raises(ValueError, match="motion vector out of bounds"):
        pfv_torch.decode_video_yuv(data, device="cpu")


def test_video_frame_matches_jax():
    rng = np.random.default_rng(11)
    rgb = rng.integers(0, 256, size=(38, 50, 3)).astype(np.uint8)
    got, want = pfv_torch.VideoFrame.from_rgb(rgb), JaxVideoFrame.from_rgb(rgb)
    for p, q in zip(_planes(got), _planes(want)):
        assert p.dtype == np.uint8 and np.array_equal(p, q)
    assert np.array_equal(got.to_rgb(), want.to_rgb())
    for make in ("new", "new_padded"):
        a = getattr(pfv_torch.VideoFrame, make)(50, 38)
        b = getattr(JaxVideoFrame, make)(50, 38)
        for p, q in zip(_planes(a), _planes(b)):
            assert np.array_equal(p, q)
    full = [rng.integers(0, 256, size=(38, 50)).astype(np.uint8) for _ in range(3)]
    for p, q in zip(_planes(pfv_torch.VideoFrame.from_planes(50, 38, *full)),
                    _planes(JaxVideoFrame.from_planes(50, 38, *full))):
        assert np.array_equal(p, q)
    with pytest.raises(ValueError):
        pfv_torch.VideoFrame.new(51, 38)
