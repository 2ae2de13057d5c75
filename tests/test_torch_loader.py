"""pfv_torch.VideoDataLoader / decode_many_rgb and
dataloader.decode_video_rgb_chunks with device="cpu" (the kernels' plain
versions, no streams) against the scalar reference decoder
`runtime.ref_decode` and against the JAX package's loader and chunked decode
(run without PFV_STEP: the JAX loader does not pass the units count on).
All comparisons are exact (tolerance 0).

Streams come from pfv_torch.synth (runtime payloads, no encoder compile):
64x48, 128x48 with a keyframe every 2 frames, the 4112x16 edge stream (the
dense route), and 64x48 without its I-packet (K1 from the starting canvas);
one with a drop frame (an I-packet without payload) and an unknown packet
mid-stream; 4112-wide streams past the dense route's positions cap
(lowered here), which the loader and the chunked decode take in chunks."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import pfv_torch
from pfv_torch import dataloader as tdl
from pfv_torch import runtime, synth
from pfv_torch.dec import split_packets
from pfv_torch.ops.color import double_plane, yuv_to_rgb
from pfv_torch.utils.profiling import StageTimer


def ref_rgb(data: bytes) -> torch.Tensor:
    """The scalar decoder's frames as (F, H, W, 3) u8 RGB, chroma doubled by
    nearest neighbour."""
    y, u, v = (torch.from_numpy(p) for p in runtime.ref_decode(data)[1:4])
    h, w = y.shape[1:]
    return yuv_to_rgb(y, double_plane(u)[:, :h, :w], double_plane(v)[:, :h, :w])


def with_extra_packets(data: bytes, at: int = 2) -> bytes:
    """`data` with a drop frame and an unknown packet after packet `at`."""
    info, packets = split_packets(data)
    packets = packets[:at + 1] + [(1, b""), (7, b"\x01\x02\x03")] + packets[at + 1:]
    return synth.container(info["width"], info["height"], info["qtables"], packets)


@pytest.fixture(scope="module")
def streams():
    small = synth.random_stream(64, 48, 5, seed=1, keyframes=3)
    info, packets = split_packets(small)
    return {
        "64x48": small,
        "128x48_gop2": synth.random_stream(128, 48, 11, seed=2, keyframes=2),
        "4112x16": synth.edge_stream("4112x16"),
        "64x48_first_p": synth.container(64, 48, info["qtables"], packets[1:]),
        "64x48_drop": with_extra_packets(synth.random_stream(64, 48, 8, seed=5,
                                                             keyframes=2)),
    }


ROUTES = {"64x48": "units", "128x48_gop2": "units", "4112x16": "dense",
          "64x48_first_p": "units", "64x48_drop": "units"}


@pytest.mark.parametrize("name", list(ROUTES))
def test_loader_equals_reference_and_whole_clip_decode(streams, name):
    data = streams[name]
    assert tdl.choose_route(data).kind == ROUTES[name]
    (got,) = list(pfv_torch.VideoDataLoader([data], device="cpu"))
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert torch.equal(got, ref_rgb(data))
    assert torch.equal(got, pfv_torch.decode_video_rgb(data, device="cpu"))


def test_loader_takes_a_stream_decoded_frame_by_frame(streams, monkeypatch):
    """A stream whose geometry fails the dense gate (forced here) decodes
    frame by frame in the consumer, from the bytes the worker's upload
    hands on."""
    data = streams["4112x16"]
    monkeypatch.setattr(tdl, "dense_gate", lambda g: "forced")
    route = tdl.choose_route(data)
    assert (route.kind, route.gate, route.host) == ("frames", "forced", data)
    (got,) = list(pfv_torch.VideoDataLoader([data], device="cpu"))
    assert torch.equal(got, ref_rgb(data))
    assert torch.equal(got, pfv_torch.decode_video_rgb(data, device="cpu"))


def test_mixed_list_matches_the_jax_loader(streams, tmp_path):
    """Bytes and paths, three geometries, in order; the JAX loader on the
    same list."""
    from pfv_tpu.loader import VideoDataLoader as JaxLoader
    from pfv_tpu.loader import decode_many_rgb as jax_decode_many_rgb

    names = ["64x48", "128x48_gop2", "64x48", "64x48_drop"]
    path = tmp_path / "clip.pfv"
    path.write_bytes(streams["128x48_gop2"])
    files = [streams["64x48"], str(path), streams["64x48"], streams["64x48_drop"]]
    got = list(pfv_torch.VideoDataLoader(files, num_threads=2, prefetch=1, device="cpu"))
    want = [np.asarray(a) for a in JaxLoader(files, num_threads=2, prefetch=1)]
    assert len(got) == len(want) == len(names)
    for g, w, name in zip(got, want, names):
        assert np.array_equal(g.numpy(), w)
        assert torch.equal(g, ref_rgb(streams[name]))
    datas = [streams[n] for n in names[:2]]
    many = pfv_torch.decode_many_rgb(datas, device="cpu")
    for g, w in zip(many, jax_decode_many_rgb(datas)):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_every_route_in_one_pass(streams):
    datas = list(streams.values())
    got = pfv_torch.decode_many_rgb(datas, device="cpu")
    assert len(got) == len(datas)
    for g, d in zip(got, datas):
        assert torch.equal(g, ref_rgb(d))


@pytest.mark.parametrize("bad, error", [(b"not a stream at all, but long enough",
                                         ValueError),
                                        ("/nonexistent/clip.pfv", FileNotFoundError)])
def test_worker_error_reaches_the_consumer(streams, bad, error):
    it = iter(pfv_torch.VideoDataLoader([streams["64x48"], bad, streams["64x48"]],
                                        device="cpu"))
    assert torch.equal(next(it), ref_rgb(streams["64x48"]))
    with pytest.raises(error):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_early_exit_stops_the_worker(streams):
    pulled = []

    def files():
        for i in range(1000):
            pulled.append(i)
            yield streams["64x48"]

    before = threading.active_count()
    it = iter(pfv_torch.VideoDataLoader(files(), prefetch=2, device="cpu"))
    assert torch.equal(next(it), ref_rgb(streams["64x48"]))
    it.close()
    assert threading.active_count() == before
    # the one consumed, two waiting in the queue, one in the worker's hands
    assert len(pulled) <= 5


def test_timer_receives_both_threads_stages(streams):
    timer = StageTimer()
    datas = [streams["64x48"], streams["128x48_gop2"], streams["64x48_first_p"]]
    assert len(list(pfv_torch.VideoDataLoader(datas, device="cpu", timer=timer))) == 3
    for stage in ("read", "demux", "upload", "decode"):
        assert timer.counts[stage] == 3, stage
    assert timer.counts["wait"] == 4  # the end of the list is waited for too


def test_cuda_device_without_a_card_raises(streams):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    with pytest.raises((RuntimeError, AssertionError)):
        pfv_torch.decode_many_rgb([streams["64x48"]])
    with pytest.raises((RuntimeError, AssertionError)):
        next(tdl.decode_video_rgb_chunks(streams["64x48"]))


# -- decode_video_rgb_chunks ---------------------------------------------


@pytest.mark.parametrize("cap, starts", [(2, [0, 2, 4, 6, 8, 10]), (3, [0, 2, 4, 6, 8]),
                                         (5, [0, 4, 8]), (512, [0])])
def test_chunks_equal_reference(streams, cap, starts):
    data = streams["128x48_gop2"]
    chunks = list(tdl.decode_video_rgb_chunks(data, cap, device="cpu"))
    assert [s for s, _ in chunks] == starts
    assert all(c.shape[0] <= cap for _, c in chunks)
    assert torch.equal(torch.cat([c for _, c in chunks]), ref_rgb(data))


def test_chunks_match_the_jax_chunks(streams):
    from pfv_tpu.dataloader import decode_video_rgb_chunks as jax_chunks

    data = synth.random_stream(64, 48, 7, seed=3, keyframes=3)
    got = list(tdl.decode_video_rgb_chunks(data, 4, device="cpu"))
    want = list(jax_chunks(data, 4))
    assert [s for s, _ in got] == [s for s, _ in want] == [0, 3]
    for (_, g), (_, w) in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_cap_below_one_gop_raises_in_both(streams):
    from pfv_tpu.dataloader import decode_video_rgb_chunks as jax_chunks

    data = streams["64x48"]  # GOPs of 3 and 2 frames
    for chunks in (tdl.decode_video_rgb_chunks(data, 2, device="cpu"), jax_chunks(data, 2)):
        with pytest.raises(ValueError, match="exceeds max_frames_per_chunk=2"):
            next(chunks)


def test_chunks_need_a_leading_iframe_in_both(streams):
    from pfv_tpu.dataloader import decode_video_rgb_chunks as jax_chunks

    data = streams["64x48_first_p"]
    for chunks in (tdl.decode_video_rgb_chunks(data, 8, device="cpu"), jax_chunks(data, 8)):
        with pytest.raises(ValueError, match="must start with an I-frame"):
            next(chunks)


@pytest.mark.parametrize("cap", [2, 3, 8])
def test_chunks_keep_drop_frames_and_unknown_packets(streams, cap):
    """A drop frame and an unknown packet start no GOP, make no frame and
    stay with the run they lie in."""
    data = streams["64x48_drop"]
    chunks = list(tdl.chunk_streams(data, cap))
    assert [s for s, _ in chunks] == list(range(0, 8, 2 * (cap // 2)))
    assert sum(runtime.count_frames(c) for _, c in chunks) == 8
    assert sum(len(split_packets(c)[1]) for _, c in chunks) == 10
    got = torch.cat([c for _, c in tdl.decode_video_rgb_chunks(data, cap, device="cpu")])
    assert torch.equal(got, ref_rgb(data))


def test_a_clip_too_long_for_its_route_passes_it_in_chunks(streams, monkeypatch):
    """The positions' limit at a small size: with it lowered to 4 frames the
    whole 4112x16 clip (8 frames, a keyframe every 4) no longer fits the GOP
    route and takes the dense route in two chunks of one GOP; so does each
    of `chunk_streams`' runs."""
    data = streams["4112x16"]
    row_span = tdl.pstep_tables(tdl.geometry(4112, 16))[2]
    monkeypatch.setattr(tdl, "MAX_POSITIONS", 5 * 64 * row_span)
    whole = tdl.choose_route(data)
    assert (whole.kind, whole.gate, len(whole.host)) == ("dense", None, 2)
    kinds = [tdl.choose_route(c).kind for _, c in tdl.chunk_streams(data, 4)]
    assert kinds == ["dense", "dense"]
    got = torch.cat([c for _, c in tdl.decode_video_rgb_chunks(data, 4, device="cpu")])
    assert torch.equal(got, ref_rgb(data))
    assert torch.equal(pfv_torch.decode_video_rgb(data, device="cpu"), got)


QIDX = [(0, 1, 2), (3, 2, 1), (1, 3, 0), (2, 0, 3), (0, 0, 1)]
CHUNKED = {
    # name: (w, h, frames, keyframe interval, frames per chunk, leading P)
    "4112x16_cut_in_gop": (4112, 16, 9, 4, 3, False),
    "4112x32_one_key": (4112, 32, 7, 1 << 30, 2, False),
    "4112x32_first_p": (4112, 32, 6, 3, 4, True),
}


@pytest.mark.parametrize("name", list(CHUNKED))
def test_loader_and_chunks_take_the_chunked_dense_route(name, monkeypatch):
    """Streams past the positions cap, on q-table indices per frame and
    plane: the loader (the worker uploads every chunk, the consumer steps
    them in turn) and `decode_video_rgb_chunks` equal the reference."""
    w, h, f, key, per_chunk, first_p = CHUNKED[name]
    data = synth.random_stream(w, h, f + first_p, seed=f, keyframes=key, qidx=QIDX)
    if first_p:
        info, packets = split_packets(data)
        data = synth.container(w, h, info["qtables"], packets[1:])
    row_span = tdl.pstep_tables(tdl.geometry(w, h))[2]
    monkeypatch.setattr(tdl, "MAX_POSITIONS", per_chunk * 64 * row_span + 1)
    route = tdl.choose_route(data)
    assert (route.kind, len(route.host), route.leading_p) == ("dense", -(-f // per_chunk),
                                                              first_p)
    want = ref_rgb(data)
    got = list(pfv_torch.VideoDataLoader([data, streams_64x48(), data], device="cpu"))
    assert torch.equal(got[0], want) and torch.equal(got[2], want)
    if not first_p:  # the chunked decode cuts at I-packets: it needs a leading one
        chunks = list(tdl.decode_video_rgb_chunks(data, min(key, 512), device="cpu"))
        assert [s for s, _ in chunks] == list(range(0, f, min(key, 512)))
        assert torch.equal(torch.cat([c for _, c in chunks]), want)


def streams_64x48() -> bytes:
    return synth.random_stream(64, 48, 5, seed=1, keyframes=3)
