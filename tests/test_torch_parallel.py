"""pfv_torch.parallel (decode_stream_batch, decode_video_gops, split_gop_runs,
skip_pframe_packet) and encoding.encode_video_gops over lists of "cpu"
devices, against the scalar reference decoder, `pfv_torch.encode_video`, and
the JAX package on its 8 virtual CPU devices (its units path forced as
tests/test_parallel_fast.py forces it, Pallas in interpret mode). Integer
results are exact (tolerance 0); mean_luma is within 0.5 of numpy's mean,
the reference test's bound.

Where the reference is at fault the tests hold the port to the stream: its
`split_gop_runs` counts a drop frame (an I-packet without payload) as a
frame though it makes none, and then refuses the runs."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import pfv_torch
from pfv_torch import runtime, synth
from pfv_torch.dec import split_packets
from pfv_torch.parallel import (decode_stream_batch, decode_video_gops,
                                skip_pframe_packet, split_gop_runs, stream_devices)
from pfv_torch.parallel.devices import each_device
from pfv_tpu.parallel import gops as jgops
from pfv_tpu.parallel import streams as jstreams

W, H = 128, 48  # the geometry of tests/test_parallel_fast.py


def _force_units(monkeypatch):
    from pfv_tpu import dataloader

    for k, v in {"PFV_STEP": "1", "PFV_SEQ": "1", "PFV_UNITS": "1",
                 "PFV_GOP_CONCURRENT": "0"}.items():
        monkeypatch.setenv(k, v)
    dataloader._make_decoder.cache_clear()


def ref_planes(data):
    return runtime.ref_decode(data)[1:4]


def with_extra_packets(data: bytes, at: int = 2) -> bytes:
    """`data` with a drop frame and an unknown packet after packet `at`."""
    info, packets = split_packets(data)
    packets = packets[:at + 1] + [(1, b""), (7, b"\x01\x02\x03")] + packets[at + 1:]
    return synth.container(info["width"], info["height"], info["qtables"], packets)


def uneven_gops() -> bytes:
    """128x48, GOPs of 5, 1, 3, 3 and 2 frames."""
    parts = [split_packets(synth.random_stream(W, H, f, seed=20 + f, keyframes=k))
             for f, k in ((6, 5), (8, 3))]
    return synth.container(W, H, parts[0][0]["qtables"], parts[0][1] + parts[1][1])


@pytest.fixture(scope="module")
def stream():
    return synth.random_stream(W, H, 11, seed=2, keyframes=2)


@pytest.fixture(scope="module")
def batch():
    """8 streams of 5 frames on one set of q-tables (the first's)."""
    parts = [split_packets(synth.random_stream(W, H, 5, seed=30 + s, keyframes=3))
             for s in range(8)]
    return [synth.container(W, H, parts[0][0]["qtables"], packets) for _, packets in parts]


@pytest.mark.parametrize("size", [(W, H), (64, 48), (136, 90), (4112, 16), (18, 10)])
def test_skip_packet_equals_the_reference_bytes(size):
    assert skip_pframe_packet(*size) == jgops.skip_pframe_packet(*size)


def test_skip_packet_decodes_as_a_copy(stream):
    padded = stream[:-5] + skip_pframe_packet(W, H) * 2 + stream[-5:]
    n, y, u, v, _ = runtime.ref_decode(padded)
    assert n == 13
    for p in (y, u, v):
        assert (p[11] == p[10]).all() and (p[12] == p[10]).all()


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("which", ["even", "uneven"])
def test_split_gop_runs_equals_the_reference_bytes(stream, which, n):
    data = stream if which == "even" else uneven_gops()
    n = min(n, 5) if which == "uneven" else n
    subs, counts = split_gop_runs(data, n)
    want_subs, want_counts = jgops.split_gop_runs(data, n)
    assert subs == want_subs and counts == want_counts
    assert sum(counts) == runtime.count_frames(data)
    assert {runtime.count_frames(s) for s in subs} == {max(counts)}


def test_split_gop_runs_errors_as_the_reference(stream):
    info, packets = split_packets(stream)
    first_p = synth.container(W, H, info["qtables"], packets[1:])
    for split in (split_gop_runs, jgops.split_gop_runs):
        with pytest.raises(ValueError, match="must start with an I-frame"):
            split(first_p, 2)
        with pytest.raises(ValueError, match="6 GOPs < 7 devices"):
            split(stream, 7)


def test_split_counts_frames_not_drop_packets():
    """The port counts what `runtime.count_frames` counts; the reference
    counts the drop frame too and hands out runs of unequal length."""
    data = with_extra_packets(synth.random_stream(64, 48, 8, seed=5, keyframes=2))
    subs, counts = split_gop_runs(data, 2)
    assert counts == [4, 4] and [runtime.count_frames(s) for s in subs] == [4, 4]
    assert sum(len(split_packets(s)[1]) for s in subs) == 10  # none lost
    ref_subs, ref_counts = jgops.split_gop_runs(data, 2)
    assert ref_counts == [5, 4]
    assert [runtime.count_frames(s) for s in ref_subs] == [4, 5]


@pytest.mark.parametrize("want", ["yuv", "rgb", "rgba"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_decode_video_gops_equals_reference(stream, n, want):
    got = decode_video_gops(stream, ["cpu"] * n, want=want)
    if want == "yuv":
        for p, r in zip(got, ref_planes(stream)):
            assert np.array_equal(p.numpy(), r)
    elif want == "rgb":
        assert torch.equal(got, pfv_torch.decode_video_rgb(stream, device="cpu"))
    else:
        assert got.dtype == torch.uint32
        assert torch.equal(got.view(torch.int32),
                           pfv_torch.decode_video_rgba(stream, device="cpu").view(torch.int32))


def test_decode_video_gops_uneven_runs_and_wide_stream():
    for data, n in ((uneven_gops(), 3), (synth.edge_stream("4112x16"), 2)):
        for p, r in zip(decode_video_gops(data, ["cpu"] * n), ref_planes(data)):
            assert np.array_equal(p.numpy(), r)


def test_gop_split_decodes_a_stream_with_a_drop_frame(monkeypatch):
    """Exact through the port; the JAX package refuses its own runs."""
    data = with_extra_packets(synth.random_stream(W, H, 8, seed=5, keyframes=2))
    for n in (2, 3):
        for p, r in zip(decode_video_gops(data, ["cpu"] * n), ref_planes(data)):
            assert np.array_equal(p.numpy(), r)
    _force_units(monkeypatch)
    with pytest.raises(ValueError):
        jgops.decode_video_gops_packed(data, mesh=jstreams.make_stream_mesh(2, axis="gops"))


def test_decode_video_gops_matches_jax(stream, monkeypatch):
    _force_units(monkeypatch)
    mesh = jstreams.make_stream_mesh(4, axis="gops")
    want = jgops.decode_video_gops_packed(stream, mesh=mesh, want="yuv")
    got = decode_video_gops(stream, ["cpu"] * 4, num_threads=2)
    for p, j, r in zip(got, want, ref_planes(stream)):
        assert np.array_equal(p.numpy(), np.asarray(j)) and np.array_equal(p.numpy(), r)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_stream_batch_equals_reference(batch, n):
    shards, mean = decode_stream_batch(batch, ["cpu"] * n)
    assert len(shards) == n and mean.dtype == torch.float32
    per = len(batch) // n
    ys = []
    for d, shard in enumerate(shards):
        assert all(p.shape[0] == per for p in shard)
        for s in range(per):
            for p, r in zip(shard, ref_planes(batch[d * per + s])):
                assert np.array_equal(p[s].numpy(), r)
        ys.append(shard[0].numpy())
    assert abs(float(mean) - np.concatenate(ys).astype(np.float64).mean()) < 0.5


@pytest.mark.parametrize("want", ["rgb", "rgba"])
def test_stream_batch_rgb_forms(batch, want):
    shards, mean = decode_stream_batch(batch[:4], ["cpu"] * 2, want=want)
    one = {"rgb": pfv_torch.decode_video_rgb, "rgba": pfv_torch.decode_video_rgba}[want]
    for d, shard in enumerate(shards):
        for s in range(2):
            ref = one(batch[2 * d + s], device="cpu")
            assert shard[s].dtype == ref.dtype
            assert torch.equal(shard[s].view(torch.uint8), ref.view(torch.uint8))
    values = np.concatenate([
        (s.view(torch.int32).numpy().view(np.uint32) if want == "rgba" else s.numpy())
        .reshape(-1) for s in shards])
    assert abs(float(mean) / values.astype(np.float64).mean() - 1) < 1e-5


def test_stream_batch_matches_jax(batch, monkeypatch):
    """8 streams on 8 devices and on 4: the JAX package's sharded decode of
    the same bytes."""
    _force_units(monkeypatch)
    for n in (8, 4):
        (jy, ju, jv), jmean = jstreams.decode_stream_batch_packed(
            batch, jstreams.make_stream_mesh(n), want="yuv")
        shards, mean = decode_stream_batch(batch, ["cpu"] * n)
        for got, want in zip(zip(*shards), (jy, ju, jv)):
            assert np.array_equal(torch.cat(got).numpy(), np.asarray(want))
        assert abs(float(mean) - np.asarray(jy).astype(np.float64).mean()) < 0.5
        assert abs(float(mean) - float(jmean)) < 0.5


def test_stream_batch_errors(batch):
    with pytest.raises(ValueError, match="not divisible"):
        decode_stream_batch(batch[:3], ["cpu"] * 2)
    other = synth.random_stream(64, 48, 5, seed=1, keyframes=3)
    with pytest.raises(ValueError, match="share geometry"):
        decode_stream_batch([batch[0], other], ["cpu"] * 2)
    info, packets = split_packets(batch[1])
    with pytest.raises(ValueError, match="share q-tables"):
        decode_stream_batch([batch[0], synth.container(W, H, info["qtables"] + 1, packets)],
                            ["cpu"])
    with pytest.raises(ValueError, match="frame count"):
        decode_stream_batch([batch[0], synth.container(W, H, info["qtables"], packets[:3])],
                            ["cpu"])
    with pytest.raises(ValueError, match="unknown output"):
        decode_stream_batch(batch[:2], ["cpu"], want="checksums")
    with pytest.raises(ValueError, match="empty"):
        decode_stream_batch(batch[:2], [])


def test_launch_counts_from_many_threads_lose_nothing():
    """The wrappers of several device threads count into one attribute."""
    import sys
    import threading
    import types

    from pfv_torch.kernels import build

    wrapper, threads, each = types.SimpleNamespace(launches=0), 16, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [build.count(wrapper, 1 + k % 2)
                                                    for k in range(each)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == threads * each * 3 // 2


def test_a_thread_s_exception_is_raised_by_the_caller():
    def work(k, dev):
        if k == 1:
            raise KeyError("second entry")
        return k

    with pytest.raises(KeyError, match="second entry"):
        each_device([torch.device("cpu")] * 3, work)
    assert each_device([torch.device("cpu")] * 3, lambda k, dev: (k, str(dev))) == [
        (0, "cpu"), (1, "cpu"), (2, "cpu")]


def test_no_card_no_fallback(stream, batch):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream_devices()
    ys, us, vs = (np.zeros((2, *s), np.uint8) for s in ((48, 64), (24, 32), (24, 32)))
    for call in (lambda: decode_stream_batch(batch), lambda: decode_video_gops(stream),
                 lambda: decode_stream_batch(batch, ["cuda:0"]),
                 lambda: pfv_torch.encode_video_gops(ys, us, vs, 30, 3, 1),
                 lambda: pfv_torch.encode_video_gops(ys, us, vs, 30, 3, 1, ["cuda"])):
        with pytest.raises((RuntimeError, AssertionError)):
            call()


# -- encode_video_gops ----------------------------------------------------

MASKS = {
    "every 2": 2,
    "every 4": 4,
    "one GOP": 100,
    "uneven": [1, 0, 0, 0, 0, 1, 1, 0, 1],
    "all keyframes": 1,
}


@pytest.fixture(scope="module")
def source():
    return tuple(map(np.stack, zip(*[synth.synth_yuv_frame(t, 64, 48) for t in range(9)])))


@pytest.mark.parametrize("n", [1, 2, 3, 16])
@pytest.mark.parametrize("mask", list(MASKS))
def test_encode_video_gops_equals_encode_video(source, mask, n):
    want = pfv_torch.encode_video(*source, 30, 3, MASKS[mask], device="cpu")
    got = pfv_torch.encode_video_gops(*source, 30, 3, MASKS[mask], devices=["cpu"] * n)
    assert got == want


def test_encode_video_gops_matches_jax(source):
    from pfv_tpu.encoding import encode_video_gops as jax_encode_video_gops

    planes = [p[:5] for p in source]
    want = jax_encode_video_gops(*planes, 24, 4, keyframes=2)
    assert pfv_torch.encode_video_gops(*planes, 24, 4, 2, devices=["cpu"] * 2) == want


def test_encode_video_gops_errors(source):
    y, u, v = source
    with pytest.raises(ValueError, match="must be even"):
        pfv_torch.encode_video_gops(y[:, :47], u, v, 30, 3, devices=["cpu"])
    with pytest.raises(ValueError, match="first frame must be a keyframe"):
        pfv_torch.encode_video_gops(y, u, v, 30, 3, [0] + [1] * 8, devices=["cpu"])
    with pytest.raises(ValueError, match="chroma planes"):
        pfv_torch.encode_video_gops(y, u[:, :20], v, 30, 3, devices=["cpu"])
