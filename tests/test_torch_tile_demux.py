"""The tile demux's persistent context (`runtime.demux_file_sparse_tiles`
over `native/pfv_tile_demux.cpp`) against the library's per-call entry
`pfv_demux_file_sparse_tiles`, which stays in the library, unchanged, as
the oracle.

The streams: the repository's test clip, a random stream with a drop
frame, the 512x384 corpus, a 1080p clip from the benchmark's stream writer
and the densest units the format encodes, each at 1, 2 and 8 workers; a
truncated payload, a motion vector out of bounds and a truncated file,
which raise as the oracle does; the splice's guard; four threads
demuxing at once; a large call, a small one and the large one again, the
repeat growing nothing; and a call after `release_demux_memory()` and in
a forked child.

No stream passes the per-frame unit bound (69 units a payload byte): the
densest payload the encoder writes, every coefficient 16383 (129 units
each; 16384 and up are refused), holds 61 units a byte."""

from __future__ import annotations

import ctypes
import json
import os
import sys
import threading
import time

import numpy as np
import pytest

from pfv_torch import dataloader as tdl
from pfv_torch import runtime as trt
from pfv_torch import synth
from pfv_torch.dec import split_packets
from pfv_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROW, REUSED = "decode.demux_grow_bytes", "decode.demux_calls_reused"


def oracle(data: bytes, tile_tables, chunk: int = 128, num_threads: int = 0):
    """The per-call entry, wrapped as `demux_file_sparse_tiles` wrapped it
    before the context: a worst-case units array, the same checks."""
    lib = trt.get_lib()
    info, off = trt.parse_header(data)
    ly, lc, yb, cb = trt._plane_dims(info)
    total_blocks = yb + 2 * cb
    stripe_of_b, lanebase_of_b, r_of_zz, gch = tile_tables
    buf = np.frombuffer(data, dtype=np.uint8)
    nf = lib.pfv_count_frames(buf, len(data), off)
    if nf < 0:
        raise ValueError(f"corrupt packet stream (code {nf})")
    cap_chunks = (min(69 * len(data), 129 * total_blocks * 256 * nf) // chunk
                  + nf * (gch + 1) + 64)
    bh = np.empty((nf, total_blocks), dtype=np.uint16)
    ftype = np.empty(nf, dtype=np.uint8)
    qidx = np.empty((nf, 3), dtype=np.uint8)
    units = np.empty((cap_chunks, chunk), dtype=np.uint32)
    coff = np.empty(nf * gch + 1, dtype=np.int32)
    bounds = trt._mv_bounds_packed(ly, lc)
    mv_absmax = np.zeros(1, dtype=np.int16)
    tables = [np.ascontiguousarray(t, dtype=np.int32)
              for t in (stripe_of_b, lanebase_of_b, r_of_zz)]
    vp = ctypes.c_void_p
    nchunks = lib.pfv_demux_file_sparse_tiles(
        buf, len(data), off, total_blocks, nf, bh.reshape(-1),
        bounds.ctypes.data_as(vp), ftype, qidx.reshape(-1),
        units.ctypes.data_as(vp), cap_chunks, coff, chunk,
        mv_absmax.ctypes.data_as(vp), num_threads, *tables, gch)
    if nchunks == -8:
        raise ValueError("corrupt P-frame payload: motion vector out of bounds")
    if nchunks < 0:
        raise ValueError(f"tile demux failed (code {nchunks})")
    info["yb"], info["cb"], info["total_blocks"] = yb, cb, total_blocks
    info["mv_absmax"] = int(mv_absmax[0])
    info["unit_layout"] = "tiles"
    return info, units[:nchunks], coff, bh, ftype, qidx


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return a == b


def _tables(data: bytes):
    info, _ = trt.parse_header(data)
    return tdl.tile_tables(tdl.geometry(info["width"], info["height"]))


def _benchmark_clip(frames: int) -> bytes:
    """A 1080p clip from the benchmark's stream writer at its 1080p decode
    traffic's statistics, a keyframe every 4 frames."""
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    try:
        from reference.streams import Clip
        from reference.tables import q_tables
    finally:
        sys.path.remove(os.path.join(ROOT, "benchmark"))
    with open(os.path.join(ROOT, "benchmark/traffic/decode_clips128.json")) as f:
        stats = json.load(f)["stream"]
    return Clip(1920, 1080, 60, frames, 4, q_tables(2), stats, 2**31 + 77, 0, "cpu").write()


@pytest.fixture(scope="module")
def streams():
    with open(os.path.join(ROOT, "tests/data/clip_136x90_q3_8f.pfv"), "rb") as f:
        clip = f.read()
    with open(os.path.join(ROOT, ".bench_cache/corpus_512x384_q2_161f.pfv"), "rb") as f:
        corpus = f.read()
    info, packets = split_packets(synth.random_stream(96, 64, 6, seed=4, keyframes=4))
    dropped = synth.container(96, 64, info["qtables"], packets[:2] + [(1, b"")] + packets[2:])
    nb = tdl.geometry(96, 64).nb
    dense = trt.encode_iframe_payload(np.full((nb, 256), 16383, np.int16), (0, 1, 1))
    densest = synth.container(96, 64, info["qtables"], packets[:3] + [(1, dense)] + packets[3:])
    return {"136x90": clip, "96x64_drop": dropped, "512x384": corpus,
            "1920x1080": _benchmark_clip(6), "96x64_densest": densest}


@pytest.mark.parametrize("num_threads", [1, 2, 8])
@pytest.mark.parametrize("name", ["136x90", "96x64_drop", "512x384", "1920x1080",
                                  "96x64_densest"])
def test_the_context_gives_the_oracle_s_arrays(streams, name, num_threads):
    data = streams[name]
    want = oracle(data, _tables(data), num_threads=num_threads)
    for _ in range(2):  # a context's first call, then one it served before
        got = trt.demux_file_sparse_tiles(data, _tables(data), num_threads=num_threads)
        assert _equal(got, want)
    assert got[1].base is None and got[1].flags.c_contiguous  # exactly the rows, owned


def _bad_streams():
    """{kind: stream}: each broken in its fourth frame of six."""
    w, h = 96, 64
    info, packets = split_packets(synth.random_stream(w, h, 6, seed=9, keyframes=4))
    nb = tdl.geometry(w, h).nb
    assert packets[3][0] == 2
    truncated = packets[:3] + [(2, packets[3][1][: len(packets[3][1]) // 2])] + packets[4:]
    mvx = np.zeros(nb, np.int8)
    mvx[0] = -5  # block 0 sits at x = 0: its window would leave the plane
    zero = np.zeros(nb, np.int8)
    bad_mv = trt.encode_pframe_payload(np.zeros((nb, 256), np.int16), mvx, zero,
                                       np.zeros(nb, np.uint8), (2, 3, 3))
    qt = info["qtables"]
    return {
        "truncated_payload": synth.container(w, h, qt, truncated),
        "vector_out_of_bounds": synth.container(w, h, qt, packets[:3] + [(2, bad_mv)]
                                                + packets[4:]),
        "truncated_file": synth.container(w, h, qt, packets)[:-40],
    }


@pytest.mark.parametrize("num_threads", [1, 2, 8])
@pytest.mark.parametrize("kind", ["truncated_payload", "vector_out_of_bounds",
                                  "truncated_file"])
def test_a_bad_stream_raises_as_the_oracle_does(streams, kind, num_threads):
    data = _bad_streams()[kind]
    tables = _tables(data)
    with pytest.raises(ValueError) as want:
        oracle(data, tables, num_threads=num_threads)
    with pytest.raises(ValueError) as got:
        trt.demux_file_sparse_tiles(data, tables, num_threads=num_threads)
    assert str(got.value) == str(want.value)
    expect = {"truncated_payload": "code -", "vector_out_of_bounds": "out of bounds",
              "truncated_file": "corrupt packet stream"}
    assert expect[kind] in str(got.value)
    good = streams["96x64_drop"]  # the context serves the next call as before
    assert _equal(trt.demux_file_sparse_tiles(good, _tables(good), num_threads=num_threads),
                  oracle(good, _tables(good), num_threads=num_threads))


def test_the_splice_writes_only_the_count_the_decode_returned(streams):
    data = streams["136x90"]
    info, off = trt.parse_header(data)
    ly, lc, yb, cb = trt._plane_dims(info)
    nb = yb + 2 * cb
    stripe_of_b, lanebase_of_b, r_of_zz, gch = _tables(data)
    nf = trt.count_frames(data)
    lib = trt.get_lib()
    ctx = lib.pfv_tile_demux_new(2)
    try:
        coff = np.empty(nf * gch + 1, np.int32)
        units = np.empty((0, 128), np.uint32)
        assert lib.pfv_tile_demux_splice(ctx, units.reshape(-1), 0, coff) == -6  # no decode
        grown = ctypes.c_int64(0)
        n = lib.pfv_tile_demux_decode(
            ctx, np.frombuffer(data, np.uint8), len(data), off, nb, nf,
            np.empty(nf * nb, np.uint16), trt._mv_bounds_packed(ly, lc),
            np.empty(nf, np.uint8), np.empty(nf * 3, np.uint8), 128, np.zeros(1, np.int16),
            *(np.ascontiguousarray(t, np.int32) for t in (stripe_of_b, lanebase_of_b, r_of_zz)),
            gch, ctypes.byref(grown))
        assert n > 0 and grown.value > 0
        units = np.empty((n, 128), np.uint32)
        assert lib.pfv_tile_demux_splice(ctx, units.reshape(-1), n - 1, coff) == -6
        assert lib.pfv_tile_demux_splice(ctx, units.reshape(-1), n, coff) == 0
        assert coff[-1] == n
        assert lib.pfv_tile_demux_splice(ctx, units.reshape(-1), n, coff) == -6  # spent
    finally:
        lib.pfv_tile_demux_free(ctx)


def test_four_threads_at_once_each_get_the_oracle_s_output(streams):
    names = ["136x90", "96x64_drop", "512x384", "1920x1080"]
    want = {n: oracle(streams[n], _tables(streams[n])) for n in names}
    ok = {n: [] for n in names}
    start = threading.Barrier(len(names))

    def work(name):
        start.wait(timeout=60)
        for _ in range(6):
            got = trt.demux_file_sparse_tiles(streams[name], _tables(streams[name]))
            ok[name].append(_equal(got, want[name]))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(n,)) for n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert ok == {n: [True] * 6 for n in names}


def _counted(tmp_path, calls):
    """Each call's (result, grown bytes, reused) under a profiler session."""
    out = []
    with profiling.device_trace(str(tmp_path)):
        for call in calls:
            before = profiling.counters()
            res = call()
            after = profiling.counters()
            out.append((res, after.get(GROW, 0) - before.get(GROW, 0),
                        after.get(REUSED, 0) - before.get(REUSED, 0)))
    return out


def test_a_repeated_call_reuses_what_the_first_grew(streams, tmp_path):
    large, small = streams["1920x1080"], streams["136x90"]
    trt.release_demux_memory()

    def call(data):
        return lambda: trt.demux_file_sparse_tiles(data, _tables(data), num_threads=3)

    (a, grown_a, reused_a), (b, _, _), (a2, grown_a2, reused_a2) = _counted(
        tmp_path, [call(large), call(small), call(large)])
    assert grown_a > 0 and reused_a == 0
    assert grown_a2 == 0 and reused_a2 == 1
    assert _equal(a, a2) and _equal(a, oracle(large, _tables(large)))
    assert _equal(b, oracle(small, _tables(small)))
    assert a[1] is not a2[1] and not np.shares_memory(a[1], a2[1])


def test_after_release_the_next_call_decodes(streams, tmp_path):
    data = streams["512x384"]
    want = oracle(data, _tables(data))
    assert _equal(trt.demux_file_sparse_tiles(data, _tables(data)), want)
    trt.release_demux_memory()
    assert not trt._contexts.idle
    [(got, grown, reused)] = _counted(
        tmp_path, [lambda: trt.demux_file_sparse_tiles(data, _tables(data))])
    assert _equal(got, want) and grown > 0 and reused == 0


def test_a_forked_child_demuxes_with_workers_of_its_own(streams):
    data = streams["512x384"]
    want = oracle(data, _tables(data), num_threads=4)
    assert _equal(trt.demux_file_sparse_tiles(data, _tables(data), num_threads=4), want)
    pid = os.fork()  # the parent's context, its workers started, is inherited
    if pid == 0:
        ok = False
        try:
            got = trt.demux_file_sparse_tiles(data, _tables(data), num_threads=4)
            ok = _equal(got, want)
        finally:
            os._exit(0 if ok else 1)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            break
        time.sleep(0.05)
    else:
        os.kill(pid, 9)
        os.waitpid(pid, 0)
        pytest.fail("the forked child's demux did not finish")
    assert os.waitstatus_to_exitcode(status) == 0
