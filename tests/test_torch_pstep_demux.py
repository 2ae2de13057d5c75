"""The pstep demux's persistent context (`runtime.demux_file_sparse_pstep`
over `native/pfv_tile_demux.cpp`, behind `dataloader.demux_host_packed`)
against two oracles, per chunk, byte for byte: the library's per-call entry
`pfv_demux_file_sparse_pstep` (through `runtime.demux_file_sparse_packed`,
which stays on it) on each chunk cut out as a stream of its own, and
`dataloader.demux_host_packed` of that chunk.

The streams: 4608x256 frames from the benchmark's stream writer at its 8K
decode traffic's statistics, I- and P-frames, cut into three chunks (the
second opening with a P-frame and holding an I-frame); a 4112x32 random
stream with a drop frame and an unknown packet at a cut; the committed
corpora through the one-chunk form and the GOP route; the densest units the
format encodes; each at 1, 2 and 0 (one per hardware thread) workers. Then:
random motion vectors against the per-call entry's bounds; a truncated
payload, a motion vector out of bounds and a truncated file, which raise as
the oracles do; the splice's guard; a repeated call growing nothing, a
larger stream growing and the smaller then reusing; a call after
`release_demux_memory()` and in a forked child; two threads at once, each
with a context of its own."""

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
from pfv_torch.dec import keyframe_runs, scan_packets, split_packets
from pfv_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROW, REUSED = "decode.pstep_grow_bytes", "decode.pstep_calls_reused"
PER = {"4608x256": 3, "4112x32_drop": 3, "136x90": 3, "512x384": 0, "96x64_densest": 0}


def _geometry(data: bytes):
    info, _ = trt.parse_header(data)
    return tdl.geometry(info["width"], info["height"])


def _cut(data: bytes, per: int) -> list[bytes]:
    """The stream cut before frames per, 2*per, ... into streams of their
    own (each drop frame or unknown packet with the run it lies in)."""
    _, spans = scan_packets(data)
    frames = trt.count_frames(data)
    if per == 0 or frames <= per:
        return [data]
    return list(keyframe_runs(data, spans, list(range(0, frames, per))))


def per_call(data: bytes, per: int, num_threads: int = 0):
    """The per-call entry on each chunk: (info, deltas, vals, meta), meta
    packing its block headers, frame types and q-table indices as
    `dataloader.demux_host_packed` packs them."""
    tables = tdl.pstep_tables(_geometry(data))
    out = []
    for c in _cut(data, per):
        info, deltas, vals, bh, ftype, qidx = trt.demux_file_sparse_packed(
            c, num_threads, pstep_tables=tables)
        out.append((info, deltas, vals, tdl._pack_meta(bh, ftype, qidx)))
    return out


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return a == b


def _benchmark_clip(width: int, height: int, frames: int, keyframes: int) -> bytes:
    """A clip from the benchmark's stream writer at its 8K decode traffic's
    statistics."""
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    try:
        from reference.streams import Clip
        from reference.tables import q_tables
    finally:
        sys.path.remove(os.path.join(ROOT, "benchmark"))
    with open(os.path.join(ROOT, "benchmark/traffic/decode_clips48.json")) as f:
        stats = json.load(f)["stream"]
    return Clip(width, height, 60, frames, keyframes, q_tables(2), stats, 2**31 + 91, 0,
                "cpu").write()


def _with_extra_packets(data: bytes, at: int) -> bytes:
    """`data` with a drop frame and an unknown packet after packet `at`."""
    info, packets = split_packets(data)
    packets = packets[:at + 1] + [(1, b""), (7, b"\x01\x02\x03")] + packets[at + 1:]
    return synth.container(info["width"], info["height"], info["qtables"], packets)


@pytest.fixture(scope="module")
def streams():
    with open(os.path.join(ROOT, "tests/data/clip_136x90_q3_8f.pfv"), "rb") as f:
        clip = f.read()
    with open(os.path.join(ROOT, ".bench_cache/corpus_512x384_q2_161f.pfv"), "rb") as f:
        corpus = f.read()
    info, packets = split_packets(synth.random_stream(96, 64, 4, seed=4, keyframes=4))
    nb = tdl.geometry(96, 64).nb
    dense = trt.encode_iframe_payload(np.full((nb, 256), 16383, np.int16), (0, 1, 1))
    densest = synth.container(96, 64, info["qtables"], packets[:2] + [(1, dense)] + packets[2:])
    drop = _with_extra_packets(synth.random_stream(4112, 32, 7, seed=6, keyframes=4), 2)
    return {"4608x256": _benchmark_clip(4608, 256, 8, 5), "4112x32_drop": drop,
            "136x90": clip, "512x384": corpus, "96x64_densest": densest}


@pytest.mark.parametrize("num_threads", [1, 2, 0])
@pytest.mark.parametrize("name", list(PER))
def test_each_chunk_equals_both_oracles(streams, name, num_threads):
    data, per = streams[name], PER[name]
    want = per_call(data, per, num_threads)
    assert len(want) == {"4608x256": 3, "4112x32_drop": 3, "136x90": 3}.get(name, 1)
    for _ in range(2):  # a context's first call, then one it served before
        got = trt.demux_file_sparse_pstep(data, per, num_threads)
        assert _equal(got, want)
    assert all(a.base is None for chunk in got for a in chunk[1:])  # exact, owned
    hosts = tdl.demux_host_packed(data, num_threads, chunk_frames=per or None)
    hosts = hosts if per else [hosts]
    assert _equal(hosts, [tdl.demux_host_packed(c, num_threads) for c in _cut(data, per)])
    assert _equal(hosts, [(info, _geometry(data), *rest) for info, *rest in want])


@pytest.mark.parametrize("num_threads", [1, 2, 0])
def test_the_gop_route_demuxes_the_corpus_in_one_chunk(streams, monkeypatch, num_threads):
    data = streams["512x384"]
    monkeypatch.setattr(tdl, "failed_gate", lambda g: "forced dense")
    route = tdl.choose_route(data, num_threads)
    assert (route.kind, route.gops) == ("gops", (3, 60))
    [(info, deltas, vals, meta)] = per_call(data, 0, num_threads)
    assert _equal(route.host, (info, _geometry(data), deltas, vals, meta))


def test_the_dense_route_takes_the_chunks_of_one_call(streams, monkeypatch):
    data = streams["4608x256"]
    monkeypatch.setattr(tdl, "dense_chunk_frames", lambda g: 3)
    calls = []
    real = trt.demux_file_sparse_pstep
    monkeypatch.setattr(trt, "demux_file_sparse_pstep",
                        lambda *a: calls.append(a) or real(*a))
    route = tdl.choose_route(data)
    assert route.kind == "dense" and len(calls) == 1 and calls[0][1] == 3
    assert _equal(route.host, [tdl.demux_host_packed(c) for c in _cut(data, 3)])


def test_motion_bounds_are_the_per_call_entry_s(streams):
    """One moved block a P-frame, at random or at a plane's edge, each
    component at its bound, one past it or 0: the context accepts and
    refuses what the per-call entry does, and its arrays equal that
    entry's."""
    w, h = 4112, 48
    g = tdl.geometry(w, h)
    rng = np.random.default_rng(17)
    info, packets = split_packets(synth.random_stream(w, h, 1, seed=8))
    bounds = [b.astype(int) for b in trt._mv_bounds(*trt._plane_dims(info)[:2])]
    edges = [0, g.lyw // 16 - 1, g.yb - 1, g.yb, g.yb + g.cb - 1, g.yb + g.cb, g.nb - 1]
    refused = 0
    for case in range(48):
        mvx, mvy = np.zeros(g.nb, np.int8), np.zeros(g.nb, np.int8)
        b = edges[case % len(edges)] if case % 2 else int(rng.integers(g.nb))
        lox, hix, loy, hiy = (int(x[b]) for x in bounds)
        mvx[b], mvy[b] = (np.clip(rng.choice([lo - 1, lo, 0, hi, hi + 1]), -64, 63)
                          for lo, hi in ((lox, hix), (loy, hiy)))
        payload = trt.encode_pframe_payload(np.zeros((g.nb, 256), np.int16), mvx, mvy,
                                            np.zeros(g.nb, np.uint8), (2, 3, 3))
        data = synth.container(w, h, info["qtables"], packets + [(2, payload)])
        try:
            want = per_call(data, 0)
        except ValueError as e:
            refused += 1
            with pytest.raises(ValueError) as got:
                trt.demux_file_sparse_pstep(data)
            assert str(got.value) == str(e) and "out of bounds" in str(e)
        else:
            assert _equal(trt.demux_file_sparse_pstep(data), want)
    assert 0 < refused < 48


def _bad_streams():
    """{kind: stream}: a 4112x32 stream of six frames, each broken in its
    fourth frame."""
    w, h = 4112, 32
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


@pytest.mark.parametrize("num_threads", [1, 2, 0])
@pytest.mark.parametrize("kind", ["truncated_payload", "vector_out_of_bounds",
                                  "truncated_file"])
def test_a_bad_stream_raises_as_the_oracle_does(streams, kind, num_threads):
    data = _bad_streams()[kind]
    tables = tdl.pstep_tables(_geometry(data))
    with pytest.raises(ValueError) as want:
        if kind == "truncated_file":  # cut into chunks, the stream is no longer truncated
            trt.demux_file_sparse_packed(data, num_threads, pstep_tables=tables)
        else:
            per_call(data, 2, num_threads)
    with pytest.raises(ValueError) as got:
        trt.demux_file_sparse_pstep(data, 2, num_threads)
    with pytest.raises(ValueError) as host:
        tdl.demux_host_packed(data, num_threads, chunk_frames=2)
    assert str(got.value) == str(want.value) == str(host.value)
    expect = {"truncated_payload": "code -", "vector_out_of_bounds": "out of bounds",
              "truncated_file": "corrupt packet stream (code -4)"}
    assert expect[kind] in str(got.value)
    good = streams["4112x32_drop"]  # the context serves the next call as before
    assert _equal(trt.demux_file_sparse_pstep(good, 3, num_threads), per_call(good, 3))


def test_a_chunk_s_positions_past_int32_raise_as_the_oracle_does():
    """8192x48000: 64*row_span = 663,552,000, so three frames fit int32
    and four do not; the frames, P-packets without a payload, are refused
    only once decoded."""
    w, h = 8192, 48000
    span = 64 * tdl.pstep_row_span(tdl.geometry(w, h))
    assert 3 * span < 2**31 <= 4 * span
    data = synth.container(w, h, np.ones((1, 64), np.int32), [(2, b"")] * 4)
    with pytest.raises(ValueError) as want:
        trt.demux_file_sparse_packed(data, pstep_tables=tdl.pstep_tables(tdl.geometry(w, h)))
    with pytest.raises(ValueError) as got:
        trt.demux_file_sparse_pstep(data)
    assert str(got.value) == str(want.value)
    assert "too large for sparse flat indexing" in str(got.value)
    with pytest.raises(ValueError, match=r"sparse demux failed \(code -2\)"):
        trt.demux_file_sparse_pstep(data, 3)


def test_the_splice_writes_only_the_counts_the_decode_returned(streams):
    data = streams["4112x32_drop"]
    info, off = trt.parse_header(data)
    nb = _geometry(data).nb
    nf = trt.count_frames(data)
    assert nf == 7
    lib = trt.get_lib()
    ctx = lib.pfv_pstep_demux_new(2)
    addr = trt._addresses
    try:
        none = np.zeros(3, np.int64)
        assert lib.pfv_pstep_demux_splice(ctx, addr([]), addr([]), none, 0) == -6  # no decode
        metas = [np.empty(f * (nb + 4), np.uint16) for f in (3, 3, 1)]
        units, mvmax = np.zeros(3, np.int64), np.zeros(3, np.int16)
        grown = ctypes.c_int64(0)
        n = lib.pfv_pstep_demux_decode(
            ctx, np.frombuffer(data, np.uint8), len(data), off, info["width"], info["height"],
            nf, 3, addr(metas), units, mvmax, ctypes.byref(grown))
        assert n > 0 and grown.value > 0 and units.sum() == n and (units > 0).all()
        deltas = [np.empty(u, np.uint16) for u in units]
        vals = [np.empty(u, np.int8) for u in units]
        short = units - np.array([0, 1, 0])
        assert lib.pfv_pstep_demux_splice(ctx, addr(deltas), addr(vals), short, 3) == -6
        assert lib.pfv_pstep_demux_splice(ctx, addr(deltas), addr(vals), units, 2) == -6
        assert lib.pfv_pstep_demux_splice(ctx, addr(deltas), addr(vals), units, 3) == 0
        assert _equal([(d, v, m) for d, v, m in zip(deltas, vals, metas)],
                      [w[1:] for w in per_call(data, 3)])
        assert lib.pfv_pstep_demux_splice(ctx, addr(deltas), addr(vals), units, 3) == -6  # spent
    finally:
        lib.pfv_pstep_demux_free(ctx)


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


def test_a_repeated_call_grows_nothing_and_a_larger_one_grows(streams, tmp_path):
    large = streams["4608x256"]
    info, packets = split_packets(large)
    small = synth.container(4608, 256, info["qtables"], packets[:4])
    other = streams["136x90"]  # another frame size: other tables, the same slots
    trt.release_demux_memory()

    def call(data):
        return lambda: trt.demux_file_sparse_pstep(data, 3, num_threads=3)

    counted = _counted(tmp_path, [call(small), call(small), call(large), call(other),
                                  call(small), call(large)])
    (s1, g1, r1), (s2, g2, r2), (l1, g3, r3), (o, _, _), (s3, g5, r5), (l2, g6, r6) = counted
    assert g1 > 0 and r1 == 0
    assert g2 == 0 and r2 == 1
    assert g3 > 0 and r3 == 0
    assert (g5, r5, g6, r6) == (0, 1, 0, 1)
    assert _equal(s1, s2) and _equal(s1, s3) and _equal(s1, per_call(small, 3))
    assert _equal(l1, l2) and _equal(l1, per_call(large, 3))
    assert _equal(o, per_call(other, 3))
    assert not np.shares_memory(l1[0][1], l2[0][1])


def test_after_release_the_next_call_decodes(streams, tmp_path):
    data = streams["4112x32_drop"]
    want = per_call(data, 3)
    assert _equal(trt.demux_file_sparse_pstep(data, 3), want)
    trt.release_demux_memory()
    assert not trt._pstep_contexts.idle
    [(got, grown, reused)] = _counted(tmp_path, [lambda: trt.demux_file_sparse_pstep(data, 3)])
    assert _equal(got, want) and grown > 0 and reused == 0


def test_a_forked_child_demuxes_with_workers_of_its_own(streams):
    data = streams["4608x256"]
    want = per_call(data, 3, 4)
    assert _equal(trt.demux_file_sparse_pstep(data, 3, num_threads=4), want)
    pid = os.fork()  # the parent's context, its workers started, is inherited
    if pid == 0:
        ok = False
        try:
            ok = _equal(trt.demux_file_sparse_pstep(data, 3, num_threads=4), want)
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


def test_a_second_caller_gets_a_context_of_its_own(streams):
    data = streams["4112x32_drop"]
    want = per_call(data, 3)
    trt.release_demux_memory()
    got = []
    with trt._pstep_contexts.take(trt.get_lib(), 5) as held:
        t = threading.Thread(target=lambda: got.append(trt.demux_file_sparse_pstep(data, 3, 5)))
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
    assert len(got) == 1 and _equal(got[0], want)
    idle = [ctx for n, ctx in trt._pstep_contexts.idle if n == 5]
    assert len(idle) == 2 and held in idle


def test_threads_at_once_each_get_the_oracle_s_output(streams):
    names = ["4608x256", "4112x32_drop", "136x90", "512x384"]
    want = {n: per_call(streams[n], PER[n]) for n in names}
    ok = {n: [] for n in names}
    start = threading.Barrier(len(names))

    def work(name):
        start.wait(timeout=60)
        for _ in range(4):
            ok[name].append(_equal(trt.demux_file_sparse_pstep(streams[name], PER[name]),
                                   want[name]))

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
    assert ok == {n: [True] * 4 for n in names}
