"""The program's spans and counters (`pfv_torch.utils.profiling.span`,
`count`, `totals`, `counters`) on the CPU: off without a
profiler session, on under `device_trace`, where the `pfv.*` spans land in
the written Chrome trace nested as the decode and encode paths nest them.

The registry is the process's, and other tests in the same process may
have added to it: every check here reads what one call added."""

from __future__ import annotations

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import pfv_torch
from pfv_torch import dataloader as tdl
from pfv_torch import encoding, synth
from pfv_torch.frame import geometry
from pfv_torch.utils import profiling
from pfv_torch.utils.profiling import StageTimer, counters, device_trace, span, totals

FRAMES = 6


@pytest.fixture(scope="module")
def units_stream():
    return synth.random_stream(64, 48, FRAMES, seed=1, keyframes=3)


@pytest.fixture(scope="module")
def source():
    frames = [synth.synth_yuv_frame(t, 64, 48) for t in range(FRAMES)]
    return tuple(map(np.stack, zip(*frames)))


def traced(tmp_path, fn):
    """Run `fn` under `device_trace` -> (its result, the `pfv.*` events of
    the written trace, the spans and the counters it added)."""
    t0, c0 = totals(), counters()
    with device_trace(str(tmp_path)):
        out = fn()
    with open(tmp_path / "trace.json") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("name", "").startswith("pfv.")]
    t1, c1 = totals(), counters()
    spans = {k: (s - t0.get(k, (0.0, 0))[0], n - t0.get(k, (0.0, 0))[1])
             for k, (s, n) in t1.items() if n != t0.get(k, (0.0, 0))[1]}
    added = {k: v - c0.get(k, 0.0) for k, v in c1.items() if k not in c0 or v != c0[k]}
    return out, events, spans, added


def named(events, name):
    return [e for e in events if e["name"] == name]


def inside(inner, outer) -> bool:
    """Whether the trace event `inner` lies within `outer` on one thread."""
    a, b = float(outer["ts"]), float(outer["ts"]) + float(outer["dur"])
    x, y = float(inner["ts"]), float(inner["ts"]) + float(inner["dur"])
    return inner["tid"] == outer["tid"] and a <= x and y <= b + 1e-3


def test_off_spans_are_one_shared_no_op_and_record_nothing(units_stream, source):
    assert not profiling.recording()
    assert span("decode.clip") is span("encode.entropy")
    t0, c0 = totals(), counters()
    pfv_torch.decode_video_rgb(units_stream, device="cpu")
    pfv_torch.encode_video(*source, 30, 3, 3, device="cpu")
    profiling.count("decode.demux_bytes", 5)
    assert totals() == t0 and counters() == c0


def test_units_route_nests_the_native_demux_in_the_demux_in_the_clip(tmp_path, units_stream):
    assert tdl.choose_route(units_stream).kind == "units"
    _, events, spans, _ = traced(tmp_path, lambda: pfv_torch.decode_video_rgb(
        units_stream, device="cpu"))
    (clip,), (demux,), (native,) = (named(events, "pfv.decode." + n)
                                    for n in ("clip", "demux", "demux_native"))
    assert inside(native, demux) and inside(demux, clip)
    for name in ("upload", "h2d", "step", "rgba"):
        (e,) = named(events, "pfv.decode." + name)
        assert inside(e, clip) and not inside(e, demux), name
    assert all(inside(e, clip) for e in named(events, "pfv.decode.tables"))
    assert "pfv.decode.densify" not in spans
    assert all(n == 1 for k, (_, n) in spans.items() if k != "pfv.decode.tables")


def test_dense_route_densifies_inside_the_step(tmp_path):
    data = synth.random_stream(4112, 32, 3, seed=1)
    assert tdl.choose_route(data).kind == "dense"
    out, events, spans, _ = traced(tmp_path, lambda: pfv_torch.decode_video_rgba(
        data, device="cpu"))
    assert out.shape[0] == 3
    (step,) = named(events, "pfv.decode.step")
    densify = named(events, "pfv.decode.densify")
    assert densify and all(inside(e, step) for e in densify)
    assert spans["pfv.decode.densify"][1] == len(densify)
    assert len(named(events, "pfv.decode.demux_native")) == spans[
        "pfv.decode.demux_native"][1] >= 1


def test_encode_video_codes_each_frame_in_an_entropy_span_inside_the_mux(tmp_path, source):
    timer = StageTimer()
    out, events, spans, added = traced(tmp_path, lambda: pfv_torch.encode_video(
        *source, 30, 3, 3, timer=timer, device="cpu"))
    assert out == pfv_torch.encode_video(*source, 30, 3, 3, device="cpu")
    # the mux codes every frame in one call of the native worker pool: one
    # entropy span a call, and the frames and the workers' seconds counted
    (mux,) = named(events, "pfv.encode.host_mux")
    (entropy,) = named(events, "pfv.encode.entropy")
    assert inside(entropy, mux) and spans["pfv.encode.entropy"][1] == 1
    assert added["encode.mux_frames"] == FRAMES
    assert added["encode.mux_worker_s"] > 0
    nested = {"h2d_upload": ("encoder_setup", "source_upload"),
              "device_encode": ("frame_loop", "compact", "device_wait"),
              "d2h_fetch": (), "host_mux": ()}
    for outer, inner in nested.items():
        (o,) = named(events, "pfv.encode." + outer)
        for name in inner:
            (e,) = named(events, "pfv.encode." + name)
            assert inside(e, o), name
    assert set(timer.counts) == {"h2d upload", "device encode", "d2h fetch", "host mux"}
    for stage, name in (("h2d upload", "h2d_upload"), ("host mux", "host_mux")):
        assert spans["pfv.encode." + name][0] <= timer.totals[stage]
    assert added["encode.h2d_bytes"] == sum(p.nbytes for p in source)
    assert 0 < added["encode.payload_bytes"] < len(out)


@pytest.mark.parametrize("frames_a_run,runs", [(None, 1), (2, 3)])
def test_encode_video_compacts_each_run_in_a_span_and_counts_the_runs(
        tmp_path, monkeypatch, source, frames_a_run, runs):
    nb = geometry(64, 48).nb
    want = pfv_torch.encode_video(*source, 30, 3, 3, device="cpu")
    if frames_a_run is not None:
        monkeypatch.setattr(encoding, "COMPACT_LIMIT", frames_a_run * nb * 256 + 1)
    out, events, spans, added = traced(tmp_path, lambda: pfv_torch.encode_video(
        *source, 30, 3, 3, device="cpu"))
    assert out == want
    (compact,) = named(events, "pfv.encode.compact")
    each = named(events, "pfv.encode.compact_run")
    assert len(each) == spans["pfv.encode.compact_run"][1] == runs
    assert all(inside(e, compact) for e in each)
    assert added["encode.coeff_bytes"] == FRAMES * nb * 512
    assert added["encode.compact_runs"] == runs
    # counted, as 0 where the device is not a CUDA one
    assert "encode.live_peak_bytes" in counters()
    assert added.get("encode.live_peak_bytes", 0) == 0


def test_native_demux_counts_the_stream_bytes_and_cpu_seconds(tmp_path, units_stream):
    _, _, spans, added = traced(tmp_path, lambda: pfv_torch.decode_video_yuv(
        units_stream, device="cpu"))
    assert spans["pfv.decode.demux_native"][1] == 1
    assert added["decode.demux_bytes"] == len(units_stream)
    assert added["decode.demux_cpu_s"] >= added.get("decode.demux_sys_s", 0.0) >= 0.0
    assert added["decode.h2d_bytes"] > 0


def test_loader_worker_spans_come_from_its_own_thread(tmp_path, units_stream):
    datas = [units_stream] * 3
    out, events, spans, _ = traced(tmp_path, lambda: list(pfv_torch.VideoDataLoader(
        datas, device="cpu")))
    assert len(out) == 3
    assert spans["pfv.decode.demux"][1] == 3 and spans["pfv.decode.upload"][1] == 3
    worker = {e["tid"] for e in named(events, "pfv.decode.demux")}
    consumer = {e["tid"] for e in named(events, "pfv.decode.step")}
    assert len(worker) == 1 and len(consumer) == 1 and worker != consumer
    assert consumer == {e["tid"] for e in named(events, "pfv.decode.rgba")}


def test_spans_and_counters_record_from_threads_the_session_did_not_start(tmp_path):
    """More threads than cores, switching often, each adding to one span and
    one counter: no update is lost."""
    n, per = (os.cpu_count() or 1) + 4, 200
    seen = []

    def work():
        seen.append(profiling.recording())
        for _ in range(per):
            with span("test.thread"):
                profiling.count("test.adds", 1)

    def run():
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=work) for _ in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)

    _, _, spans, added = traced(tmp_path, run)
    assert seen == [True] * n
    assert spans["pfv.test.thread"][1] == n * per and added["test.adds"] == n * per
