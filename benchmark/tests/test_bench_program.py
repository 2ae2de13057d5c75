"""`harness/program.py` on the CPU: the attribution of device operations to
the program's spans on a small hand-written Chrome trace, and the metrics
that read the program's spans and counters in the traced dry run of each
cell."""

import json

import pytest
from test_bench_harness import CELLS, bench_json, cpu, last_line  # noqa: F401 - a fixture

from harness import program

NEW = {"demux_cpu_ms_per_frame.decode", "demux_sys_pct.decode", "densify_ms_per_frame.decode",
       "enqueue_ms_per_frame.encode", "mux_glue_ms_per_frame.encode"}
DEVICE_ONLY = {"densify_ms_per_frame.decode"}  # the CPU dry run has no device operations


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 7, "tid": tid,
            "ts": ts, "dur": dur}


def _launch(corr, ts, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 7,
            "tid": tid, "ts": ts, "dur": 1, "args": {"correlation": corr}}


def _op(corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"op{corr}", "pid": 0, "tid": 9, "ts": ts,
            "dur": dur, "args": {"correlation": corr}}


def test_attribution_takes_the_innermost_span_open_at_the_launch(tmp_path):
    events = [
        _span("bench.window", 0, 1000),
        _span("pfv.decode.clip", 10, 500),
        _span("pfv.decode.step", 100, 300),
        _span("pfv.decode.densify", 150, 50),
        _span("pfv_torch.runtime.demux_file_sparse_tiles", 20, 30),
        _launch(1, 160), _op(1, 170, 40),                     # in densify, in step, in clip
        _launch(2, 250), _op(2, 260, 20, "gpu_memset"),       # in step, after densify ended
        _launch(3, 30), _op(3, 35, 10, "gpu_memcpy"),         # in clip; the other span is not pfv.
        _launch(4, 700), _op(4, 710, 30),                     # after the clip: no span
        _launch(5, 160, tid=2), _op(5, 720, 5),               # another thread: no span
        _op(6, 730, 7),                                       # no launch event: no span
        _launch(7, 160), _op(7, 1500, 100),                   # starts after the window
        {"ph": "i", "name": "pfv.decode.clip", "ts": 0},      # not a complete event
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    by_span, lost, total = program.attribution(str(path))
    assert by_span == pytest.approx({"pfv.decode.densify": 40e-6, "pfv.decode.step": 20e-6,
                                     "pfv.decode.clip": 10e-6})
    assert lost == pytest.approx(42e-6) and total == pytest.approx(112e-6)
    assert program.device_seconds("pfv.decode.densify", str(path)) == pytest.approx(40e-6)
    assert program.device_seconds("pfv.decode.rgba", str(path)) is None
    assert program.attribution(str(path), window="no.such.span") is None


def test_a_window_reads_only_what_was_added_after_it_was_made(tmp_path):
    from pfv_torch.utils.profiling import count, device_trace, span

    with device_trace(str(tmp_path)):
        with span("test.window"):
            count("test.window_adds", 2)
        w = program.Window()
        assert w.calls("pfv.test.window") == 0 and w.seconds("pfv.test.window") is None
        for _ in range(3):
            with span("test.window"):
                count("test.window_adds", 1)
    assert w.calls("pfv.test.window") == 3 and w.seconds("pfv.test.window") >= 0
    assert w.counter("test.window_adds") == 3


@pytest.mark.parametrize("workload", CELLS)
def test_the_program_metrics_read_in_the_traced_dry_run(cpu, workload):  # noqa: F811
    res = last_line(["--workload", workload, "--seed", str(2**31 + 11), "--seconds", "0.3",
                     "--trace", "1"])
    assert res["correct"] is True
    listed = {m["name"] for m in bench_json()["per_layer"] if workload in m["workloads"]}
    mine = NEW & listed
    assert mine, "every cell reports one of the program's metrics"
    for name in mine - DEVICE_ONLY:
        assert res["metrics"][name]["value"] >= 0, name
    for name in mine & DEVICE_ONLY:
        assert name not in res["metrics"], name
    if "mux_glue_ms_per_frame.encode" in mine:
        m = res["metrics"]
        assert m["mux_glue_ms_per_frame.encode"]["value"] < m["mux_ms_per_frame.encode"]["value"]
    if "demux_sys_pct.decode" in mine:
        assert res["metrics"]["demux_sys_pct.decode"]["value"] <= 100
