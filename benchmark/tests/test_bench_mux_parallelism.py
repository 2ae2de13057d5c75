"""`metrics/mux_parallelism.encode.py` on the CPU: the traced dry run of
the 1080p encode cell reads the mux's workers at once, the workers' summed
seconds on the frames over the entropy span's, between none and the
workers there are; a program that counts no worker seconds reads nothing."""

import os

import pytest
from test_bench_harness import bench_json, cpu, last_line  # noqa: F401 - a fixture

from harness import main as hm
from harness import program

NAME = "mux_parallelism.encode"


def test_the_traced_encode_reads_the_workers_at_once(cpu):  # noqa: F811
    res = last_line(["--workload", "hd1080.encode", "--seed", str(2**31 + 57),
                     "--seconds", "0.3", "--trace", "1"])
    assert res["correct"] is True
    got = res["metrics"][NAME]
    assert got["unit"] == "workers" and 0 < got["value"] <= os.cpu_count() + 0.5
    listed = [m for m in bench_json()["per_layer"] if m["name"] == NAME]
    assert [m["workloads"] for m in listed] == [["hd1080.encode", "uhd2160.encode"]]


def test_a_program_without_the_counter_reads_nothing(monkeypatch, tmp_path):
    from pfv_torch.utils import profiling

    metric = hm.metric_files([NAME])[NAME]
    monkeypatch.setattr(profiling, "counters", lambda: {})
    with profiling.device_trace(str(tmp_path)):
        with profiling.span("encode.entropy"):
            pass
        assert metric.read(None) is None
    monkeypatch.setattr(program, "_registry", lambda: None)
    assert hm.metric_files([NAME])[NAME].read(None) is None


@pytest.mark.parametrize("worker_s", [[0.5], [0.25, 1.5]])
def test_the_reading_is_worker_seconds_over_entropy_seconds(tmp_path, worker_s):
    from pfv_torch.utils import profiling

    with profiling.device_trace(str(tmp_path)):
        metric = hm.metric_files([NAME])[NAME]
        t0 = profiling.totals().get("pfv.encode.entropy", (0.0, 0))[0]
        for s in worker_s:
            with profiling.span("encode.entropy"):
                profiling.count("encode.mux_worker_s", s)
        entropy = profiling.totals()["pfv.encode.entropy"][0] - t0
        assert metric.read(None) == pytest.approx(sum(worker_s) / entropy)
