"""`metrics/pstep_reuse_pct.decode.py` on the CPU: the traced dry run of
the 8K decode cell (the dense route forced on tiny frames, in chunks) reads
every window call served from the pstep demux's kept buffers (set-up's
warm-up call of each clip grew them), and a program that counts no reuse
reads nothing."""

import pytest
from test_bench_harness import bench_json, cpu, last_line  # noqa: F401 - a fixture

from harness import main as hm
from harness import program

NAME = "pstep_reuse_pct.decode"


def test_the_window_reuses_what_the_warm_up_grew(cpu):  # noqa: F811
    from pfv_torch import runtime

    runtime.release_demux_memory()
    res = last_line(["--workload", "uhd8k.decode", "--seed", str(2**31 + 41),
                     "--seconds", "0.3", "--trace", "1"])
    assert res["correct"] is True
    assert res["metrics"][NAME] == {"value": 100.0, "unit": "%"}
    listed = [m for m in bench_json()["per_layer"] if m["name"] == NAME]
    assert [m["workloads"] for m in listed] == [["uhd8k.decode"]]


def test_a_program_without_the_counter_reads_nothing(monkeypatch, tmp_path):
    from pfv_torch.utils import profiling

    metric = hm.metric_files([NAME])[NAME]
    monkeypatch.setattr(profiling, "counters", lambda: {})
    with profiling.device_trace(str(tmp_path)):
        with profiling.span("decode.demux_native"):
            pass
        assert metric.read(None) is None
    monkeypatch.setattr(program, "_registry", lambda: None)
    assert hm.metric_files([NAME])[NAME].read(None) is None


@pytest.mark.parametrize("grown", [[0, 0], [1 << 20, 0, 0, 0]])
def test_the_share_counts_calls_that_grew_nothing(tmp_path, grown):
    from pfv_torch.utils import profiling

    with profiling.device_trace(str(tmp_path)):
        metric = hm.metric_files([NAME])[NAME]
        for g in grown:
            with profiling.span("decode.demux_native"):
                profiling.count("decode.pstep_calls_reused", int(g == 0))
        want = 100.0 * sum(g == 0 for g in grown) / len(grown)
        assert metric.read(None) == pytest.approx(want)
