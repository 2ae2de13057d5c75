"""The harness's path of every cell on the CPU at a tiny size, with the
check for a card stubbed: a well-formed last line; the control and each
fault the cell can have, planted in the program underneath, read not
correct; nothing of JAX or the JAX package is loaded, and the reference
imports nothing of the program."""

import ast
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

from harness import main as hm

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}
LOAD_SPEC = hm.load_spec
DENSE_WIDTH = 80


def bench_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


CELLS = [w["name"] for w in bench_json()["workloads"]]


def tiny(workload):
    """The workload at 96x64 (the 8K cell's at DENSE_WIDTH x 64), six frames
    a clip, a keyframe every 4."""
    bench, cell, cfg, traffic = LOAD_SPEC(workload)
    wide = cfg["width"] > 4096
    cfg = dict(cfg, width=DENSE_WIDTH if wide else 96, height=64, keyframe_interval=4)
    traffic = dict(traffic, frames_per_clip=6)
    if "stream" in traffic:
        traffic["stream"] = dict(traffic["stream"], p_coded=0.4)
    return bench, cell, cfg, traffic


@pytest.fixture
def cpu(monkeypatch):
    """The CPU and tiny sizes; the dense route (the 8K cell's) forced on
    tiny frames and cut into chunks of 4, so that K3's chunk hand-off runs."""
    from pfv_torch import dataloader

    monkeypatch.setattr(dataloader, "failed_gate",
                        lambda g: "forced dense" if g.width == DENSE_WIDTH else None)
    monkeypatch.setattr(dataloader, "dense_chunk_frames", lambda g: 4)
    monkeypatch.setattr(hm, "DEVICE", "cpu")
    monkeypatch.setattr(hm, "require_cards", lambda chips: ("cpu", chips))
    monkeypatch.setattr(hm, "load_spec", tiny)
    monkeypatch.setattr(hm, "power_limit", lambda: "no card")


def last_line(args):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = hm.main(args)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_dry_run_prints_a_well_formed_last_line(cpu, workload, trace):
    res = last_line(["--workload", workload, "--seed", str(2**31 + 3), "--seconds", "0.3",
                     "--trace", str(trace)])
    assert RESULT_KEYS <= set(res) and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    bench = bench_json()
    if trace:
        want = {m["name"] for m in bench["per_layer"] if workload in m["workloads"]}
        assert set(res["metrics"]) <= want
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        want = {m["name"] for m in bench["end_to_end"]
                if workload in m.get("workloads", [workload])}
        assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_reads_not_correct(cpu, workload):
    res = last_line(["--workload", workload, "--seed", "17", "--seconds", "0.3",
                     "--trace", "0", "--control", "1"])
    assert res["correct"] is False
    assert any(v["value"] > 0 for k, v in res["checks"].items() if k.startswith("mismatched"))


def _altered_rgba(orig):
    def f(g, canvases, want):
        out = orig(g, canvases, want)
        if want == "rgba":
            out = out.clone()
            out.view(torch.int32)[-1, 3, 5] ^= 0x10
        return out
    return f


def _frozen_state(orig):
    def f(*args, **kwargs):
        out = orig(*args, **kwargs)
        return out[:1].expand_as(out).contiguous()
    return f


def _frozen_dense(orig):
    def f(*args, out, **kwargs):
        orig(*args, out=out, **kwargs)
        out[1:] = out[:1]
    return f


def _altered_mux(orig):
    def f(*args):
        out = bytearray(orig(*args))
        out[len(out) // 2] ^= 1
        return bytes(out)
    return f


def _unchanged_pframe(orig):
    def f(self, planes, coeffs, motion):
        coeffs.zero_()
    return f


FAULTS = {
    ("hd1080.decode", "answer altered"): ("pfv_torch.dataloader", "_output", _altered_rgba),
    ("hd1080.decode", "state unchanged"): ("pfv_torch.dataloader", "step_frames", _frozen_state),
    ("uhd8k.decode", "answer altered"): ("pfv_torch.dataloader", "_output", _altered_rgba),
    ("uhd8k.decode", "state unchanged"): ("pfv_torch.dataloader", "seq_frames_dense",
                                          _frozen_dense),
    ("hd1080.encode", "answer altered"): ("pfv_torch.encoding", "_mux", _altered_mux),
    ("hd1080.encode", "state unchanged"): ("pfv_torch.device.FrameEncoder", "pframe",
                                           _unchanged_pframe),
}


@pytest.mark.parametrize("workload,fault", sorted(FAULTS))
def test_a_fault_underneath_reads_not_correct(cpu, monkeypatch, workload, fault):
    """A fault planted in the program under the harness: an answer
    altered where it is produced, or a step that leaves its state as it
    was."""
    import importlib

    owner_name, attr, make = FAULTS[(workload, fault)]
    mod, _, cls = owner_name.rpartition(".")
    try:
        owner = getattr(importlib.import_module(mod), cls)
    except (ImportError, AttributeError):
        owner = importlib.import_module(owner_name)
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    res = last_line(["--workload", workload, "--seed", "23", "--seconds", "0.3", "--trace", "0"])
    assert res["correct"] is False


def test_no_run_loads_jax_or_the_jax_package():
    code = ("import sys; sys.path[:0] = [%r, %r]; from harness import main as hm; "
            "hm.DEVICE = 'cpu'; hm.require_cards = lambda c: ('cpu', c); "
            "bench, cell, cfg, t = hm.load_spec('hd1080.decode'); "
            "cfg = dict(cfg, width=64, height=48); t = dict(t, frames_per_clip=4); "
            "hm.run(cell, cfg, t, bench, 5, 0.2, True, device='cpu'); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))") % (BENCH, ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "pfv_torch" in loaded
    assert not loaded & hm.FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for name in os.listdir(ref):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, name)).read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            for m in mods:
                assert m.split(".")[0] not in {"pfv_torch", "pfv_tpu", "jax", "harness"}, (name, m)


def test_every_name_in_benchmark_json_has_its_file():
    """Each per-layer metric has its reader, each cell its traffic mix and
    configuration; BENCHMARK.json alone declares what they are."""
    bench = bench_json()
    files = hm.metric_files([m["name"] for m in bench["per_layer"]])
    assert all(callable(f.read) for f in files.values())
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
