"""One run of one cell: `python benchmark/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout.

Set-up (imports, the program's kernel build or load, inputs from the seed,
one warm-up call per input) counts into `setup_s`; then the window; then,
with the program's state released and the memory peak read, the
comparison with the reference. The last line of standard output is the
result's JSON object; the comparisons are also the last lines of standard
error. `--control 1` puts the reference's control (its divisions floored)
in the program's place: its result has to read not correct.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "pfv_tpu"}
DEVICE = "cuda"  # the CPU tests of the harness set "cpu", with require_cards stubbed


class NoCard(SystemExit):
    pass


def load_spec(workload: str):
    """(BENCHMARK.json, the workload's entry, its config, its traffic)."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload '{workload}' in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(BENCH, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return bench, cell, cfg, traffic


def require_cards(chips: int):
    """(device name, count) of the cards; exits without a result where
    there are fewer than the cell asks for."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoCard(f"this cell needs {chips} CUDA card(s); found {n}")
    return torch.cuda.get_device_name(0), chips


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def metric_files(names):
    """{name: module} of the per-layer metric files benchmark/metrics/<name>.py."""
    import importlib.util

    out = {}
    for name in names:
        path = os.path.join(BENCH, "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


class Reading:
    """What a per-layer metric file reads from: the window's work and time,
    the host spans, the encoder's stages and the device timeline."""

    def __init__(self, driver, spans, timeline, work):
        self.frames = driver.frames
        self.stages = driver.stages.seconds if driver.stages else {}
        self.spans = spans
        self.timeline = timeline
        self.work = work

    def span_ms_per_frame(self, names):
        if not self.frames or not any(self.spans.calls.get(n) for n in names):
            return None
        return 1e3 * sum(self.spans.seconds.get(n, 0.0) for n in names) / self.frames

    def stage_ms_per_frame(self, name):
        if not self.frames or name not in self.stages:
            return None
        return 1e3 * self.stages[name] / self.frames

    def roofline(self, bound: str, kernel: str):
        """100 x the bound per launch made over the device time per launch
        the profiler saw; None where it saw no launch."""
        from harness.roofline import mean_bound_s

        dev_s, seen = self.timeline.kernel(kernel)
        least = mean_bound_s(bound, self.work)
        if not seen or not dev_s or least is None:
            return None
        return 100.0 * least / (dev_s / seen)

    def idle_pct(self):
        t = self.timeline
        return 100.0 * (1.0 - t.busy_s / t.window_s) if t.window_s > 0 else None


def run(cell: dict, cfg: dict, traffic: dict, bench: dict, seed: int, seconds: float,
        trace: bool, control: bool = False, device: str = "cuda",
        t_start: float | None = None):
    """One run -> (result dict, lines for standard error)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    import pfv_torch
    from harness import control as ctl
    from harness.drivers import DRIVERS
    from reference.codec import Arith

    torch.backends.cuda.matmul.allow_tf32 = False
    kind, count = require_cards(cell["chips"])
    cuda = torch.device(device).type == "cuda"
    program = ctl.Control() if control else pfv_torch
    driver = DRIVERS[traffic["path"]](cfg, traffic, seed, device, program)
    if control:
        program.bind(driver)
    driver.setup()
    driver.sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    files = metric_files([m["name"] for m in bench["per_layer"]
                          if cell["name"] in m["workloads"]]) if trace else {}
    if trace:
        spans, timeline = traced_window(driver, files, seconds, cuda)
    else:
        e2e = driver.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    driver.release()
    bad_modules = forbidden_modules()
    if bad_modules:
        raise SystemExit(f"modules loaded that the port must not load: {bad_modules}")

    t_ref = time.perf_counter()
    numbers, work = driver.check(Arith())
    t_ref = time.perf_counter() - t_ref
    work = {"width": cfg["width"], "height": cfg["height"], "calls": work}
    checks = {"failed_calls": (driver.failed, 0)}
    checks.update({k: (v, 0) for k, v in numbers.items() if k.startswith("mismatched")})
    compared = sum(v for k, v in numbers.items() if k.endswith("compared"))
    correct = compared >= 1 and all(v <= lim for v, lim in checks.values())

    notes = [f"reference and comparison {t_ref:.3f} s after a {driver.elapsed:.3f} s window"]
    notes += driver.notes()
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    if trace:
        values = per_layer(files, Reading(driver, spans, timeline, work), notes)
    else:
        values = dict(e2e, setup_s=setup_s)
    result = {"correct": bool(correct), "attempted": driver.calls, "failed": driver.failed,
              "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
              "device": {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": count,
                         "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"].update(busy_s=timeline.busy_s, window_s=timeline.window_s)
        result["breakdown"] = timeline.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    result["checks"]["compared"] = {"value": compared, "limit": ">= 1"}
    lines = notes + [f"check {k}: {v['value']} (limit {v['limit']})"
                     for k, v in result["checks"].items()]
    return result, lines


def traced_window(driver, files, seconds: float, cuda: bool):
    """The window under the profiler, with host spans around the functions
    the metric files name -> (spans, timeline)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from harness.trace import Spans, Timeline

    spans = Spans([s for f in files.values() for s in getattr(f, "SPANS", ())])
    spans.install()
    driver.trace_spans()
    prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    prof.start()
    try:
        with record_function("bench.window"):
            driver.window(seconds)
        driver.sync()
    finally:
        prof.stop()
        spans.remove()
    out = os.path.join(BENCH, "out")
    os.makedirs(out, exist_ok=True)
    return spans, Timeline(prof, "bench.window", os.path.join(out, "trace.json"))


def per_layer(files, reading, notes) -> dict:
    """{name: value} of the metric files that found something to read."""
    from harness.roofline import mean_bound_s

    values = {}
    for name, f in files.items():
        if hasattr(f, "KERNEL"):
            dev_s, seen = reading.timeline.kernel(f.KERNEL)
            notes.append(f"kernel {f.KERNEL}: {dev_s:.6f} s device over {seen} launches "
                         f"seen; bound {mean_bound_s(f.BOUND, reading.work)} s a launch")
        value = f.read(reading)
        if value is not None:
            values[name] = value
    return values


def main(argv=None) -> int:
    t_start = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench, cell, cfg, traffic = load_spec(args.workload)
    try:
        result, lines = run(cell, cfg, traffic, bench, args.seed, args.seconds,
                            bool(args.trace), bool(args.control), DEVICE, t_start)
    except NoCard as e:
        print(str(e), file=sys.stderr)
        return 3
    print(f"{cell['name']} seed {args.seed}: {power_limit()}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
