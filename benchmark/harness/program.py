"""The program's own instruments, read for the per-layer metrics of a traced
run: the spans and counters of `pfv_torch.utils.profiling`, and the device
operations launched inside the spans.

The program fills its registry only while a profiler session records; in
a traced run that is the window alone (set-up's warm-up calls come before
the session, and the reference calls nothing of the program). A metric
file is loaded anew by each run, before its window; the `Window` it makes
then holds what the registry held already, so that a process that runs
several windows (the CPU tests) reads each window's own.

`attribution` reads the profiler's Chrome trace that the harness has
written: each device operation (kernel, copy, fill) that starts inside
`bench.window` goes to the innermost `pfv.*` span of the thread that
launched it that was open at its launch, matched by the `correlation` id
that the launch event (`cuda_runtime` or `cuda_driver`) and the operation
share.

A program without these instruments reads None everywhere: it has no
registry, and its trace no `pfv.*` span.
"""

from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRACE = os.path.join(BENCH, "out", "trace.json")
PREFIX = "pfv."
WINDOW_SPAN = "bench.window"
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCHES = ("cuda_runtime", "cuda_driver")


def _registry():
    """(totals, counters) of the program's registry, or None where the
    program has none."""
    try:
        from pfv_torch.utils.profiling import counters, totals
    except ImportError:
        return None
    return totals(), counters()


class Window:
    """The program's spans and counters since this object was made."""

    def __init__(self):
        self._start = _registry() or ({}, {})

    def _now(self):
        return _registry() or ({}, {})

    def calls(self, span: str) -> int:
        """Calls of the span `span` ("pfv.<family>.<name>")."""
        return self._now()[0].get(span, (0.0, 0))[1] - self._start[0].get(span, (0.0, 0))[1]

    def seconds(self, span: str) -> float | None:
        """Host seconds of the span `span`, None where it was not entered."""
        if not self.calls(span):
            return None
        return self._now()[0][span][0] - self._start[0].get(span, (0.0, 0))[0]

    def counter(self, name: str) -> float:
        """What was added to the counter `name`."""
        return self._now()[1].get(name, 0.0) - self._start[1].get(name, 0.0)


def attribution(path: str = TRACE, window: str = WINDOW_SPAN):
    """({span name: device seconds}, unattributed device seconds, all
    device seconds) of the operations that start inside the span `window`
    of the Chrome trace at `path`; None where the trace has no such span."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    win = next((e for e in events if e.get("name") == window), None)
    if win is None:
        return None
    t0 = float(win["ts"])
    t1 = t0 + float(win.get("dur", 0))
    spans, launch_at, ops = defaultdict(list), {}, []
    for e in events:
        cat, args = e.get("cat"), e.get("args") or {}
        thread = (e.get("pid"), e.get("tid"))
        if cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            a = float(e["ts"])
            spans[thread].append((a, a + float(e.get("dur", 0)), e["name"]))
        elif cat in LAUNCHES and "correlation" in args:
            launch_at[args["correlation"]] = (thread, float(e["ts"]))
        elif cat in DEVICE_OPS and t0 <= float(e["ts"]) < t1:
            ops.append((args.get("correlation"), float(e.get("dur", 0)) / 1e6))
    for v in spans.values():
        v.sort()
    starts = {k: [s[0] for s in v] for k, v in spans.items()}
    by_span, lost, total = defaultdict(float), 0.0, 0.0
    for corr, dur in ops:
        total += dur
        name = None
        if corr in launch_at:
            thread, t = launch_at[corr]
            name = _innermost(spans.get(thread, []), starts.get(thread, []), t)
        if name is None:
            lost += dur
        else:
            by_span[name] += dur
    return dict(by_span), lost, total


def _innermost(spans, starts, t: float):
    """The name of the innermost of one thread's `spans` ((start, end,
    name), sorted by start, nested) that holds time `t`, or None. Of the
    spans that hold `t`, the innermost started last."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        a, b, name = spans[i]
        if b > t:
            return name
        i -= 1
    return None


_cache: dict = {}


def device_seconds(span: str, path: str = TRACE) -> float | None:
    """Device seconds of the window's operations launched inside the span
    `span` and in none nested in it; None where none was."""
    if not os.path.exists(path):
        return None
    st = os.stat(path)
    stamp = (path, st.st_mtime_ns, st.st_size)
    if _cache.get("stamp") != stamp:
        _cache.clear()
        _cache.update(stamp=stamp, value=attribution(path))
    got = _cache["value"]
    return got[0].get(span) if got else None
