"""Stage timers, the program's spans and counters, and a device trace
(counterpart of pfv_tpu/utils/profiling.py).

`StageTimer` accumulates host wall time per named stage of a pipeline
(demux / upload / device / fetch); `encoding.encode_video(timer=...)` and
`loader.VideoDataLoader(timer=...)` report their stages to one. A stage of
asynchronous device work measures its enqueue unless the caller
synchronizes inside it.

`span(name)` and `count(name, value)` are the instruments inside the
decode and encode paths (the families `pfv.decode.*` and `pfv.encode.*`).
They are on only while a torch profiler session records. Then a span opens
`torch.profiler.record_function("pfv." + name)`, so its start and end lie
in the profiler's trace on the clock of the kernels and copies launched
inside it, and adds its host seconds and one call to an in-process
registry; `count` adds to the same registry; `totals()` and `counters()`
read it. Off, `span` returns one shared no-op context and `count` returns
at once. `device_trace` starts such a session and writes its trace.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler


class StageTimer:
    """Accumulates wall time per named stage.

    with timer.stage("demux"): ...
    print(timer.report())
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:>16}: {total*1000:8.2f} ms total, {n:5d} calls, "
                f"{total/n*1000:8.3f} ms/call"
            )
        return "\n".join(lines)


_NOOP = contextlib.nullcontext()


def recording() -> bool:
    """Whether a torch profiler session records, in any thread. (The
    thread-local `torch.autograd._profiler_enabled()` reads False in a
    thread the session was not started from, such as the loader's worker.)"""
    return _autograd_profiler._is_profiler_enabled


class _Registry:
    """Host seconds and calls per span, and a sum per counter."""

    def __init__(self):
        self.lock = threading.Lock()
        self.seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.counters: dict[str, float] = defaultdict(float)

    def add_span(self, name: str, seconds: float) -> None:
        with self.lock:
            self.seconds[name] += seconds
            self.calls[name] += 1

    def add(self, name: str, value: float) -> None:
        with self.lock:
            self.counters[name] += value


_registry = _Registry()


class _Span:
    """The profiler range and the registry entry of one span. Its host
    seconds hold the opening and closing of its own range, so that a
    span's time less its children's holds none of theirs."""

    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._rf.__exit__(*exc)
        _registry.add_span(self.name, time.perf_counter() - self._t0)
        return False


def span(name: str):
    """A context manager: while a profiler session records, the profiler
    range "pfv." + `name` and an entry of `totals()`; else a shared no-op."""
    return _Span("pfv." + name) if recording() else _NOOP


def count(name: str, value: float) -> None:
    """Add `value` to the counter `name` while a profiler session records."""
    if recording():
        _registry.add(name, value)


def totals() -> dict[str, tuple[float, int]]:
    """A copy of the registry's spans: {"pfv." + name: (host seconds, calls)}."""
    with _registry.lock:
        return {k: (v, _registry.calls[k]) for k, v in _registry.seconds.items()}


def counters() -> dict[str, float]:
    """A copy of the registry's counters: {name: sum}."""
    with _registry.lock:
        return dict(_registry.counters)


@contextlib.contextmanager
def device_trace(logdir: str):
    """A `torch.profiler` context over host and, where there is a card,
    CUDA activity; yields the profiler and, when the block ends, writes a
    Chrome trace (chrome://tracing, Perfetto) to `logdir`/trace.json. The
    session turns `span` and `count` on: the trace shows the `pfv.*` spans
    beside the kernels and copies they launched, every thread's where this
    torch can profile all threads, and `totals()` and `counters()` sum them."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    try:
        config = {"experimental_config": torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True)}
    except (AttributeError, TypeError):  # a torch that profiles one thread only
        config = {}
    prof = profile(activities=activities, **config)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
