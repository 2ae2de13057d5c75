"""The traced run's instruments: host spans around the program's functions,
named by dotted path, and the profiler's device timeline.

`Spans` replaces each named function (a module attribute, or a class
attribute for `module.Class.method`) by a wrapper that adds its host-clock
duration to a total and opens a `torch.profiler.record_function` of the
same name; it adds no synchronize. `Timeline` reads the profiler's events
once the window has closed: device time per kernel name, the launches it
saw, the busy share of the window and the breakdown of the longest device
operations and idle gaps, from the profiler's Chrome trace (whose format
holds across torch versions).
"""

from __future__ import annotations

import bisect
import functools
import importlib
import json
import re
import time
from collections import defaultdict

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _resolve(dotted: str):
    """(owner, attribute) of `pkg.module.func` or `pkg.module.Class.method`."""
    parts = dotted.split(".")
    for i in range(len(parts) - 1, 0, -1):
        try:
            owner = importlib.import_module(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for name in parts[i:-1]:
            owner = getattr(owner, name)
        return owner, parts[-1]
    raise ValueError(f"cannot resolve {dotted}")


class Spans:
    """Host spans around functions named by dotted path; `seconds[name]`
    and `calls[name]` accumulate while installed."""

    def __init__(self, names):
        self.names = list(dict.fromkeys(names))
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self._saved = []

    def _wrap(self, name: str, fn):
        from torch.profiler import record_function

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            try:
                with record_function(name):
                    return fn(*args, **kwargs)
            finally:
                self.seconds[name] += time.perf_counter() - t
                self.calls[name] += 1
        return wrapper

    def install(self):
        for name in self.names:
            owner, attr = _resolve(name)
            fn = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
            self._saved.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(name, fn))

    def remove(self):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved.clear()


def short_name(name: str) -> str:
    """A kernel's name without its namespace prefix, template arguments and
    argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return name[5:] if name.startswith("void ") else name


class Timeline:
    """The device side of a profiler session, read from its events."""

    def __init__(self, prof, window_span: str, path: str):
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        dev, host = [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            a = int(round(float(e["ts"]) * 1e3))
            b = a + int(round(float(e.get("dur", 0)) * 1e3))
            kind = e.get("cat")
            if kind in DEVICE_ACTIVITIES:
                dev.append((a, b, e.get("name", ""), kind))
            elif kind == "user_annotation":
                host.append((a, b, e.get("name", "")))
        win = [(a, b) for a, b, n in host if n == window_span]
        if not win:
            raise RuntimeError(f"the profiler holds no '{window_span}' span")
        self.t0, self.t1 = win[0]
        self.window_s = (self.t1 - self.t0) / 1e9
        self.kernels = defaultdict(lambda: [0.0, 0])
        for a, b, name, kind in dev:
            if kind == "kernel" and self.t0 <= a < self.t1:
                k = self.kernels[name]
                k[0] += (b - a) / 1e9
                k[1] += 1
        self.intervals = self._merged([(max(a, self.t0), min(b, self.t1))
                                       for a, b, _, _ in dev if b > self.t0 and a < self.t1])
        self.busy_s = sum(b - a for a, b in self.intervals) / 1e9
        self._dev, self._host = dev, [h for h in host if h[2] != window_span]

    @staticmethod
    def _merged(iv):
        out = []
        for a, b in sorted(iv):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def kernel(self, substring: str):
        """(device seconds, launches seen) of the kernels whose name holds
        `substring`."""
        hits = [v for k, v in self.kernels.items() if substring in k]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps of
        the window by the innermost host span open at their middle."""
        ops = defaultdict(float)
        for a, b, name, kind in self._dev:
            if self.t0 <= a < self.t1:
                ops[short_name(name) if kind == "kernel" else kind] += (b - a) / 1e9
        by_name = defaultdict(list)
        for a, b, name in self._host:
            by_name[name].append((a, b))
        index = {n: (sorted(v), [x[0] for x in sorted(v)]) for n, v in by_name.items()}
        gaps = defaultdict(float)
        edges = [self.t0] + [x for iv in self.intervals for x in iv] + [self.t1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid, best, label = (a + b) / 2, -1, "outside the named spans"
            for name, (iv, starts) in index.items():
                i = bisect.bisect_right(starts, mid) - 1
                if i >= 0 and iv[i][1] > mid and iv[i][0] > best:
                    best, label = iv[i][0], name
            gaps[label] += (b - a) / 1e9
        pick = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"device_ops": pick(ops), "idle_gaps": pick(gaps)}
