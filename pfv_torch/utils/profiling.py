"""Stage timers and a device trace (counterpart of
pfv_tpu/utils/profiling.py).

`StageTimer` accumulates host wall time per named stage of a pipeline
(demux / upload / device / fetch); `encoding.encode_video(timer=...)` and
`loader.VideoDataLoader(timer=...)` report their stages to one. A stage of
asynchronous device work measures its enqueue unless the caller
synchronizes inside it. `device_trace` records what the device ran.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


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

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """A `torch.profiler` context over host and, where there is a card,
    CUDA activity; yields the profiler and, when the block ends, writes a
    Chrome trace (chrome://tracing, Perfetto) to `logdir`/trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
