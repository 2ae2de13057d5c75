"""The drivers of the traffic files' paths. A traffic file names its path
("decode" or "encode"); each path drives one entry of the program
(`ENTRY`). A driver makes the inputs from the seed, warms every shape up,
runs the measured window, and afterwards holds what the window produced
against the reference.

decode  closed loop, one clip in flight: bytes in host memory ->
        `decode_video_rgba` -> synchronized; a seeded sample of the calls
        keeps copies of some of their frames, the last one always
encode  closed loop: source planes in host memory -> `encode_video` ->
        bytes; every output is kept and compared
"""

from __future__ import annotations

import contextlib
import random
import time

import numpy as np
import torch

from reference.codec import Arith, Encoder
from reference.color import rgba_words
from reference.entropy import frame_payload
from reference.sources import clip_planes
from reference.streams import Clip, container
from reference.tables import INTER_QIDX, INTRA_QIDX, q_tables


class Reservoir:
    """A uniform sample of k items from a stream of unknown length, its
    choices drawn from a seeded generator (algorithm R)."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self) -> int | None:
        """The slot the next item goes to, or None."""
        i, self.seen = self.seen, self.seen + 1
        if i < self.k:
            self.items.append(None)
            return i
        j = self.rng.randrange(i + 1)
        return j if j < self.k else None


def _frame_work(fr, nb: int) -> dict:
    ftype, _, coeffs, mvx, _, hc = fr
    p = ftype == 2
    return {"ftype": ftype, "nb": nb,
            "decoded": int(hc.sum()) if p else nb,
            "coded": int(hc.sum()) if p else 0,
            "shifted": int((mvx % 4 != 0).sum()) if p else 0,
            "nonzeros": int((coeffs != 0).sum())}


class Driver:
    ENTRY = ""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, program):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.dev = torch.device(device)
        self.entry = getattr(program, self.ENTRY)
        self.rng = random.Random(seed * 31 + 7)
        self.w, self.h = cfg["width"], cfg["height"]
        self.qtables = q_tables(cfg["quality"])
        self.frames = self.calls = 0
        self.failed = 0
        self.stages = None
        self.span = lambda name: contextlib.nullcontext()

    def trace_spans(self):
        """Open a profiler span around each call of the traced window."""
        from torch.profiler import record_function

        self.span = record_function

    def notes(self) -> list[str]:
        """Lines for standard error beside the comparisons."""
        out = [f"a call failed: {self.error}"] if self.failed else []
        if self.stages is not None and self.frames:
            out.append("stages ms/frame: " + ", ".join(
                f"{k} {1e3 * v / self.frames:.4f}" for k, v in self.stages.seconds.items()))
        return out

    def release(self):
        """Drop the program's state before the reference runs."""

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def clip(self, c: int, frames: int) -> Clip:
        cfg = self.cfg
        return Clip(self.w, self.h, cfg["fps"], frames, cfg["keyframe_interval"],
                    self.qtables, self.traffic["stream"], self.seed, c, self.dev)


class Decode(Driver):
    ENTRY = "decode_video_rgba"

    def setup(self):
        t = self.traffic
        self.clips = [self.clip(c, t["frames_per_clip"]) for c in range(t["clips"])]
        self.data = [c.write() for c in self.clips]
        for d in self.data:
            self.entry(d, device=self.dev)
        self.sync()
        self.sample = Reservoir(t["check"]["calls"], self.rng)
        self.per_clip = [0] * len(self.clips)

    def window(self, seconds: float):
        n, keep = len(self.data), self.traffic["check"]["frames_per_call"]
        t0 = time.perf_counter()
        while True:
            c = self.calls % n
            try:
                with self.span("bench.call"):
                    out = self.entry(self.data[c], device=self.dev)
                    self.sync()
            except Exception as e:  # noqa: BLE001 - a failed call is counted, not fatal
                self.failed += 1
                self.error = repr(e)
                out = None
            self.calls += 1
            if out is not None:
                self.frames += out.shape[0]
                self.per_clip[c] += 1
                slot = self.sample.offer()
                if slot is not None:
                    f = out.shape[0]
                    picks = sorted({f - 1, *self.rng.sample(range(f - 1), min(keep - 1, f - 1))})
                    self.sample.items[slot] = (c, {k: out[k].clone() for k in picks})
            if time.perf_counter() - t0 >= seconds:
                break
        self.elapsed = time.perf_counter() - t0
        return {"decode_fps": self.frames / self.elapsed}

    def check(self, ar: Arith):
        """(numbers {name: value}, per-frame work of every clip)."""
        want = {}
        for c, frames in self.sample.items:
            want.setdefault(c, set()).update(frames)
        bad, compared, work = 0, 0, []
        for c, clip in enumerate(self.clips):
            frames = []
            for f, (fr, planes) in enumerate(zip(clip.frames(), clip.decoded(ar))):
                frames.append(_frame_work(fr, clip.nb))
                if f not in want.get(c, ()):
                    continue
                ref = rgba_words(*planes, self.h, self.w)
                for cc, got in self.sample.items:
                    if cc == c and f in got:
                        bad += int((got[f].view(torch.int32) != ref).sum())
                        compared += 1
            work.append((self.per_clip[c], frames))
        return {"mismatched_px": bad, "frames_compared": compared}, work


class _Stages:
    """`encode_video`'s timer: host seconds per stage, each stage also a
    profiler span."""

    def __init__(self):
        self.seconds = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        from torch.profiler import record_function

        t = time.perf_counter()
        try:
            with record_function(f"encode_video:{name}"):
                yield
        finally:
            self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t


class Encode(Driver):
    ENTRY = "encode_video"

    def setup(self):
        t = self.traffic
        self.sources = [clip_planes(self.w, self.h, t["frames_per_clip"], self.seed, c, self.dev)
                        for c in range(t["clips"])]
        for src in self.sources:
            self._call(src, None)
        self.sync()
        self.outputs = [[] for _ in self.sources]

    def trace_spans(self):
        super().trace_spans()
        self.stages = _Stages()

    def _call(self, src, timer):
        cfg = self.cfg
        return self.entry(*src, cfg["fps"], cfg["quality"], keyframes=cfg["keyframe_interval"],
                          timer=timer, device=self.dev)

    def window(self, seconds: float):
        n = len(self.sources)
        t0 = time.perf_counter()
        while True:
            c = self.calls % n
            try:
                with self.span("bench.call"):
                    self.outputs[c].append(self._call(self.sources[c], self.stages))
                self.frames += self.sources[c][0].shape[0]
            except Exception as e:  # noqa: BLE001 - a failed call is counted, not fatal
                self.failed += 1
                self.error = repr(e)
            self.calls += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.elapsed = time.perf_counter() - t0
        return {"encode_fps": self.frames / self.elapsed}

    def reference_bytes(self, src, ar: Arith):
        """The reference encoder's .pfv bytes and per-frame work."""
        cfg = self.cfg
        enc = Encoder(self.w, self.h, self.qtables, cfg["quality"], self.dev, ar)
        payloads, frames = [], []
        for f in range(src[0].shape[0]):
            planes = [torch.from_numpy(p[f]) for p in src]
            if f % cfg["keyframe_interval"] == 0:
                c, mvx, mvy, hc = enc.iframe(planes)
                payloads.append((1, frame_payload(c, INTRA_QIDX)))
                ftype = 1
            else:
                c, mvx, mvy, hc = enc.pframe(planes)
                payloads.append((2, frame_payload(c, INTER_QIDX, (mvx, mvy, hc))))
                ftype = 2
            frames.append(_frame_work((ftype, None, c, mvx, mvy, hc), c.shape[0]))
        return container(self.w, self.h, cfg["fps"], self.qtables, payloads), frames

    def check(self, ar: Arith):
        bad = compared = 0
        work = []
        for src, outs in zip(self.sources, self.outputs):
            ref, frames = self.reference_bytes(src, ar)
            for out in outs:
                a = np.frombuffer(out, np.uint8)
                b = np.frombuffer(ref, np.uint8)
                m = min(a.size, b.size)
                bad += int((a[:m] != b[:m]).sum()) + abs(a.size - b.size)
                compared += 1
            work.append((len(outs), frames))
        return {"mismatched_bytes": bad, "clips_compared": compared}, work


DRIVERS = {"decode": Decode, "encode": Encode}
