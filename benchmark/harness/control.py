"""The control of the comparisons: the reference, its transforms' truncating
divisions floored (`Arith(floor=True)`), put in the program's place behind
the same entry names. A run with `--control 1` has to read not correct.

It is handed the inputs the driver made: a decode call's bytes and an
encode call's planes are matched, by identity, to the clip they came from,
whose symbols or sources the control then works from.
"""

from __future__ import annotations

import torch

from reference.codec import Arith
from reference.color import rgba_words


class Control:
    def __init__(self):
        self.ar = Arith(floor=True)
        self.driver = None

    def bind(self, driver):
        self.driver = driver

    def _clip_of(self, data):
        return next(c for c, d in zip(self.driver.clips, self.driver.data) if d is data)

    def decode_video_rgba(self, data, device="cuda"):
        clip, d = self._clip_of(data), self.driver
        return torch.stack([rgba_words(*p, d.h, d.w) for p in clip.decoded(self.ar)])

    def encode_video(self, y, u, v, fps, quality, keyframes, timer=None, device="cuda"):
        d = self.driver
        src = next(s for s in d.sources if s[0] is y)
        return d.reference_bytes(src, self.ar)[0]

