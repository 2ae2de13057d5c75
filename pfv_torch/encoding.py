"""Whole-clip encode: every frame on the device, one compaction, one fetch,
then the host mux (counterpart of pfv_tpu/encoding.py `encode_video`).

The frames go to the device in one upload. Each frame is encoded as the
streaming Encoder does, through a `device.FrameEncoder` (motion search, one
launch of K6, one of the in-loop frame step); K6 writes its coefficients,
zeros in skipped blocks, straight into one (F, nb, 256) int16 buffer. One
`torch.nonzero` compacts the clip (the JAX package needs a counting pass
and a guessed cap for this: XLA has no data-dependent shapes), one copy brings the nonzeros and the block headers
to the host, and the shared C++ runtime entropy-codes each frame from its
nonzeros. The bytes equal the streaming Encoder's and the JAX package's.
"""

from __future__ import annotations

import contextlib
import struct
from typing import Sequence

import numpy as np
import torch

from pfv_torch import runtime
from pfv_torch.device import INTER_Q, INTRA_Q, FrameEncoder
from pfv_torch.enc import container_header
from pfv_torch.frame import geometry
from pfv_torch.ops.pframe import skip_threshold
from pfv_torch.ops.quant import derive_q_tables


def _pad_frames(frames: np.ndarray, ph: int, pw: int, clear: int) -> np.ndarray:
    f, h, w = frames.shape
    if (h, w) == (ph, pw):
        return np.ascontiguousarray(frames)
    out = np.full((f, ph, pw), clear, dtype=np.uint8)
    out[:, :h, :w] = frames
    return out


def _keyframe_mask(keyframes, f: int) -> np.ndarray:
    if isinstance(keyframes, (int, np.integer)):
        is_key = np.arange(f) % keyframes == 0
    else:
        is_key = np.asarray(keyframes, dtype=bool)
        if is_key.shape != (f,):
            raise ValueError(f"keyframe mask {is_key.shape} is not ({f},)")
    if not is_key[0]:
        raise ValueError("the first frame must be a keyframe")
    return is_key


def encode_video(y: np.ndarray, u: np.ndarray, v: np.ndarray, framerate: int,
                 quality: int, keyframes: Sequence[bool] | int = 15, timer=None,
                 device="cuda") -> bytes:
    """Encode 4:2:0 planes (F, H, W), (F, H/2, W/2) x2 uint8 -> .pfv bytes.

    `keyframes`: an int interval (frames 0, interval, 2 * interval, ... are
    I-frames) or an explicit bool mask whose first entry is set. `timer`,
    any object whose `stage(name)` is a context manager, receives the
    stages "h2d upload", "device encode", "d2h fetch" and "host mux"; the
    device stages end with a synchronize. Byte-identical to feeding the
    frames through the streaming Encoder.
    """
    stage = timer.stage if timer is not None else (lambda name: contextlib.nullcontext())
    f, h, w = y.shape
    if w % 2 or h % 2:
        raise ValueError("width and height must be even (4:2:0 chroma)")
    if u.shape != (f, h // 2, w // 2) or v.shape != u.shape:
        raise ValueError(f"chroma planes must be (F, H/2, W/2); got {u.shape} / "
                         f"{v.shape} for luma {y.shape}")
    is_key = _keyframe_mask(keyframes, f)
    qt_host = derive_q_tables(quality)
    dev = torch.device(device)
    g = geometry(w, h)
    shapes, clear = ((g.ly0, g.lyw), (g.lc0, g.lcw), (g.lc0, g.lcw)), (0, 128, 128)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    padded = [_pad_frames(p, *s, c) for p, s, c in zip((y, u, v), shapes, clear)]
    with stage("h2d upload"):
        enc = FrameEncoder(g, qt_host, skip_threshold(quality), dev)
        src = [torch.from_numpy(p).to(dev) for p in padded]
        sync()

    with stage("device encode"):
        live = torch.empty((f, g.nb, 256), dtype=torch.int16, device=dev)
        mvx = torch.zeros((f, g.nb), dtype=torch.int8, device=dev)
        mvy = torch.zeros((f, g.nb), dtype=torch.int8, device=dev)
        hc = torch.ones((f, g.nb), dtype=torch.uint8, device=dev)
        enc.check([p[0] for p in src], live[0], (mvy[0], mvx[0], hc[0]))
        for t in range(f):
            planes = [p[t] for p in src]
            if is_key[t]:
                enc.iframe(planes, live[t])
            else:
                enc.pframe(planes, live[t], (mvy[t], mvx[t], hc[t]))
        # frame-local flat indices, each frame's in ascending order
        flat = live.view(f, -1)
        frame_of, idx = torch.nonzero(flat, as_tuple=True)
        val = flat[frame_of, idx]
        counts = torch.bincount(frame_of, minlength=f)
        idx = idx.to(torch.int32)
        sync()

    with stage("d2h fetch"):
        idx, val, counts, mvx, mvy, hc = (
            t.cpu().numpy() for t in (idx, val, counts, mvx, mvy, hc))

    with stage("host mux"):
        out = [container_header(w, h, framerate, qt_host)]
        ends = np.cumsum(counts)
        for t in range(f):
            lo, hi = ends[t] - counts[t], ends[t]
            if is_key[t]:
                payload = runtime.encode_iframe_payload_sparse(
                    idx[lo:hi], val[lo:hi], g.nb, INTRA_Q)
            else:
                payload = runtime.encode_pframe_payload_sparse(
                    idx[lo:hi], val[lo:hi], mvx[t], mvy[t], hc[t], INTER_Q)
            out += [struct.pack("<BI", 1 if is_key[t] else 2, len(payload)), payload]
        out.append(struct.pack("<BI", 0, 0))
    return b"".join(out)
