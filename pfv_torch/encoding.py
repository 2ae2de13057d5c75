"""Whole-clip encode: every frame on the device, one compaction, one fetch,
then the host mux (counterpart of pfv_tpu/encoding.py `encode_video` and
`encode_video_gops`).

The planes go to the device as they come, one copy each, and are padded to
whole macroblocks there. Each frame is encoded as the streaming Encoder
does, through a `device.FrameEncoder` (for a P-frame one launch of K8, the
motion search; one of K6, one of the in-loop frame step); K6 writes its
coefficients, zeros in skipped blocks, straight into one (F, nb, 256) int16
buffer. `torch.nonzero` compacts it (the JAX package needs a counting pass
and a guessed cap for this: XLA has no data-dependent shapes) in runs of
whole frames, each of fewer than `COMPACT_LIMIT` elements, one run where the
clip fits; one copy brings the nonzeros and the block headers to the host,
and the C++ runtime entropy-codes every frame from its nonzeros in one call,
on a pool of workers kept between calls. The bytes equal the streaming
Encoder's and the JAX package's.
`encode_video_gops` gives each of a list of devices a run of whole GOPs and
muxes once.
"""

from __future__ import annotations

import contextlib
import struct
from typing import Sequence

import numpy as np
import torch

from pfv_torch import runtime
from pfv_torch.dec import balanced_bounds
from pfv_torch.device import INTER_Q, INTRA_Q, FrameEncoder, upload_padded
from pfv_torch.enc import container_header
from pfv_torch.frame import geometry
from pfv_torch.ops.pframe import skip_threshold
from pfv_torch.ops.quant import derive_q_tables
from pfv_torch.parallel.devices import as_devices
from pfv_torch.utils.profiling import count, recording, span

# INT_MAX: CUDA builds of PyTorch before large-tensor support refuse a
# `torch.nonzero` of this many elements or more, and a 4K clip's coefficient
# buffer passes it at 173 frames. A run of the compaction holds fewer.
COMPACT_LIMIT = 2**31 - 1


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


def _check_planes(y, u, v) -> None:
    f, h, w = y.shape
    if w % 2 or h % 2:
        raise ValueError("width and height must be even (4:2:0 chroma)")
    if u.shape != (f, h // 2, w // 2) or v.shape != u.shape:
        raise ValueError(f"chroma planes must be (F, H/2, W/2); got {u.shape} / "
                         f"{v.shape} for luma {y.shape}")


def _encode_frames(enc: FrameEncoder, src, is_key):
    """The frame loop over a run of frames that opens with a keyframe: each
    of the padded (F, ph, pw) u8 planes `src` on enc's device through
    `enc` -> (coeffs (F, nb, 256) i16, zeros in skipped blocks, mvx, mvy, hc
    (F, nb)) on the device. Nothing here waits for the device."""
    g, dev = enc.g, enc.device
    f = src[0].shape[0]
    live = torch.empty((f, g.nb, 256), dtype=torch.int16, device=dev)
    mvx = torch.zeros((f, g.nb), dtype=torch.int8, device=dev)
    mvy = torch.zeros((f, g.nb), dtype=torch.int8, device=dev)
    hc = torch.ones((f, g.nb), dtype=torch.uint8, device=dev)
    enc.check([p[0] for p in src], live[0], (mvy[0], mvx[0], hc[0]))
    with span("encode.frame_loop"):
        for t in range(f):
            planes = [p[t] for p in src]
            if is_key[t]:
                enc.iframe(planes, live[t])
            else:
                enc.pframe(planes, live[t], (mvy[t], mvx[t], hc[t]))
    return live, mvx, mvy, hc


def compact_runs(f: int, nb: int) -> list[tuple[int, int]]:
    """The runs of whole frames, (first, end) in order, that `_compact` cuts
    an (f, nb, 256) coefficient buffer into: as many frames each as hold
    fewer than `COMPACT_LIMIT` coefficients (at least one), the last run
    the rest."""
    step = max(1, (COMPACT_LIMIT - 1) // (nb * 256))
    return [(a, min(a + step, f)) for a in range(0, f, step)]


def _compact(live, mvx, mvy, hc):
    """The compaction of `_encode_frames`' run -> (idx, val, counts, mvx,
    mvy, hc) on the device: every frame's nonzero coefficients (frame-local
    flat indices in ascending order, their values, the number per frame)
    and the block headers. Each run of `compact_runs` is one `torch.nonzero`,
    one gather and one `bincount`; the runs' outputs are joined in frame
    order. `torch.nonzero` waits for the device."""
    f, nb = live.shape[:2]
    parts = []
    with span("encode.compact"):
        runs = compact_runs(f, nb)
        count("encode.coeff_bytes", live.nbytes)
        count("encode.compact_runs", len(runs))
        for a, b in runs:
            with span("encode.compact_run"):
                flat = live[a:b].view(b - a, -1)
                frame_of, idx = torch.nonzero(flat, as_tuple=True)
                val = flat[frame_of, idx]
                counts = torch.bincount(frame_of, minlength=b - a)
                parts.append((idx.to(torch.int32), val, counts))
        joined = parts[0] if len(parts) == 1 else [torch.cat(p) for p in zip(*parts)]
        return (*joined, mvx, mvy, hc)


def _mux(w: int, h: int, framerate: int, qt_host, nb: int, is_key, idx, val, counts,
         mvx, mvy, hc) -> bytes:
    """The host mux: the container's header, every frame's packet
    entropy-coded from its nonzeros (`_compact`'s arrays, on the host) in
    one call of the native coder's worker pool, the EOF packet."""
    with span("encode.entropy"):
        packets = runtime.encode_packets_sparse(is_key, idx, val, counts, mvx, mvy, hc, nb,
                                                INTRA_Q, INTER_Q)
    return b"".join([container_header(w, h, framerate, qt_host), packets,
                     struct.pack("<BI", 0, 0)])


def encode_video(y: np.ndarray, u: np.ndarray, v: np.ndarray, framerate: int,
                 quality: int, keyframes: Sequence[bool] | int = 15, timer=None,
                 device="cuda") -> bytes:
    """Encode 4:2:0 planes (F, H, W), (F, H/2, W/2) x2 uint8 -> .pfv bytes.

    `keyframes`: an int interval (frames 0, interval, 2 * interval, ... are
    I-frames) or an explicit bool mask whose first entry is set. `timer`,
    any object whose `stage(name)` is a context manager, receives the
    stages "h2d upload", "device encode", "d2h fetch" and "host mux"; the
    device stages end with a synchronize. Each stage is also the span
    "pfv.encode." + its name in snake case (`utils.profiling.span`).
    While a profiler session records on a CUDA device, the call resets the
    device's peak of allocated memory and adds it, read after the fetch, to
    the counter "encode.live_peak_bytes" (0 on other devices).
    Byte-identical to feeding the frames through the streaming Encoder.
    """
    stage = timer.stage if timer is not None else (lambda name: contextlib.nullcontext())
    f, h, w = y.shape
    _check_planes(y, u, v)
    is_key = _keyframe_mask(keyframes, f)
    qt_host = derive_q_tables(quality)
    dev = torch.device(device)
    g = geometry(w, h)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    peak = recording() and dev.type == "cuda"
    if peak:
        torch.cuda.reset_peak_memory_stats(dev)

    with stage("h2d upload"), span("encode.h2d_upload"):
        with span("encode.encoder_setup"):
            enc = FrameEncoder(g, qt_host, skip_threshold(quality), dev)
        with span("encode.source_upload"):
            count("encode.h2d_bytes", y.nbytes + u.nbytes + v.nbytes)
            src = upload_padded(g, (y, u, v), dev)
            sync()

    with stage("device encode"), span("encode.device_encode"):
        coded = _compact(*_encode_frames(enc, src, is_key))
        with span("encode.device_wait"):
            sync()

    with stage("d2h fetch"), span("encode.d2h_fetch"):
        coded = [t.cpu().numpy() for t in coded]
    count("encode.live_peak_bytes", torch.cuda.max_memory_allocated(dev) if peak else 0)

    with stage("host mux"), span("encode.host_mux"):
        return _mux(w, h, framerate, qt_host, g.nb, is_key, *coded)


def encode_video_gops(y: np.ndarray, u: np.ndarray, v: np.ndarray, framerate: int,
                      quality: int, keyframes: Sequence[bool] | int = 15,
                      devices=None) -> bytes:
    """`encode_video` over a list of devices (all CUDA devices unless
    given), byte-identical output. An I-frame resets the reconstruction, so
    keyframe-delimited GOPs encode independently: the clip is cut into
    contiguous runs of whole GOPs, balanced by frames, one run per device
    (as many runs as there are GOPs, where those are fewer). One thread
    enqueues each device's run in turn through `encode_video`'s frame loop,
    so a device works while the next one's run is enqueued; then each run is
    compacted and fetched, and one host mux writes the frames in order."""
    f, h, w = y.shape
    _check_planes(y, u, v)
    is_key = _keyframe_mask(keyframes, f)
    devices = as_devices(devices)
    qt_host = derive_q_tables(quality)
    g = geometry(w, h)
    starts = np.flatnonzero(is_key).tolist()
    devices = devices[:len(starts)]
    bounds = [*balanced_bounds(starts, f, len(devices)), f]
    runs = []
    for dev, a, b in zip(devices, bounds, bounds[1:]):
        enc = FrameEncoder(g, qt_host, skip_threshold(quality), dev)
        src = upload_padded(g, [p[a:b] for p in (y, u, v)], dev)
        runs.append(_encode_frames(enc, src, is_key[a:b]))
    runs = [[t.cpu().numpy() for t in _compact(*run)] for run in runs]
    coded = [np.concatenate(part) for part in zip(*runs)]
    return _mux(w, h, framerate, qt_host, g.nb, is_key, *coded)
