"""One stream's GOP runs decoded over a list of devices (counterpart of
pfv_tpu/parallel/gops.py).

The P-frame chain is sequential, but an I-frame resets the prediction, so
keyframe-delimited GOPs are independent. The stream is cut in the container,
at I-packets, into one run of whole GOPs per device (header + packets + EOF:
a stream of its own), the runs balanced by frames and the shorter ones
padded to the longest with all-skip P-packets; the runs decode as a stream
batch, each through the route its packets give it, and the frames are put
back in order on the first device, the pad frames cut.
"""

from __future__ import annotations

import struct

import torch

from pfv_torch.dec import balanced_bounds, keyframe_runs, keyframes_of, scan_packets
from pfv_torch.device import INTER_Q
from pfv_torch.frame import geometry
from pfv_torch.parallel.devices import as_devices
from pfv_torch.parallel.streams import decode_stream_batch, joined


def skip_pframe_packet(width: int, height: int) -> bytes:
    """A P-frame packet in which every block is skipped: a 16-byte all-zero
    frequency table (no symbol is ever read, and an empty Huffman tree is
    legal), the encoder's P-frame q-table indices (2, 3, 3), as the JAX
    package's pad packet has them, then two zero header bits per block,
    byte-aligned. It decodes as a copy of the frame
    before it."""
    payload = bytes(16) + bytes(INTER_Q) + bytes((2 * geometry(width, height).nb + 7) // 8)
    return struct.pack("<BI", 2, len(payload)) + payload


def split_gop_runs(data: bytes, n: int):
    """Cut one stream into n streams of the same geometry, each a
    contiguous run of whole GOPs, the frame counts balanced, the shorter
    runs padded to the longest with all-skip P-packets.

    Returns (substreams, frames): frames[k] counts the stream's frames in
    run k, as `runtime.count_frames` counts them (a drop frame and an
    unknown packet make no frame, start no GOP and stay with the run they
    lie in). Raises ValueError unless the first frame is an I-frame and
    there are at least n GOPs."""
    info, spans = scan_packets(data)
    starts, frames = keyframes_of(spans)
    if len(starts) < n:
        raise ValueError(f"stream has {len(starts)} GOPs < {n} devices; GOP sharding "
                         "needs at least one GOP per device")
    bounds = balanced_bounds(starts, frames, n)
    counts = [b - a for a, b in zip(bounds, [*bounds[1:], frames])]
    pad = skip_pframe_packet(info["width"], info["height"])
    tails = [pad * (max(counts) - c) for c in counts]
    return list(keyframe_runs(data, spans, bounds, tails)), counts


def decode_video_gops(data: bytes, devices=None, num_threads: int = 0,
                      want: str = "yuv"):
    """Decode one stream with its GOP runs spread over `devices` (all CUDA
    devices unless given; at least as many GOPs as devices) -> the frames
    in order on devices[0]: a (y, u, v) triple of (F, ...) u8 for want
    "yuv", (F, H, W, 3) u8 for "rgb", (F, H, W) uint32 for "rgba"."""
    devices = as_devices(devices)
    subs, counts = split_gop_runs(data, len(devices))
    shards, _ = decode_stream_batch(subs, devices, num_threads, want)

    def stitch(parts):
        return joined(torch.cat, [p[0, :c].to(devices[0]) for p, c in zip(parts, counts)])

    if want == "yuv":
        return tuple(stitch([s[j] for s in shards]) for j in range(3))
    return stitch(shards)
