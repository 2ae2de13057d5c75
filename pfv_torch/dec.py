"""The streaming PFV Decoder on one device (counterpart of pfv_tpu/dec.py).

Packet demux and entropy decode run on the host (the shared C++ runtime);
each frame's coefficients and block headers are copied to the device in one
upload from a pinned staging buffer, and the frame step
(kernels/frame_step.py: K5's iDCT and K7's motion compensation as one
kernel) decodes its three planes into a fused (chh, cw) canvas (frame.py)
in one launch. The framebuffer
stays on the device between frames: two canvases, the previous frame and
the one being written. The decoder is configured by the bitstream: the
q-tables ride in the header, and per-frame indices pick one per plane.

`FrameDecoder` is the per-frame step itself; the whole-clip decode
(dataloader.py) runs it in `decode_frames`, which the tests and the chip
check hold the whole-clip routes to, and for a geometry too large for its
dense coefficients.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Callable

import numpy as np
import torch

from pfv_torch import runtime
from pfv_torch.frame import (Geometry, VideoFrame, canvas_layout, geometry, initial_canvas,
                             slice_yuv)
from pfv_torch.kernels.frame_step import FrameStep

PFV_MAGIC = b"PFVIDEO\0"
PFV_VERSION = 211


class DecodeError(Exception):
    """Decode failure; the subclasses mirror the reference's taxonomy
    (FormatError / VersionError / IOError)."""


class FormatError(DecodeError):
    """Bad magic or malformed container."""


class VersionError(DecodeError):
    """Codec version mismatch."""


class StreamIOError(DecodeError, EOFError):
    """Truncated or unreadable stream, or a corrupt payload. Also an
    EOFError, as the JAX package's is."""


def scan_packets(data: bytes):
    """-> (header info, [(start, end, ptype)]): the byte span, its 5-byte
    packet header included, of every packet of `data` before the EOF packet,
    drop frames and unknown packets included. Stops at the EOF packet, or
    where less than a packet header is left, as the scalar decoder does;
    raises ValueError where a payload runs past the end."""
    info, off = runtime.parse_header(data)
    spans = []
    while off + 5 <= len(data):
        ptype, plen = struct.unpack_from("<BI", data, off)
        end = off + 5 + plen
        if end > len(data):
            raise ValueError("corrupt packet stream: a payload runs past the end")
        if ptype == 0:
            break
        spans.append((off, end, ptype))
        off = end
    return info, spans


def makes_frame(start: int, end: int, ptype: int) -> bool:
    """Whether the packet of that span makes a frame: an I-packet with a
    payload or a P-packet. A drop frame (an I-packet without one, quirk Q8)
    and an unknown packet make none, as `runtime.count_frames` counts."""
    return ptype == 2 or (ptype == 1 and end - start > 5)


def split_packets(data: bytes):
    """-> (header info, [(ptype, payload)]): `scan_packets`' packets, the
    payloads as memoryviews."""
    info, spans = scan_packets(data)
    view = memoryview(data)
    return info, [(t, view[a + 5:b]) for a, b, t in spans]


EOF_PACKET = struct.pack("<BI", 0, 0)


def keyframes_of(spans) -> tuple[list[int], int]:
    """-> (the frame index of every I-frame, the number of frames) of
    `scan_packets`' spans. Raises ValueError unless the first frame is an
    I-frame: only then is every keyframe-delimited run a stream of its
    own."""
    kinds = [t for a, b, t in spans if makes_frame(a, b, t)]
    starts = [i for i, t in enumerate(kinds) if t == 1]
    if not starts or starts[0] != 0:
        raise ValueError("stream must start with an I-frame")
    return starts, len(kinds)


def balanced_bounds(starts, frames: int, n: int) -> list[int]:
    """The first frame of each of n contiguous runs of whole GOPs, their
    frame counts balanced: a run ends at the GOP with which the running
    count reaches its proportional share of `frames`, or where only one GOP
    is left for each run to come. starts: the I-frames' indices, the first
    0, at least n of them."""
    bounds, run = [0], 1
    for k, gop_end in enumerate([*starts[1:], frames], 1):
        left = len(starts) - k
        if run < n and left >= n - run and (gop_end >= frames * run / n
                                            or left == n - run):
            bounds.append(gop_end)
            run += 1
    return bounds


def keyframe_runs(data: bytes, spans, bounds, tails=None):
    """A stream cut before frames into streams of their own, run by run (a
    generator of bytes: the stream's header, the run's packets, `tail`, an
    EOF packet). spans: `scan_packets`' spans; bounds: ascending frame
    indices, the first 0: an I-frame's each where every run must decode
    alone, any frame's where the decoder hands a run the last canvas of the
    run before it (the dense route's chunks). Run k holds the packets
    from frame bounds[k] up to frame bounds[k + 1] (the first run from the
    first packet, the last to the last): a packet that makes no frame stays
    with the run it lies in. tails[k], where given, goes between run k's
    packets and its EOF packet."""
    frames = [i for i, s in enumerate(spans) if makes_frame(*s)]
    cuts = [0] + [frames[b] for b in bounds[1:]] + [len(spans)]
    view, header = memoryview(data), data[:spans[0][0]]
    for k, (a, b) in enumerate(zip(cuts, cuts[1:])):
        yield b"".join([header, view[spans[a][0]:spans[b - 1][1]],
                        tails[k] if tails else b"", EOF_PACKET])


def frame_packets(data: bytes):
    """The packets of `data` that make a frame, in stream order: I-packets
    with a payload and P-packets. Drop frames (I-packets without one,
    quirk Q8) and unknown packets make none."""
    return [(t, p) for t, p in split_packets(data)[1]
            if (t == 1 and len(p)) or t == 2]


class FrameDecoder:
    """Decodes one frame packet into a fused canvas on `device`, from the
    canvas of the frame before it, in three steps that can be timed apart:
    `entropy` (host), `upload` (host to device), `planes` (the frame step,
    one launch for Y, U and V).

    The entropy decoder writes straight into one staging buffer per
    decoder (pinned host memory on a CUDA device): the frame's (nb, 256)
    i16 coefficients, then its header rows mvy, mvx and has_coeff, (nb,)
    each. `upload` copies the buffer to its device twin, `coeffs` and
    `motion`, in one asynchronous copy and records an event; `entropy`
    waits on that event before it writes the buffer again. The buffers are
    checked against the frame step once, here."""

    def __init__(self, g: Geometry, qtables: np.ndarray, device):
        self.g = g
        self.step = FrameStep(qtables, canvas_layout(g), device)
        self.device = self.step.device
        self.qtables = self.step.qtables
        nb, cuda = g.nb, self.device.type == "cuda"
        size = 512 * nb + 3 * nb
        self._host = torch.empty(size, dtype=torch.uint8, pin_memory=cuda)
        host = self._host.numpy()
        self._coeffs_h = host[:512 * nb].view(np.int16).reshape(nb, 256)
        self._motion_h = host[512 * nb:].view(np.int8).reshape(3, nb)
        self._buf = torch.empty(size, dtype=torch.uint8, device=self.device)
        self.coeffs = self._buf[:512 * nb].view(torch.int16).view(nb, 256)
        mvy, mvx, hc = self._buf[512 * nb:].view(torch.int8).view(3, nb)
        self.motion = (mvy, mvx, hc.view(torch.uint8))
        self._copied = torch.cuda.Event() if cuda else None
        self.step.check(self.coeffs, self.motion, (0,) * 3, self.initial_canvas(),
                        self.initial_canvas())

    def initial_canvas(self) -> torch.Tensor:
        """The framebuffer before the first frame: Y 0, U and V 128."""
        return initial_canvas(self.g, self.device)

    def entropy(self, ptype: int, payload):
        """Host: payload -> the staging buffer; returns (intra, q-table
        indices). Raises ValueError on a corrupt payload, a motion vector
        whose window leaves the padded plane, or a q-table index the header
        does not have."""
        g = self.g
        if self._copied is not None:
            self._copied.synchronize()  # the last upload has read the buffer
        if ptype == 1:
            _, qidx = runtime.decode_iframe_payload(payload, g.nb, out=self._coeffs_h)
        else:
            mvy, mvx, hc = self._motion_h
            _, _, _, _, qidx = runtime.decode_pframe_payload(
                payload, g.nb, out=(self._coeffs_h, mvx, mvy, hc.view(np.uint8)))
            runtime.validate_motion(mvx, mvy, (g.ly0, g.lyw), (g.lc0, g.lcw))
        nq = self.step.nq
        if (qidx >= nq).any():
            raise ValueError(f"corrupt payload: q-table index {list(qidx)} out of "
                             f"range (header has {nq} tables)")
        return ptype == 1, tuple(int(q) for q in qidx)

    def upload(self, frame):
        """The staging buffer -> `coeffs` and `motion` on the device, one
        copy; returns `frame`, `entropy`'s result."""
        self._buf.copy_(self._host, non_blocking=True)
        if self._copied is not None:
            # the copy runs on the device's current stream, which need not be
            # the current device's
            self._copied.record(torch.cuda.current_stream(self.device))
        return frame

    def planes(self, frame, out: torch.Tensor, prev: torch.Tensor) -> None:
        """The frame step of the uploaded frame: canvas `out` from canvas
        `prev` (apart from each other), one launch."""
        intra, qidx = frame
        self.step.check_canvases(None if intra else prev, out)
        self.step.launch(self.coeffs, None if intra else self.motion, qidx, prev, out)

    def decode(self, ptype: int, payload, out: torch.Tensor,
               prev: torch.Tensor) -> None:
        self.planes(self.upload(self.entropy(ptype, payload)), out, prev)


class Decoder:
    """Streaming PFV decoder over a seekable binary reader, on `device`.

    The container may start at any byte offset of the reader; all seeks are
    relative to the position at construction time.
    """

    def __init__(self, reader: BinaryIO, num_threads: int = 0, device="cuda"):
        self._reader = reader
        self._num_threads = num_threads
        self._header_start = reader.tell()

        magic = reader.read(8)
        if len(magic) < 8:
            raise StreamIOError("unexpected end of stream in header")
        if magic != PFV_MAGIC:
            raise FormatError("format error: bad magic")
        raw = reader.read(12)
        if len(raw) < 12:
            raise StreamIOError("unexpected end of stream in header")
        (version,) = struct.unpack("<I", raw[:4])
        if version != PFV_VERSION:
            raise VersionError(f"version error: {version} != {PFV_VERSION}")
        w, h, fps, nq = struct.unpack("<HHHH", raw[4:])
        self._width, self._height, self._framerate = w, h, fps
        qt_raw = reader.read(nq * 128)
        if len(qt_raw) < nq * 128:
            raise StreamIOError("unexpected end of stream in q-tables")
        self.qtables = np.frombuffer(qt_raw, dtype="<u2").astype(np.int32).reshape(nq, 64)

        self._reset_pos = reader.tell()
        self._delta_accum = 0.0
        self._eof = False

        self._g = geometry(w, h)
        self._frames = FrameDecoder(self._g, self.qtables, device)
        self._fb = self._frames.initial_canvas()  # the frame last shown
        self._back = torch.empty_like(self._fb)   # the frame being written

    # -- accessors --------------------------------------------------------

    def width(self) -> int:
        return self._width

    def height(self) -> int:
        return self._height

    def framerate(self) -> int:
        return self._framerate

    # -- playback control -------------------------------------------------

    def reset(self) -> None:
        """Rewind to the first packet. The framebuffer is kept."""
        self._eof = False
        self._reader.seek(self._reset_pos)

    def advance_delta(self, delta: float,
                      onvideo: Callable[[VideoFrame], None]) -> bool:
        """Time-accumulator playback pump: decode as many frames as `delta`
        seconds cover at the stream's frame rate."""
        self._delta_accum += delta
        delta_per_frame = 1.0 / self._framerate
        while self._delta_accum >= delta_per_frame:
            if not self.advance_frame(onvideo):
                return False
            self._delta_accum -= delta_per_frame
        return True

    def advance_frame(self, onvideo: Callable[[VideoFrame], None]) -> bool:
        """Decode the next frame; returns False at EOF.

        Drop frames (I-packet, zero payload) consume a frame slot without
        invoking the callback (quirk Q8). Unknown packet types are skipped.
        """
        if self._eof:
            return False
        while True:
            hdr = self._reader.read(5)
            if len(hdr) < 5:
                raise StreamIOError("unexpected end of stream")
            ptype, plen = struct.unpack("<BI", hdr)
            if ptype == 0:
                self._eof = True
                return False
            if (ptype == 1 and plen > 0) or ptype == 2:
                self._decode(ptype, self._read_payload(plen))
                onvideo(self._emit())
                return True
            if ptype == 1:  # drop frame
                return True
            self._reader.seek(plen, 1)  # unknown packet: skip its payload

    def decode_all(self) -> list[VideoFrame]:
        """Decode every remaining frame through the whole-clip path
        (`pfv_torch.decode_video_yuv`) and fetch them in one batch.

        Must be called with the stream at the first packet (a fresh decoder
        or after reset()): P-frames reference preceding state. Leaves the
        stream at EOF.
        """
        from pfv_torch.dataloader import decode_video_yuv

        if self._eof:
            return []
        pos = self._reader.tell()
        if pos != self._reset_pos:
            raise ValueError("decode_all requires the stream at the first "
                             "packet; call reset() first")
        rest = self._reader.read()
        self._eof = True
        if not rest:
            return []
        # a standalone stream: header + remaining packets (the container
        # may be embedded at any offset of the reader)
        self._reader.seek(self._header_start)
        header = self._reader.read(self._reset_pos - self._header_start)
        self._reader.seek(pos + len(rest))
        ys, us, vs = (p.cpu().numpy() for p in decode_video_yuv(
            header + rest, self._frames.device, self._num_threads))
        return [VideoFrame(self._width, self._height, ys[i], us[i], vs[i])
                for i in range(ys.shape[0])]

    # -- internals --------------------------------------------------------

    def _read_payload(self, plen: int) -> bytes:
        payload = self._reader.read(plen)
        if len(payload) < plen:
            raise StreamIOError("unexpected end of stream in packet payload")
        return payload

    def _decode(self, ptype: int, payload: bytes) -> None:
        try:
            host = self._frames.entropy(ptype, payload)
        except ValueError as e:
            raise StreamIOError(str(e)) from e
        self._frames.planes(self._frames.upload(host), self._back, self._fb)
        self._fb, self._back = self._back, self._fb

    def _emit(self) -> VideoFrame:
        """The frame last decoded, copied to the host: unpadded planes."""
        host = self._fb.to("cpu", copy=True).numpy()
        return VideoFrame(self._width, self._height, *slice_yuv(self._g, host))
