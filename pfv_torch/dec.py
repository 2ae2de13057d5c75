"""The streaming PFV Decoder on one device (counterpart of pfv_tpu/dec.py).

Packet demux and entropy decode run on the host (the shared C++ runtime);
each frame's coefficients and block headers are copied to the device in one
upload each, and every plane is decoded by kernels K5 (iDCT) and K7 (motion
compensation) into a fused (chh, cw) canvas (frame.py). The framebuffer
stays on the device between frames: two canvases, the previous frame and
the one being written. The decoder is configured by the bitstream: the
q-tables ride in the header, and per-frame indices pick one per plane.

`FrameDecoder` is the per-frame step itself; the whole-clip decode
(dataloader.py) also runs it, for streams its K1 path does not take.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Callable

import numpy as np
import torch

from pfv_torch import runtime
from pfv_torch.device import iframe_decode_plane, origins_for, pframe_decode_plane
from pfv_torch.frame import Geometry, VideoFrame, canvas_planes, geometry, slice_yuv

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


def split_packets(data: bytes):
    """-> (header info, [(ptype, payload)]): every packet of `data` before
    the EOF packet, drop frames and unknown packets included, payloads as
    memoryviews. Stops at the EOF packet, or where less than a packet
    header is left, as the scalar decoder does; raises ValueError where a
    payload runs past the end."""
    info, off = runtime.parse_header(data)
    view = memoryview(data)
    packets = []
    while off + 5 <= len(data):
        ptype, plen = struct.unpack_from("<BI", data, off)
        off += 5
        if off + plen > len(data):
            raise ValueError("corrupt packet stream: a payload runs past the end")
        if ptype == 0:
            break
        packets.append((ptype, view[off:off + plen]))
        off += plen
    return info, packets


def frame_packets(data: bytes):
    """The packets of `data` that make a frame, in stream order: I-packets
    with a payload and P-packets. Drop frames (I-packets without one,
    quirk Q8) and unknown packets make none."""
    return [(t, p) for t, p in split_packets(data)[1]
            if (t == 1 and len(p)) or t == 2]


class FrameDecoder:
    """Decodes one frame packet into a fused canvas on `device`, from the
    canvas of the frame before it, in three steps that can be timed apart:
    `entropy` (host), `upload` (host to device), `planes` (K5 + K7 for each
    of Y, U, V)."""

    def __init__(self, g: Geometry, qtables: np.ndarray, device):
        self.g = g
        self.device = torch.device(device)
        self.qtables = torch.from_numpy(
            np.ascontiguousarray(qtables, dtype=np.int32)).to(self.device)
        oy = origins_for(g.ly0, g.lyw, self.device)
        oc = origins_for(g.lc0, g.lcw, self.device)
        yb, cb = g.yb, g.cb
        self._parts = ((slice(0, yb), oy), (slice(yb, yb + cb), oc),
                       (slice(yb + cb, g.nb), oc))

    def initial_canvas(self) -> torch.Tensor:
        """The framebuffer before the first frame: Y 0, U and V 128."""
        g = self.g
        c = torch.zeros((g.chh, g.cw), dtype=torch.uint8, device=self.device)
        c[g.ly0:, :2 * g.lcw] = 128
        return c

    def entropy(self, ptype: int, payload):
        """Host: payload -> (intra, (nb, 256) i16 coefficients, (3, nb) int8
        [mvy, mvx, has_coeff] or None, q-table indices). Raises ValueError
        on a corrupt payload, a motion vector whose window leaves the
        padded plane, or a q-table index the header does not have."""
        g = self.g
        if ptype == 1:
            coeffs, qidx = runtime.decode_iframe_payload(payload, g.nb)
            hdr = None
        else:
            coeffs, mvx, mvy, hc, qidx = runtime.decode_pframe_payload(payload, g.nb)
            runtime.validate_motion(mvx, mvy, (g.ly0, g.lyw), (g.lc0, g.lcw))
            hdr = np.stack([mvy, mvx, hc.view(np.int8)])
        nq = self.qtables.shape[0]
        if (qidx >= nq).any():
            raise ValueError(f"corrupt payload: q-table index {list(qidx)} out of "
                             f"range (header has {nq} tables)")
        return ptype == 1, coeffs, hdr, [int(q) for q in qidx]

    def upload(self, host):
        """`entropy`'s arrays -> tensors on the device (two copies)."""
        intra, coeffs, hdr, qidx = host
        dev = self.device
        return (intra, torch.from_numpy(coeffs).to(dev),
                None if hdr is None else torch.from_numpy(hdr).to(dev), qidx)

    def plane_args(self, frame):
        """Per plane (Y, U, V) of an uploaded frame: (coeffs (N, 256) i16,
        q-table (64,) i32, by, bx (N,) i32 origins, mvy, mvx (N,) int8,
        has_coeff (N,) u8), the motion inputs None for an I-frame."""
        _, coeffs, hdr, qidx = frame
        for (sl, (by, bx)), qi in zip(self._parts, qidx):
            motion = ((None,) * 3 if hdr is None else
                      (hdr[0, sl], hdr[1, sl], hdr[2, sl].view(torch.uint8)))
            yield (coeffs[sl], self.qtables[qi], by, bx, *motion)

    def planes(self, frame, out: torch.Tensor, prev: torch.Tensor) -> None:
        """K5 + K7 for each plane of an uploaded frame: canvas `out` from
        canvas `prev` (distinct tensors)."""
        for (coeffs, q, by, bx, mvy, mvx, hc), o, p in zip(
                self.plane_args(frame), canvas_planes(self.g, out),
                canvas_planes(self.g, prev)):
            if frame[0]:
                iframe_decode_plane(coeffs, q, p, by, bx, o)
            else:
                pframe_decode_plane(coeffs, mvx, mvy, hc, p, q, by, bx, o)

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
