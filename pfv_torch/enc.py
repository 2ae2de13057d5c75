"""The streaming PFV Encoder on one device (counterpart of pfv_tpu/enc.py).

Per frame, the three planes go to the device as they come, are padded to
whole macroblocks there, in three device planes the Encoder keeps, and go
through a `device.FrameEncoder`: for a P-frame one launch of kernel K8 (the
motion search of Y, U and V against the previous reconstruction), then
one launch of kernel K6 (the frame-encode step: forward DCT + quantization
of Y, U and V, prediction windows read from the previous reconstruction)
and one launch of the frame step, which reconstructs the frame in the loop
exactly as a decoder will. The dense coefficients come back to the host,
where the shared C++ runtime entropy-codes the packet. The reconstructed
previous frame stays on the device between frames, in two fused canvases
that swap (the frame step never writes over the canvas it reads). The
bytes equal the JAX package's Encoder's.

Quality is inverted (quirk Q4): 0 is the finest, 10 the coarsest.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np
import torch

from pfv_torch import runtime
from pfv_torch.device import (INTER_Q, INTRA_Q, PLANE_CLEAR, FrameEncoder, padded_shapes,
                              plane_mse, upload_padded)
from pfv_torch.frame import VideoFrame, geometry
from pfv_torch.ops.pframe import skip_threshold
from pfv_torch.ops.quant import derive_q_tables

PFV_MAGIC = b"PFVIDEO\0"
PFV_VERSION = 211
PLANES = ("y", "u", "v")


def container_header(width: int, height: int, framerate: int,
                     qtables: dict[str, np.ndarray]) -> bytes:
    """Magic, version, geometry, frame rate and the four q-tables in the
    order intra luma, intra chroma, inter luma, inter chroma."""
    return b"".join(
        [PFV_MAGIC, struct.pack("<IHHHH", PFV_VERSION, width, height, framerate, 4)]
        + [qtables[k].astype("<u2").tobytes()
           for k in ("intra_l", "intra_c", "inter_l", "inter_c")])


class Encoder:
    """Streaming PFV encoder writing to `writer`, encoding on `device`.

    Writes the container header on construction. `num_threads` is accepted
    for API parity and ignored: a frame is two or three kernel launches.
    """

    def __init__(self, writer: BinaryIO, width: int, height: int, framerate: int,
                 quality: int = 5, num_threads: int = 0, device="cuda"):
        del num_threads
        if not 0 <= quality <= 10:
            raise ValueError("quality must be in 0..=10")
        if width % 2 or height % 2:
            raise ValueError("width and height must be even (4:2:0 chroma)")
        self.width = width
        self.height = height
        self.framerate = framerate
        self.device = torch.device(device)
        self._writer = writer
        self._finished = False
        # per-frame observability: payload bytes, skip-block share, and the
        # luma PSNR against the source when collect_psnr is set
        self.collect_psnr = False
        self.stats: list[dict] = []

        self._qt_host = derive_q_tables(quality)
        g = geometry(width, height)
        self._frames = FrameEncoder(g, self._qt_host, skip_threshold(quality), self.device)
        # the padded source planes of the frame in hand; the padding is
        # written here, once
        self._padded = [torch.full(shape, clear, dtype=torch.uint8, device=self.device)
                        for shape, clear in zip(padded_shapes(g), PLANE_CLEAR)]
        # a frame's coefficients and block headers (mvy, mvx, has_coeff)
        self._coeffs = torch.empty((g.nb, 256), dtype=torch.int16, device=self.device)
        headers = torch.zeros((3, g.nb), dtype=torch.int8, device=self.device)
        self._motion = (headers[0], headers[1], headers[2].view(torch.uint8))

        writer.write(container_header(width, height, framerate, self._qt_host))

    def reconstruction(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The reconstructed previous frame as padded (Y, U, V) u8 planes on
        the device: what a decoder shows for the last frame encoded, and
        what the next P-frame is predicted from."""
        return self._frames.planes()

    def _write_packet(self, ptype: int, payload: bytes) -> None:
        self._writer.write(struct.pack("<BI", ptype, len(payload)))
        self._writer.write(payload)

    def _sources(self, frame: VideoFrame):
        """The frame's (Y, U, V) planes, padded, on the device; raises
        ValueError on a frame of another size or a finished encoder."""
        if self._finished:
            raise ValueError("the encoder is finished")
        h, w = self.height, self.width
        want = {"y": (h, w), "u": (h // 2, w // 2), "v": (h // 2, w // 2)}
        planes = dict(zip(PLANES, (frame.plane_y, frame.plane_u, frame.plane_v)))
        if (frame.width, frame.height) != (w, h) or any(
                np.shape(planes[k]) != want[k] for k in PLANES):
            raise ValueError(f"frame {frame.width}x{frame.height} with planes "
                             f"{[np.shape(planes[k]) for k in PLANES]} does not fit "
                             f"the encoder's {w}x{h}")
        src = upload_padded(self._frames.g, [planes[k] for k in PLANES], self.device,
                            self._padded)
        self._frames.check(src, self._coeffs, self._motion)
        return src

    def _psnr(self, src: torch.Tensor) -> float | None:
        if not self.collect_psnr:
            return None
        h, w = self.height, self.width
        mse = float(plane_mse(self._frames.planes()[0][:h, :w], src[:h, :w]))
        return 10.0 * float(np.log10(255.0**2 / max(mse, 1e-9)))

    def encode_iframe(self, frame: VideoFrame) -> None:
        """Intra-encode a frame, q-table indices (0, 1, 1)."""
        src = self._sources(frame)
        self._frames.iframe(src, self._coeffs)
        payload = runtime.encode_iframe_payload(self._coeffs.cpu().numpy(), INTRA_Q)
        self._write_packet(1, payload)
        self.stats.append({"type": "I", "payload_bytes": len(payload),
                           "skip_pct": 0.0, "psnr_y": self._psnr(src[0])})

    def encode_pframe(self, frame: VideoFrame) -> None:
        """Inter-encode a frame against the previous reconstruction, q-table
        indices (2, 3, 3)."""
        src = self._sources(frame)
        self._frames.pframe(src, self._coeffs, self._motion)
        coeffs, mvy, mvx, hc = (t.cpu().numpy() for t in (self._coeffs, *self._motion))
        payload = runtime.encode_pframe_payload(coeffs, mvx, mvy, hc, INTER_Q)
        self._write_packet(2, payload)
        self.stats.append({"type": "P", "payload_bytes": len(payload),
                           "skip_pct": round(100.0 * float((hc == 0).mean()), 2),
                           "psnr_y": self._psnr(src[0])})

    def encode_dropframe(self) -> None:
        """A zero-length I-frame packet (quirk Q8). The previous frame is
        left as it was."""
        if self._finished:
            raise ValueError("the encoder is finished")
        self._write_packet(1, b"")

    def finish(self) -> None:
        """Write the EOF packet."""
        if self._finished:
            raise ValueError("the encoder is finished")
        self._finished = True
        self._write_packet(0, b"")

    def __enter__(self) -> "Encoder":
        return self

    def __exit__(self, *exc) -> None:
        if not self._finished:
            self.finish()

    def __del__(self):
        # the reference finishes the stream when the encoder is dropped
        try:
            if not self._finished and not self._writer.closed:
                self.finish()
        except Exception:
            pass
