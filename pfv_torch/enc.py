"""The streaming PFV Encoder on one device (counterpart of pfv_tpu/enc.py).

Per frame, each padded plane is encoded on the device (motion search for
P-frames, then kernel K6, forward DCT + quantization) and reconstructed in
the loop by the frame step, one launch per plane, exactly as a decoder
will; the dense coefficients come
back to the host, where the shared C++ runtime entropy-codes the packet.
The reconstructed previous frame stays on the device between frames, in two
sets of planes that swap (the frame step never writes over the plane it
reads). The
bytes equal the JAX package's Encoder's.

Quality is inverted (quirk Q4): 0 is the finest, 10 the coarsest.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np
import torch

from pfv_torch import runtime
from pfv_torch.device import (iframe_encode_plane, origins_for, pad_plane_host,
                              pframe_encode_plane, plane_mse, plane_step)
from pfv_torch.frame import VideoFrame, pad16
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
    for API parity and ignored: each plane is one batch of kernel launches.
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

        self._min_err = skip_threshold(quality)
        self._qt_host = derive_q_tables(quality)
        self._qt = {k: torch.from_numpy(v).to(self.device)
                    for k, v in self._qt_host.items()}

        ly, lc = (pad16(height), pad16(width)), (pad16(height // 2), pad16(width // 2))
        self._shapes = {"y": ly, "u": lc, "v": lc}
        self._clear = {"y": 0, "u": 128, "v": 128}
        oy, oc = origins_for(*ly, self.device), origins_for(*lc, self.device)
        self._origins = {"y": oy, "u": oc, "v": oc}
        # the in-loop frame step of each plane shape and q-table
        self._steps = {qk: plane_step(self._qt_host[qk], *(ly if qk[-1] == "l" else lc),
                                      self.device) for qk in self._qt_host}
        # the reconstructed previous frame (Y 0, U and V 128 before the
        # first), and the planes the next frame is reconstructed into
        self._prev = {k: torch.full(self._shapes[k], self._clear[k], dtype=torch.uint8,
                                    device=self.device) for k in PLANES}
        self._back = {k: torch.empty_like(p) for k, p in self._prev.items()}

        writer.write(container_header(width, height, framerate, self._qt_host))

    def reconstruction(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The reconstructed previous frame as padded (Y, U, V) u8 planes on
        the device: what a decoder shows for the last frame encoded, and
        what the next P-frame is predicted from."""
        return tuple(self._prev[k] for k in PLANES)

    def _write_packet(self, ptype: int, payload: bytes) -> None:
        self._writer.write(struct.pack("<BI", ptype, len(payload)))
        self._writer.write(payload)

    def _sources(self, frame: VideoFrame):
        """The frame's planes, padded, on the device; raises ValueError on a
        frame of another size or a finished encoder."""
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
        return {k: pad_plane_host(np.asarray(planes[k]), *self._shapes[k],
                                  self._clear[k], self.device) for k in PLANES}

    def _swap(self) -> None:
        self._prev, self._back = self._back, self._prev

    def _psnr(self, src: torch.Tensor) -> float | None:
        if not self.collect_psnr:
            return None
        h, w = self.height, self.width
        mse = float(plane_mse(self._prev["y"][:h, :w], src[:h, :w]))
        return 10.0 * float(np.log10(255.0**2 / max(mse, 1e-9)))

    def encode_iframe(self, frame: VideoFrame) -> None:
        """Intra-encode a frame, q-table indices (0, 1, 1)."""
        src = self._sources(frame)
        coeffs = []
        for k, qk in zip(PLANES, ("intra_l", "intra_c", "intra_c")):
            c, _ = iframe_encode_plane(src[k], self._qt[qk], *self._origins[k],
                                       self._back[k], self._steps[qk])
            coeffs.append(c)
        self._swap()
        payload = runtime.encode_iframe_payload(torch.cat(coeffs).cpu().numpy(),
                                                (0, 1, 1))
        self._write_packet(1, payload)
        self.stats.append({"type": "I", "payload_bytes": len(payload),
                           "skip_pct": 0.0, "psnr_y": self._psnr(src["y"])})

    def encode_pframe(self, frame: VideoFrame) -> None:
        """Inter-encode a frame against the previous reconstruction, q-table
        indices (2, 3, 3). All planes are encoded before it is replaced."""
        src = self._sources(frame)
        parts = []
        for k, qk in zip(PLANES, ("inter_l", "inter_c", "inter_c")):
            parts.append(pframe_encode_plane(src[k], self._prev[k], self._qt[qk],
                                             self._min_err, *self._origins[k],
                                             self._back[k], self._steps[qk])[:4])
        self._swap()
        coeffs, mvx, mvy, hc = (torch.cat(p).cpu().numpy() for p in zip(*parts))
        payload = runtime.encode_pframe_payload(coeffs, mvx, mvy, hc.astype(np.uint8),
                                                (2, 3, 3))
        self._write_packet(2, payload)
        self.stats.append({"type": "P", "payload_bytes": len(payload),
                           "skip_pct": round(100.0 * float((~hc).mean()), 2),
                           "psnr_y": self._psnr(src["y"])})

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
