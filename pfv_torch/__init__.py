"""pfv_torch: the PFV codec's decode in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

Two entry points: the whole-clip decode (`decode_video_yuv` and its RGBA,
RGB and checksum forms) and the streaming `Decoder`. The JAX package
`pfv_tpu` beside it is the reference; this package never imports jax. It
shares the C++ entropy/container runtime with it, loaded by file path
(`pfv_torch.runtime`).
"""

from pfv_torch.dataloader import (decode_video_checksums, decode_video_rgb,
                                  decode_video_rgba, decode_video_yuv,
                                  plane_checksums, rgba_view)
from pfv_torch.dec import (PFV_VERSION, DecodeError, Decoder, FormatError,
                           StreamIOError, VersionError)
from pfv_torch.frame import VideoFrame

CODEC_VERSION = PFV_VERSION

__all__ = [
    "CODEC_VERSION",
    "DecodeError",
    "Decoder",
    "FormatError",
    "StreamIOError",
    "VersionError",
    "VideoFrame",
    "decode_video_checksums",
    "decode_video_rgb",
    "decode_video_rgba",
    "decode_video_yuv",
    "plane_checksums",
    "rgba_view",
]
