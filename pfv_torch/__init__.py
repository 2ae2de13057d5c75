"""pfv_torch: the PFV codec in PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper (sm_90a).

Decode has two entry points: the whole-clip decode (`decode_video_yuv` and
its RGBA, RGB and checksum forms; `decode_video_rgb_chunks` for clips of any
length; `VideoDataLoader` for many clips, demux and upload pipelined with
the decode) and the streaming `Decoder`. Encode has two: the streaming
`Encoder` and the whole-clip `encode_video`. `pfv_torch.parallel` and
`encode_video_gops` spread streams and GOP runs over a list of devices;
`python -m pfv_torch` is the command-line tool. The JAX package
`pfv_tpu` beside it is the reference; this package never imports jax and
loads nothing of `pfv_tpu`: `pfv_torch.runtime` is its own copy of the C++
entropy/container runtime.
"""

from pfv_torch.dataloader import (decode_video_checksums, decode_video_rgb,
                                  decode_video_rgb_chunks, decode_video_rgba,
                                  decode_video_yuv, plane_checksums, rgba_view)
from pfv_torch.dec import (PFV_VERSION, DecodeError, Decoder, FormatError,
                           StreamIOError, VersionError)
from pfv_torch.enc import Encoder
from pfv_torch.encoding import encode_video, encode_video_gops
from pfv_torch.frame import VideoFrame
from pfv_torch.loader import VideoDataLoader, decode_many_rgb

CODEC_VERSION = PFV_VERSION

__all__ = [
    "CODEC_VERSION",
    "DecodeError",
    "Decoder",
    "Encoder",
    "FormatError",
    "StreamIOError",
    "VersionError",
    "VideoDataLoader",
    "VideoFrame",
    "decode_many_rgb",
    "decode_video_checksums",
    "decode_video_rgb",
    "decode_video_rgb_chunks",
    "decode_video_rgba",
    "decode_video_yuv",
    "encode_video",
    "encode_video_gops",
    "plane_checksums",
    "rgba_view",
]
