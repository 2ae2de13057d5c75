"""pfv_torch: the PFV codec's whole-clip decode in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package `pfv_tpu` beside it is the reference; this package never
imports jax. It shares the C++ entropy/container runtime with it, loaded by
file path (`pfv_torch.runtime`).
"""

from pfv_torch.dataloader import (decode_video_checksums, decode_video_rgb,
                                  decode_video_rgba, decode_video_yuv,
                                  plane_checksums, rgba_view)

__all__ = [
    "decode_video_checksums",
    "decode_video_rgb",
    "decode_video_rgba",
    "decode_video_yuv",
    "plane_checksums",
    "rgba_view",
]
