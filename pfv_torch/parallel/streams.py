"""A batch of streams decoded over a list of devices (counterpart of
pfv_tpu/parallel/streams.py).

PFV streams are independent, so the several-device mapping is data
parallel: the batch is cut into contiguous groups, one per device, and each
device decodes its group through the whole-clip routes of
`pfv_torch.dataloader` (K1 up to width 4096, K3 or K4 above: each stream
takes the route its own geometry and packets give it), in a thread and on a stream of
its own. The one statistic over all devices, the mean of the luma, is the
mean of the devices' means, brought to the first device.

All streams of a batch share geometry, q-tables and frame count; stack
unlike videos into batches of their own.
"""

from __future__ import annotations

import numpy as np
import torch

from pfv_torch import runtime
from pfv_torch.dataloader import _decode_clip, rgba_view
from pfv_torch.parallel.devices import as_devices, each_device


def joined(join, tensors):
    """`join` (torch.stack or torch.cat) of a list of tensors; packed RGBA
    (uint32) goes through its int32 view."""
    if tensors[0].dtype == torch.uint32:
        return join([t.view(torch.int32) for t in tensors]).view(torch.uint32)
    return join(tensors)


def _mean(t: torch.Tensor) -> torch.Tensor:
    """The float32 mean of a u8 tensor's values, or of a packed-RGBA
    tensor's uint32 words (from the sums of their four bytes)."""
    if t.dtype == torch.uint8:
        return t.sum(dtype=torch.float32) / t.numel()
    per_byte = rgba_view(t).reshape(-1, 4).sum(0, dtype=torch.float32)
    weights = torch.tensor([1.0, 256.0, 65536.0, 16777216.0], device=t.device)
    return (per_byte * weights).sum() / t.numel()


def check_batch(datas: list[bytes], n_devices: int) -> None:
    """Raise ValueError unless the streams divide evenly over the devices
    and share geometry, q-tables and frame count."""
    if not datas or len(datas) % n_devices:
        raise ValueError(f"stream count {len(datas)} not divisible by the "
                         f"{n_devices} devices")
    first, _ = runtime.parse_header(datas[0])
    for d in datas[1:]:
        info, _ = runtime.parse_header(d)
        if (info["width"], info["height"]) != (first["width"], first["height"]):
            raise ValueError("all streams in a batch must share geometry")
        if not np.array_equal(info["qtables"], first["qtables"]):
            raise ValueError("all streams in a batch must share q-tables")
    if len({runtime.count_frames(d) for d in datas}) != 1:
        raise ValueError("all streams in a batch must share their frame count")


def decode_stream_batch(datas: list[bytes], devices=None, num_threads: int = 0,
                        want: str = "yuv"):
    """Decode S same-geometry streams over `devices` (all CUDA devices
    unless given; S divisible by their number), streams
    [d * S/n, (d + 1) * S/n) on devices[d].

    Returns (shards, mean_luma). shards[d], on devices[d], holds that
    device's streams stacked: (S/n, F, H, W, 3) u8 for want "rgb",
    (S/n, F, H, W) uint32 for "rgba", a (y, u, v) triple of (S/n, F, ...) u8
    for "yuv". mean_luma, a float32 scalar on devices[0], is the mean over
    the devices of each one's mean (of Y for "yuv", of the whole product
    otherwise)."""
    devices = as_devices(devices)
    if want not in ("yuv", "rgb", "rgba"):
        raise ValueError(f"unknown output '{want}'")
    check_batch(datas, len(devices))
    per = len(datas) // len(devices)

    def group(k: int, dev: torch.device):
        outs = [_decode_clip(d, want, dev, num_threads)
                for d in datas[k * per:(k + 1) * per]]
        if want == "yuv":
            shard = tuple(torch.stack([o[j] for o in outs]) for j in range(3))
            return shard, _mean(shard[0])
        shard = joined(torch.stack, outs)
        return shard, _mean(shard)

    results = each_device(devices, group)
    means = torch.stack([mean.to(devices[0]) for _, mean in results])
    return [shard for shard, _ in results], means.mean()
