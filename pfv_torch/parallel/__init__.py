"""Decode over a list of devices: a batch of streams, or the GOP runs of one
stream, a group per device (counterpart of pfv_tpu/parallel)."""

from pfv_torch.parallel.devices import stream_devices
from pfv_torch.parallel.gops import decode_video_gops, skip_pframe_packet, split_gop_runs
from pfv_torch.parallel.streams import decode_stream_batch

__all__ = ["decode_stream_batch", "decode_video_gops", "skip_pframe_packet",
           "split_gop_runs", "stream_devices"]
