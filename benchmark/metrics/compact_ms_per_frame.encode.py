"""compact_ms_per_frame.encode: Device time of the operations launched inside the program's span pfv.encode.compact_run (one run of whole frames of the compaction: its torch.nonzero, gather and bincount), per frame encoded."""

from harness.program import device_seconds


def read(r):
    dev_s = device_seconds("pfv.encode.compact_run")
    return None if dev_s is None or not r.frames else 1e3 * dev_s / r.frames
