"""A list of devices in place of a mesh: which devices, and one thread and
one stream per entry."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import torch


def stream_devices(n: int | None = None) -> list[torch.device]:
    """All CUDA devices, or the first n (counterpart of `make_stream_mesh`).
    Raises RuntimeError without a CUDA device and ValueError for more than
    there are."""
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device")
    if n is not None and not 0 < n <= count:
        raise ValueError(f"{n} devices asked for, {count} CUDA devices present")
    return [torch.device("cuda", i) for i in range(count if n is None else n)]


def resolved(device) -> torch.device:
    """`device` as a torch device, a CUDA device with its index ("cuda" is
    the current one). Raises where a CUDA device is named and there is
    none."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def as_devices(devices) -> list[torch.device]:
    """`devices` as torch devices; None stands for `stream_devices()`. A
    list may name a device more than once: each entry gets a thread and a
    stream of its own."""
    if devices is None:
        return stream_devices()
    devices = [resolved(d) for d in devices]
    if not devices:
        raise ValueError("the list of devices is empty")
    return devices


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for item in x:
            yield from _tensors(item)


def each_device(devices: list[torch.device], work) -> list:
    """[work(k, devices[k]) for every k], each call in a thread of its own;
    for a CUDA device under `torch.cuda.device` and a new stream of it, so
    that the entries' kernels and copies run side by side. The calling
    thread's current stream of each device then waits for that entry's
    work, and the tensors among the results (tuples and lists are searched)
    are recorded on it, so the caller may use and free them as its own. An
    exception of a call is raised here."""

    def call(k: int):
        dev = devices[k]
        if dev.type != "cuda":
            return work(k, dev), None
        with torch.cuda.device(dev), torch.cuda.stream(torch.cuda.Stream(dev)):
            result = work(k, dev)
            done = torch.cuda.Event()
            done.record()
        return result, done

    with ThreadPoolExecutor(len(devices)) as pool:
        futures = [pool.submit(call, k) for k in range(len(devices))]
        finished = [f.result() for f in futures]
    for dev, (result, done) in zip(devices, finished):
        if done is not None:
            current = torch.cuda.current_stream(dev)
            current.wait_event(done)
            for t in _tensors(result):
                t.record_stream(current)
    return [result for result, _ in finished]
