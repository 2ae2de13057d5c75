"""VideoDataLoader: pipelined decode of many videos to RGB on the device
(counterpart of pfv_tpu/loader.py).

A background worker reads video i+1, runs its host demux
(`dataloader.choose_route`: the C++ demux releases the interpreter lock)
and uploads it while the consumer's thread runs video i's frame step and
K2, so the steady rate is set by the slower of the two and not by their
sum. On a CUDA device the worker uploads on a stream of its own: it packs
the used prefix of the demux's arrays into one pinned staging buffer, copies
that to the device in one asynchronous copy, builds the per-frame tables on
the same stream and records an event; the consumer's stream waits on the
event, so the copy of video i+1 runs beside the kernels of video i. Frames
are yielded as (F, H, W, 3) uint8 tensors on the device, what
`decode_video_rgb` returns for the same bytes; nothing comes back to the
host. Each video takes the route its own geometry gives it; what the
worker's upload returns, the consumer's frame step takes (the chunks of a
wide stream are all uploaded by the worker and stepped one at a time by the
consumer; a geometry too large for the dense coefficients decodes in the
consumer, frame by frame, from the stream's bytes).
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from pfv_torch.dataloader import _output, choose_route, run_route, upload_route
from pfv_torch.parallel.devices import resolved
from pfv_torch.utils.profiling import count, span

ALIGN = 256  # bytes: every array of a staged clip starts at a multiple


class PinnedStager:
    """Copies lists of numpy arrays to a CUDA device through one pinned
    host buffer: the arrays are packed into the buffer, one asynchronous
    copy on the current stream takes it to a new device buffer, and the
    arrays come back as views of that. The buffer is written again only
    after the event recorded behind its last copy has completed."""

    def __init__(self, device):
        self.device = device
        self._pinned = torch.empty(0, dtype=torch.uint8)
        self._copied = torch.cuda.Event()

    def __call__(self, arrays) -> list[torch.Tensor]:
        with span("decode.h2d"):
            count("decode.h2d_bytes", sum(a.nbytes for a in arrays))
            arrays = [np.ascontiguousarray(a) for a in arrays]
            offsets = [0]
            for a in arrays:
                offsets.append(offsets[-1] + -(-a.nbytes // ALIGN) * ALIGN)
            total = offsets[-1]
            self.wait()
            if self._pinned.numel() < total:
                self._pinned = torch.empty(total, dtype=torch.uint8, pin_memory=True)
            host = self._pinned.numpy()
            for a, off in zip(arrays, offsets):
                host[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
            dev = torch.empty(total, dtype=torch.uint8, device=self.device)
            dev.copy_(self._pinned[:total], non_blocking=True)
            self._copied.record(torch.cuda.current_stream(self.device))
            return [dev[off:off + a.nbytes].view(torch.from_numpy(a[:0]).dtype).view(a.shape)
                    for a, off in zip(arrays, offsets)]

    def wait(self) -> None:
        """Block until the last copy has read the pinned buffer."""
        self._copied.synchronize()


def _tensors(uploaded):
    """The tensors in `upload_route`'s result, however nested in tuples and
    lists."""
    if isinstance(uploaded, torch.Tensor):
        yield uploaded
    elif isinstance(uploaded, (tuple, list)):
        for t in uploaded:
            yield from _tensors(t)


class VideoDataLoader:
    """Iterate .pfv byte streams (or file paths) -> RGB tensors on `device`.

    Args:
      files: iterable of bytes or paths.
      num_threads: entropy-demux threads per video (0 = all cores).
      prefetch: how many demuxed and uploaded videos may wait ahead of the
        decode.
      device: where the frames are decoded and left ("cpu" runs the
        kernels' plain versions, without streams).
      timer: any object whose `stage(name)` is a context manager (a
        `utils.profiling.StageTimer`) receives, per video, the worker's
        stages "read", "demux" and "upload" (the copy and the tables,
        enqueued) and the consumer's "wait" (for the worker) and "decode"
        (the frame step and K2, enqueued). "demux" and "upload" hold the
        spans "pfv.decode.demux" and "pfv.decode.upload", "decode" the
        spans "pfv.decode.step" and "pfv.decode.rgba".
    """

    def __init__(self, files: Iterable[bytes | str], num_threads: int = 0,
                 prefetch: int = 2, device="cuda", timer=None):
        self._files = files
        self._num_threads = num_threads
        self._prefetch = max(1, prefetch)
        self._device = resolved(device)
        self._stage = timer.stage if timer is not None else (
            lambda name: contextlib.nullcontext())

    def _produce(self, q: queue.Queue, stop: threading.Event) -> None:
        """The worker: each video demuxed and uploaded, then queued as
        (route, what its upload returned, the event behind the upload);
        None at the end, an exception in place of the video that raised
        it."""
        dev, stage = self._device, self._stage

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        cuda = dev.type == "cuda"
        with contextlib.ExitStack() as ctx:
            stager = None
            try:
                if cuda:
                    ctx.enter_context(torch.cuda.device(dev))
                    ctx.enter_context(torch.cuda.stream(torch.cuda.Stream(dev)))
                    stager = PinnedStager(dev)
                for f in self._files:
                    if stop.is_set():
                        return
                    with stage("read"):
                        if isinstance(f, str):
                            with open(f, "rb") as fh:
                                f = fh.read()
                    with stage("demux"):
                        route = choose_route(f, self._num_threads)
                    with stage("upload"):
                        uploaded = upload_route(route, dev, stager)
                        ready = None
                        if cuda:
                            ready = torch.cuda.Event()
                            ready.record()
                    # the demux's arrays (worst-case capacity) are not kept
                    item = (route._replace(host=None), uploaded, ready)
                    if not put(item):
                        return
                put(None)
            except Exception as e:  # the consumer raises it
                put(e)
            finally:
                if stager is not None:
                    stager.wait()

    def _decode(self, item) -> torch.Tensor:
        """The consumer's half of one video: wait for its upload on the
        current stream, then the route's frame step and K2."""
        route, uploaded, ready = item
        if ready is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(ready)
            # allocated on the worker's stream, read on this one: the
            # allocator must not hand the memory out before these kernels end
            for t in _tensors(uploaded):
                t.record_stream(current)
        with self._stage("decode"):
            return _output(route.g, run_route(route, uploaded, self._device), "rgb")

    def __iter__(self) -> Iterator[torch.Tensor]:
        q: queue.Queue = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()
        worker = threading.Thread(target=self._produce, args=(q, stop), daemon=True)
        worker.start()
        try:
            while True:
                with self._stage("wait"):
                    item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield self._decode(item)
                del item  # the uploaded tensors go with the video
        finally:
            stop.set()
            worker.join()


def decode_many_rgb(datas: list[bytes], num_threads: int = 0,
                    device="cuda") -> list[torch.Tensor]:
    """Decode a list of videos through the pipelined loader; wait for the
    device, so the whole batch is resident when this returns."""
    out = list(VideoDataLoader(datas, num_threads, device=device))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return out
