"""mux_parallelism.encode: How many workers of the host mux coded frames at once: the workers' summed seconds on the frames (the program's counter encode.mux_worker_s) over the host seconds of the program's span pfv.encode.entropy."""

from harness.program import Window

WINDOW = Window()
WORKER_S = "encode.mux_worker_s"


def read(r):
    entropy = WINDOW.seconds("pfv.encode.entropy")
    try:
        from pfv_torch.utils.profiling import counters
    except ImportError:
        return None
    if not entropy or WORKER_S not in counters():
        return None  # a program whose mux codes on no worker pool
    return WINDOW.counter(WORKER_S) / entropy
