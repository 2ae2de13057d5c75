"""demux_cpu_ms_per_frame.decode: The process's CPU seconds, user and system, every thread's, over the native demux calls (the program's span pfv.decode.demux_native), per frame decoded."""

from harness.program import Window

WINDOW = Window()


def read(r):
    if not r.frames or not WINDOW.calls("pfv.decode.demux_native"):
        return None
    return 1e3 * WINDOW.counter("decode.demux_cpu_s") / r.frames
