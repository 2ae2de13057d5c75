"""demux_sys_pct.decode: The share of the native demux calls' CPU seconds spent in kernel mode (mapping and faulting pages, thread start-up)."""

from harness.program import Window

WINDOW = Window()


def read(r):
    cpu = WINDOW.counter("decode.demux_cpu_s")
    if not WINDOW.calls("pfv.decode.demux_native") or cpu <= 0:
        return None
    return 100.0 * WINDOW.counter("decode.demux_sys_s") / cpu
