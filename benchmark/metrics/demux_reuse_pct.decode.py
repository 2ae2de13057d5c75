"""demux_reuse_pct.decode: The share of the native tile demux calls (the program's span pfv.decode.demux_native) served from the unit buffers the demux kept from earlier calls, adding none (the counter decode.demux_calls_reused)."""

from harness.program import Window

WINDOW = Window()
REUSED = "decode.demux_calls_reused"


def read(r):
    calls = WINDOW.calls("pfv.decode.demux_native")
    try:
        from pfv_torch.utils.profiling import counters
    except ImportError:
        return None
    if not calls or REUSED not in counters():
        return None  # a program whose demux keeps no buffers between calls
    return 100.0 * WINDOW.counter(REUSED) / calls
