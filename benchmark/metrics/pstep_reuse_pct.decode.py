"""pstep_reuse_pct.decode: The share of the native demux calls (the program's span pfv.decode.demux_native) that the pstep demux (the dense and GOP routes) served from the buffers it kept from earlier calls, adding none (the counter decode.pstep_calls_reused)."""

from harness.program import Window

WINDOW = Window()
REUSED = "decode.pstep_calls_reused"


def read(r):
    calls = WINDOW.calls("pfv.decode.demux_native")
    try:
        from pfv_torch.utils.profiling import counters
    except ImportError:
        return None
    if not calls or REUSED not in counters():
        return None  # a program whose pstep demux keeps no buffers between calls
    return 100.0 * WINDOW.counter(REUSED) / calls
