"""mux_glue_ms_per_frame.encode: Host time of the mux outside the native entropy coder (the program's span pfv.encode.host_mux less its pfv.encode.entropy spans: buffers, copies, packing, the join), per frame encoded."""

from harness.program import Window

WINDOW = Window()


def read(r):
    mux = WINDOW.seconds("pfv.encode.host_mux")
    if mux is None or not r.frames:
        return None
    return 1e3 * (mux - (WINDOW.seconds("pfv.encode.entropy") or 0.0)) / r.frames
