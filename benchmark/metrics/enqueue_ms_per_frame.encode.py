"""enqueue_ms_per_frame.encode: Host time of encode_video's frame loop (the program's span pfv.encode.frame_loop: K8, K6 and the frame step enqueued, nothing waited for), per frame encoded."""

from harness.program import Window

WINDOW = Window()


def read(r):
    s = WINDOW.seconds("pfv.encode.frame_loop")
    return None if s is None or not r.frames else 1e3 * s / r.frames
