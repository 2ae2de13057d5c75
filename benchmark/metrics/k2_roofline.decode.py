"""k2_roofline.decode: K2's bound per launch (one a clip) over its device time per launch seen."""

BOUND = "k2"
KERNEL = "canvas_rgba_kernel"


def read(r):
    return r.roofline(BOUND, KERNEL)
