"""k6_roofline.encode: K6's bound per launch (one a frame) over its device time per launch seen."""

BOUND = "k6"
KERNEL = "frame_encode_kernel"


def read(r):
    return r.roofline(BOUND, KERNEL)
