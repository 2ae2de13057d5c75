"""k1_roofline.decode: K1's bound per launch over its device time per launch seen."""

BOUND = "k1"
KERNEL = "step_frame_kernel"


def read(r):
    return r.roofline(BOUND, KERNEL)
