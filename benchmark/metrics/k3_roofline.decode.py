"""k3_roofline.decode: K3's bound per launch over its device time per launch seen."""

BOUND = "k3"
KERNEL = "dense_step_kernel"


def read(r):
    return r.roofline(BOUND, KERNEL)
