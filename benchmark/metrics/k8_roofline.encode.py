"""k8_roofline.encode: K8's bound per launch (one a P-frame) over its device time per launch seen."""

BOUND = "k8"
KERNEL = "motion_search_kernel"


def read(r):
    return r.roofline(BOUND, KERNEL)
