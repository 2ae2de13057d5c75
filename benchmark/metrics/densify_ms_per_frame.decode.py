"""densify_ms_per_frame.decode: Device time of the operations launched inside the program's span pfv.decode.densify (the pstep units scatter-added into dense coefficients), per frame decoded."""

from harness.program import device_seconds


def read(r):
    dev_s = device_seconds("pfv.decode.densify")
    return None if dev_s is None or not r.frames else 1e3 * dev_s / r.frames
