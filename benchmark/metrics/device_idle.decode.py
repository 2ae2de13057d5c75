"""device_idle.decode: The share of the traced window in which no kernel, copy or fill ran on the card."""


def read(r):
    return r.idle_pct()
