"""mux_ms_per_frame.encode: encode_video's stage "host mux" (entropy coding and the container) per frame encoded."""

STAGE = "host mux"


def read(r):
    return r.stage_ms_per_frame(STAGE)
