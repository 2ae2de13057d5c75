"""h2d_ms_per_frame.encode: encode_video's stage "h2d upload" (the source planes to the card, padded there; it ends in a synchronize) per frame encoded."""

STAGE = "h2d upload"


def read(r):
    return r.stage_ms_per_frame(STAGE)
