"""upload_ms_per_frame.decode: The demux's arrays copied to the card and the per-frame tables built there, per frame decoded."""

SPANS = ("pfv_torch.dataloader.upload_route",)


def read(r):
    return r.span_ms_per_frame(SPANS)
