"""demux_ms_per_frame.decode: Host demux per frame decoded: the tile demux (K1's route) and the pstep demux (the dense route)."""

SPANS = ("pfv_torch.runtime.demux_file_sparse_tiles", "pfv_torch.dataloader.demux_host_packed")


def read(r):
    return r.span_ms_per_frame(SPANS)
