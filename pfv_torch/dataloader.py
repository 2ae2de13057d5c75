"""Whole-clip decode of a .pfv stream into device memory (PyTorch/CUDA).

Counterpart of pfv_tpu/dataloader.py. A stream takes one of four routes
(`choose_route`), by its geometry:

  "units"  widths up to 4096: .pfv bytes -> C++ tile demux (host) -> H2D
           -> per-frame tables -> K1 frame step, one launch per frame ->
           (F, chh, cw) canvases
  "gops"   wider, small frames with a uniform keyframe interval L: .pfv
           bytes -> C++ pstep demux (host) -> H2D -> densify_pstep (a device
           scatter-add into (G*L, 64, row_span) coefficients) -> K4, G GOPs
           side by side, one launch per step: L launches
  "dense"  the other wide streams: .pfv bytes -> C++ pstep demux (host),
           in chunks of whole frames, all in one native call -> H2D; then
           chunk by chunk densify_pstep and K3, one launch per frame, each
           chunk from the last canvas of the one before it
  "frames" decode_frames: the streaming decoder's frame step (one launch
           per frame for Y, U and V), only for a geometry whose row of
           dense coefficients does not fit the pstep demux (`dense_gate`)

then YUV views of the canvases | K2 -> (F, H, W) uint32 RGBA. K1, K3 and K4
take any frame types and any q-table index per frame and plane: every frame
dequantizes with its own multipliers, and a stream whose first frame is a
P-frame predicts it from the reference framebuffer (Y 0, U and V 128). The
canvas fuses the three planes: Y at rows [0, ly0), U and V side by side
below it, V starting at column lcw. Every public entry point takes an
explicit `device` ("cuda" by default) and leaves its result there; a CPU
device runs the kernels' plain PyTorch versions. The demux, the upload, the
tables, densify, the frame step and K2 each open a span `pfv.decode.*` of
`utils.profiling`, on only while a profiler session records.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pfv_torch import runtime
from pfv_torch.dec import FrameDecoder, frame_packets, keyframe_runs, keyframes_of, scan_packets
from pfv_torch.frame import Geometry, geometry, initial_canvas, slice_yuv
from pfv_torch.kernels.dense_step import MAX_ROW_SPAN, seq_frames_dense, step_gops
from pfv_torch.kernels.rgba import canvas_rgba
from pfv_torch.kernels.step import lanes_per_stripe, step_frames
from pfv_torch.ops.quant import DCT_SCALE_FACTOR, INV_ZIGZAG_TABLE
from pfv_torch.utils.profiling import count, span

UNITS_CHUNK = 128  # units per chunk of the tile demux
GOP_MAX_BLOCKS = 4096  # the GOP route takes small frames only (SD, not 1080p)
MAX_POSITIONS = 1 << 31  # the pstep demux's flat unit positions are int32
# The most dense coefficient positions of one chunk: 24 frames of 8K UHD
# (64*row_span = 53,084,160 each). The densify holds 6 bytes per position
# (an int32 sum and its int16 copy), ~7.6 GB at this cap.
CHUNK_POSITIONS = 24 * 53_084_160


def tile_tables(g: Geometry):
    """(stripe_of_b, lanebase_of_b, r_of_zz, gch) for the tile demux: each
    stream block's canvas stripe and in-stripe lane base 4*gc (Y blocks,
    then U blocks, then V blocks from lane 4*guw), and the row-major row of
    each zigzag slot."""
    gyw, guw = g.lyw // 16, g.lcw // 16
    r, c = np.divmod(np.arange(g.yb), gyw)
    rc, cc = np.divmod(np.arange(g.cb), guw)
    stripe = np.concatenate([r, g.gly + rc, g.gly + rc]).astype(np.int32)
    lane = np.concatenate([4 * c, 4 * cc, 4 * (guw + cc)]).astype(np.int32)
    r_of_zz = np.empty(64, np.int32)
    r_of_zz[INV_ZIGZAG_TABLE] = np.arange(64, dtype=np.int32)
    return stripe, lane, r_of_zz, g.gch


def pstep_row_span(g: Geometry) -> int:
    """The length of a row of the dense coefficients: gch*2*scp."""
    return g.gch * lanes_per_stripe(g.cw)


def pstep_tables(g: Geometry):
    """(off_of_b, r_of_zz, row_span) for the pstep demux: each stream
    block's base stripe*2*scp + 4*gc in a row of the dense coefficients,
    the row-major row of each zigzag slot, and `pstep_row_span`. (The
    native pstep context builds the same tables from the frame size.)"""
    stripe, lane, r_of_zz, _ = tile_tables(g)
    rs = lanes_per_stripe(g.cw)
    return (stripe * rs + lane).astype(np.int32), r_of_zz, pstep_row_span(g)


def stream_gate(qidx, n_qtables: int) -> None:
    """The one check of the frame steps (K1, K3, K4) on a stream's frames:
    raises ValueError for a q-table index the header does not have. Any
    frame types and any index per frame and plane pass."""
    if (np.asarray(qidx) >= n_qtables).any():
        raise ValueError("corrupt stream: q-table index out of range")


def failed_gate(g: Geometry):
    """The gate of the "units" route, checked before any demux: "2*scp <=
    1024" when a stripe's lanes do not fit K1's 10-bit unit lanes (widths
    above 4096), else None."""
    if lanes_per_stripe(g.cw) > 1024:
        return "2*scp <= 1024"
    return None


def dense_gate(g: Geometry):
    """The one gate of the dense routes (K3, K4), a geometry's: "row_span <
    2^24" when a row of the dense coefficients does not fit the pstep
    demux's 24-bit offsets (32768x32768 fails it), else None."""
    if pstep_row_span(g) >= MAX_ROW_SPAN:
        return "row_span < 2^24"
    return None


def dense_chunk_frames(g: Geometry) -> int:
    """The most frames one chunk of the dense routes holds: its positions,
    the one past its last frame included, fit the demux's int32
    (MAX_POSITIONS) and CHUNK_POSITIONS. At least 1 for a geometry that
    passes `dense_gate` (64*row_span < 2^30)."""
    span = 64 * pstep_row_span(g)
    return min((MAX_POSITIONS - 1) // span, CHUNK_POSITIONS // span)


def gop_shape(ftype, nb: int):
    """(G, L) when the stream has a uniform keyframe interval L (I-frames
    exactly at frames 0, L, 2L, ...; at least two GOPs) and frames of at
    most GOP_MAX_BLOCKS blocks, else None. Frame-major data is then (G, L)
    GOPs; the last is padded to L frames."""
    ftype = np.asarray(ftype).reshape(-1)
    f = ftype.shape[0]
    starts = np.flatnonzero(ftype == 1)
    if starts.size < 2 or starts[0] != 0:
        return None
    l = int(starts[1])
    if not np.array_equal(starts, np.arange(0, f, l)) or nb > GOP_MAX_BLOCKS:
        return None
    g = -(-f // l)
    if g * l * nb * 256 >= MAX_POSITIONS:
        return None
    return g, l


class Route(NamedTuple):
    """How a stream decodes. kind "units": `host` holds `demux_host`'s
    output (K1); "gops": `host` holds `demux_host_packed`'s output and
    `gops` the (G, L) of the GOP route (K4); "dense": `host` holds a list,
    `demux_host_packed`'s output for each chunk of the stream (K3);
    "frames": the per-frame path, `gate` naming the gate the stream failed.
    `leading_p`: the first frame is a P-frame, predicted from the reference
    framebuffer (`frame.initial_canvas`)."""

    g: Geometry
    kind: str
    gate: str | None
    host: tuple | list | None
    gops: tuple | None = None
    leading_p: bool = False


def _pack_meta(bh, ftype, qidx) -> np.ndarray:
    """[block headers | ftype | qidx] as one u16 array."""
    return np.concatenate([bh.reshape(-1), ftype.astype(np.uint16),
                           qidx.reshape(-1).astype(np.uint16)])


def _frame_meta(meta: np.ndarray, nb: int):
    """The (F,) frame types and (F, 3) q-table indices of packed meta."""
    f = meta.shape[0] // (nb + 4)
    return meta[f * nb:f * nb + f], meta[f * nb + f:].reshape(f, 3)


def choose_route(data: bytes, num_threads: int = 0) -> Route:
    """Pick the route by the stream's geometry (and, above width 4096, its
    keyframe pattern), then run the route's demux. Raises ValueError for a
    q-table index the header does not have."""
    with span("decode.demux"):
        hdr, _ = runtime.parse_header(data)
        g = geometry(hdr["width"], hdr["height"])
        nq = hdr["qtables"].shape[0]
        if failed_gate(g) is None:
            info, units, coff, bh, ftype, qidx = runtime.demux_file_sparse_tiles(
                data, tile_tables(g), chunk=UNITS_CHUNK, num_threads=num_threads)
            stream_gate(qidx, nq)
            return Route(g, "units", None, (info, g, units, coff, _pack_meta(bh, ftype, qidx)),
                         leading_p=bool(ftype.size and ftype[0] == 2))
        gate = dense_gate(g)
        if gate is not None:
            return Route(g, "frames", gate, None)
        cap = dense_chunk_frames(g)
        hosts = demux_host_packed(data, num_threads, chunk_frames=cap)
        metas = [_frame_meta(host[4], g.nb) for host in hosts]
        for _, qidx in metas:
            stream_gate(qidx, nq)
        ftype = np.concatenate([t for t, _ in metas])
        gops = gop_shape(ftype, g.nb)
        if gops is not None and gops[0] * gops[1] <= cap:  # then one chunk
            return Route(g, "gops", None, hosts[0], gops)
        return Route(g, "dense", None, hosts, leading_p=bool(ftype.size and ftype[0] == 2))


def demux_host(data: bytes, num_threads: int = 0):
    """Parse and entropy-decode `data` on the host into the tile layout:
    (info, geometry, units (NC, 128) u32, coff (F*gch + 1,) i32,
    meta (F*nb + 4F,) u16 = [block headers | ftype | qidx]). Raises
    ValueError, naming the gate, for a geometry K1 does not take."""
    route = choose_route(data, num_threads)
    if route.kind != "units":
        raise ValueError(f"gate '{failed_gate(route.g)}' failed for a "
                         f"{route.g.width}x{route.g.height} stream")
    return route.host


def demux_host_packed(data: bytes, num_threads: int = 0, chunk_frames: int | None = None):
    """Parse and entropy-decode `data` on the host into the pstep layout:
    (info, geometry, deltas (n,) u16, vals (n,) i8, meta (F*nb + 4F,) u16).
    The inclusive cumsum of the deltas gives each unit's position in the
    dense (F, 64, row_span) coefficients, the last unit parked at
    F*64*row_span; `densify_pstep` scatter-adds the vals there. With
    `chunk_frames`, the stream is cut into chunks of that many frames (the
    last may hold fewer) and the result is a list of such tuples, one per
    chunk, each as if its chunk were a stream of its own (the dense
    route's; the same native call decodes every chunk). Raises ValueError
    where a chunk's positions do not fit int32 (the dense route's chunks
    hold at most `dense_chunk_frames` frames) or a row does not fit 24 bits
    (`dense_gate`)."""
    chunks = runtime.demux_file_sparse_pstep(data, chunk_frames or 0, num_threads)
    g = geometry(chunks[0][0]["width"], chunks[0][0]["height"])
    hosts = [(info, g, *rest) for info, *rest in chunks]
    return hosts if chunk_frames else hosts[0]


def unpack_meta(meta: torch.Tensor, nb: int):
    """int32 tensor of the u16 meta words -> (mvx, mvy, hc, ftype, qidx).
    Block headers pack (mvx & 127) | (mvy & 127) << 7 | hc << 14."""
    f = meta.shape[0] // (nb + 4)
    bh = meta[:f * nb].reshape(f, nb)
    mvx = ((bh & 127) ^ 64) - 64
    mvy = (((bh >> 7) & 127) ^ 64) - 64
    hc = (bh >> 14).to(torch.uint8)
    return mvx, mvy, hc, meta[f * nb:f * nb + f], meta[f * nb + f:].reshape(f, 3)


def block_maps(g: Geometry, mvx, mvy, hc):
    """Per-block (F, nb) headers -> (dy, dx, hc) maps (F, gch, gcw) in
    canvas order: Y stripes first; in the chroma stripes U blocks, then V
    blocks from block column lcw/16; 0 in the padding."""
    f = mvx.shape[0]
    gyw, guw, gchc = g.lyw // 16, g.lcw // 16, g.lc0 // 16
    yb, cb = g.yb, g.cb

    def canvas_order(per_block, dtype):
        out = torch.zeros((f, g.gch, g.gcw), dtype=dtype, device=per_block.device)
        pb = per_block.to(dtype)
        out[:, :g.gly, :gyw] = pb[:, :yb].reshape(f, g.gly, gyw)
        out[:, g.gly:, :guw] = pb[:, yb:yb + cb].reshape(f, gchc, guw)
        out[:, g.gly:, guw:2 * guw] = pb[:, yb + cb:].reshape(f, gchc, guw)
        return out

    with span("decode.tables"):
        return (canvas_order(mvy, torch.int8), canvas_order(mvx, torch.int8),
                canvas_order(hc, torch.uint8))


def frame_multipliers(qtables, qidx) -> torch.Tensor:
    """(F, 3, 64) int32 dequant multipliers, on the tables' device: row
    (f, p) = (qtables[qidx[f, p]] * SCALE)[INV_ZIGZAG] (quirk Q1) in the
    row-major r order the demuxes deliver, p = 0, 1, 2 for Y, U, V. One
    gather of the (nq, 64) products by the (F, 3) indices."""
    dev = qtables.device
    scale = torch.from_numpy(DCT_SCALE_FACTOR).to(dev)
    iz = torch.from_numpy(INV_ZIGZAG_TABLE).long().to(dev)
    return (qtables * scale)[:, iz][qidx.long()]


def pageable_copy(dev):
    """The plain host-to-device copy of a list of numpy arrays: one
    blocking `.to(dev)` each, from pageable memory, on the current stream."""
    def h2d(arrays):
        with span("decode.h2d"):
            count("decode.h2d_bytes", sum(a.nbytes for a in arrays))
            return [torch.from_numpy(a).to(dev) for a in arrays]
    return h2d


def _meta_tables(g: Geometry, meta_t, qtables_t):
    """The meta words (int16 bits) and the q-tables, both on the device ->
    (mvx, mvy, hc (F, nb), ftype (F,) int32, qmul (F, 3, 64) int32)."""
    with span("decode.tables"):
        mvx, mvy, hc, ftype, qidx = unpack_meta(meta_t.to(torch.int32) & 0xFFFF, g.nb)
        return mvx, mvy, hc, ftype.contiguous(), frame_multipliers(qtables_t, qidx)


def upload_meta(info, g: Geometry, meta, dev):
    """The u16 meta words -> copied to device `dev`, unpacked: (mvx, mvy,
    hc (F, nb), ftype (F,) int32, qmul (F, 3, 64) int32)."""
    return _meta_tables(g, *pageable_copy(dev)([meta.view(np.int16), info["qtables"]]))


def upload(host, device="cuda", h2d=None):
    """`demux_host`'s output -> copied to `device`, with the per-frame
    tables built there: (geometry, (units, coff, dy, dx, hc, ftype, qmul)),
    the inputs of `step_frames`. `h2d` copies a list of numpy arrays to the
    device (`pageable_copy` unless given; the loader's copies from pinned
    memory); the tables are built on the current stream."""
    info, g, units, coff, meta = host
    h2d = h2d or pageable_copy(torch.device(device))
    units_t, coff_t, meta_t, qt = h2d([units.view(np.int32), coff, meta.view(np.int16),
                                       info["qtables"]])
    mvx, mvy, hc, ftype, qmul = _meta_tables(g, meta_t, qt)
    dy, dx, hcm = block_maps(g, mvx, mvy, hc)
    return g, (units_t, coff_t, dy, dx, hcm, ftype, qmul)


def densify_pstep(deltas, vals, f: int, row_span: int) -> torch.Tensor:
    """The pstep unit stream -> dense (f, 64, row_span) int16 coefficients.

    deltas (n,) int16 (the demux's u16 deltas, widened here with & 0xFFFF)
    and vals (n,) int8 on one device. Positions are the inclusive cumsum of
    the deltas; each value is the scatter-add of its units. The sum runs in
    int32 and is cut to int16, which equals an int16 add that wraps. The
    demux parks the last unit at F*64*row_span, one past the stream's
    frames: a sacrificial slot takes it (a pad frame does, when f > F)."""
    total = f * 64 * row_span
    pos = torch.cumsum(deltas.to(torch.int32) & 0xFFFF, 0, dtype=torch.int64)
    buf = torch.zeros(total + 1, dtype=torch.int32, device=deltas.device)
    buf.index_add_(0, pos, vals.to(torch.int32))
    return buf[:total].to(torch.int16).view(f, 64, row_span)


def upload_pstep(host, device="cuda", h2d=None):
    """`demux_host_packed`'s output -> copied to `device` (`h2d` as
    `upload`'s), the tables unpacked there: (geometry, (deltas (n,) int16,
    vals (n,) int8, mvx, mvy, hc (F, nb), ftype (F,) int32, qmul (F, 3, 64)
    int32))."""
    g, (pstep,) = upload_chunks([host], device, h2d)
    return g, pstep


def upload_chunks(hosts, device="cuda", h2d=None):
    """`demux_host_packed`'s outputs for the chunks of one stream -> copied
    to `device` in one `h2d` call, each chunk's tables unpacked there:
    (geometry, [`upload_pstep`'s tensors of each chunk])."""
    info, g = hosts[0][:2]
    h2d = h2d or pageable_copy(torch.device(device))
    arrays = [a for _, _, deltas, vals, meta in hosts
              for a in (deltas.view(np.int16), vals, meta.view(np.int16))]
    *per_chunk, qt = h2d(arrays + [info["qtables"]])
    return g, [(d, v, *_meta_tables(g, m, qt))
               for d, v, m in zip(per_chunk[0::3], per_chunk[1::3], per_chunk[2::3])]


def _densified(g: Geometry, pstep, frames: int = 0):
    """`upload_pstep`'s tensors with the unit stream densified: (coeffs
    (max(F, frames), 64, row_span) i16, mvx, mvy, hc, ftype, qmul)."""
    d, v, *tables = pstep
    with span("decode.densify"):
        coeffs = densify_pstep(d, v, max(tables[3].shape[0], frames), pstep_row_span(g))
    return (coeffs, *tables)


def upload_packed(host, frames: int = 0, device="cuda"):
    """`demux_host_packed`'s output -> copied to `device` and densified:
    (geometry, (coeffs (max(F, frames), 64, row_span) i16, mvx, mvy, hc
    (F, nb), ftype (F,) int32, qmul (F, 3, 64) int32))."""
    g, pstep = upload_pstep(host, device)
    return g, _densified(g, pstep, frames)


def _dense_canvases(g: Geometry, chunks, prev=None):
    """The "dense" route: `upload_chunks`' chunks densified and decoded by
    K3 one at a time, into slices of one (F, chh, cw) output, each from the
    last canvas of the chunk before it (the first from `prev`, the stream's
    starting canvas, or zeros). Only one chunk's coefficients are alive at
    a time; the output is allocated after the first chunk's densify, whose
    int32 sum is gone by then, so a clip of one chunk peaks no higher than
    its densify."""
    sizes = [c[5].shape[0] for c in chunks]
    out, a = None, 0
    for chunk, n in zip(chunks, sizes):
        coeffs, mvx, mvy, hc, ftype, qmul = _densified(g, chunk)
        if out is None:
            out = torch.empty((sum(sizes), g.chh, g.cw), dtype=torch.uint8,
                              device=coeffs.device)
        seq_frames_dense(coeffs, *block_maps(g, mvx, mvy, hc), ftype, qmul, g.chh, g.cw,
                         g.gly, g.guw, prev=prev, out=out[a:a + n])
        del coeffs
        prev, a = (out[a + n - 1] if n else prev), a + n
    return out


def upload_gops(host, n_gops: int, gop_len: int, device="cuda"):
    """`demux_host_packed`'s output -> K4's inputs for G GOPs of L frames:
    (geometry, F, (coeffs, dy, dx, hc, ftype) each (G, L, ...), qmul).
    The G*L frames are densified, the last GOP padded with all-skip
    P-frames (ftype 2, mv 0, hc 0, multipliers 0). Raises ValueError unless
    every GOP opens with an I-frame and the last one holds a frame."""
    ftype_h = _frame_meta(host[4], host[1].nb)[0]
    f, n = ftype_h.shape[0], n_gops * gop_len
    if not (n_gops > 0 and gop_len > 0 and n - gop_len < f <= n):
        raise ValueError(f"{n_gops} GOPs of {gop_len} frames do not hold {f} frames")
    if (ftype_h[::gop_len] != 1).any():
        raise ValueError(f"a GOP of {gop_len} frames does not open with an I-frame")
    g, pstep = upload_pstep(host, device)
    return g, f, *_gop_inputs(g, pstep, n_gops, gop_len)


def _gop_inputs(g: Geometry, pstep, n_gops: int, gop_len: int):
    """`upload_pstep`'s tensors -> K4's (per-step tensors, qmul (G, L, 3,
    64)) for G GOPs of L frames that hold the stream's F frames."""
    n = n_gops * gop_len
    coeffs, mvx, mvy, hc, ftype, qmul = _densified(g, pstep, n)
    pad = n - ftype.shape[0]

    def padded(t, fill):
        return torch.cat([t, torch.full((pad,) + t.shape[1:], fill, dtype=t.dtype,
                                        device=t.device)])

    maps = block_maps(g, padded(mvx, 0), padded(mvy, 0), padded(hc, 0))
    per_step = (coeffs.view(n_gops, gop_len, 64, -1),
                *(m.view(n_gops, gop_len, g.gch, g.gcw) for m in maps),
                padded(ftype, 2).view(n_gops, gop_len))
    return per_step, padded(qmul, 0).view(n_gops, gop_len, 3, 64)


def _gops_canvases(g: Geometry, f: int, per_step, qmul):
    """The "gops" route: one call of K4 (L launches), step l decoding frame
    l of every GOP from frame l-1 of the same GOP; the canvases un-stacked
    and cut to F."""
    out = step_gops(*per_step, qmul, g.chh, g.cw, g.gly, g.guw)
    return out.view(-1, g.chh, g.cw)[:f]


def decode_frames(data: bytes, device="cuda"):
    """Decode a whole stream frame by frame, each through one launch of
    the frame step (dec.FrameDecoder), -> (geometry, (F, chh, cw) u8
    canvases) in the layout K1 writes, zeros outside the planes. Takes
    every stream the
    format allows: any q-table index per frame and plane, any first packet
    (the framebuffer starts at Y 0, U and V 128), any width, any motion
    vector that keeps its window in the plane."""
    info, _ = runtime.parse_header(data)
    g = geometry(info["width"], info["height"])
    packets = frame_packets(data)
    frames = FrameDecoder(g, info["qtables"], device)
    canvases = torch.zeros((len(packets), g.chh, g.cw), dtype=torch.uint8,
                           device=frames.device)
    prev = frames.initial_canvas()
    for (ptype, payload), out in zip(packets, canvases):
        frames.decode(ptype, payload, out, prev)
        prev = out
    return g, canvases


def upload_route(route: Route, device="cuda", h2d=None):
    """The first half of a decode: the route's demux output copied to
    `device` (`h2d` as `upload`'s) and its tables unpacked there, on the
    current stream. -> the route's device tensors: `step_frames`' inputs
    ("units"), `upload_pstep`'s tensors ("gops"), a list of them, one per
    chunk ("dense"), None ("frames": that route uploads frame by frame as it
    decodes)."""
    with span("decode.upload"):
        if route.kind == "units":
            return upload(route.host, device, h2d)[1]
        if route.kind == "gops":
            return upload_pstep(route.host, device, h2d)[1]
        if route.kind == "dense":
            return upload_chunks(route.host, device, h2d)[1]
        return None


def run_route(route: Route, uploaded, data: bytes, device="cuda"):
    """The second half: the route's frame step over `upload_route`'s
    tensors, on the current stream -> (F, chh, cw) u8 canvases. `route.host`
    is not read; `data`, the stream's bytes, only by route "frames"."""
    g = route.g
    with span("decode.step"):
        if route.kind == "gops":
            return _gops_canvases(g, uploaded[5].shape[0],
                                  *_gop_inputs(g, uploaded, *route.gops))
        if route.kind == "frames":
            return decode_frames(data, device)[1]
        dev = (uploaded[0] if route.kind == "units" else uploaded[0][0]).device
        prev = initial_canvas(g, dev) if route.leading_p else None
        if route.kind == "units":
            return step_frames(*uploaded, g.chh, g.cw, g.gly, g.guw, prev)
        return _dense_canvases(g, uploaded, prev)


def decode_canvases(data: bytes, device="cuda", num_threads: int = 0):
    """Decode a whole stream -> (geometry, (F, chh, cw) u8 canvases) by the
    route `choose_route` picks."""
    route = choose_route(data, num_threads)
    return route.g, run_route(route, upload_route(route, device), data, device)


def _output(g: Geometry, canvases, want: str):
    """Decode canvases -> the output `want` names."""
    if want not in ("yuv", "rgb", "rgba", "checksums"):
        raise ValueError(f"unknown output '{want}'")
    if want == "yuv":
        return slice_yuv(g, canvases)
    if want == "checksums":
        return plane_checksums(*slice_yuv(g, canvases))
    with span("decode.rgba"):
        rgba = canvas_rgba(canvases, g.height, g.width, g.ly0, g.lcw)
    return rgba if want == "rgba" else rgba_view(rgba)[..., :3]


def _decode_clip(data: bytes, want: str, device="cuda", num_threads: int = 0):
    """`decode_canvases` and then `_output`'s `want` of the canvases, in
    the span "pfv.decode.clip"."""
    with span("decode.clip"):
        return _output(*decode_canvases(data, device, num_threads), want)


def decode_packed_gops(host, g: int, l: int, want: str = "rgb", device="cuda"):
    """Decode `demux_host_packed`'s output as g GOPs of l frames side by
    side (K4, one launch per step: l launches) -> `want`: "yuv" (Y, U, V
    views), "rgb" (F, H, W, 3) u8, "rgba" (F, H, W) uint32 (K2) or
    "checksums" (F, 3). The stream must pass `stream_gate`, open a GOP with
    an I-frame every l frames, and fill the last GOP."""
    info, geo, _, _, meta = host
    stream_gate(_frame_meta(meta, geo.nb)[1], info["qtables"].shape[0])
    geo, f, per_step, qmul = upload_gops(host, g, l, device)
    return _output(geo, _gops_canvases(geo, f, per_step, qmul), want)


def decode_video_yuv(data: bytes, device="cuda", num_threads: int = 0):
    """Decode a whole .pfv stream to unpadded (Y, U, V) u8 tensors, views
    of the decode canvases on `device`."""
    return _decode_clip(data, "yuv", device, num_threads)


def decode_video_rgba(data: bytes, device="cuda",
                      num_threads: int = 0) -> torch.Tensor:
    """Decode a whole .pfv stream to (F, H, W) uint32 packed RGBA (bytes R,
    G, B, A=255 in memory order; `rgba_view` gives the channels)."""
    return _decode_clip(data, "rgba", device, num_threads)


def rgba_view(rgba: torch.Tensor) -> torch.Tensor:
    """(F, H, W) uint32 packed RGBA -> zero-copy (F, H, W, 4) u8 view."""
    return rgba.view(torch.uint8).reshape(rgba.shape + (4,))


def decode_video_rgb(data: bytes, device="cuda",
                     num_threads: int = 0) -> torch.Tensor:
    """Decode a whole .pfv stream to a (F, H, W, 3) u8 RGB view."""
    return _decode_clip(data, "rgb", device, num_threads)


def chunk_bounds(starts, frames: int, cap: int) -> list[int]:
    """Greedy chunking: the first frame of each chunk, every chunk as many
    whole GOPs (`starts`: the I-frames' indices, the first 0) as hold at
    most `cap` frames. Raises ValueError for a GOP longer than `cap`."""
    bounds = [0]
    for s, gop_end in zip(starts, [*starts[1:], frames]):
        if gop_end - bounds[-1] > cap and s > bounds[-1]:
            bounds.append(s)
        if gop_end - bounds[-1] > cap:
            raise ValueError(f"a single GOP ({gop_end - bounds[-1]} frames) exceeds "
                             f"max_frames_per_chunk={cap}")
    return bounds


def chunk_streams(data: bytes, max_frames_per_chunk: int):
    """Cut a stream at I-packets (a GOP is a stream of its own) into runs of
    as many whole GOPs as hold at most `max_frames_per_chunk` frames: a
    generator of (start_frame, the run between the stream's header and an
    EOF packet). A drop frame or an unknown packet starts no GOP and stays
    with the run it lies in. Raises ValueError unless the first frame is an
    I-frame, and for a GOP longer than the cap."""
    _, spans = scan_packets(data)
    starts, frames = keyframes_of(spans)
    bounds = chunk_bounds(starts, frames, max_frames_per_chunk)
    yield from zip(bounds, keyframe_runs(data, spans, bounds))


def decode_video_rgb_chunks(data: bytes, max_frames_per_chunk: int = 512,
                            num_threads: int = 0, device="cuda"):
    """Decode a stream of any length chunk by chunk: a generator of
    (start_frame, (F_chunk, H, W, 3) u8 RGB on `device`).

    Each of `chunk_streams`' runs decodes by the route `choose_route` picks
    for it (the dense route cuts a long run into chunks of its own). No
    chunk is padded. One chunk's canvases are alive at a time, which bounds
    the memory of a long clip's output: the generator holds nothing of a
    chunk once it has yielded it."""
    for start, chunk in chunk_streams(data, max_frames_per_chunk):
        yield start, decode_video_rgb(chunk, device, num_threads)


def plane_checksums(y, u, v) -> torch.Tensor:
    """Position-weighted u32 checksums, (F, 3) int64: per frame and plane,
    sum(px[i] * (i * 2654435761 + 1)) mod 2^32."""
    mask = 0xFFFFFFFF
    cols = []
    for p in (y, u, v):
        flat = p.reshape(p.shape[0], -1).to(torch.int64)
        wgt = (torch.arange(flat.shape[1], dtype=torch.int64, device=p.device)
               * 2654435761 + 1) & mask
        cols.append(((flat * wgt) & mask).sum(dim=1) & mask)
    return torch.stack(cols, dim=1)


def decode_video_checksums(data: bytes, device="cuda",
                           num_threads: int = 0) -> torch.Tensor:
    """Decode and return only the (F, 3) plane checksums, on `device`."""
    return _decode_clip(data, "checksums", device, num_threads)
