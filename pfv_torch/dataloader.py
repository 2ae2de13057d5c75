"""Whole-clip decode of a .pfv stream into device memory (PyTorch/CUDA).

Counterpart of the units path of pfv_tpu/dataloader.py:

    .pfv bytes -> shared C++ tile demux (host) -> H2D -> per-clip tables
    -> K1 frame step, one launch per frame -> (F, chh, cw) u8 canvases
    -> YUV views | K2 -> (F, H, W) uint32 RGBA

The canvas fuses the three planes: Y at rows [0, ly0), U and V side by side
below it, V starting at column lcw. A stream that fails one of K1's gates
(`failed_gate`) decodes instead frame by frame, through the streaming
decoder's step (K5 + K7 per plane, dec.FrameDecoder), into the same
canvases; `choose_route` records which path a stream takes and why, as the
JAX package falls back from its units path to its per-block paths. Every
public entry point takes an explicit `device` ("cuda" by default) and
leaves its result there; a CPU device runs the kernels' plain PyTorch
versions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pfv_torch import runtime
from pfv_torch.dec import FrameDecoder, frame_packets
from pfv_torch.frame import Geometry, geometry, slice_yuv
from pfv_torch.kernels.rgba import canvas_rgba
from pfv_torch.kernels.step import lanes_per_stripe, step_frames
from pfv_torch.ops.quant import DCT_SCALE_FACTOR, INV_ZIGZAG_TABLE

UNITS_CHUNK = 128  # units per chunk of the tile demux


def tile_tables(g: Geometry):
    """(stripe_of_b, lanebase_of_b, r_of_zz, gch) for the tile demux: each
    stream block's canvas stripe and in-stripe lane base 4*gc (Y blocks,
    then U blocks, then V blocks from lane 4*guw), and the row-major row of
    each zigzag slot."""
    gyw, guw, gchc = g.lyw // 16, g.lcw // 16, g.lc0 // 16
    r, c = np.divmod(np.arange(g.yb), gyw)
    rc, cc = np.divmod(np.arange(g.cb), guw)
    stripe = np.concatenate([r, g.gly + rc, g.gly + rc]).astype(np.int32)
    lane = np.concatenate([4 * c, 4 * cc, 4 * (guw + cc)]).astype(np.int32)
    r_of_zz = np.empty(64, np.int32)
    r_of_zz[INV_ZIGZAG_TABLE] = np.arange(64, dtype=np.int32)
    return stripe, lane, r_of_zz, g.gch


def failed_gate(g: Geometry, ftype=None, qidx=None, n_qtables: int = 0):
    """The name of the first of K1's gates the stream fails, or None: the
    u16 unit index fits (2*scp <= 1024; the only gate without ftype and
    qidx, checked before the tile demux), the first frame is intra, and the
    q-table indices are uniform per frame type with U == V. Raises
    ValueError for a q-table index the header does not have."""
    if lanes_per_stripe(g.cw) > 1024:
        return "2*scp <= 1024"
    if ftype is None:
        return None
    ftype = np.asarray(ftype).reshape(-1)
    qidx = np.asarray(qidx).reshape(-1, 3)
    if (qidx >= n_qtables).any():
        raise ValueError("corrupt stream: q-table index out of range")
    if ftype.size == 0 or ftype[0] != 1:
        return "first frame is intra"
    uniform = (qidx[:, 1] == qidx[:, 2]).all() and all(
        (rows == rows[:1]).all() for rows in (qidx[ftype == t] for t in (1, 2)))
    if not uniform:
        return "uniform q indices per frame type, U == V"
    return None


class Route(NamedTuple):
    """How a stream decodes: `gate` None -> the units path (tile demux +
    K1), `host` holding `demux_host`'s output; else the per-frame path
    (K5 + K7), `gate` naming the K1 gate the stream failed."""

    g: Geometry
    gate: str | None
    host: tuple | None


def choose_route(data: bytes, num_threads: int = 0) -> Route:
    """Run the tile demux if the geometry allows it, then K1's gates."""
    hdr, _ = runtime.parse_header(data)
    g = geometry(hdr["width"], hdr["height"])
    gate = failed_gate(g)
    if gate is not None:
        return Route(g, gate, None)
    info, units, coff, bh, ftype, qidx = runtime.demux_file_sparse_tiles(
        data, tile_tables(g), chunk=UNITS_CHUNK, num_threads=num_threads)
    gate = failed_gate(g, ftype, qidx, info["qtables"].shape[0])
    if gate is not None:
        return Route(g, gate, None)
    meta = np.concatenate([bh.reshape(-1), ftype.astype(np.uint16),
                           qidx.reshape(-1).astype(np.uint16)])
    return Route(g, None, (info, g, units, coff, meta))


def demux_host(data: bytes, num_threads: int = 0):
    """Parse and entropy-decode `data` on the host into the tile layout:
    (info, geometry, units (NC, 128) u32, coff (F*gch + 1,) i32,
    meta (F*nb + 4F,) u16 = [block headers | ftype | qidx]). Raises
    ValueError, naming the gate, for a stream K1 does not take."""
    route = choose_route(data, num_threads)
    if route.gate is not None:
        raise ValueError(f"gate '{route.gate}' failed for a "
                         f"{route.g.width}x{route.g.height} stream")
    return route.host


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

    return (canvas_order(mvy, torch.int8), canvas_order(mvx, torch.int8),
            canvas_order(hc, torch.uint8))


def dequant_multipliers(qtables, ftype, hc, qidx) -> torch.Tensor:
    """(2, 2, 64) int32 multipliers [I/P][luma/chroma][row-major r] =
    (qtable * SCALE)[INV_ZIGZAG] (quirk Q1): mode I from the first I-frame's
    q indices, mode P from the first P-frame with a coded block (frame 0's
    when there is none)."""
    dev = qtables.device
    scale = torch.from_numpy(DCT_SCALE_FACTOR).to(dev)
    iz = torch.from_numpy(INV_ZIGZAG_TABLE).long().to(dev)
    i_idx = torch.argmax((ftype == 1).to(torch.int32))
    coded_p = (ftype == 2) & (hc.to(torch.int32).sum(dim=1) > 0)
    p_idx = torch.argmax(coded_p.to(torch.int32))

    def tables(sel):
        return torch.stack([(qtables[sel[0]] * scale)[iz],
                            (qtables[sel[1]] * scale)[iz]])

    return torch.stack([tables(qidx[i_idx]), tables(qidx[p_idx])])


def upload(host, device="cuda"):
    """`demux_host`'s output -> copied to `device`, with the per-clip tables
    built there: (geometry, (units, coff, dy, dx, hc, ftype, qmul)), the
    inputs of `step_frames`."""
    info, g, units, coff, meta = host
    dev = torch.device(device)
    units_t = torch.from_numpy(units.view(np.int32)).to(dev)
    coff_t = torch.from_numpy(coff).to(dev)
    meta_t = torch.from_numpy(meta.view(np.int16)).to(dev).to(torch.int32) & 0xFFFF
    mvx, mvy, hc, ftype, qidx = unpack_meta(meta_t, g.nb)
    dy, dx, hcm = block_maps(g, mvx, mvy, hc)
    qmul = dequant_multipliers(torch.from_numpy(info["qtables"]).to(dev),
                               ftype, hc, qidx)
    return g, (units_t, coff_t, dy, dx, hcm, ftype.contiguous(), qmul)


def decode_frames(data: bytes, device="cuda"):
    """Decode a whole stream frame by frame, each through K5 + K7 per plane
    (dec.FrameDecoder), -> (geometry, (F, chh, cw) u8 canvases) in the
    layout K1 writes, zeros outside the planes. Takes every stream the
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


def decode_canvases(data: bytes, device="cuda", num_threads: int = 0):
    """Decode a whole stream -> (geometry, (F, chh, cw) u8 canvases): by
    the units path (K1) where `choose_route` allows, else `decode_frames`."""
    route = choose_route(data, num_threads)
    if route.gate is not None:
        return decode_frames(data, device)
    g, args = upload(route.host, device)
    return g, step_frames(*args, g.chh, g.cw, g.gly)


def decode_video_yuv(data: bytes, device="cuda", num_threads: int = 0):
    """Decode a whole .pfv stream to unpadded (Y, U, V) u8 tensors, views
    of the decode canvases on `device`."""
    g, canvases = decode_canvases(data, device, num_threads)
    return slice_yuv(g, canvases)


def decode_video_rgba(data: bytes, device="cuda",
                      num_threads: int = 0) -> torch.Tensor:
    """Decode a whole .pfv stream to (F, H, W) uint32 packed RGBA (bytes R,
    G, B, A=255 in memory order; `rgba_view` gives the channels)."""
    g, canvases = decode_canvases(data, device, num_threads)
    return canvas_rgba(canvases, g.height, g.width, g.ly0, g.lcw)


def rgba_view(rgba: torch.Tensor) -> torch.Tensor:
    """(F, H, W) uint32 packed RGBA -> zero-copy (F, H, W, 4) u8 view."""
    return rgba.view(torch.uint8).reshape(rgba.shape + (4,))


def decode_video_rgb(data: bytes, device="cuda",
                     num_threads: int = 0) -> torch.Tensor:
    """Decode a whole .pfv stream to a (F, H, W, 3) u8 RGB view."""
    return rgba_view(decode_video_rgba(data, device, num_threads))[..., :3]


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
    return plane_checksums(*decode_video_yuv(data, device, num_threads))
