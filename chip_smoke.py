#!/usr/bin/env python3
"""Smoke run of pfv_torch's main path on one CUDA card.

    python3 chip_smoke.py

from the repository root. Phases, one line each:
  1. build the CUDA kernels from pfv_torch/csrc with nvcc;
  2. hold each kernel against its plain PyTorch version on the card, on the
     inputs the main path gives it for the three committed corpora;
  3. drive the main path (decode_video_yuv on all three corpora,
     decode_video_rgba on 1080p, decode_video_checksums on 512x384) and
     check it pixel-exact against the scalar reference decoder;
  4. check the launch counts of that run: K1 once per decoded frame, K2 at
     least once;
  5. time each kernel and its plain version per 1080p clip with CUDA events;
  6. time each layer of a whole 1080p decode (host demux, upload and
     tables, K1, K2) and the whole calls, host clock, synchronized;
  7. hold K5 (iDCT) and K7 (motion compensation) against their plain
     versions on the card, on the inputs the streaming Decoder gives them
     for the first I-frame and the first P-frame of both 1080p corpora;
  8. drive the streaming Decoder over the three corpora at full length
     (advance_frame, every frame pixel-exact against the scalar reference;
     on 1080p also decode_all and reset with a second pass; advance_delta on
     512x384) and check the launch counts of that run: K5 and K7 three
     times (Y, U, V) per frame decoded, K1 once per frame of decode_all;
  9. drive the whole-clip decode over three streams K1's gates refuse,
     built here from the shared runtime (1080p without its first I-packet,
     1080p with it re-encoded on q-table indices (0, 1, 3), a 4112x64
     random stream): decode_video_yuv pixel-exact and decode_video_rgba
     byte-exact against the reference, K1 launched 0 times, K5 and K7
     three times per frame;
 10. time K5 and K7 per 1080p frame (CUDA events, kernel and plain
     alternating), each layer of a whole 1080p clip through the Decoder's
     frame step (host entropy decode, H2D, K5, K7, D2H of the frames) and
     its advance_frame loop, and the per-frame fallback against the K1 path
     per 1080p clip (host clock, synchronized);
 11. rebuild the three corpora's source frames with pfv_torch.synth (no
     JAX), and hold K6 (forward DCT + quantization) against its plain
     version on the card: the intra entry on the 1080p first frame's three
     padded planes, the delta entry on the first P-frame's blocks and the
     motion search's winning windows;
 12. drive encode_video (quality 2, a keyframe every 60, as the corpora
     were written) over the three sources and check each output's sha256
     against the committed corpus, which the JAX package's encoder wrote;
     check the launch counts of that run: K5, K6 and K7 three times (Y, U,
     V) per frame encoded, K1 and K2 never;
 13. drive the streaming Encoder over the 512x384 source and the first GOP
     of the 1080p pan: its bytes equal encode_video's, and the scalar
     reference decoder's frames of the 512x384 output equal the Encoder's
     own in-loop reconstruction; launch counts as in 12;
 14. time K6 per 1080p frame (CUDA events with the wrapper, profiler device
     time, plain version alternating), encode_video's frames/s per corpus,
     each layer of a whole 1080p encode (source H2D, motion search, K6,
     in-loop K5 + K7, compaction and D2H, host mux; each synchronized) and
     the device's busy share of a whole 1080p encode (profiler).
Each main-path phase (3, 8, 9, 12, 13) sets the launch counts to 0 just
before it and reads them just after. The line before the last is the kernels' JSON
summary; the last line is the device JSON. Any failure raises, so the exit code is not 0; without a CUDA
device, or without the repository around it, it exits non-zero before
printing a result.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import statistics
import struct
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CORPORA = {
    "1080p": ".bench_cache/corpus_1920x1080_q2_120f.pfv",
    "1080p_pan": ".bench_cache/corpus_1920x1080_q2_120f_pan.pfv",
    "512x384": ".bench_cache/corpus_512x384_q2_161f.pfv",
}
TIMED = ("1080p", "1080p_pan")  # K1 per-clip times; K2 on the first
REPS = 5
FALLBACK_WIDE = (4112, 64, 6)  # width, height, frames of the random stream
# the corpora's sources: width, height, frames, generator (bench.py CONFIGS)
SOURCES = {
    "512x384": (512, 384, 161, "std"),
    "1080p_pan": (1920, 1080, 120, "pan"),
    "1080p": (1920, 1080, 120, "std"),
}
QUALITY, KEYFRAMES, FPS = 2, 60, 30
ENC_REPS = 3


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {what}")


def max_abs_err(a, b) -> int:
    return int((a.to(torch.int32) - b.to(torch.int32)).abs().max().item())


def timed_ms(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t)


def paired_ms(kernel_fn, plain_fn):
    """Median ms of kernel and plain runs, alternating, after one warm-up."""
    kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    ks, ps = [], []
    for _ in range(REPS):
        ks.append(timed_ms(kernel_fn))
        ps.append(timed_ms(plain_fn))
    return statistics.median(ks), statistics.median(ps)


def median_host_ms(fn) -> float:
    fn()
    return statistics.median(host_ms(fn) for _ in range(REPS))


def counts():
    from pfv_torch.kernels.fdct import fdct_blocks
    from pfv_torch.kernels.idct import decode_blocks
    from pfv_torch.kernels.mc import mc_reconstruct
    from pfv_torch.kernels.rgba import canvas_rgba
    from pfv_torch.kernels.step import step_frames

    return {"K1": step_frames, "K2": canvas_rgba, "K5": decode_blocks,
            "K6": fdct_blocks, "K7": mc_reconstruct}


def zero_counts() -> None:
    for fn in counts().values():
        fn.launches = 0


def read_counts() -> dict:
    torch.cuda.synchronize()
    return {k: fn.launches for k, fn in counts().items()}


def ref_canvases(g, ref, dev):
    """(F, chh, cw) canvases holding the reference planes, zeros elsewhere."""
    from pfv_torch.frame import slice_yuv

    canv = torch.zeros((ref[0].shape[0], g.chh, g.cw), dtype=torch.uint8, device=dev)
    for view, plane in zip(slice_yuv(g, canv), ref):
        view.copy_(torch.from_numpy(plane))
    return canv


def decoder_frames(dec, compare, count):
    """Run dec.advance_frame to EOF; each frame goes to compare(i, frame)."""
    n = 0

    def emit(f):
        nonlocal n
        compare(n, f)
        n += 1

    while dec.advance_frame(emit):
        pass
    count[0] += n
    return n


def exact_frame(ref, what):
    def compare(i, f):
        for p, r in zip((f.plane_y, f.plane_u, f.plane_v), ref):
            check(i < r.shape[0] and p.shape == r.shape[1:] and (p == r[i]).all(),
                  f"{what}: frame {i} differs from ref_decode")
    return compare


def kernel_pair_inputs(fd, frame, prev):
    """Per plane of an uploaded frame: the K5 inputs, and the K7 inputs
    without the blocks (motion zeros for an I-frame)."""
    for coeffs, q, by, bx, mvy, mvx, hc in fd.plane_args(frame):
        n = coeffs.shape[0]
        if mvy is None:
            mvy = mvx = torch.zeros(n, dtype=torch.int8, device=coeffs.device)
            hc = mvy.view(torch.uint8)
        yield (coeffs.view(n, 4, 64), q), (by, bx, mvy, mvx, hc)


def synth_sources(pool):
    """The corpora's source frames as (Y, U, V) uint8 stacks, per corpus."""
    from pfv_torch import synth

    out = {}
    for name, (w, h, f, kind) in SOURCES.items():
        if kind == "pan":
            out[name] = synth.synth_pan_clip(f, w, h)
            continue
        frames = list(pool.map(lambda t: synth.synth_yuv_frame(t, w, h), range(f)))
        out[name] = tuple(np.stack([p[i] for p in frames]) for i in range(3))
    return out


def packets_prefix(data: bytes, n: int) -> bytes:
    """The header and first n packets of a .pfv stream, then an EOF packet."""
    from pfv_torch import runtime

    _, off = runtime.parse_header(data)
    for _ in range(n):
        off += 5 + struct.unpack_from("<BI", data, off)[1]
    return data[:off] + struct.pack("<BI", 0, 0)


def stream_encode(planes, w, h, n, recon=None) -> bytes:
    """The first n frames through the streaming Encoder on the card; each
    frame's in-loop reconstruction (unpadded, host) appended to `recon`."""
    from pfv_torch import Encoder, VideoFrame

    buf = io.BytesIO()
    with Encoder(buf, w, h, FPS, QUALITY, device="cuda") as enc:
        for t in range(n):
            f = VideoFrame(w, h, *(p[t] for p in planes))
            (enc.encode_iframe if t % KEYFRAMES == 0 else enc.encode_pframe)(f)
            if recon is not None:
                y, u, v = (p.to("cpu", copy=True).numpy() for p in enc.reconstruction())
                recon.append((y[:h, :w], u[:h // 2, :w // 2], v[:h // 2, :w // 2]))
    return buf.getvalue()


def encode_layers(planes, w, h, dev):
    """One encode of a clip through encode_video's layers, each ending in a
    synchronize -> (bytes, ms per layer)."""
    from pfv_torch import runtime
    from pfv_torch.device import iframe_decode_plane, origins_for, pframe_decode_plane
    from pfv_torch.enc import container_header
    from pfv_torch.frame import geometry
    from pfv_torch.kernels.fdct import fdct_blocks
    from pfv_torch.ops.blocks import plane_to_blocks
    from pfv_torch.ops.motion import motion_search
    from pfv_torch.ops.pframe import skip_threshold
    from pfv_torch.ops.quant import derive_q_tables

    ms = dict.fromkeys(("host pad", "source H2D", "motion search", "K6",
                        "K5+K7 in-loop", "compaction+D2H", "host mux"), 0.0)
    clock = [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        ms[name] += 1e3 * (now - clock[0])
        clock[0] = now

    f = planes[0].shape[0]
    g = geometry(w, h)
    shapes = ((g.ly0, g.lyw), (g.lc0, g.lcw), (g.lc0, g.lcw))
    qt_host = derive_q_tables(QUALITY)
    qt = {k: torch.from_numpy(t).to(dev) for k, t in qt_host.items()}
    min_err = skip_threshold(QUALITY)
    origins = [origins_for(*s, dev) for s in shapes]
    bounds = (0, g.yb, g.yb + g.cb, g.nb)
    padded = []
    for p, s, c in zip(planes, shapes, (0, 128, 128)):
        a = np.full((f, *s), c, dtype=np.uint8)
        a[:, :p.shape[1], :p.shape[2]] = p
        padded.append(a)
    lap("host pad")
    src = [torch.from_numpy(a).to(dev) for a in padded]
    lap("source H2D")
    live = torch.empty((f, g.nb, 256), dtype=torch.int16, device=dev)
    mvx = torch.zeros((f, g.nb), dtype=torch.int8, device=dev)
    mvy = torch.zeros((f, g.nb), dtype=torch.int8, device=dev)
    hc = torch.ones((f, g.nb), dtype=torch.bool, device=dev)
    prev = [torch.full(s, c, dtype=torch.uint8, device=dev)
            for s, c in zip(shapes, (0, 128, 128))]
    back = [torch.empty_like(p) for p in prev]
    lap("compaction+D2H")
    for t in range(f):
        key = t % KEYFRAMES == 0
        for i in range(3):
            sl, (by, bx) = slice(bounds[i], bounds[i + 1]), origins[i]
            blocks = plane_to_blocks(src[i][t])
            q = qt[("intra_" if key else "inter_") + ("l" if i == 0 else "c")]
            if key:
                lap("motion search")
                c = fdct_blocks(blocks, q)
                lap("K6")
                iframe_decode_plane(c.view(-1, 256), q, src[i][t], by, bx, back[i])
                lap("K5+K7 in-loop")
                live[t, sl] = c.view(-1, 256)
            else:
                mx, my, err, win = motion_search(blocks, prev[i], by, bx)
                coded = err.to(torch.float32) > float(min_err)
                lap("motion search")
                c = fdct_blocks(blocks, q, win)
                lap("K6")
                mx, my = mx.to(torch.int8), my.to(torch.int8)
                pframe_decode_plane(c.view(-1, 256), mx, my, coded.to(torch.uint8),
                                    prev[i], q, by, bx, back[i])
                lap("K5+K7 in-loop")
                torch.mul(c.view(-1, 256), coded[:, None], out=live[t, sl])
                mvx[t, sl], mvy[t, sl], hc[t, sl] = mx, my, coded
            lap("compaction+D2H")
        prev, back = back, prev
    flat = live.view(f, -1)
    frame_of, idx = torch.nonzero(flat, as_tuple=True)
    val, counts = flat[frame_of, idx], torch.bincount(frame_of, minlength=f)
    idx, val, counts, mvx, mvy, hc = (x.cpu().numpy() for x in (
        idx.to(torch.int32), val, counts, mvx, mvy, hc))
    lap("compaction+D2H")
    out = [container_header(w, h, FPS, qt_host)]
    ends = np.cumsum(counts)
    for t in range(f):
        lo, hi = ends[t] - counts[t], ends[t]
        if t % KEYFRAMES == 0:
            payload = runtime.encode_iframe_payload_sparse(idx[lo:hi], val[lo:hi],
                                                           g.nb, (0, 1, 1))
        else:
            payload = runtime.encode_pframe_payload_sparse(
                idx[lo:hi], val[lo:hi], mvx[t], mvy[t], hc[t].astype(np.uint8),
                (2, 3, 3))
        out += [struct.pack("<BI", 1 if t % KEYFRAMES == 0 else 2, len(payload)),
                payload]
    out.append(struct.pack("<BI", 0, 0))
    lap("host mux")
    return b"".join(out), ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pfv_torch import dataloader as dl
    from pfv_torch import runtime, synth
    from pfv_torch.dec import Decoder, FrameDecoder, frame_packets, split_packets
    from pfv_torch.frame import canvas_planes
    from pfv_torch.kernels import build
    from pfv_torch.kernels.idct import decode_blocks, decode_blocks_plain
    from pfv_torch.kernels.mc import mc_reconstruct, mc_reconstruct_plain
    from pfv_torch.kernels.rgba import canvas_rgba, canvas_rgba_plain
    from pfv_torch.kernels.step import step_frames, step_frames_plain

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    log = build.build()
    build.lib()
    print(f"phase 1 build: nvcc {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())

    datas = {k: open(os.path.join(ROOT, p), "rb").read() for k, p in CORPORA.items()}
    refs = {k: runtime.ref_decode(d)[1:4] for k, d in datas.items()}
    err_k1 = err_k2 = 0
    for name, data in datas.items():
        g, args = dl.upload(dl.demux_host(data), dev)
        canv = step_frames(*args, g.chh, g.cw, g.gly)
        e1 = max_abs_err(canv, step_frames_plain(*args, g.chh, g.cw, g.gly))
        geo = (g.height, g.width, g.ly0, g.lcw)
        e2 = max_abs_err(dl.rgba_view(canvas_rgba(canv, *geo)),
                         dl.rgba_view(canvas_rgba_plain(canv, *geo)))
        print(f"phase 2 kernels vs plain, {name} ({g.width}x{g.height}, "
              f"{args[5].shape[0]} frames, {args[0].shape[0]} unit chunks): "
              f"K1 max_abs_err {e1}, K2 max_abs_err {e2}")
        err_k1, err_k2 = max(err_k1, e1), max(err_k2, e2)
    check(err_k1 == 0 and err_k2 == 0, "a kernel disagrees with its plain version")

    zero_counts()
    yuv = {k: dl.decode_video_yuv(d, device="cuda") for k, d in datas.items()}
    rgba = dl.decode_video_rgba(datas["1080p"], device="cuda")
    sums = dl.decode_video_checksums(datas["512x384"], device="cuda")
    launches = read_counts()

    for name, planes in yuv.items():
        exact = all((p.cpu().numpy() == r).all() for p, r in zip(planes, refs[name]))
        print(f"phase 3 decode_video_yuv {name}: {tuple(planes[0].shape)} "
              f"pixel-exact vs ref_decode: {exact}")
        check(exact, f"decode_video_yuv {name} differs from ref_decode")
    g = dl.geometry(1920, 1080)
    canv = ref_canvases(g, refs["1080p"], dev)
    want = canvas_rgba_plain(canv, g.height, g.width, g.ly0, g.lcw)
    exact = torch.equal(rgba.view(torch.int32), want.view(torch.int32))
    print(f"phase 3 decode_video_rgba 1080p: {tuple(rgba.shape)} {rgba.dtype} "
          f"byte-exact vs plain K2 of ref_decode planes: {exact}")
    check(exact, "decode_video_rgba differs from the plain RGBA of ref_decode")
    want = dl.plane_checksums(*(torch.from_numpy(p) for p in refs["512x384"]))
    exact = torch.equal(sums.cpu(), want)
    print(f"phase 3 decode_video_checksums 512x384: {tuple(sums.shape)} "
          f"equal to the checksums of ref_decode: {exact}")
    check(exact, "decode_video_checksums differs from ref_decode's")

    # yuv of every corpus, rgba of 1080p, checksums of 512x384
    frames = sum(refs[k][0].shape[0] for k in CORPORA)
    frames += refs["1080p"][0].shape[0] + refs["512x384"][0].shape[0]
    print(f"phase 4 launches in the main-path run: K1 {launches['K1']} "
          f"(frames decoded {frames}), K2 {launches['K2']}")
    check(launches["K1"] == frames, "K1 was not launched once per frame")
    check(launches["K2"] >= 1, "K2 was not launched")
    check(launches["K5"] == launches["K7"] == 0, "the K1 path launched K5 or K7")

    times = {}
    for name in TIMED:
        host = dl.demux_host(datas[name])
        g, args = dl.upload(host, dev)
        dims = (g.chh, g.cw, g.gly)
        times[("K1", name)] = paired_ms(lambda: step_frames(*args, *dims),
                                        lambda: step_frames_plain(*args, *dims))
        print(f"phase 5 K1 per clip, {name}: kernel {times[('K1', name)][0]:.3f} ms, "
              f"plain {times[('K1', name)][1]:.3f} ms ({card})")
        if name == TIMED[0]:
            canv = step_frames(*args, *dims)
            geo = (g.height, g.width, g.ly0, g.lcw)
            times["K2"] = paired_ms(lambda: canvas_rgba(canv, *geo),
                                    lambda: canvas_rgba_plain(canv, *geo))
            print(f"phase 5 K2 per clip, {name}: kernel {times['K2'][0]:.3f} ms, "
                  f"plain {times['K2'][1]:.3f} ms ({card})")
        canv = step_frames(*args, *dims)
        geo = (g.height, g.width, g.ly0, g.lcw)
        layers = {
            "demux": lambda: dl.demux_host(datas[name]),
            "upload+tables": lambda: dl.upload(host, dev),
            "K1": lambda: step_frames(*args, *dims),
            "K2": lambda: canvas_rgba(canv, *geo),
            "decode_video_yuv": lambda: dl.decode_video_yuv(datas[name], dev),
            "decode_video_rgba": lambda: dl.decode_video_rgba(datas[name], dev),
        }
        for fn in layers.values():
            fn()
        parts = ", ".join(
            f"{k} {statistics.median(host_ms(fn) for _ in range(REPS)):.3f}"
            for k, fn in layers.items())
        print(f"phase 6 per clip, {name}, median of {REPS}, ms: {parts} ({card})")

    # phase 7: K5 and K7 against their plain versions, Decoder inputs
    err_k5 = err_k7 = 0
    for name in TIMED:
        info, _ = runtime.parse_header(datas[name])
        g = dl.geometry(info["width"], info["height"])
        fd = FrameDecoder(g, info["qtables"], dev)
        packets = frame_packets(datas[name])
        check(packets[0][0] == 1 and packets[1][0] == 2,
              f"{name} does not open with an I-frame and a P-frame")
        prev, cur = fd.initial_canvas(), torch.empty((g.chh, g.cw), dtype=torch.uint8,
                                                     device=dev)
        for f in (0, 1):
            frame = fd.upload(fd.entropy(*packets[f]))
            for (k5_in, k7_in), p in zip(kernel_pair_inputs(fd, frame, prev),
                                         canvas_planes(g, prev)):
                res = decode_blocks(*k5_in)
                e5 = max_abs_err(res, decode_blocks_plain(*k5_in))
                e7 = max_abs_err(mc_reconstruct(res, p, *k7_in, frame[0]),
                                 mc_reconstruct_plain(res, p, *k7_in, frame[0]))
                err_k5, err_k7 = max(err_k5, e5), max(err_k7, e7)
            fd.planes(frame, cur, prev)
            prev, cur = cur, prev
            print(f"phase 7 kernels vs plain, {name} frame {f} "
                  f"({'I' if frame[0] else 'P'}, {g.nb} blocks): K5 max_abs_err "
                  f"{err_k5}, K7 max_abs_err {err_k7}")
    check(err_k5 == 0 and err_k7 == 0, "K5 or K7 disagrees with its plain version")

    # phase 8: the streaming Decoder, the second main path
    zero_counts()
    stepped, bulk = [0], 0
    for name, data in datas.items():
        dec = Decoder(io.BytesIO(data), device="cuda")
        n = decoder_frames(dec, exact_frame(refs[name], f"Decoder {name}"), stepped)
        check(n == refs[name][0].shape[0], f"Decoder {name} decoded {n} frames")
        print(f"phase 8 Decoder.advance_frame {name}: {n} frames pixel-exact "
              "vs ref_decode")
    dec = Decoder(io.BytesIO(datas["1080p"]), device="cuda")
    frames = dec.decode_all()
    bulk += len(frames)
    compare = exact_frame(refs["1080p"], "Decoder.decode_all 1080p")
    for i, f in enumerate(frames):
        compare(i, f)
    dec.reset()
    n = decoder_frames(dec, exact_frame(refs["1080p"], "Decoder after reset"), stepped)
    check(len(frames) == n == refs["1080p"][0].shape[0], "decode_all or reset pass short")
    print(f"phase 8 Decoder.decode_all 1080p: {len(frames)} frames, then reset and "
          f"advance_frame: {n} frames, all pixel-exact vs ref_decode")
    dec = Decoder(io.BytesIO(datas["512x384"]), device="cuda")
    got, compare = [0], exact_frame(refs["512x384"], "Decoder.advance_delta 512x384")

    def paced(f):
        compare(got[0], f)
        got[0] += 1

    ticks = 0
    while dec.advance_delta(0.75 / dec.framerate(), paced):
        ticks += 1
    stepped[0] += got[0]
    check(got[0] == refs["512x384"][0].shape[0], "advance_delta decoded too few frames")
    print(f"phase 8 Decoder.advance_delta 512x384: {got[0]} frames in {ticks + 1} "
          "ticks of 3/4 frame, pixel-exact vs ref_decode")
    dec_launches = read_counts()
    print(f"phase 8 launches in the Decoder run: {dec_launches} (frames stepped "
          f"{stepped[0]}, frames of decode_all {bulk})")
    check(dec_launches["K5"] == dec_launches["K7"] == 3 * stepped[0],
          "K5 and K7 were not launched three times per stepped frame")
    check(dec_launches["K1"] == bulk, "decode_all did not launch K1 once per frame")

    # phase 9: streams K1's gates refuse go frame by frame through K5 + K7
    info, packets = split_packets(datas["1080p"])
    first_i = next(i for i, (t, _) in enumerate(packets) if t == 1)
    g = dl.geometry(info["width"], info["height"])
    coeffs, _ = runtime.decode_iframe_payload(packets[first_i][1], g.nb)
    requant = list(packets)
    requant[first_i] = (1, runtime.encode_iframe_payload(coeffs, (0, 1, 3)))
    fallback = {
        "1080p_first_p": synth.container(g.width, g.height, info["qtables"],
                                         packets[first_i + 1:]),
        "1080p_q013": synth.container(g.width, g.height, info["qtables"], requant),
        "4112x64": synth.random_stream(*FALLBACK_WIDE, seed=2, keyframes=4),
    }
    fb_refs = {k: runtime.ref_decode(d)[1:4] for k, d in fallback.items()}
    gates = {k: dl.choose_route(d).gate for k, d in fallback.items()}
    zero_counts()
    fb_frames = 0
    for name, data in fallback.items():
        check(gates[name] is not None, f"{name} passed K1's gates")
        planes = dl.decode_video_yuv(data, device="cuda")
        rgba = dl.decode_video_rgba(data, device="cuda")
        torch.cuda.synchronize()
        exact = all((p.cpu().numpy() == r).all() for p, r in zip(planes, fb_refs[name]))
        hdr, _ = runtime.parse_header(data)
        gf = dl.geometry(hdr["width"], hdr["height"])
        want = canvas_rgba_plain(ref_canvases(gf, fb_refs[name], dev),
                                 gf.height, gf.width, gf.ly0, gf.lcw)
        exact_rgba = torch.equal(rgba.view(torch.int32), want.view(torch.int32))
        fb_frames += 2 * fb_refs[name][0].shape[0]
        print(f"phase 9 fallback {name} (gate '{gates[name]}'): "
              f"{tuple(planes[0].shape)} decode_video_yuv pixel-exact: {exact}, "
              f"decode_video_rgba byte-exact: {exact_rgba}")
        check(exact and exact_rgba, f"fallback {name} differs from ref_decode")
    fb_launches = read_counts()
    print(f"phase 9 launches in the fallback run: {fb_launches} (frames decoded "
          f"{fb_frames})")
    check(fb_launches["K1"] == 0, "a fallback stream launched K1")
    check(fb_launches["K5"] == fb_launches["K7"] == 3 * fb_frames,
          "K5 and K7 were not launched three times per fallback frame")
    check(fb_launches["K2"] == len(fallback), "K2 was not launched once per RGBA call")

    # phase 10: times
    info, _ = runtime.parse_header(datas["1080p"])
    g = dl.geometry(info["width"], info["height"])
    fd = FrameDecoder(g, info["qtables"], dev)
    packets = frame_packets(datas["1080p"])
    canv = torch.empty((2, g.chh, g.cw), dtype=torch.uint8, device=dev)
    fd.planes(fd.upload(fd.entropy(*packets[0])), canv[0], fd.initial_canvas())
    pin = list(kernel_pair_inputs(fd, fd.upload(fd.entropy(*packets[1])), canv[0]))
    blocks = [decode_blocks(*k5_in) for k5_in, _ in pin]
    refp, outp = canvas_planes(g, canv[0]), canvas_planes(g, canv[1])

    def k5_frame():
        return [decode_blocks(*a) for a, _ in pin]

    def k7_frame():
        return [mc_reconstruct(r, p, *a, False, o)
                for r, p, (_, a), o in zip(blocks, refp, pin, outp)]

    times["K5"] = paired_ms(k5_frame, lambda: [decode_blocks_plain(*a) for a, _ in pin])
    times["K7"] = paired_ms(k7_frame, lambda: [
        mc_reconstruct_plain(r, p, *a, False, o)
        for r, p, (_, a), o in zip(blocks, refp, pin, outp)])
    print(f"phase 10 per 1080p P-frame (Y, U, V; CUDA events around the three "
          f"wrapper calls, launch overhead included): K5 kernel {times['K5'][0]:.4f} "
          f"ms, plain {times['K5'][1]:.4f} ms; K7 kernel {times['K7'][0]:.4f} ms, "
          f"plain {times['K7'][1]:.4f} ms ({card})")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            k5_frame(), k7_frame()
        torch.cuda.synchronize()
    device_us = {k: sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
                        if kernel in e.key) / 10
                 for k, kernel in (("K5", "idct_blocks_kernel"), ("K7", "mc_kernel"))}
    print("phase 10 per 1080p P-frame, device time of the kernels alone "
          "(torch.profiler, 10 frames): " + ", ".join(
              f"{k} {v:.2f} us" if v else f"{k} not measured (no device time seen)"
              for k, v in device_us.items()) + f" ({card})")

    def decoder_layers():
        """One pass of the Decoder's frame step over the clip, each layer
        synchronized, -> ms per layer."""
        t = dict.fromkeys(("host entropy decode", "H2D", "K5", "K7", "D2H emit"), 0.0)
        prev, cur = fd.initial_canvas(), canv[1]
        for p in packets:
            t0 = time.perf_counter()
            host = fd.entropy(*p)
            t1 = time.perf_counter()
            frame = fd.upload(host)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            pairs = list(kernel_pair_inputs(fd, frame, prev))
            res = [decode_blocks(*k5_in) for k5_in, _ in pairs]
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            for r, (_, k7_in), pp, o in zip(res, pairs, canvas_planes(g, prev),
                                            canvas_planes(g, cur)):
                mc_reconstruct(r, pp, *k7_in, frame[0], o)
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            cur.to("cpu", copy=True)
            t5 = time.perf_counter()
            for k, dt in zip(t, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
                t[k] += 1e3 * dt
            prev, cur = cur, prev
        return t

    def advance_all():
        dec = Decoder(io.BytesIO(datas["1080p"]), device="cuda")
        while dec.advance_frame(lambda f: None):
            pass

    nfr = len(packets)
    runs = [decoder_layers() for _ in range(REPS + 1)][1:]
    lt = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    loop_ms = median_host_ms(advance_all)
    print(f"phase 10 Decoder per 1080p clip ({nfr} frames), in-loop layers, median "
          f"of {REPS}, ms: " + ", ".join(f"{k} {v:.3f}" for k, v in lt.items())
          + f" (sum {sum(lt.values()):.3f}); advance_frame loop {loop_ms:.3f} ms, "
          f"{1e3 * nfr / loop_ms:.2f} frames/s ({card})")
    first_p = fallback["1080p_first_p"]
    k1_ms, fb_ms = [], []
    dl.decode_video_yuv(datas["1080p"], dev), dl.decode_video_yuv(first_p, dev)
    for _ in range(REPS):
        k1_ms.append(host_ms(lambda: dl.decode_video_yuv(datas["1080p"], dev)))
        fb_ms.append(host_ms(lambda: dl.decode_video_yuv(first_p, dev)))
    print(f"phase 10 decode_video_yuv per 1080p clip, median of {REPS}: K1 path "
          f"{statistics.median(k1_ms):.3f} ms ({refs['1080p'][0].shape[0]} frames), "
          f"per-frame fallback {statistics.median(fb_ms):.3f} ms "
          f"({fb_refs['1080p_first_p'][0].shape[0]} frames, first frame P) ({card})")

    # phase 11: the sources, then K6 against its plain version
    from pfv_torch import encode_video
    from pfv_torch.device import iframe_encode_plane, origins_for, pad_plane_host
    from pfv_torch.kernels.fdct import fdct_blocks, fdct_blocks_plain
    from pfv_torch.ops.blocks import plane_to_blocks
    from pfv_torch.ops.motion import motion_search
    from pfv_torch.ops.quant import derive_q_tables

    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        srcs = synth_sources(pool)
    print(f"phase 11 sources rebuilt with pfv_torch.synth: " + ", ".join(
        f"{k} {tuple(v[0].shape)}" for k, v in srcs.items())
        + f" in {time.perf_counter() - t0:.1f} s")
    qt = {k: torch.from_numpy(v).to(dev) for k, v in derive_q_tables(QUALITY).items()}
    g = dl.geometry(1920, 1080)
    k6_in = {"intra": [], "delta": []}
    for i, (shape, clear) in enumerate((((g.ly0, g.lyw), 0), ((g.lc0, g.lcw), 128),
                                        ((g.lc0, g.lcw), 128))):
        f0, f1 = (pad_plane_host(srcs["1080p"][i][t], *shape, clear, dev) for t in (0, 1))
        by, bx = origins_for(*shape, dev)
        qi, qp = qt["intra_l" if i == 0 else "intra_c"], qt["inter_l" if i == 0 else "inter_c"]
        _, recon = iframe_encode_plane(f0, qi, by, bx)
        b1 = plane_to_blocks(f1)
        k6_in["intra"].append((plane_to_blocks(f0), qi))
        k6_in["delta"].append((b1, qp, motion_search(b1, recon, by, bx)[3]))
    err_k6 = 0
    for entry, args in k6_in.items():
        e = max(max_abs_err(fdct_blocks(*a), fdct_blocks_plain(*a)) for a in args)
        print(f"phase 11 K6 vs plain, 1080p frame {0 if entry == 'intra' else 1} "
              f"({entry} entry, Y/U/V {[a[0].shape[0] for a in args]} blocks): "
              f"max_abs_err {e}")
        err_k6 = max(err_k6, e)
    check(err_k6 == 0, "K6 disagrees with its plain version")

    # phase 12: encode_video, the encode main path, against the JAX bytes
    zero_counts()
    encoded, enc_first_ms = {}, {}
    for name, planes in srcs.items():
        t0 = time.perf_counter()
        encoded[name] = encode_video(*planes, FPS, QUALITY, KEYFRAMES, device="cuda")
        enc_first_ms[name] = 1e3 * (time.perf_counter() - t0)
    enc_launches = read_counts()
    for name, data in encoded.items():
        want = datas[name]
        got_sha, want_sha = (hashlib.sha256(d).hexdigest() for d in (data, want))
        print(f"phase 12 encode_video {name} ({SOURCES[name][2]} frames, whole file): "
              f"{len(data)} bytes sha256 {got_sha}; {CORPORA[name]} sha256 "
              f"{want_sha}; equal: {data == want}")
        check(data == want, f"encode_video {name} differs from the JAX package's bytes")
    enc_frames = sum(v[2] for v in SOURCES.values())
    print(f"phase 12 launches in the encode run: {enc_launches} (frames encoded "
          f"{enc_frames})")
    check(enc_launches["K5"] == enc_launches["K6"] == enc_launches["K7"] == 3 * enc_frames,
          "K5, K6 and K7 were not launched three times per encoded frame")
    check(enc_launches["K1"] == enc_launches["K2"] == 0, "the encoder launched K1 or K2")

    # phase 13: the streaming Encoder, and the round trip
    zero_counts()
    recon = []
    w, h, n, _ = SOURCES["512x384"]
    data = stream_encode(srcs["512x384"], w, h, n, recon)
    check(data == encoded["512x384"], "Encoder 512x384 differs from encode_video")
    ry = runtime.ref_decode(data)[1:4]
    exact = len(recon) == ry[0].shape[0] and all(
        (a == r[t]).all() for t, planes in enumerate(recon) for a, r in zip(planes, ry))
    print(f"phase 13 Encoder 512x384 ({n} frames): bytes equal to encode_video's; "
          f"ref_decode of them equals the in-loop reconstruction: {exact}")
    check(exact, "the reference decoder's frames differ from the in-loop reconstruction")
    data = stream_encode(srcs["1080p_pan"], 1920, 1080, KEYFRAMES)
    exact = data == packets_prefix(encoded["1080p_pan"], KEYFRAMES)
    print(f"phase 13 Encoder 1080p_pan first GOP ({KEYFRAMES} frames): bytes equal to "
          f"encode_video's first GOP: {exact}")
    check(exact, "Encoder 1080p_pan first GOP differs from encode_video")
    st_launches = read_counts()
    print(f"phase 13 launches in the Encoder run: {st_launches} (frames encoded "
          f"{n + KEYFRAMES})")
    check(st_launches["K5"] == st_launches["K6"] == st_launches["K7"]
          == 3 * (n + KEYFRAMES), "the Encoder did not launch K5, K6, K7 3x per frame")

    # phase 14: times
    times["K6"] = {e: paired_ms(lambda: [fdct_blocks(*a) for a in args],
                                lambda: [fdct_blocks_plain(*a) for a in args])
                   for e, args in k6_in.items()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            for args in k6_in.values():
                for a in args:
                    fdct_blocks(*a)
        torch.cuda.synchronize()
    k6_us = {e: sum(getattr(ev, "device_time_total", 0) for ev in prof.key_averages()
                    if f"fdct_kernel<{flag}>" in ev.key) / 10
             for e, flag in (("intra", "false"), ("delta", "true"))}
    print("phase 14 K6 per 1080p frame (Y, U, V): " + "; ".join(
        f"{e} entry: kernel {times['K6'][e][0]:.4f} ms with the wrapper, plain "
        f"{times['K6'][e][1]:.4f} ms, device time "
        + (f"{k6_us[e]:.2f} us" if k6_us[e] else "not measured (no device time seen)")
        for e in k6_in) + f" ({card})")
    fps = {}
    for name, planes in srcs.items():
        runs = [host_ms(lambda: encode_video(*planes, FPS, QUALITY, KEYFRAMES,
                                             device="cuda")) for _ in range(ENC_REPS)]
        fps[name] = 1e3 * SOURCES[name][2] / statistics.median(runs)
        print(f"phase 14 encode_video {name}: first call {enc_first_ms[name]:.3f} ms, "
              f"median of {ENC_REPS} {statistics.median(runs):.3f} ms "
              f"({', '.join(f'{r:.3f}' for r in runs)}), {fps[name]:.2f} frames/s "
              f"({card})")
    for name in ("1080p", "1080p_pan"):
        w, h = SOURCES[name][:2]
        runs = []
        for _ in range(ENC_REPS):
            data, ms = encode_layers(srcs[name], w, h, dev)
            check(data == datas[name], f"the layer-timed encode of {name} differs")
            runs.append(ms)
        lt = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
        print(f"phase 14 encode layers per {name} clip ({SOURCES[name][2]} frames, "
              f"each synchronized, median of {ENC_REPS}), ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in lt.items())
              + f" (sum {sum(lt.values()):.3f}) ({card})")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        wall = host_ms(lambda: encode_video(*srcs["1080p"], FPS, QUALITY, KEYFRAMES,
                                            device="cuda"))
    # kernels and copies only: an operator's device time is its kernels'
    on_card = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(ev.self_device_time_total for ev in on_card)
    top = sorted(on_card, key=lambda ev: -ev.self_device_time_total)
    print(f"phase 14 encode_video 1080p under the profiler: wall {wall:.3f} ms, device "
          f"busy {busy_us / 1e3:.3f} ms, busy share {busy_us / 1e3 / wall:.4f}; top "
          "device time: " + "; ".join(
              f"{ev.key[:70]} {ev.self_device_time_total / 1e3:.3f} ms ({ev.count} runs)"
              for ev in top[:8]) + f" ({card})")

    kernels = [
        {"name": "step_frame", "route": "cuda",
         "source": "pfv_torch/csrc/step_kernel.cu",
         "replaces": "pfv_tpu/ops/pallas/step_kernel.py:596",
         "launches": launches["K1"], "max_abs_err": err_k1,
         "ms": times[("K1", TIMED[0])][0], "plain_ms": times[("K1", TIMED[0])][1]},
        {"name": "canvas_rgba", "route": "cuda",
         "source": "pfv_torch/csrc/rgba_kernel.cu",
         "replaces": "pfv_tpu/ops/pallas/rgb_kernel.py:37",
         "launches": launches["K2"], "max_abs_err": err_k2,
         "ms": times["K2"][0], "plain_ms": times["K2"][1]},
        {"name": "idct_blocks", "route": "cuda",
         "source": "pfv_torch/csrc/idct_kernel.cu",
         "replaces": "pfv_tpu/ops/pallas/idct_kernel.py:59",
         "launches": dec_launches["K5"], "max_abs_err": err_k5,
         "ms": times["K5"][0], "plain_ms": times["K5"][1]},
        {"name": "mc_reconstruct", "route": "cuda",
         "source": "pfv_torch/csrc/mc_kernel.cu",
         "replaces": "pfv_tpu/ops/pallas/mc_kernel.py:31",
         "launches": dec_launches["K7"], "max_abs_err": err_k7,
         "ms": times["K7"][0], "plain_ms": times["K7"][1]},
        {"name": "fdct_quantize", "route": "cuda",
         "source": "pfv_torch/csrc/fdct_kernel.cu",
         "replaces": "pfv_tpu/ops/pallas/dct_kernel.py:61",
         "launches": enc_launches["K6"], "max_abs_err": err_k6,
         "ms": times["K6"]["delta"][0], "plain_ms": times["K6"]["delta"][1]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
