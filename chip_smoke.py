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
     per 1080p clip (host clock, synchronized).
Each main-path phase (3, 8, 9) sets the launch counts to 0 just before it
and reads them just after. The line before the last is the kernels' JSON
summary; the last line is the device JSON. Any failure raises, so the exit code is not 0; without a CUDA
device, or without the repository around it, it exits non-zero before
printing a result.
"""

from __future__ import annotations

import io
import json
import os
import statistics
import subprocess
import sys
import time

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
    from pfv_torch.kernels.idct import decode_blocks
    from pfv_torch.kernels.mc import mc_reconstruct
    from pfv_torch.kernels.rgba import canvas_rgba
    from pfv_torch.kernels.step import step_frames

    return {"K1": step_frames, "K2": canvas_rgba, "K5": decode_blocks,
            "K7": mc_reconstruct}


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
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
