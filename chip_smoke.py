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
     tables, K1, K2) and the whole calls, host clock, synchronized.
The line before the last is the kernels' JSON summary; the last line is the
device JSON. Any failure raises, so the exit code is not 0; without a CUDA
device, or without the repository around it, it exits non-zero before
printing a result.
"""

from __future__ import annotations

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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pfv_torch import dataloader as dl
    from pfv_torch import runtime
    from pfv_torch.kernels import build
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

    step_frames.launches = canvas_rgba.launches = 0
    yuv = {k: dl.decode_video_yuv(d, device="cuda") for k, d in datas.items()}
    rgba = dl.decode_video_rgba(datas["1080p"], device="cuda")
    sums = dl.decode_video_checksums(datas["512x384"], device="cuda")
    torch.cuda.synchronize()
    launches = {"K1": step_frames.launches, "K2": canvas_rgba.launches}

    for name, planes in yuv.items():
        exact = all((p.cpu().numpy() == r).all() for p, r in zip(planes, refs[name]))
        print(f"phase 3 decode_video_yuv {name}: {tuple(planes[0].shape)} "
              f"pixel-exact vs ref_decode: {exact}")
        check(exact, f"decode_video_yuv {name} differs from ref_decode")
    g = dl.geometry(1920, 1080)
    canv = torch.zeros((rgba.shape[0], g.chh, g.cw), dtype=torch.uint8, device=dev)
    ry, ru, rv = (torch.from_numpy(p).to(dev) for p in refs["1080p"])
    canv[:, :g.height, :g.width] = ry
    canv[:, g.ly0:g.ly0 + g.height // 2, :g.width // 2] = ru
    canv[:, g.ly0:g.ly0 + g.height // 2, g.lcw:g.lcw + g.width // 2] = rv
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
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
