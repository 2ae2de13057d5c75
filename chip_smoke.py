#!/usr/bin/env python3
"""Smoke run of pfv_torch's main path on one CUDA card.

    python3 chip_smoke.py

from the repository root. Phases, one line each:
  1. build the CUDA kernels from pfv_torch/csrc with nvcc and, beside them,
     the port's own copy of the C++ entropy runtime with g++;
  2. hold each kernel against its plain PyTorch version on the card, on the
     inputs the main path gives it for the three committed corpora, and K1
     on the edge streams of pfv_torch.synth (widths 528, 1936 and 4096,
     height 16, the longest vectors the planes allow, P-frames with no
     coded block and with all coded), also with random vectors of the
     7-bit field's whole range that leave the canvas on every side, and on
     the 1080p streams of phase 9 with per-frame tables (their own, and
     random ones with U and V apart in every frame) from a starting canvas
     (the reference framebuffer, a random one); and K2
     on random canvases that its vector path refuses in part or whole
     (width % 8 == 4, width % 4 != 0, odd width, odd height, a V column
     that is not 4-byte aligned);
  3. drive the main path (decode_video_yuv on all three corpora,
     decode_video_rgba on 1080p, decode_video_checksums on 512x384) and
     check it pixel-exact against the scalar reference decoder;
  4. check the launch counts of that run: K1 once per decoded frame, K2 at
     least once, no other kernel;
  5. time K1 and K2 and their plain versions per 1080p clip with CUDA
     events and the profiler's device time, and count the unit words K1's
     CTAs read against the words of the tiles;
  6. time each layer of a whole 1080p decode (host demux, upload and
     tables, K1, K2) and the whole calls, host clock, synchronized, and the
     512x384 demux and decode_video_yuv;
  7. hold the frame step (K5 + K7 as one kernel, one launch per frame) and
     K5 (iDCT) and K7 (motion compensation) per plane against their plain
     versions on the card, on the inputs the streaming Decoder gives them
     for the first I-frame and the first P-frame of both 1080p corpora; the
     frame step also with random vectors of the int8 field's whole range
     (windows that leave every plane), q-table indices that differ per
     plane (U and V apart), and in its one-plane form (device.plane_step);
  8. drive the streaming Decoder over the three corpora at full length
     (advance_frame, every frame pixel-exact against the scalar reference;
     on 1080p also decode_all and reset with a second pass; advance_delta on
     512x384) and check the launch counts of that run: the frame step once
     per frame decoded, K5 and K7 never, K1 once per frame of decode_all;
  9. drive the whole-clip decode over three streams the TPU kernels'
     contracts refuse, built here with the port's runtime (1080p without its
     first I-packet, 1080p with it re-encoded on q-table indices (0, 1, 3), a
     4112x64 random stream without its first I-packet): decode_video_yuv
     pixel-exact and decode_video_rgba byte-exact against the reference,
     K1 (1080p) or K3 (4112x64) once per frame, the frame step, K4, K5 and
     K7 never;
 10. time the frame step per 1080p P-frame (CUDA events around the wrapper,
     one call and 100 back to back, the host's enqueue time, the profiler's
     device time, its plain version alternating) and, in the same call, K5
     and K7 per plane; each layer of a whole 1080p clip
     through the Decoder (host entropy decode, pinned H2D, frame step, D2H
     of the frames) and its advance_frame loop, and per 1080p clip the K1
     path, K1 from the starting canvas (phase 9's first-P stream) and the
     per-frame path on that stream (host clock, synchronized);
 11. rebuild the three corpora's source frames with pfv_torch.synth (no
     JAX), and hold K6 (the frame-encode step: forward DCT + quantization
     of a frame's three planes in one launch) against its plain version on
     the card: on the 1080p first frame (intra), on the first P-frame with
     the motion search's vectors and flags, and on that P-frame with random
     vectors that leave every plane, random flags and U and V on different
     q-tables; and its per-plane entry fdct_blocks on the same frames' blocks
     and the search's winning windows; then K8 (the motion search of a
     P-frame's three planes in one launch) against its plain version, every
     vector and flag equal, at the skip thresholds of qualities 0 and 10: on
     the first P-frame of each corpus's source against the in-loop
     reconstruction of its first frame, on a 1080p frame of random noise, on
     a flat frame and on a frame equal to the previous one (every candidate
     ties: every vector 0), on single planes 16x16, 16x64 and 64x16 and on
     the planes of an 18x10 frame (one macroblock high or wide: only the
     centre, or one axis, is in the plane), and on the stress inputs of
     pfv_torch.synth.search_stress on a 1080p canvas (every vector in
     -15..15, so every column phase of a window; ring candidates that tie;
     the largest error, also at thresholds just below and at it; walks
     against every edge of U and V) and on a one-block-high and a
     one-block-wide plane; each search one launch;
 12. drive encode_video (quality 2, a keyframe every 60, as the corpora
     were written) over the three sources and check each output's sha256
     against the committed corpus, which the JAX package's encoder wrote;
     check the launch counts of that run: K6 and the in-loop frame step once
     per frame encoded, K8 once per P-frame, K6's per-plane entry, K1, K2,
     K5 and K7 never;
 13. drive the streaming Encoder over the 512x384 source and the first GOP
     of the 1080p pan: its bytes equal encode_video's, and the scalar
     reference decoder's frames of the 512x384 output equal the Encoder's
     own in-loop reconstruction; launch counts as in 12;
 14. time K6 per 1080p frame, an I-frame and a P-frame (CUDA events around
     one wrapped call, 100 calls back to back, the profiler's device time,
     the plain version alternating) and K8 per 1080p P-frame of both 1080p
     sources in the same way and, by the profiler, after a fill that evicts
     the L2 and after 2 ms of an idle card, K8's SASS instructions per 16
     pixels of a candidate and registers (cuobjdump), encode_video's
     frames/s per corpus,
     each layer of a whole 1080p encode (source H2D, the padding on the
     device, K8, K6, the in-loop frame step, compaction and D2H, host mux;
     each synchronized) and
     the device's busy share of a whole 1080p encode and K8's time per
     launch in it (profiler);
 15. hold K3 (dense whole-clip step) and K4 (dense frame step, batched over
     GOPs) against their plain versions on the card, on the inputs the dense
     routes give them for the three corpora: K3 over the whole clip, K4 in
     GOP form ((2, 60) at 1080p, (3, 60) at 512x384, 19 pad frames), step
     by step (one call on [:, l:l+1] views of the (G, L, ...) tensors) and
     whole; and
     on the 4112x16 edge stream, also with random vectors, and K4 with random
     per-frame tables from random canvases; K3 with per-frame tables from a
     starting canvas on phase 9's 4112x64 stream (exact against the reference
     from the reference framebuffer);
 16. drive the dense routes: decode_video_yuv and decode_video_rgba of an
     8K UHD stream (7680x4320, 24 frames, a keyframe every 8: route
     "dense", K3) and of a 4112x64 stream with a keyframe every 4 (route
     "gops", K4), and decode_packed_gops over the three corpora, all exact
     against the reference; K3 launched once per 8K frame, K4 L times per
     GOP-route clip, K1, K5 and K7 never;
 17. time K3 and K4 per clip against their plain versions (CUDA events and
     profiler device time), each layer of the 8K decode (host demux, H2D,
     tables, densify, K3, K2) and the whole calls, and the per-frame
     fallback on the same 8K stream.
 18. drive VideoDataLoader over the three corpora twice over, mixed (1080p,
     512x384, 1080p pan, ...): every clip equal to decode_video_rgb of the
     same bytes, K1 once per frame and K2 once per clip; then the loader's
     and a plain decode_video_rgb loop's rates over the same list (host
     clock, synchronized, median of 3), with the worker's read, demux and
     upload and the consumer's wait and decode per clip;
 19. build two 48-frame 8K UHD streams, past a dense chunk's 24 frames
     (phase 16's packets twice; its I-packet, then its P-packets over and
     over), and drive decode_video_yuv and decode_video_rgba over both: the
     dense route in two chunks, K3 once per frame, each chunk from the last
     canvas of the one before, exact against the reference; then
     decode_video_rgb_chunks with a cap of 24 (two runs, each route "dense"),
     every pixel equal to K2's plain version of the reference planes; the
     times of the whole-clip decode, the chunks and the per-frame path on the
     same bytes, and the peak device memory of each beside a 24-frame
     decode's (beyond it, the 48-frame decode may hold no more than its 48
     canvases and the second chunk's uploaded tensors);
 20. drive decode_stream_batch of four 1080p streams and decode_video_gops
     of the 1080p corpus over the list ["cuda:0", "cuda:0"] (the one card
     twice: two threads, two streams), exact against the reference,
     mean_luma against numpy, K1 once per frame; the batch's time on one
     list entry and on two;
 21. drive encode_video_gops of the 512x384 source over the same list:
     sha256 equal to the committed corpus, K6 and the frame step once per
     frame, K8 once per P-frame; its time beside encode_video's;
 22. drive the command-line tool in-process (info, verify, bench --runs 3
     on the 512x384 corpus; encode --synth 8, then decode to a temporary
     .npy held to the reference decoder).
Each main-path phase (3, 8, 9, 12, 13, 16, 18-22) sets the launch counts to
0 just before it and reads them just after; the kernels' JSON line gives
each kernel's launches summed over those phases. Under programmatic dependent launch
the profiler's time of a grid holds its wait for the previous grid, so a
clip's device time can exceed its CUDA-event time. The kernels' JSON line
gives each kernel's time beside its bound: the larger of the bytes it must
move at the card's 3.35 TB/s and the operations its code runs on the
inputs of the timed call (counted from the CUDA sources: see the *_OPS
constants), at the card's issue rate from its SM count and top SM clock
(nvidia-smi): one warp instruction per clock in each of an SM's four
partitions, 128 lanes per SM, ~33.5 T op/s on an H100 SXM, for the integer
kernels (K1, K3-K8, the frame step; nvcc puts integer adds and shifts on
the INT32 pipe
and, as IMAD, on the FMA pipe); twice that for K2's float math (a fused
multiply-add is two operations, 67 T/s). Both sides are printed. The line
before the last is the kernels' JSON summary; the last line is the device
JSON. Any failure raises, so the exit code is not 0; without a CUDA
device, or without the repository around it, it exits non-zero before
printing a result.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import re
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
UHD = (7680, 4320, 24, 8)  # width, height, frames, keyframe interval
GOPS = {"1080p": (2, 60), "1080p_pan": (2, 60), "512x384": (3, 60)}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
# operations per second of the card, set in main(): "int" (128 lanes per SM)
# and "fp32" (128 lanes, FMA = 2)
RATES = {}
# Operations, counted from the CUDA sources. One 8-point transform (dct8.cuh
# idct8 or fdct8): 36 adds and 12 truncating divisions (mask, add, shift),
# 6 sign extractions. Per inverse-transformed coefficient: dequantize, a
# column and a row transform, then shift, offset, two clamps and the byte
# pack; the dense frame step and the per-plane frame step widen each
# coefficient they load (one more).
# Per forward-transformed coefficient (K6): the residual by byte-wise SIMD
# (6 per 4 pixels) and the widening (2), two transforms, then scale, shift,
# magnitude, the reciprocal multiply (2), the sign (2) and the pack. Frame
# steps (step_common.cuh store_tile), per 16-pixel row of a
# P-frame block: 4 funnel shifts where the window is not 4-byte aligned
# (dx % 4 != 0), the select where the block is coded (6 SIMD operations per
# 4 pixels); an intra row is a copy. K1 per unit word: sign-extend the
# value, split row and lane, the shared atomic add. K7 per pixel of a coded
# block: offset, double, add, two clamps. K2 per pixel: colour conversion
# and packing, float32. K8 (motion_kernel.cu): what the search itself needs per
# 16 pixels of a candidate whose error is summed, whatever the kernel's form:
# four byte-wise differences of four pixels (__vabsdiffu4), four dot products
# that square and add them (__dp4a), one add into the candidate's sum. The
# kernel takes a step's eight ring candidates at once (lane l:
# candidate l / 4 + 1, rows l % 4 + 4 r), reads each window row as four whole
# words of one of four byte-shifted copies of the staged region (pitch 47
# words, 1.5 wavefronts per load), 2 x 8 blocks a CTA of 16 warps, 3 CTAs an
# SM, and runs about 18 SASS instructions per 16 pixels of a candidate
# (sass_per_16px; 48 in the earlier form that took a candidate per
# half-warp, word selects and funnel shifts included). The bound counts none
# of that body: the kernel waits on the loads of its staged region, not on
# its instructions (PERF.md §6).
DCT8_OPS = 36 + 3 * 12 + 6
IDCT_OPS = 1 + 2 * DCT8_OPS / 8 + 5
FDCT_OPS = 4 + 2 * DCT8_OPS / 8 + 8
SHIFT_OPS, SELECT_OPS, UNIT_OPS, MC_OPS, RGBA_OPS = 4, 24, 4, 5, 15
SEARCH_OPS = 4 + 4 + 1
# the corpora's sources: width, height, frames, generator (bench.py CONFIGS)
SOURCES = {
    "512x384": (512, 384, 161, "std"),
    "1080p_pan": (1920, 1080, 120, "pan"),
    "1080p": (1920, 1080, 120, "std"),
}
QUALITY, KEYFRAMES, FPS = 2, 60, 30
# K2 on random (3, 160, 256) canvases: height, width, first chroma row, V column
K2_EDGES = {
    "width % 8 == 4": (90, 132, 96, 112),
    "width % 4 != 0": (90, 134, 96, 112),
    "odd height": (89, 136, 96, 112),
    "V column not 4-byte aligned": (90, 100, 96, 70),
    "odd width and height, odd V column": (77, 131, 96, 67),
}
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


def bound(nbytes: float, ops: float, kind: str = "int"):
    """(least ms, "bytes" or "operations", the bytes' ms, the operations'
    ms): the larger of the bytes' and the operations' times."""
    t_bytes, t_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / RATES[kind]
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", t_bytes, t_ops


def card_rates() -> dict:
    """The card's integer and float32 operation rates from its SM count and
    top SM clock: one warp instruction per clock per SM partition."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"int": sms * 128 * mhz * 1e6, "fp32": sms * 128 * 2 * mhz * 1e6,
            "sms": sms, "mhz": mhz}


def device_profile(fn, kernel: str, reps: int):
    """(The profiler's device time of the kernels whose name holds `kernel`
    over reps calls of fn, ms; the launches of them it saw)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages()
            if kernel in e.key and e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.device_time_total for e in seen) / 1e3, sum(e.count for e in seen)


def device_ms(fn, kernel: str, reps: int = 3) -> float:
    """The profiler's device time per call of fn of the kernels whose name
    holds `kernel`, ms; 0.0 when the profiler saw none."""
    return device_profile(fn, kernel, reps)[0] / reps


def launch_us(fn, kernel: str, reps: int = 10) -> str:
    """The profiler's device time per launch it saw of the kernels whose
    name holds `kernel` over reps calls of fn, as text with the launches
    seen; a launch the profiler drops does not count as one of 0 us."""
    ms, seen = device_profile(fn, kernel, reps)
    return f"{1e3 * ms / seen:.2f} us ({seen} launches seen)" if seen else "not measured"


def random_vectors(maps, seed: int):
    """The (dy, dx, hc) maps with dy and dx replaced by random vectors of
    the 7-bit field's whole range, so that windows leave the canvas on
    every side."""
    dy, dx, hc = maps
    gen = torch.Generator(device=dy.device).manual_seed(seed)
    return (*(torch.randint(-64, 64, dy.shape, generator=gen, device=dy.device,
                            dtype=torch.int8) for _ in range(2)), hc)


def random_tables(frames: int, seed: int, dev):
    """(F, 3, 64) int32 dequant multipliers from four random q-tables of the
    format's u16 range, frame by frame on random indices, U and V on
    different tables in every frame."""
    from pfv_torch.dataloader import frame_multipliers

    gen = torch.Generator(device=dev).manual_seed(seed)
    qt = torch.randint(1, 65536, (4, 64), generator=gen, device=dev, dtype=torch.int32)
    y, u, dv = (torch.randint(lo, 4, (frames,), generator=gen, device=dev)
                for lo in (0, 0, 1))
    return frame_multipliers(qt, torch.stack([y, u, (u + dv) % 4], 1))


def random_canvas(g, seed: int, dev, n: int = 0):
    """A random (chh, cw) u8 canvas, or n of them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, 256, ((n,) if n else ()) + (g.chh, g.cw), generator=gen,
                         device=dev, dtype=torch.uint8)


def unit_scan(args, g) -> tuple[int, int]:
    """(unit words K1's CTAs read, unit words of the tiles) for a clip: a
    CTA that needs the residual reads all of its tile's words."""
    _, coff, _, _, hc, ftype = args[:6]
    f = ftype.shape[0]
    words = ((coff[1:] - coff[:-1]).to(torch.int64) * args[0].shape[1]).view(f, g.gch)
    nlb = -(-g.gcw // 32)
    padded = torch.zeros((f, g.gch, nlb * 32), dtype=torch.bool, device=hc.device)
    padded[..., :g.gcw] = hc != 0
    ctas = torch.where((ftype == 1)[:, None, None], True,
                       padded.view(f, g.gch, nlb, 32).any(-1)).sum(-1)
    return int((words * ctas).sum()), int(words.sum())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def decoded_blocks(ftype, hc) -> int:
    """Blocks a frame step inverse-transforms: all of an I-frame's, the
    coded ones of a P-frame's. ftype (F,), hc (F, nb)."""
    intra = ftype == 1
    return int(torch.where(intra, hc.shape[1], hc.to(torch.int64).sum(1)).sum())


def step_bound(ftype, dx, hc, out, inputs, dense: bool = False, words: int = 0):
    """Bound of a frame step: its inputs read once (dense coefficients, not
    among `inputs`, only where a block is decoded: 512 B each), the
    canvases `out` written once; the operations of the code (IDCT_OPS per
    decoded coefficient, one more if dense, SHIFT_OPS and SELECT_OPS per
    P-frame block row, UNIT_OPS per unit word). ftype (F,), dx and hc
    (F, blocks) of the canvas."""
    n = decoded_blocks(ftype, hc)
    moved = nbytes(out, *inputs) + (512 * n if dense else 0)
    p = (ftype != 1)[:, None]
    shifted = int(((dx.to(torch.int32) % 4 != 0) & p).sum())
    coded = int(((hc != 0) & p).sum())
    ops = ((IDCT_OPS + dense) * 256 * n + 16 * (SHIFT_OPS * shifted + SELECT_OPS * coded)
           + UNIT_OPS * words)
    return bound(moved, ops)


def gop_steps(g, per_step, qmul, out):
    """Run K4 over the L steps of G GOPs into out (G, L, chh, cw), one
    `step_gops` call on [:, l:l+1] views per step, from zero canvases; hold
    each step against its plain version on the same inputs -> the largest
    absolute difference."""
    from pfv_torch.kernels.dense_step import step_frames_batched_plain, step_gops

    prev = torch.zeros_like(out[:, 0])
    err = 0
    for l in range(out.shape[1]):
        step_gops(*(t[:, l:l + 1] for t in per_step), qmul[:, l:l + 1], g.chh, g.cw,
                  g.gly, g.guw, prev=prev, out=out[:, l:l + 1])
        args = (prev, *(t[:, l] for t in per_step), qmul[:, l], g.chh, g.cw, g.gly, g.guw)
        err = max(err, max_abs_err(out[:, l], step_frames_batched_plain(*args)))
        prev = out[:, l]
    return err


def counts():
    from pfv_torch.kernels.dense_step import seq_frames_dense, step_gops
    from pfv_torch.kernels.fdct import FrameEncode, fdct_blocks
    from pfv_torch.kernels.frame_step import FrameStep
    from pfv_torch.kernels.idct import decode_blocks
    from pfv_torch.kernels.mc import mc_reconstruct
    from pfv_torch.kernels.motion import MotionSearch
    from pfv_torch.kernels.rgba import canvas_rgba
    from pfv_torch.kernels.step import step_frames

    return {"K1": step_frames, "K2": canvas_rgba, "K3": seq_frames_dense,
            "K4": step_gops, "K5": decode_blocks, "K6": FrameEncode,
            "K6 per plane": fdct_blocks, "K7": mc_reconstruct, "K8": MotionSearch,
            "FS": FrameStep}


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


def kernel_pair_inputs(fd, frame):
    """Per plane of a frame uploaded by FrameDecoder fd: the K5 inputs, and
    the K7 inputs without the blocks (motion zeros for an I-frame)."""
    from pfv_torch.device import origins_for
    from pfv_torch.frame import canvas_layout

    intra, qidx = frame
    qt = fd.qtables.to(fd.device)
    for (first, _, _, ph, pw), qi in zip(canvas_layout(fd.g), qidx):
        n = (ph // 16) * (pw // 16)
        sl = slice(first, first + n)
        if intra:
            mvy = mvx = torch.zeros(n, dtype=torch.int8, device=fd.device)
            hc = mvy.view(torch.uint8)
        else:
            mvy, mvx, hc = (t[sl] for t in fd.motion)
        yield ((fd.coeffs[sl].view(n, 4, 64), qt[qi]),
               (*origins_for(ph, pw, fd.device), mvy, mvx, hc))


def frame_step_vs_plain(step, coeffs, motion, qidx, prev) -> int:
    """The frame step on the card against its plain version on the same
    inputs, each into a canvas filled with 7 -> the largest absolute
    difference."""
    from pfv_torch.kernels.frame_step import frame_step_plain

    shape = step.extent if prev is None else prev.shape
    got, want = (torch.full(shape, 7, dtype=torch.uint8, device=coeffs.device)
                 for _ in range(2))
    step(coeffs, motion, qidx, prev, got)
    frame_step_plain(coeffs, motion, step.qtables, qidx, step.layout, prev, want)
    return max_abs_err(got, want)


def frame_step_bound(g, motion):
    """Bound of the frame step on one frame of geometry g: coefficients of
    decoded blocks (512 B each), the prediction windows of P-blocks and the
    planes' output (1 B per pixel each), the 3 B header of each P-block;
    IDCT_OPS + 1 per decoded coefficient, SHIFT_OPS and SELECT_OPS per
    P-block row. motion: (mvy, mvx, hc) or None (I-frame)."""
    px = 256 * g.nb
    if motion is None:
        n, windows, shifted, coded = g.nb, 0, 0, 0
    else:
        coded = int((motion[2] != 0).sum())
        shifted = int((motion[1].to(torch.int32) % 4 != 0).sum())
        n, windows = coded, px + 3 * g.nb
    return bound(512 * n + windows + px,
                 (IDCT_OPS + 1) * 256 * n + 16 * (SHIFT_OPS * shifted + SELECT_OPS * coded))


def frame_encode_bound(g, motion):
    """Bound of the frame-encode step on one frame of geometry g: the source
    planes read once (1 B per pixel), the coefficients written once (512 B
    per block, zeros included), for a P-frame the 3 B header of each block
    and the prediction window of each coded block (256 B); FDCT_OPS per
    coefficient of a transformed block (every block of an I-frame, the
    coded ones of a P-frame). motion: (mvy, mvx, hc) or None (I-frame)."""
    px = 256 * g.nb
    if motion is None:
        n, extra = g.nb, 0
    else:
        n = int((motion[2] != 0).sum())
        extra = 3 * g.nb + 256 * n
    return bound(px + 512 * g.nb + extra, FDCT_OPS * 256 * n)


def frame_encode_vs_plain(step, sources, motion, qidx, prev) -> int:
    """The frame-encode step on the card against its plain version on the
    same inputs, each into a buffer filled with 7 -> the largest absolute
    difference."""
    from pfv_torch.kernels.fdct import frame_encode_plain

    got, want = (torch.full((step.blocks, 256), 7, dtype=torch.int16,
                            device=sources[0].device) for _ in range(2))
    step(sources, motion, qidx, prev, got)
    frame_encode_plain(sources, motion, step.qtables, qidx, step.layout, prev, want)
    return max_abs_err(got, want)


def search_vs_plain(layout, sources, prev, min_err):
    """The motion search on the card against its plain version on the same
    inputs, each into header rows filled with 7 -> (the largest absolute
    difference over mvy, mvx and has_coeff, the kernel's rows)."""
    from pfv_torch.kernels.motion import MotionSearch, motion_search_plain

    search = MotionSearch(layout, min_err, prev.device)
    got, want = ([torch.full((search.blocks,), 7, dtype=d, device=prev.device)
                  for d in (torch.int8, torch.int8, torch.uint8)] for _ in range(2))
    before = MotionSearch.launches
    search(sources, prev, got)
    check(MotionSearch.launches - before == 1, "a motion search was not one launch")
    motion_search_plain(sources, prev, search.layout, min_err, want)
    return max(max_abs_err(a, b) for a, b in zip(got, want)), got


def least_candidates(layout) -> int:
    """The candidates whose error a motion search of these planes sums
    whatever the data, from the geometry alone: per block the first centre,
    then at each of the four steps the ring's candidates whose window lies in
    the plane while the centre stays at the block's origin (a step is at most
    16, so a neighbour is out only past the plane's first or last block of a
    row or column). A walk that moves away from an edge sums more, at most
    1 + 4 * 8 per block."""
    total = 0
    for p in layout:
        nby, nbx = p.h // 16, p.w // 16
        total += nby * nbx + 4 * ((3 * nbx - 2) * (3 * nby - 2) - nby * nbx)
    return total


def motion_search_bound(g, candidates: int):
    """Bound of the motion search on one frame of geometry g: the source
    planes and the previous planes read once (1 B per pixel each), the 3 B
    header of each block written; SEARCH_OPS per 16 pixels, 16 times, of
    each candidate summed."""
    return bound(2 * 256 * g.nb + 3 * g.nb, 16 * SEARCH_OPS * candidates)


def sass_per_16px(so_path: str, kernel: str = "motion_search_kernel"):
    """(instructions from the kernel's first IDP.4A to its last, IDP.4A
    count, those instructions per 16 pixels of a candidate: a block's 33
    candidates of 256 pixels are 16.5 runs of 16 pixels per lane) from
    cuobjdump -sass of the library; None where cuobjdump is missing or
    fails, or the kernel has no IDP.4A."""
    exe = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    try:
        out = subprocess.run([exe, "-sass", so_path], capture_output=True, text=True,
                             check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    for func in out.split("Function : ")[1:]:
        if kernel in func.split("\n", 1)[0]:
            ins = re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", func)
            idp = [i for i, op in enumerate(ins) if "IDP.4A" in op]
            if idp:
                n = idp[-1] - idp[0] + 1
                return n, len(idp), n / (33 * 256 / 32 / 16)
    return None


def kernel_registers(so_path: str, kernel: str = "motion_search_kernel"):
    """The registers per thread of the library's kernel from cuobjdump
    -res-usage; None where cuobjdump is missing or fails or the kernel is
    not found."""
    exe = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    try:
        out = subprocess.run([exe, "-res-usage", so_path], capture_output=True, text=True,
                             check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    m = re.search(r"Function [^\n]*" + kernel + r"[^\n]*\n\s*REG:(\d+)", out)
    return int(m.group(1)) if m else None


def first_pframe(name, srcs, dev):
    """(A FrameEncoder that has encoded frame 0 of a corpus's source, frame
    1's padded source planes on the card)."""
    from pfv_torch.device import FrameEncoder, upload_padded
    from pfv_torch.frame import geometry
    from pfv_torch.ops.pframe import skip_threshold
    from pfv_torch.ops.quant import derive_q_tables

    g = geometry(*SOURCES[name][:2])
    fe = FrameEncoder(g, derive_q_tables(QUALITY), skip_threshold(QUALITY), dev)
    src0, src1 = (upload_padded(g, [p[t] for p in srcs[name]], dev) for t in (0, 1))
    fe.iframe(src0, torch.empty((g.nb, 256), dtype=torch.int16, device=dev))
    return fe, src1


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
    from pfv_torch.device import INTER_Q, INTRA_Q, FrameEncoder, pad_planes
    from pfv_torch.enc import container_header
    from pfv_torch.frame import geometry
    from pfv_torch.ops.pframe import skip_threshold
    from pfv_torch.ops.quant import derive_q_tables

    ms = dict.fromkeys(("source H2D", "device pad", "K8 motion search", "K6",
                        "in-loop frame step", "compaction+D2H", "host mux"), 0.0)
    clock = [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        ms[name] += 1e3 * (now - clock[0])
        clock[0] = now

    f = planes[0].shape[0]
    g = geometry(w, h)
    qt_host = derive_q_tables(QUALITY)
    enc = FrameEncoder(g, qt_host, skip_threshold(QUALITY), dev)
    src = [torch.from_numpy(p).to(dev) for p in planes]
    lap("source H2D")
    src = pad_planes(g, src)
    lap("device pad")
    live = torch.empty((f, g.nb, 256), dtype=torch.int16, device=dev)
    mvx = torch.zeros((f, g.nb), dtype=torch.int8, device=dev)
    mvy = torch.zeros((f, g.nb), dtype=torch.int8, device=dev)
    hc = torch.ones((f, g.nb), dtype=torch.uint8, device=dev)
    enc.check([p[0] for p in src], live[0], (mvy[0], mvx[0], hc[0]))
    lap("compaction+D2H")
    for t in range(f):
        cur = [p[t] for p in src]
        motion = None if t % KEYFRAMES == 0 else (mvy[t], mvx[t], hc[t])
        if motion is not None:
            enc.search(cur, motion)
            lap("K8 motion search")
        enc.transform(cur, motion, live[t])
        lap("K6")
        enc.reconstruct(live[t], motion)
        lap("in-loop frame step")
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
                                                           g.nb, INTRA_Q)
        else:
            payload = runtime.encode_pframe_payload_sparse(
                idx[lo:hi], val[lo:hi], mvx[t], mvy[t], hc[t], INTER_Q)
        out += [struct.pack("<BI", 1 if t % KEYFRAMES == 0 else 2, len(payload)),
                payload]
    out.append(struct.pack("<BI", 0, 0))
    lap("host mux")
    return b"".join(out), ms


def ref_rgba_plain(g, planes, dev):
    """K2's plain version of the reference planes -> (F, H, W) packed RGBA."""
    from pfv_torch.kernels.rgba import canvas_rgba_plain

    return canvas_rgba_plain(ref_canvases(g, planes, dev), g.height, g.width, g.ly0, g.lcw)


def rgb_exact(g, rgb, planes, dev, step: int = 4) -> bool:
    """Whether (F, H, W, 3) u8 RGB on the card equals K2's plain version of
    the reference planes, `step` frames at a time."""
    from pfv_torch.dataloader import rgba_view

    ok = rgb.shape[0] == planes[0].shape[0]
    for f0 in range(0, rgb.shape[0], step):
        want = rgba_view(ref_rgba_plain(g, [r[f0:f0 + step] for r in planes], dev))
        ok = ok and torch.equal(rgb[f0:f0 + step], want[..., :3])
    return ok


class StageLog:
    """A timer for `VideoDataLoader(timer=...)` that keeps every stage's
    duration, ms, in the order the stages ended."""

    def __init__(self):
        self.ms = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.ms.setdefault(name, []).append(1e3 * (time.perf_counter() - t))


def drain(clips) -> int:
    """Iterate `clips` (RGB tensors on the card, or (start, RGB) pairs),
    dropping each as the next arrives; wait for the card -> frames seen."""
    frames = 0
    for clip in clips:
        frames += (clip[1] if isinstance(clip, tuple) else clip).shape[0]
        del clip
    torch.cuda.synchronize()
    return frames


def peak_bytes(fn) -> int:
    """torch.cuda.max_memory_allocated over one call of fn, less what was
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pfv_torch import dataloader as dl
    from pfv_torch import runtime, synth
    from pfv_torch.dec import Decoder, FrameDecoder, frame_packets, split_packets
    from pfv_torch.device import plane_step
    from pfv_torch.frame import canvas_layout, canvas_planes, initial_canvas
    from pfv_torch.kernels import build
    from pfv_torch.kernels.frame_step import frame_step_plain
    from pfv_torch.kernels.idct import decode_blocks, decode_blocks_plain
    from pfv_torch.kernels.mc import mc_reconstruct, mc_reconstruct_plain
    from pfv_torch.kernels.rgba import canvas_rgba, canvas_rgba_plain
    from pfv_torch.kernels.step import step_frames, step_frames_plain

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    RATES.update(card_rates())
    print(f"operation rates for the bounds: {RATES['sms']} SMs at {RATES['mhz']:.0f} MHz "
          f"(clocks.max.sm): integer {RATES['int'] / 1e12:.3f} T op/s (128 lanes per SM), "
          f"float32 {RATES['fp32'] / 1e12:.3f} T op/s (128 lanes, FMA = 2) ({card})")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(lambda: (runtime.get_lib(), time.perf_counter() - t0))
        log = build.build()
        nvcc_s = time.perf_counter() - t0
        rt_s = native.result()[1]
    build.lib()
    rt_path = runtime.so_path()
    check(rt_path.startswith(os.path.join(ROOT, "pfv_torch", "build") + os.sep),
          "the port's runtime library is not its own build")
    print(f"phase 1 build: nvcc {nvcc_s:.2f} s; the port's C++ runtime with g++ "
          f"beside it, {rt_s:.2f} s, {os.path.relpath(rt_path, ROOT)} ({card})")
    for line in log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())

    datas = {k: open(os.path.join(ROOT, p), "rb").read() for k, p in CORPORA.items()}
    refs = {k: runtime.ref_decode(d)[1:4] for k, d in datas.items()}
    # the streams the TPU kernels' contracts refuse (phases 2, 9, 10, 15): a
    # leading P-frame, q-table indices (0, 1, 3) (U != V) on the I-frame
    info, packets = split_packets(datas["1080p"])
    first_i = next(i for i, (t, _) in enumerate(packets) if t == 1)
    g = dl.geometry(info["width"], info["height"])
    coeffs, _ = runtime.decode_iframe_payload(packets[first_i][1], g.nb)
    requant = list(packets)
    requant[first_i] = (1, runtime.encode_iframe_payload(coeffs, (0, 1, 3)))
    refused = {
        "1080p_first_p": synth.container(g.width, g.height, info["qtables"],
                                         packets[first_i + 1:]),
        "1080p_q013": synth.container(g.width, g.height, info["qtables"], requant),
    }
    winfo, wpackets = split_packets(synth.random_stream(*FALLBACK_WIDE, seed=2,
                                                        keyframes=4))
    refused["4112x64_first_p"] = synth.container(*FALLBACK_WIDE[:2], winfo["qtables"],
                                                  wpackets[1:])
    refused_refs = {k: runtime.ref_decode(d)[1:4] for k, d in refused.items()}
    err_k1 = err_k2 = 0
    for name, data in datas.items():
        g, args = dl.upload(dl.demux_host(data), dev)
        canv = step_frames(*args, g.chh, g.cw, g.gly, g.guw)
        e1 = max_abs_err(canv, step_frames_plain(*args, g.chh, g.cw, g.gly, g.guw))
        geo = (g.height, g.width, g.ly0, g.lcw)
        e2 = max_abs_err(dl.rgba_view(canvas_rgba(canv, *geo)),
                         dl.rgba_view(canvas_rgba_plain(canv, *geo)))
        print(f"phase 2 kernels vs plain, {name} ({g.width}x{g.height}, "
              f"{args[5].shape[0]} frames, {args[0].shape[0]} unit chunks): "
              f"K1 max_abs_err {e1}, K2 max_abs_err {e2}")
        err_k1, err_k2 = max(err_k1, e1), max(err_k2, e2)
    for name in sorted(synth.EDGE_STREAMS):
        data = synth.edge_stream(name)
        route = dl.choose_route(data)
        if route.kind != "units":
            continue
        g, args = dl.upload(route.host, dev)
        dims = (g.chh, g.cw, g.gly, g.guw)
        canv = step_frames(*args, *dims)
        e1 = max_abs_err(canv, step_frames_plain(*args, *dims))
        exact = all((p.cpu().numpy() == r).all() for p, r in zip(
            dl.slice_yuv(g, canv), runtime.ref_decode(data)[1:4]))
        wild = (*args[:2], *random_vectors(args[2:5], 5), *args[5:])
        ew = max_abs_err(step_frames(*wild, *dims), step_frames_plain(*wild, *dims))
        coded = [int(h.sum()) for h, t in zip(args[4].flatten(1), args[5].tolist()) if t != 1]
        print(f"phase 2 K1 vs plain, edge stream {name} ({args[5].shape[0]} frames, coded "
              f"blocks per P-frame {coded} of {g.nb}): max_abs_err {e1}, pixel-exact vs "
              f"ref_decode: {exact}; with random vectors in [-64, 63]: max_abs_err {ew}")
        check(exact, f"K1 on the edge stream {name} differs from ref_decode")
        err_k1 = max(err_k1, e1, ew)
    # K1's per-frame tables and starting canvas: the 1080p streams without
    # their first I-packet and on q-table indices (0, 1, 3), with their own
    # tables from the reference framebuffer and with random tables (U != V in
    # every frame) from a random canvas
    for seed, name in enumerate(("1080p_first_p", "1080p_q013")):
        g, args = dl.upload(dl.demux_host(refused[name]), dev)
        dims = (g.chh, g.cw, g.gly, g.guw)
        errs = {}
        for label, q, start in (
                ("own tables, reference framebuffer", args[6], initial_canvas(g, dev)),
                ("random tables, random canvas", random_tables(args[5].shape[0], seed, dev),
                 random_canvas(g, seed, dev))):
            a = (*args[:6], q)
            errs[label] = max_abs_err(step_frames(*a, *dims, start),
                                      step_frames_plain(*a, *dims, start))
        print(f"phase 2 K1 vs plain, per-frame tables and a starting canvas, {name} "
              f"({args[5].shape[0]} frames, the first {'P' if args[5][0] == 2 else 'I'}): "
              "max_abs_err " + ", ".join(f"{k} {v}" for k, v in errs.items()))
        err_k1 = max(err_k1, *errs.values())
    canv = torch.randint(0, 256, (3, 160, 256), dtype=torch.uint8, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    edges = {k: max_abs_err(dl.rgba_view(canvas_rgba(canv, *geo)),
                            dl.rgba_view(canvas_rgba_plain(canv, *geo)))
             for k, geo in K2_EDGES.items()}
    print("phase 2 K2 vs plain on random canvases off its vector path, max_abs_err: "
          + ", ".join(f"{k} {K2_EDGES[k][1::-1]} {e}" for k, e in edges.items()))
    err_k2 = max(err_k2, *edges.values())
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
    check(launches["K3"] == launches["K4"] == launches["K5"] == launches["K7"]
          == launches["FS"] == 0, "the K1 path launched K3, K4, K5, K7 or the frame step")

    times, bounds = {}, {}
    for name in TIMED:
        host = dl.demux_host(datas[name])
        g, args = dl.upload(host, dev)
        dims = (g.chh, g.cw, g.gly, g.guw)
        times[("K1", name)] = paired_ms(lambda: step_frames(*args, *dims),
                                        lambda: step_frames_plain(*args, *dims))
        k1_dev = device_ms(lambda: step_frames(*args, *dims), "step_frame_kernel")
        read, words = unit_scan(args, g)
        print(f"phase 5 K1 per clip, {name}: kernel {times[('K1', name)][0]:.3f} ms (one "
              f"call), profiler device time {k1_dev:.3f} ms (each grid's wait for the "
              f"previous one included), plain {times[('K1', name)][1]:.3f} ms; "
              f"unit words read by its CTAs {read} against {words} in the tiles "
              f"({read / words:.2f}x) ({card})")
        if name == TIMED[0]:
            canv = step_frames(*args, *dims)
            geo = (g.height, g.width, g.ly0, g.lcw)
            times["K2"] = paired_ms(lambda: canvas_rgba(canv, *geo),
                                    lambda: canvas_rgba_plain(canv, *geo))
            k2_dev = device_ms(lambda: canvas_rgba(canv, *geo), "canvas_rgba_kernel")
            print(f"phase 5 K2 per clip, {name}: kernel {times['K2'][0]:.3f} ms, device "
                  f"time {k2_dev:.3f} ms, plain {times['K2'][1]:.3f} ms ({card})")
            bounds["K1"] = step_bound(args[5], args[3].flatten(1), args[4].flatten(1), canv,
                                      args[:7], words=int(args[1][-1]) * args[0].shape[1])
            px = canv.shape[0] * g.height * g.width
            bounds["K2"] = bound(nbytes(canv) + 4 * px, RGBA_OPS * px, "fp32")
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
    small = {"demux": lambda: dl.demux_host(datas["512x384"]),
             "decode_video_yuv": lambda: dl.decode_video_yuv(datas["512x384"], dev)}
    print(f"phase 6 per clip, 512x384, median of {REPS}, ms: " + ", ".join(
        f"{k} {median_host_ms(fn):.3f}" for k, fn in small.items()) + f" ({card})")

    # phase 7: the frame step, K5 and K7 against their plain versions,
    # Decoder inputs
    err_k5 = err_k7 = err_fs = 0
    for name in TIMED:
        info, _ = runtime.parse_header(datas[name])
        g = dl.geometry(info["width"], info["height"])
        fd = FrameDecoder(g, info["qtables"], dev)
        packets = frame_packets(datas[name])
        check(packets[0][0] == 1 and packets[1][0] == 2,
              f"{name} does not open with an I-frame and a P-frame")
        prev, cur = fd.initial_canvas(), torch.empty((g.chh, g.cw), dtype=torch.uint8,
                                                     device=dev)
        nq = fd.step.nq
        split = ((nq - 1) % nq, 0, 1 % nq)  # U and V apart where nq > 1
        ylay = canvas_layout(g)[0]
        for f in (0, 1):
            frame = fd.upload(fd.entropy(*packets[f]))
            intra, qidx = frame
            for (k5_in, k7_in), p in zip(kernel_pair_inputs(fd, frame),
                                         canvas_planes(g, prev)):
                res = decode_blocks(*k5_in)
                e5 = max_abs_err(res, decode_blocks_plain(*k5_in))
                e7 = max_abs_err(mc_reconstruct(res, p, *k7_in, intra),
                                 mc_reconstruct_plain(res, p, *k7_in, intra))
                err_k5, err_k7 = max(err_k5, e5), max(err_k7, e7)
            motion = None if intra else fd.motion
            wild = None if intra else (*random_vectors(fd.motion, 70 + f)[:2],
                                       fd.motion[2])
            ystep = plane_step(fd.qtables[qidx[0]], ylay[3], ylay[4], dev)
            yprev = canvas_planes(g, prev)[0].contiguous()
            yargs = (fd.coeffs[:g.yb], None if intra else tuple(t[:g.yb] for t in motion))
            errs = {
                "stream": frame_step_vs_plain(fd.step, fd.coeffs, motion, qidx, prev),
                "random vectors, q " + str(split): frame_step_vs_plain(
                    fd.step, fd.coeffs, wild, split, prev),
                "one plane (Y)": frame_step_vs_plain(ystep, *yargs, (0,), yprev),
            }
            err_fs = max(err_fs, *errs.values())
            fd.planes(frame, cur, prev)
            prev, cur = cur, prev
            print(f"phase 7 kernels vs plain, {name} frame {f} "
                  f"({'I' if intra else 'P'}, {g.nb} blocks, q indices {qidx}): frame "
                  f"step max_abs_err " + ", ".join(f"{k} {v}" for k, v in errs.items())
                  + f"; per plane K5 max_abs_err {err_k5}, K7 max_abs_err {err_k7}")
    check(err_fs == 0, "the frame step disagrees with its plain version")
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
    check(dec_launches["FS"] == stepped[0],
          "the frame step was not launched once per stepped frame")
    check(dec_launches["K5"] == dec_launches["K7"] == 0, "the Decoder launched K5 or K7")
    check(dec_launches["K1"] == bulk, "decode_all did not launch K1 once per frame")

    # phase 9: those streams through the whole-clip decode, on K1 or K3
    routes9 = {k: dl.choose_route(d) for k, d in refused.items()}
    zero_counts()
    want9 = {"K1": 0, "K3": 0}
    for name, data in refused.items():
        planes = dl.decode_video_yuv(data, device="cuda")
        rgba = dl.decode_video_rgba(data, device="cuda")
        torch.cuda.synchronize()
        exact = all((p.cpu().numpy() == r).all() for p, r in zip(planes, refused_refs[name]))
        gf = routes9[name].g
        want = canvas_rgba_plain(ref_canvases(gf, refused_refs[name], dev),
                                 gf.height, gf.width, gf.ly0, gf.lcw)
        exact_rgba = torch.equal(rgba.view(torch.int32), want.view(torch.int32))
        want9["K1" if routes9[name].kind == "units" else "K3"] += 2 * refused_refs[name][0].shape[0]
        print(f"phase 9 {name} (route '{routes9[name].kind}', leading P-frame "
              f"{routes9[name].leading_p}): {tuple(planes[0].shape)} decode_video_yuv "
              f"pixel-exact: {exact}, decode_video_rgba byte-exact: {exact_rgba}")
        check(exact and exact_rgba, f"{name} differs from ref_decode")
    fb_launches = read_counts()
    print(f"phase 9 launches in that run: {fb_launches} (expected K1 {want9['K1']}, K3 "
          f"{want9['K3']}: once per frame, two calls each; the frame step 0)")
    check([routes9[k].kind for k in refused] == ["units", "units", "dense"],
          "phase 9's streams did not take the routes of their geometry")
    check(fb_launches["K1"] == want9["K1"] and fb_launches["K3"] == want9["K3"],
          "phase 9 did not launch K1 or K3 once per frame")
    check(fb_launches["FS"] == fb_launches["K4"] == fb_launches["K5"] == fb_launches["K7"]
          == 0, "phase 9 launched the frame step, K4, K5 or K7")
    check(fb_launches["K2"] == len(refused), "K2 was not launched once per RGBA call")

    # phase 10: times
    info, _ = runtime.parse_header(datas["1080p"])
    g = dl.geometry(info["width"], info["height"])
    fd = FrameDecoder(g, info["qtables"], dev)
    packets = frame_packets(datas["1080p"])
    canv = torch.empty((2, g.chh, g.cw), dtype=torch.uint8, device=dev)
    fd.planes(fd.upload(fd.entropy(*packets[0])), canv[0], fd.initial_canvas())
    pframe = fd.upload(fd.entropy(*packets[1]))
    pin = list(kernel_pair_inputs(fd, pframe))
    blocks = [decode_blocks(*k5_in) for k5_in, _ in pin]
    refp, outp = canvas_planes(g, canv[0]), canvas_planes(g, canv[1])

    def fs_frame():
        fd.planes(pframe, canv[1], canv[0])

    def fs_plain():
        frame_step_plain(fd.coeffs, fd.motion, fd.qtables, pframe[1], fd.step.layout,
                         canv[0], canv[1])

    def k5_frame():
        return [decode_blocks(*a) for a, _ in pin]

    def k7_frame():
        return [mc_reconstruct(r, p, *a, False, o)
                for r, p, (_, a), o in zip(blocks, refp, pin, outp)]

    times["FS"] = paired_ms(fs_frame, fs_plain)
    bounds["FS"] = frame_step_bound(g, fd.motion)
    times["K5"] = paired_ms(k5_frame, lambda: [decode_blocks_plain(*a) for a, _ in pin])
    bounds["K5"] = bound(sum(nbytes(*a) + a[0].numel() for a, _ in pin),
                         IDCT_OPS * sum(a[0].numel() for a, _ in pin))
    bounds["K7"] = bound(sum(nbytes(r, p, *a) + o.numel() for r, p, (_, a), o
                             in zip(blocks, refp, pin, outp)),
                         MC_OPS * 256 * sum(int(a[4].sum()) for _, a in pin))
    times["K7"] = paired_ms(k7_frame, lambda: [
        mc_reconstruct_plain(r, p, *a, False, o)
        for r, p, (_, a), o in zip(blocks, refp, pin, outp)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        fs_frame()
    enqueue_us = 1e4 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        k5_frame(), k7_frame()
    enqueue57_us = 1e4 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    # a frame's call after an idle card holds the card's wake-up; 100 calls
    # back to back between one pair of events give the steady rate
    run_fs = timed_ms(lambda: [fs_frame() for _ in range(100)]) / 100
    run57 = timed_ms(lambda: [(k5_frame(), k7_frame()) for _ in range(100)]) / 100
    print(f"phase 10 per 1080p P-frame ({int(fd.motion[2].sum())} of {g.nb} blocks "
          f"coded), CUDA events around the wrapper calls, launch overhead included: "
          f"frame step (one call, one launch) {times['FS'][0]:.4f} ms, plain "
          f"{times['FS'][1]:.4f} ms; K5 (three calls) {times['K5'][0]:.4f} ms, plain "
          f"{times['K5'][1]:.4f} ms; K7 (three calls) {times['K7'][0]:.4f} ms, plain "
          f"{times['K7'][1]:.4f} ms; 100 frames back to back, per frame: frame step "
          f"{run_fs:.4f} ms, K5 + K7 {run57:.4f} ms; host time to enqueue, per frame "
          f"(100 frames): frame step {enqueue_us:.2f} us, K5 + K7 {enqueue57_us:.2f} us "
          f"({card})")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fs_frame(), k5_frame(), k7_frame()
        torch.cuda.synchronize()
    device_us = {k: sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
                        if kernel in e.key) / 10
                 for k, kernel in (("FS", "frame_step_kernel"), ("K5", "idct_blocks_kernel"),
                                   ("K7", "mc_kernel"))}
    fs_b = bounds["FS"]
    print("phase 10 per 1080p P-frame, device time of the kernels alone "
          "(torch.profiler, 10 frames): " + ", ".join(
              f"{k} {v:.2f} us" if v else f"{k} not measured (no device time seen)"
              for k, v in device_us.items())
          + f"; frame step bound {1e3 * fs_b[0]:.3f} us ({fs_b[1]}; bytes "
          f"{1e3 * fs_b[2]:.3f} us, operations {1e3 * fs_b[3]:.3f} us), share of the "
          f"device time " + (f"{1e3 * fs_b[0] / device_us['FS']:.3f}" if device_us["FS"]
                             else "not measured") + f" ({card})")

    def decoder_layers():
        """One pass of the Decoder's frame step over the clip, each layer
        synchronized, -> ms per layer."""
        t = dict.fromkeys(("host entropy decode", "pinned H2D", "frame step",
                           "D2H emit"), 0.0)
        prev, cur = fd.initial_canvas(), canv[1]
        for p in packets:
            t0 = time.perf_counter()
            frame = fd.entropy(*p)
            t1 = time.perf_counter()
            fd.upload(frame)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            fd.planes(frame, cur, prev)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            cur.to("cpu", copy=True)
            t4 = time.perf_counter()
            for k, dt in zip(t, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
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
    first_p = refused["1080p_first_p"]
    k1_ms, kp_ms, fb_ms = [], [], []
    dl.decode_video_yuv(datas["1080p"], dev), dl.decode_video_yuv(first_p, dev)
    dl.decode_frames(first_p, dev)
    for _ in range(REPS):
        k1_ms.append(host_ms(lambda: dl.decode_video_yuv(datas["1080p"], dev)))
        kp_ms.append(host_ms(lambda: dl.decode_video_yuv(first_p, dev)))
        fb_ms.append(host_ms(lambda: dl.decode_frames(first_p, dev)))
    print(f"phase 10 per 1080p clip, median of {REPS}: decode_video_yuv (K1) "
          f"{statistics.median(k1_ms):.3f} ms ({refs['1080p'][0].shape[0]} frames); "
          f"without its first I-packet ({refused_refs['1080p_first_p'][0].shape[0]} frames, "
          f"first frame P): decode_video_yuv (K1 from the starting canvas) "
          f"{statistics.median(kp_ms):.3f} ms, per-frame path (decode_frames) "
          f"{statistics.median(fb_ms):.3f} ms ({card})")

    # phase 11: the sources, then K6 against its plain version
    from pfv_torch import encode_video
    from pfv_torch.device import (INTER_Q, INTRA_Q, FrameEncoder, iframe_encode_plane,
                                  origins_for, padded_shapes, upload_padded)
    from pfv_torch.kernels.frame_step import plane_layout
    from pfv_torch.kernels.motion import MotionSearch, motion_search_plain
    from pfv_torch.kernels.fdct import fdct_blocks, fdct_blocks_plain, frame_encode_plain
    from pfv_torch.ops.blocks import plane_to_blocks
    from pfv_torch.ops.motion import motion_search
    from pfv_torch.ops.pframe import skip_threshold
    from pfv_torch.ops.quant import derive_q_tables

    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        srcs = synth_sources(pool)
    print(f"phase 11 sources rebuilt with pfv_torch.synth: " + ", ".join(
        f"{k} {tuple(v[0].shape)}" for k, v in srcs.items())
        + f" in {time.perf_counter() - t0:.1f} s ({card})")
    g = dl.geometry(1920, 1080)
    shapes = padded_shapes(g)
    src0, src1 = (upload_padded(g, [p[t] for p in srcs["1080p"]], dev) for t in (0, 1))
    fe = FrameEncoder(g, derive_q_tables(QUALITY), skip_threshold(QUALITY), dev)
    k6_co = torch.empty((g.nb, 256), dtype=torch.int16, device=dev)
    headers = torch.zeros((3, g.nb), dtype=torch.int8, device=dev)
    k6_motion = (headers[0], headers[1], headers[2].view(torch.uint8))
    fe.check(src0, k6_co, k6_motion)
    err_k6 = {"frame 0, intra": frame_encode_vs_plain(fe.encode, src0, None, INTRA_Q, None)}
    fe.iframe(src0, k6_co)
    k6_prev = fe.prev  # frame 0 as a decoder shows it
    fe.search(src1, k6_motion)
    err_k6["frame 1, P, the search's vectors and flags"] = frame_encode_vs_plain(
        fe.encode, src1, k6_motion, INTER_Q, k6_prev)
    gen = torch.Generator(device=dev).manual_seed(11)
    wild = (*random_vectors(k6_motion, 110)[:2],
            torch.randint(0, 2, (g.nb,), generator=gen, device=dev, dtype=torch.uint8))
    err_k6["frame 1, P, random vectors in [-64, 63], random flags, q (3, 0, 1)"] = \
        frame_encode_vs_plain(fe.encode, src1, wild, (3, 0, 1), k6_prev)
    print(f"phase 11 K6 (frame-encode step) vs plain, 1080p ({g.nb} blocks, "
          f"{int(k6_motion[2].sum())} coded by the search, {int(wild[2].sum())} by the "
          "random flags), max_abs_err: " + ", ".join(f"{k}: {e}" for k, e in err_k6.items()))
    qt = {k: torch.from_numpy(v).to(dev) for k, v in derive_q_tables(QUALITY).items()}
    k6_in = {"intra": [], "delta": []}
    for i, shape in enumerate(shapes):
        by, bx = origins_for(*shape, dev)
        qi, qp = qt["intra_l" if i == 0 else "intra_c"], qt["inter_l" if i == 0 else "inter_c"]
        _, recon = iframe_encode_plane(src0[i], qi, by, bx)
        b1 = plane_to_blocks(src1[i])
        k6_in["intra"].append((plane_to_blocks(src0[i]), qi))
        k6_in["delta"].append((b1, qp, motion_search(b1, recon, by, bx)[3]))
    for entry, args in k6_in.items():
        e = max(max_abs_err(fdct_blocks(*a), fdct_blocks_plain(*a)) for a in args)
        print(f"phase 11 K6's per-plane entry fdct_blocks vs plain, 1080p frame "
              f"{0 if entry == 'intra' else 1} ({entry} entry, Y/U/V "
              f"{[a[0].shape[0] for a in args]} blocks): max_abs_err {e}")
        err_k6[entry] = e
    err_k6 = max(err_k6.values())
    check(err_k6 == 0, "K6 disagrees with its plain version")
    del k6_in

    # K8 against its plain version: name -> (layout, sources, previous canvas)
    k8_in = {"1080p frame 1": (fe.motion.layout, src1, k6_prev)}
    for name in ("1080p_pan", "512x384"):
        fe_n, s1 = first_pframe(name, srcs, dev)
        k8_in[f"{name} frame 1"] = (fe_n.motion.layout, s1, fe_n.prev)
    gen = torch.Generator(device=dev).manual_seed(8)

    def noise(shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)

    noisy = noise((g.chh, g.cw))
    k8_in["1080p random noise"] = (fe.motion.layout, [noise(sh) for sh in shapes], noisy)
    k8_in["1080p flat"] = (fe.motion.layout, [torch.full(sh, v, dtype=torch.uint8, device=dev)
                                               for sh, v in zip(shapes, (90, 100, 110))],
                           torch.full((g.chh, g.cw), 93, dtype=torch.uint8, device=dev))
    k8_in["1080p equal to prev"] = (fe.motion.layout, canvas_planes(g, noisy), noisy)
    for h, w in ((16, 16), (16, 64), (64, 16)):
        k8_in[f"one plane {w}x{h}"] = (plane_layout(h, w), [noise((h, w))], noise((h, w)))
    g18 = dl.geometry(18, 10)
    k8_in["18x10"] = (canvas_layout(g18), [noise(sh) for sh in padded_shapes(g18)],
                      noise((g18.chh, g18.cw)))

    def on_card(planes):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in planes]

    # the stress inputs (pfv_torch.synth.search_stress): every vector, ties in
    # the ring, the largest error, walks against every edge of U and V
    for kind in synth.SEARCH_STRESS:
        sources, prev = synth.search_stress_canvas(kind, 1920, 1080, seed=12)
        k8_in[f"1080p {kind}"] = (fe.motion.layout, on_card(sources), on_card([prev])[0])
    for h, w in ((16, 1920), (1088, 16)):
        src, prev = synth.search_stress("shifts", h, w, seed=12)
        src, prev = on_card([src, prev])
        k8_in[f"one plane {w}x{h} shifts"] = (plane_layout(h, w), [src], prev)
    largest = 16 * 16 * 255 ** 2
    err_k8 = 0
    for name, (layout, sources, prev) in k8_in.items():
        thresholds = (0.0, 57600.0)  # qualities 0 and 10
        if "largest" in name:  # just below and at every block's error
            thresholds += (largest - 1.0, float(largest))
        for min_err in thresholds:
            e, (mvy, mvx, hc) = search_vs_plain(layout, sources, prev, min_err)
            still = not bool(mvy.any()) and not bool(mvx.any())
            vectors = len(set(zip(mvy.tolist(), mvx.tolist())))
            print(f"phase 11 K8 (motion search) vs plain, {name}, min_err {min_err:.0f} "
                  f"({mvy.shape[0]} blocks, {int(hc.sum())} coded, "
                  f"{int(((mvy != 0) | (mvx != 0)).sum())} moved, {vectors} vectors): "
                  f"max_abs_err {e}")
            if "flat" in name or "equal" in name or name == "one plane 16x16":
                check(still, f"K8 on {name}: a vector is not 0 where every candidate ties")
            if name == "1080p shifts":
                check(vectors == 31 * 31, "K8 on 1080p shifts: not every vector was found")
            if "largest" in name:
                check(still and bool((hc == (min_err < largest)).all()),
                      f"K8 on {name}, min_err {min_err:.0f}: has_coeff is off")
            err_k8 = max(err_k8, e)
    check(err_k8 == 0, "K8 disagrees with its plain version")
    k8_in = {k.split()[0]: v for k, v in k8_in.items() if k.endswith("frame 1")}

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
    check(enc_launches["K6"] == enc_launches["FS"] == enc_frames,
          "K6 and the frame step were not launched once per encoded frame")
    enc_pframes = sum(v[2] - len(range(0, v[2], KEYFRAMES)) for v in SOURCES.values())
    check(enc_launches["K8"] == enc_pframes,
          f"K8 was not launched once per P-frame ({enc_pframes})")
    check(enc_launches["K1"] == enc_launches["K2"] == enc_launches["K5"]
          == enc_launches["K7"] == enc_launches["K6 per plane"] == 0,
          "the encoder launched K1, K2, K5, K7 or K6's per-plane entry")

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
    check(st_launches["K6"] == st_launches["FS"] == n + KEYFRAMES,
          "the Encoder did not launch K6 and the frame step once per frame")
    check(st_launches["K8"] == n - len(range(0, n, KEYFRAMES)) + KEYFRAMES - 1,
          "the Encoder did not launch K8 once per P-frame")
    check(st_launches["K1"] == st_launches["K2"] == st_launches["K5"]
          == st_launches["K7"] == st_launches["K6 per plane"] == 0,
          "the Encoder launched K1, K2, K5, K7 or K6's per-plane entry")

    # phase 14: times
    k6_calls = {"I": (src0, None, INTRA_Q, None), "P": (src1, k6_motion, INTER_Q, k6_prev)}
    times["K6"], bounds["K6"], k6_run, k6_us = {}, {}, {}, {}
    for kind, args in k6_calls.items():
        def k6_frame():
            fe.encode.launch(*args, k6_co)

        def k6_plain():
            frame_encode_plain(args[0], args[1], fe.encode.qtables, args[2],
                               fe.encode.layout, args[3], k6_co)

        times["K6"][kind] = paired_ms(k6_frame, k6_plain)
        bounds["K6"][kind] = frame_encode_bound(g, args[1])
        k6_run[kind] = timed_ms(lambda: [k6_frame() for _ in range(100)]) / 100
        k6_us[kind] = 1e3 * device_ms(k6_frame, "frame_encode_kernel", reps=10)
    print("phase 14 K6 per 1080p frame (Y, U and V in one call): " + "; ".join(
        f"{kind}-frame ({g.nb if kind == 'I' else int(k6_motion[2].sum())} of {g.nb} "
        f"blocks coded): one wrapped call {times['K6'][kind][0]:.4f} ms, 100 back to "
        f"back {k6_run[kind]:.4f} ms per frame, plain {times['K6'][kind][1]:.4f} ms, "
        f"device time "
        + (f"{k6_us[kind]:.2f} us" if k6_us[kind] else "not measured (no device time seen)")
        + f", bound {1e3 * bounds['K6'][kind][0]:.3f} us ({bounds['K6'][kind][1]})"
        for kind in k6_calls) + f" ({card})")
    times["K8"], bounds["K8"] = {}, {}
    l2_fill = torch.empty(256 << 20, dtype=torch.uint8, device=dev)  # 5x the 50 MiB L2
    for name in TIMED:
        layout, sources, prev = k8_in[name]
        search = MotionSearch(layout, skip_threshold(QUALITY), dev)
        k8_rows = [torch.empty_like(t) for t in k6_motion]
        search.check(sources, prev, k8_rows)

        def k8_frame():
            search.launch(sources, prev, k8_rows)

        def k8_plain():
            motion_search_plain(sources, prev, layout, search.min_err, k8_rows)

        times["K8"][name] = paired_ms(k8_frame, k8_plain)
        cands = least_candidates(layout)
        bounds["K8"][name] = motion_search_bound(g, cands)
        k8_run = timed_ms(lambda: [k8_frame() for _ in range(100)]) / 100

        def k8_after_fill():  # the L2 holds none of the search's inputs
            l2_fill.zero_()
            k8_frame()

        def k8_after_idle():  # the card idle for 2 ms, the L2 kept
            torch.cuda.synchronize()
            time.sleep(0.002)
            k8_frame()

        k8_us = [launch_us(fn, "motion_search_kernel")
                 for fn in (k8_frame, k8_after_fill, k8_after_idle)]
        print(f"phase 14 K8 per 1080p P-frame, {name} frame 1 (Y, U and V in one call, "
              f"{g.nb} blocks, at least {cands} candidates summed, {int(k8_rows[2].sum())} blocks "
              f"coded): one wrapped call {times['K8'][name][0]:.4f} ms, 100 back to back "
              f"{k8_run:.4f} ms per frame, plain {times['K8'][name][1]:.4f} ms, device time "
              + f"{k8_us[0]} (after a 256 MiB fill that evicts the L2 {k8_us[1]}, after 2 "
              f"ms of an idle card {k8_us[2]})"
              + f", bound {1e3 * bounds['K8'][name][0]:.3f} us ({bounds['K8'][name][1]}; "
              f"bytes {1e3 * bounds['K8'][name][2]:.3f}, operations "
              f"{1e3 * bounds['K8'][name][3]:.3f}) ({card})")
    del l2_fill
    sass, regs = sass_per_16px(build.SO_PATH), kernel_registers(build.SO_PATH)
    print("phase 14 K8 SASS (cuobjdump -sass of the built library): " + (
        f"{sass[0]} instructions from the first IDP.4A to the last, {sass[1]} IDP.4A: "
        f"{sass[2]:.2f} instructions per 16 pixels of a candidate (SEARCH_OPS "
        f"{SEARCH_OPS})" if sass else "not measured (cuobjdump failed)")
        + f"; {regs if regs else 'not read'} registers per thread (cuobjdump -res-usage)")
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
    k8_ev = [ev for ev in on_card if "motion_search_kernel" in ev.key]
    print("phase 14 K8 inside that encode_video: " + (
        f"{sum(ev.count for ev in k8_ev)} launches, "
        f"{sum(ev.self_device_time_total for ev in k8_ev) / 1e3:.3f} ms, "
        f"{sum(ev.self_device_time_total for ev in k8_ev) / sum(ev.count for ev in k8_ev):.2f}"
        f" us per launch" if k8_ev else "not seen by the profiler") + f" ({card})")

    # phase 15: K3 and K4 against their plain versions, dense-route inputs
    from pfv_torch.kernels.dense_step import (seq_frames_dense, seq_frames_dense_plain,
                                              step_gops, step_gops_plain)

    def k3_inputs(host):
        g, (coeffs, mvx, mvy, hc, ftype, qmul) = dl.upload_packed(host, device=dev)
        return g, (coeffs, *dl.block_maps(g, mvx, mvy, hc), ftype, qmul, g.chh, g.cw,
                   g.gly, g.guw)

    hosts = {k: dl.demux_host_packed(d) for k, d in datas.items()}
    err_k3 = err_k4 = 0
    for name, host in hosts.items():
        g, args = k3_inputs(host)
        e3 = max_abs_err(seq_frames_dense(*args), seq_frames_dense_plain(*args))
        del args
        _, f, per_step, qmul = dl.upload_gops(host, *GOPS[name], dev)
        out = torch.empty((*GOPS[name], g.chh, g.cw), dtype=torch.uint8, device=dev)
        e4 = gop_steps(g, per_step, qmul, out)
        dims = (g.chh, g.cw, g.gly, g.guw)
        whole = step_gops(*per_step, qmul, *dims)
        e4 = max(e4, max_abs_err(whole, out), max_abs_err(whole, step_gops_plain(
            *per_step, qmul, *dims)))
        exact = all((p.cpu().numpy() == r).all() for p, r in zip(
            dl.slice_yuv(g, out.view(-1, g.chh, g.cw)[:f]), refs[name]))
        print(f"phase 15 kernels vs plain, {name} ({f} frames, dense coefficients "
              f"{tuple(per_step[0].shape[2:])} i16 per frame): K3 max_abs_err {e3}; K4 "
              f"max_abs_err {e4} in GOP form {GOPS[name]} ({np.prod(GOPS[name]) - f} pad "
              f"frames; step by step and whole), its frames pixel-exact vs ref_decode: "
              f"{exact}")
        check(exact, f"K4's GOP decode of {name} differs from ref_decode")
        err_k3, err_k4 = max(err_k3, e3), max(err_k4, e4)
        del per_step, out, whole
    name = "4112x16"
    data = synth.edge_stream(name)
    route = dl.choose_route(data)
    check(route.kind == "gops", f"the edge stream {name} did not take the GOP route")
    g, args = k3_inputs(route.host)
    canv = seq_frames_dense(*args)
    e3 = max_abs_err(canv, seq_frames_dense_plain(*args))
    wild = (args[0], *random_vectors(args[1:4], 6), *args[4:])
    e3w = max_abs_err(seq_frames_dense(*wild), seq_frames_dense_plain(*wild))
    _, f, per_step, qmul = dl.upload_gops(route.host, *route.gops, dev)
    out = torch.empty((*route.gops, g.chh, g.cw), dtype=torch.uint8, device=dev)
    e4 = gop_steps(g, per_step, qmul, out)
    dims = (g.chh, g.cw, g.gly, g.guw)
    e4 = max(e4, max_abs_err(step_gops(*per_step, qmul, *dims), out))
    prev = torch.randint(0, 256, (route.gops[0], g.chh, g.cw), dtype=torch.uint8,
                         device=dev)
    wild = (per_step[0], *random_vectors(per_step[1:4], 7), per_step[4], qmul, *dims)
    e4w = max_abs_err(step_gops(*wild, prev=prev), step_gops_plain(*wild, prev=prev))
    ref = runtime.ref_decode(data)[1:4]
    exact = all((p.cpu().numpy() == r).all() for c in (canv, out.view(-1, g.chh, g.cw)[:f])
                for p, r in zip(dl.slice_yuv(g, c), ref))
    print(f"phase 15 kernels vs plain, edge stream {name} ({f} frames, GOPs "
          f"{route.gops}): K3 max_abs_err {e3}, K4 max_abs_err {e4} (strided views, "
          f"step by step and whole), both pixel-exact vs ref_decode: {exact}; with "
          f"random vectors in [-64, 63]: K3 max_abs_err {e3w}, K4 {e4w}")
    check(exact, f"K3 or K4 on the edge stream {name} differs from ref_decode")
    err_k3, err_k4 = max(err_k3, e3, e3w), max(err_k4, e4, e4w)
    # K4 with random per-frame tables (U != V) from random canvases
    rq = random_tables(int(np.prod(route.gops)), 8, dev).view(*route.gops, 3, 64)
    prev = random_canvas(g, 8, dev, route.gops[0])
    e4t = max_abs_err(step_gops(*per_step, rq, *dims, prev=prev),
                      step_gops_plain(*per_step, rq, *dims, prev=prev))
    del per_step, out, canv, args, wild
    # K3 with per-frame tables and a starting canvas: phase 9's 4112x64 stream
    # without its I-packet, its own tables from the reference framebuffer
    # (then exact vs ref_decode), random tables from a random canvas
    name = "4112x64_first_p"
    g, args = k3_inputs(dl.demux_host_packed(refused[name]))
    start = initial_canvas(g, dev)
    canv = seq_frames_dense(*args, prev=start)
    e3t = {"own tables, reference framebuffer": max_abs_err(
        canv, seq_frames_dense_plain(*args, prev=start))}
    exact = all((p.cpu().numpy() == r).all()
                for p, r in zip(dl.slice_yuv(g, canv), refused_refs[name]))
    rand = (*args[:5], random_tables(args[4].shape[0], 9, dev), *args[6:])
    start = random_canvas(g, 9, dev)
    e3t["random tables, random canvas"] = max_abs_err(
        seq_frames_dense(*rand, prev=start), seq_frames_dense_plain(*rand, prev=start))
    print(f"phase 15 per-frame tables and a starting canvas: K3 on {name} "
          f"({args[4].shape[0]} frames, the first P) max_abs_err "
          + ", ".join(f"{k} {v}" for k, v in e3t.items())
          + f", pixel-exact vs ref_decode: {exact}; K4 on the edge stream's GOPs, random "
          f"tables from random canvases, max_abs_err {e4t}")
    check(exact, f"K3 from the starting canvas differs from ref_decode on {name}")
    err_k3, err_k4 = max(err_k3, *e3t.values()), max(err_k4, e4t)
    del args, rand, canv
    check(err_k3 == 0 and err_k4 == 0, "K3 or K4 disagrees with its plain version")

    # phase 16: the dense routes, the third main path
    t0 = time.perf_counter()
    uhd = synth.random_stream(*UHD[:3], seed=3, keyframes=UHD[3])
    dense_streams = {"8K UHD": uhd,
                     "4112x64": synth.random_stream(*FALLBACK_WIDE, seed=2, keyframes=4)}
    d_refs = {k: runtime.ref_decode(d)[1:4] for k, d in dense_streams.items()}
    routes = {k: dl.choose_route(d) for k, d in dense_streams.items()}
    print(f"phase 16 streams built with the port's runtime and decoded by ref_decode in "
          f"{time.perf_counter() - t0:.1f} s: " + ", ".join(
              f"{k} {len(d)} bytes, {d_refs[k][0].shape[0]} frames, route "
              f"'{routes[k].kind}' {routes[k].gops or ''}" for k, d in dense_streams.items())
          + f" ({card})")
    check(routes["8K UHD"].kind == "dense" and routes["4112x64"].kind == "gops",
          "the wide streams did not take the dense routes")
    zero_counts()
    dense_out = {k: (dl.decode_video_yuv(d, device="cuda"),
                     dl.decode_video_rgba(d, device="cuda"))
                 for k, d in dense_streams.items()}
    gop_out = {k: dl.decode_packed_gops(h, *GOPS[k], "yuv", device="cuda")
               for k, h in hosts.items()}
    gop_rgba = dl.decode_packed_gops(hosts["512x384"], *GOPS["512x384"], "rgba",
                                     device="cuda")
    dense_launches = read_counts()
    for name, (planes, rgba) in dense_out.items():
        exact = all((p.cpu().numpy() == r).all() for p, r in zip(planes, d_refs[name]))
        gd = routes[name].g
        exact_rgba = True
        for f0 in range(0, rgba.shape[0], 4):  # the plain RGBA of 8K frames, 4 at a time
            want = canvas_rgba_plain(ref_canvases(gd, [r[f0:f0 + 4] for r in d_refs[name]],
                                                  dev), gd.height, gd.width, gd.ly0, gd.lcw)
            exact_rgba &= torch.equal(rgba[f0:f0 + 4].view(torch.int32), want.view(torch.int32))
        print(f"phase 16 dense route '{routes[name].kind}' {name}: {tuple(planes[0].shape)} "
              f"decode_video_yuv pixel-exact vs ref_decode: {exact}, decode_video_rgba "
              f"byte-exact: {exact_rgba}")
        check(exact and exact_rgba, f"the dense route differs from ref_decode on {name}")
    for name, planes in gop_out.items():
        exact = all((p.cpu().numpy() == r).all() for p, r in zip(planes, refs[name]))
        print(f"phase 16 decode_packed_gops {name} {GOPS[name]}: {tuple(planes[0].shape)} "
              f"pixel-exact vs ref_decode: {exact}")
        check(exact, f"decode_packed_gops {name} differs from ref_decode")
    g = dl.geometry(512, 384)
    want = canvas_rgba_plain(ref_canvases(g, refs["512x384"], dev), g.height, g.width,
                             g.ly0, g.lcw)
    exact = torch.equal(gop_rgba.view(torch.int32), want.view(torch.int32))
    print(f"phase 16 decode_packed_gops 512x384 rgba: byte-exact vs plain K2 of "
          f"ref_decode planes: {exact}")
    check(exact, "decode_packed_gops rgba differs")
    k4_want = (2 * routes["4112x64"].gops[1] + sum(GOPS[k][1] for k in hosts)
               + GOPS["512x384"][1])
    k3_want = 2 * d_refs["8K UHD"][0].shape[0]
    print(f"phase 16 launches in the dense-route run: {dense_launches} (K3 expected "
          f"{k3_want}: once per 8K frame, two calls; K4 expected {k4_want}: L per clip)")
    check(dense_launches["K3"] == k3_want, "K3 was not launched once per 8K frame")
    check(dense_launches["K4"] == k4_want, "K4 was not launched L times per GOP clip")
    check(dense_launches["K1"] == dense_launches["K5"] == dense_launches["K7"] == 0,
          "the dense routes launched K1, K5 or K7")
    check(dense_launches["K2"] == 3, "K2 was not launched once per RGBA call")
    del dense_out, gop_out, gop_rgba

    # phase 17: times of K3 and K4 per clip, the 8K layers, the refused
    host8 = dl.demux_host_packed(uhd)
    k3_in = {}
    for name, host in (("1080p", hosts["1080p"]), ("8K UHD", host8)):
        g, args = k3_inputs(host)
        times[("K3", name)] = paired_ms(lambda: seq_frames_dense(*args),
                                        lambda: seq_frames_dense_plain(*args))
        canv = seq_frames_dense(*args)
        err_k3 = max(err_k3, max_abs_err(canv, seq_frames_dense_plain(*args)))
        bounds[("K3", name)] = step_bound(args[4], args[2].flatten(1), args[3].flatten(1),
                                          canv, args[1:6], dense=True)
        dev_ms = device_ms(lambda: seq_frames_dense(*args), "dense_step_kernel")
        print(f"phase 17 K3 per clip, {name} ({args[4].shape[0]} frames): kernel "
              f"{times[('K3', name)][0]:.3f} ms (one call), profiler device time "
              f"{dev_ms:.3f} ms (waits included), plain {times[('K3', name)][1]:.3f} ms, "
              f"bound {bounds[('K3', name)][0]:.4f} ms ({bounds[('K3', name)][1]}) ({card})")
        k3_in[name] = (g, args, canv)
    check(err_k3 == 0, "K3 disagrees with its plain version at 8K")
    for name in ("512x384", "1080p"):
        g, f, per_step, qmul = dl.upload_gops(hosts[name], *GOPS[name], dev)
        out = torch.empty((*GOPS[name], g.chh, g.cw), dtype=torch.uint8, device=dev)
        dims = (g.chh, g.cw, g.gly, g.guw)
        times[("K4", name)] = paired_ms(
            lambda: step_gops(*per_step, qmul, *dims, out=out),
            lambda: step_gops_plain(*per_step, qmul, *dims, out=out))
        n = int(np.prod(GOPS[name]))
        bounds[("K4", name)] = step_bound(
            per_step[4].reshape(n), per_step[2].reshape(n, -1), per_step[3].reshape(n, -1),
            out, (*per_step[1:], qmul, out[:, 0]), dense=True)
        dev_ms = device_ms(lambda: step_gops(*per_step, qmul, *dims, out=out),
                           "dense_step_kernel")
        print(f"phase 17 K4 per clip, {name} (GOP form {GOPS[name]}, one call, "
              f"{GOPS[name][1]} launches): kernel {times[('K4', name)][0]:.3f} ms, profiler "
              f"device time {dev_ms:.3f} ms (waits included), plain "
              f"{times[('K4', name)][1]:.3f} ms, bound {bounds[('K4', name)][0]:.4f} ms "
              f"({bounds[('K4', name)][1]}) ({card})")
        del per_step, out
    info8, g8, deltas8, vals8, meta8 = host8
    d8, v8 = (torch.from_numpy(a).to(dev) for a in (deltas8.view(np.int16), vals8))
    f8 = d_refs["8K UHD"][0].shape[0]
    _, args8, canv8 = k3_in["8K UHD"]
    geo8 = (g8.height, g8.width, g8.ly0, g8.lcw)
    layers = {
        "host demux": lambda: dl.demux_host_packed(uhd),
        "H2D deltas+vals": lambda: [torch.from_numpy(a).to(dev)
                                    for a in (deltas8.view(np.int16), vals8)],
        "tables": lambda: dl.block_maps(g8, *dl.upload_meta(info8, g8, meta8, dev)[:3]),
        "densify": lambda: dl.densify_pstep(d8, v8, f8, dl.pstep_tables(g8)[2]),
        "K3": lambda: seq_frames_dense(*args8),
        "K2": lambda: canvas_rgba(canv8, *geo8),
        "decode_video_yuv": lambda: dl.decode_video_yuv(uhd, dev),
        "decode_video_rgba": lambda: dl.decode_video_rgba(uhd, dev),
        "per-frame fallback (decode_frames)": lambda: dl.decode_frames(uhd, dev),
    }
    for fn in layers.values():
        fn()
    lt = {k: statistics.median(host_ms(fn) for _ in range(ENC_REPS))
          for k, fn in layers.items()}
    print(f"phase 17 8K UHD decode per clip ({f8} frames, {len(deltas8)} units, "
          f"{deltas8.nbytes + vals8.nbytes + meta8.nbytes} bytes uploaded, dense "
          f"coefficients {nbytes(args8[0])} bytes), layers each synchronized, median of "
          f"{ENC_REPS}, ms: " + ", ".join(f"{k} {v:.3f}" for k, v in lt.items())
          + f" ({card})")
    del k3_in, args8, canv8, d8, v8


    # phase 18: the loader, demux and upload of clip i+1 beside the kernels
    # of clip i
    from pfv_torch import VideoDataLoader

    order = ["1080p", "512x384", "1080p_pan"] * 2
    clips = [datas[k] for k in order]
    whole = {k: dl.decode_video_rgb(d, device="cuda") for k, d in datas.items()}
    zero_counts()
    loaded = list(VideoDataLoader(clips, device="cuda"))
    ld_launches = read_counts()
    exact = len(loaded) == len(clips) and all(
        torch.equal(got, whole[k]) for got, k in zip(loaded, order))
    ld_frames = sum(refs[k][0].shape[0] for k in order)
    print(f"phase 18 VideoDataLoader over {len(clips)} clips ({', '.join(order)}; "
          f"{ld_frames} frames): every clip equal to decode_video_rgb of its bytes: {exact}; "
          f"launches {ld_launches}")
    check(exact, "a clip of the loader differs from decode_video_rgb")
    check(ld_launches["K1"] == ld_frames, "the loader did not launch K1 once per frame")
    check(ld_launches["K2"] == len(clips), "the loader did not launch K2 once per clip")
    check(all(v == 0 for k, v in ld_launches.items() if k not in ("K1", "K2")),
          "the loader launched a kernel of another route")
    del loaded, whole
    ld_ms, loop_ms, logs = [], [], []
    for _ in range(ENC_REPS):
        logs.append(StageLog())
        ld_ms.append(host_ms(lambda: drain(VideoDataLoader(clips, device="cuda",
                                                           timer=logs[-1]))))
        loop_ms.append(host_ms(lambda: drain(dl.decode_video_rgb(d, device="cuda")
                                             for d in clips)))
    ld, lp = statistics.median(ld_ms), statistics.median(loop_ms)
    # per stage, over the clips of all passes (the wait for the end of the
    # list, the last of each pass, left out)
    per_clip = {k: [v for log in logs for v in log.ms[k][:len(clips)]] for k in logs[0].ms}
    print(f"phase 18 rates over the {len(clips)} clips, median of {ENC_REPS}: loader "
          f"{ld:.3f} ms ({', '.join(f'{v:.3f}' for v in ld_ms)}), "
          f"{1e3 * len(clips) / ld:.3f} clips/s, {1e3 * ld_frames / ld:.2f} frames/s; plain "
          f"loop of decode_video_rgb {lp:.3f} ms ({', '.join(f'{v:.3f}' for v in loop_ms)}), "
          f"{1e3 * len(clips) / lp:.3f} clips/s, {1e3 * ld_frames / lp:.2f} frames/s; loader / "
          f"loop {ld / lp:.4f}; per clip, ms, median (largest) of {len(per_clip['demux'])}: "
          "worker " + ", ".join(
              f"{k} {statistics.median(per_clip[k]):.3f} ({max(per_clip[k]):.3f})"
              for k in ("read", "demux", "upload"))
          + " (upload: packed into pinned memory, copy and tables enqueued), consumer "
          + ", ".join(f"{k} {statistics.median(per_clip[k]):.3f} ({max(per_clip[k]):.3f})"
                      for k in ("wait", "decode"))
          + f" (decode: K1 and K2 enqueued) ({card})")

    # phase 19: 8K UHD streams of 48 frames, past a chunk's 24: the dense
    # route in two chunks, each chunk's K3 from the last canvas of the one
    # before; then decode_video_rgb_chunks, which cuts at I-packets
    uinfo, upackets = split_packets(uhd)
    uhd2 = synth.container(*UHD[:2], uinfo["qtables"], list(upackets) * 2)
    ref2 = [np.concatenate([r, r]) for r in d_refs["8K UHD"]]
    pk = [p for p in upackets if p[0] == 2]
    one_key = synth.container(*UHD[:2], uinfo["qtables"],
                              upackets[:1] + [pk[i % len(pk)] for i in range(2 * UHD[2] - 1)])
    t0 = time.perf_counter()
    ref1 = runtime.ref_decode(one_key)[1:4]
    ref1_s = time.perf_counter() - t0
    long8k = {"packets twice": (uhd2, ref2), "one keyframe": (one_key, ref1)}
    routes19 = {k: dl.choose_route(d) for k, (d, _) in long8k.items()}
    g8 = routes19["packets twice"].g
    chunks19 = {k: [dl._frame_meta(h[4], g8.nb)[0].size for h in r.host]
                for k, r in routes19.items()}
    kinds = [dl.choose_route(c).kind for _, c in dl.chunk_streams(uhd2, UHD[2])]
    print(f"phase 19 8K UHD streams of {2 * UHD[2]} frames: the {UHD[2]}-frame stream's "
          f"packets twice ({len(uhd2)} bytes) and its I-packet then its P-packets over and "
          f"over ({len(one_key)} bytes, ref_decode {ref1_s:.1f} s): " + ", ".join(
              f"{k} route '{r.kind}', chunks of {chunks19[k]} frames"
              for k, r in routes19.items())
          + f"; decode_video_rgb_chunks' runs of at most {UHD[2]} frames, routes {kinds}")
    check(all(r.kind == "dense" for r in routes19.values())
          and all(c == [UHD[2], UHD[2]] for c in chunks19.values()),
          "the 48-frame 8K streams did not take the dense route in two chunks")
    check(kinds == ["dense", "dense"], "the 8K chunks did not take the dense route")
    zero_counts()
    for name, (data, ref) in long8k.items():
        planes = dl.decode_video_yuv(data, device="cuda")
        exact = all((p.cpu().numpy() == r).all() for p, r in zip(planes, ref))
        del planes
        rgba = dl.decode_video_rgba(data, device="cuda")
        exact_rgba = rgb_exact(g8, dl.rgba_view(rgba)[..., :3], ref, dev)
        del rgba
        print(f"phase 19 {name}: decode_video_yuv pixel-exact vs ref_decode: {exact}, "
              f"decode_video_rgba equal to plain K2 of the reference planes: {exact_rgba}")
        check(exact and exact_rgba, f"the 48-frame 8K stream ({name}) differs")
    long_launches = read_counts()
    print(f"phase 19 launches in that run: {long_launches} (K3 expected "
          f"{8 * UHD[2]}: once per frame, four calls of {2 * UHD[2]} frames)")
    check(long_launches["K3"] == 8 * UHD[2] and long_launches["K2"] == 2,
          "the 48-frame streams did not launch K3 once per frame and K2 once per call")
    check(all(v == 0 for k, v in long_launches.items() if k not in ("K2", "K3")),
          "the 48-frame streams launched a kernel of another route")
    zero_counts()
    starts, exact = [], True
    for start, rgb in dl.decode_video_rgb_chunks(uhd2, UHD[2], device="cuda"):
        starts.append((start, rgb.shape[0]))
        exact &= rgb_exact(g8, rgb, [r[start:start + rgb.shape[0]] for r in ref2], dev)
        del rgb
    ch_launches = read_counts()  # the comparisons launch no counted kernel
    print(f"phase 19 decode_video_rgb_chunks: chunks (start, frames) {starts}, every "
          f"pixel equal to plain K2 of the reference planes: {exact}; launches "
          f"{ch_launches}")
    check(exact and starts == [(0, UHD[2]), (UHD[2], UHD[2])],
          "the chunked 8K decode differs from the reference")
    check(ch_launches["K3"] == 2 * UHD[2] and ch_launches["K2"] == 2,
          "the chunks did not launch K3 once per frame and K2 once per chunk")
    check(all(v == 0 for k, v in ch_launches.items() if k not in ("K2", "K3")),
          "the chunks launched a kernel of another route")
    # peak memory: a 24-frame decode peaks in its densify, before its
    # canvases exist; a 48-frame decode densifies its second chunk beside
    # all 48 canvases and holds the second chunk's uploaded tensors too. A
    # second chunk's coefficients alive at once would add 2.5 GB more.
    up = dl.upload_chunks(routes19["packets twice"].host, dev)[1]
    extra = 2 * UHD[2] * g8.chh * g8.cw, nbytes(*up[1])
    del up
    peak48 = peak_bytes(lambda: dl.decode_video_yuv(uhd2, device="cuda"))
    peak24 = peak_bytes(lambda: dl.decode_video_yuv(uhd, device="cuda"))
    peak2 = peak_bytes(lambda: drain(dl.decode_video_rgb_chunks(uhd2, UHD[2],
                                                                 device="cuda")))
    peak1 = peak_bytes(lambda: drain([dl.decode_video_rgb(uhd, device="cuda")]))
    t19 = {"decode_video_yuv (dense route, two chunks)": (
               ENC_REPS, lambda: dl.decode_video_yuv(uhd2, dev)),
           f"decode_video_rgb_chunks (cap {UHD[2]})": (
               ENC_REPS, lambda: drain(dl.decode_video_rgb_chunks(uhd2, UHD[2],
                                                                  device="cuda"))),
           "decode_frames (per-frame path)": (2, lambda: dl.decode_frames(uhd2, dev))}
    t19 = {k: [host_ms(fn) for _ in range(n)] for k, (n, fn) in t19.items()}
    print(f"phase 19 per {2 * UHD[2]}-frame 8K clip (packets twice), ms: " + "; ".join(
        f"{k} median {statistics.median(v):.3f} ({', '.join(f'{x:.3f}' for x in v)})"
        for k, v in t19.items()) + f" ({card})")
    print(f"phase 19 peak device memory (torch.cuda.max_memory_allocated over the call): "
          f"decode_video_yuv of 48 frames {peak48} bytes, of the 24-frame stream {peak24} "
          f"bytes, more by {peak48 - peak24} (the 48 canvases {extra[0]} and the second "
          f"chunk's uploaded tensors {extra[1]}: {sum(extra)}); decode_video_rgb_chunks {peak2} "
          f"bytes, decode_video_rgb of the {UHD[2]}-frame stream {peak1} bytes, ratio "
          f"{peak2 / peak1:.4f} ({card})")
    check(peak48 - peak24 <= sum(extra) + (64 << 20),
          "the 48-frame decode held more than one chunk's coefficients at a time")
    check(peak2 < 1.25 * peak1, "more than one chunk was alive at a time")
    del ref2, ref1, long8k

    # phase 20: a stream batch and a GOP split over a list of devices (the
    # one card named twice: two threads, two streams)
    from pfv_torch.parallel import decode_stream_batch, decode_video_gops, split_gop_runs

    two = ["cuda:0", "cuda:0"]
    names = ["1080p", "1080p_pan", "1080p", "1080p_pan"]
    zero_counts()
    shards, mean_luma = decode_stream_batch([datas[k] for k in names], two)
    gop_rgba = decode_video_gops(datas["1080p"], two, want="rgba")
    par_launches = read_counts()
    exact = all((p[s].cpu().numpy() == r).all()
                for d, shard in enumerate(shards) for s in range(2)
                for p, r in zip(shard, refs[names[2 * d + s]]))
    want_mean = float(np.mean([refs[k][0].astype(np.float64).mean() for k in names]))
    print(f"phase 20 decode_stream_batch of {len(names)} 1080p streams on {two}: shards "
          f"{[tuple(sh[0].shape) for sh in shards]} pixel-exact vs ref_decode: {exact}; "
          f"mean_luma {float(mean_luma):.6f}, numpy {want_mean:.6f}")
    check(exact, "decode_stream_batch differs from ref_decode")
    check(abs(float(mean_luma) - want_mean) < 0.5, "mean_luma is off numpy's mean")
    g = dl.geometry(1920, 1080)
    exact = torch.equal(gop_rgba.view(torch.int32),
                        ref_rgba_plain(g, refs["1080p"], dev).view(torch.int32))
    run_frames = split_gop_runs(datas["1080p"], 2)[1]
    print(f"phase 20 decode_video_gops 1080p on {two} (runs of {run_frames} frames): "
          f"{tuple(gop_rgba.shape)} byte-exact vs plain K2 of ref_decode planes: {exact}; "
          f"launches {par_launches}")
    check(exact, "decode_video_gops differs from the reference")
    par_frames = sum(refs[k][0].shape[0] for k in names) + refs["1080p"][0].shape[0]
    check(par_launches["K1"] == par_frames, "phase 20 did not launch K1 once per frame")
    check(par_launches["K2"] == 2, "the GOP split did not launch K2 once per run")
    check(all(v == 0 for k, v in par_launches.items() if k not in ("K1", "K2")),
          "phase 20 launched a kernel of another route")
    del shards, gop_rgba
    batch = [datas[k] for k in names]
    sb = {1: [], 2: []}
    for _ in range(ENC_REPS):
        for n, runs in sb.items():
            runs.append(host_ms(lambda: decode_stream_batch(batch, ["cuda:0"] * n)))
    print(f"phase 20 decode_stream_batch of the {len(names)} streams (yuv), host clock, "
          f"synchronized, ms: " + "; ".join(
              f"{n} list entr{'y' if n == 1 else 'ies'} (one card) median "
              f"{statistics.median(v):.3f} ({', '.join(f'{x:.3f}' for x in v)})"
              for n, v in sb.items()) + f" ({card})")

    # phase 21: encode_video_gops, a run of GOPs per list entry
    from pfv_torch import encode_video_gops

    zero_counts()
    data = encode_video_gops(*srcs["512x384"], FPS, QUALITY, KEYFRAMES, devices=two)
    eg_launches = read_counts()
    got_sha, want_sha = (hashlib.sha256(d).hexdigest() for d in (data, datas["512x384"]))
    print(f"phase 21 encode_video_gops 512x384 on {two}: {len(data)} bytes sha256 "
          f"{got_sha}; {CORPORA['512x384']} sha256 {want_sha}; equal: "
          f"{data == datas['512x384']}; launches {eg_launches}")
    check(data == datas["512x384"], "encode_video_gops differs from the committed corpus")
    check(eg_launches["K6"] == eg_launches["FS"] == SOURCES["512x384"][2],
          "encode_video_gops did not launch K6 and the frame step once per frame")
    f512 = SOURCES["512x384"][2]
    check(eg_launches["K8"] == f512 - len(range(0, f512, KEYFRAMES)),
          "encode_video_gops did not launch K8 once per P-frame")
    check(all(v == 0 for k, v in eg_launches.items() if k not in ("K6", "K8", "FS")),
          "encode_video_gops launched another kernel")
    eg = {}
    for label, fn in (("encode_video", lambda: encode_video(
            *srcs["512x384"], FPS, QUALITY, KEYFRAMES, device="cuda")),
            ("encode_video_gops, 2 list entries (one thread)", lambda: encode_video_gops(
                *srcs["512x384"], FPS, QUALITY, KEYFRAMES, devices=two))):
        eg[label] = [host_ms(fn) for _ in range(ENC_REPS)]
    print(f"phase 21 per 512x384 clip ({SOURCES['512x384'][2]} frames), ms: " + "; ".join(
        f"{k} median {statistics.median(v):.3f} ({', '.join(f'{x:.3f}' for x in v)})"
        for k, v in eg.items()) + f" ({card})")

    # phase 22: the command-line tool, in-process
    import tempfile

    from pfv_torch import cli

    def tool(*argv) -> str:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(list(argv))
        return out.getvalue()

    corpus = os.path.join(ROOT, CORPORA["512x384"])
    n512 = refs["512x384"][0].shape[0]
    zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        pfv, npy = os.path.join(tmp, "synth.pfv"), os.path.join(tmp, "frames.npy")
        text = {"info": tool("info", corpus), "verify": tool("verify", corpus),
                "bench": tool("bench", corpus, "--runs", "3"),
                "encode": tool("encode", pfv, "--synth", "8"),
                "decode": tool("decode", pfv, "--output", npy)}
        cli_launches = read_counts()
        with open(pfv, "rb") as f:
            made = f.read()
        frames = torch.from_numpy(np.load(npy)).to(dev)
    for k, v in text.items():
        for line in v.splitlines():
            print(f"phase 22 pfv-torch {k}: {line}")
    cref = runtime.ref_decode(made)[1:4]
    exact = rgb_exact(dl.geometry(512, 384), frames, cref, dev, step=8)
    print(f"phase 22 encode --synth 8 then decode: {tuple(frames.shape)} equal to plain "
          f"K2 of ref_decode of the encoded bytes: {exact}; launches {cli_launches}")
    check(exact, "the tool's decoded frames differ from the reference")
    check("512x384 @ 30 fps, 4 q-tables" in text["info"]
          and "3 I-frames, 158 P-frames" in text["info"], "pfv-torch info is off")
    check(text["verify"].startswith(f"OK: {n512} frames"), "pfv-torch verify failed")
    check(text["bench"].count("RUN ") == 3, "pfv-torch bench did not print 3 runs")
    check(cli_launches["K1"] == 4 * n512 + 8 and cli_launches["K2"] == 4
          and cli_launches["K6"] == cli_launches["FS"] == 8 and cli_launches["K8"] == 7,
          "the tool's launch counts are off")
    main_runs = {3: launches, 8: dec_launches, 9: fb_launches, 12: enc_launches,
                 13: st_launches, 16: dense_launches, 18: ld_launches, 19: long_launches,
                 "19 chunks": ch_launches, 20: par_launches, 21: eg_launches,
                 22: cli_launches}
    print("launches per main-path phase: " + "; ".join(
        f"{ph}: " + ", ".join(f"{k} {v}" for k, v in r.items() if v)
        for ph, r in main_runs.items()))

    def total(k: str) -> int:
        return sum(r[k] for r in main_runs.values())

    def kernel_entry(name, source, replaces, launches, err, t, b):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": t[0], "plain_ms": t[1],
                "bound_ms": b[0], "bound_by": b[1], "library_ms": None}

    # launches: the sum over the main-path phases, each counted from 0;
    # library_ms is null: no single PyTorch call computes any of these functions
    kernels = [
        kernel_entry("step_frame", "pfv_torch/csrc/step_kernel.cu",
                     "pfv_tpu/ops/pallas/step_kernel.py:596", total("K1"), err_k1,
                     times[("K1", TIMED[0])], bounds["K1"]),
        kernel_entry("canvas_rgba", "pfv_torch/csrc/rgba_kernel.cu",
                     "pfv_tpu/ops/pallas/rgb_kernel.py:37",
                     total("K2"), err_k2, times["K2"], bounds["K2"]),
        kernel_entry("dense_seq_frame", "pfv_torch/csrc/dense_step_kernel.cu",
                     "pfv_tpu/ops/pallas/step_kernel.py:440", total("K3"),
                     err_k3, times[("K3", "8K UHD")], bounds[("K3", "8K UHD")]),
        kernel_entry("dense_step_batch", "pfv_torch/csrc/dense_step_kernel.cu",
                     "pfv_tpu/ops/pallas/step_kernel.py:263", total("K4"),
                     err_k4, times[("K4", "512x384")], bounds[("K4", "512x384")]),
        kernel_entry("idct_blocks", "pfv_torch/csrc/idct_kernel.cu",
                     "pfv_tpu/ops/pallas/idct_kernel.py:59", total("K5"), err_k5,
                     times["K5"], bounds["K5"]),
        kernel_entry("fdct_quantize", "pfv_torch/csrc/fdct_kernel.cu",
                     "pfv_tpu/ops/pallas/dct_kernel.py:61",
                     total("K6"), err_k6, times["K6"]["P"], bounds["K6"]["P"]),
        kernel_entry("mc_reconstruct", "pfv_torch/csrc/mc_kernel.cu",
                     "pfv_tpu/ops/pallas/mc_kernel.py:31", total("K7"), err_k7,
                     times["K7"], bounds["K7"]),
        # XLA in the JAX package, no Pallas kernel
        kernel_entry("motion_search", "pfv_torch/csrc/motion_kernel.cu",
                     "pfv_tpu/ops/motion.py:170", total("K8"), err_k8,
                     times["K8"][TIMED[0]], bounds["K8"][TIMED[0]]),
        # K5 + K7 as one kernel
        dict(kernel_entry("frame_step", "pfv_torch/csrc/frame_step_kernel.cu",
                          "pfv_tpu/ops/pallas/idct_kernel.py:59",
                          total("FS"), err_fs, times["FS"], bounds["FS"]),
             also_replaces="pfv_tpu/ops/pallas/mc_kernel.py:31"),
    ]
    sides = [("K1 1080p", bounds["K1"]), ("K2 1080p", bounds["K2"])] + [
        (f"{k} {n}", bounds[(k, n)]) for k, n in (("K3", "8K UHD"), ("K3", "1080p"),
                                                  ("K4", "512x384"), ("K4", "1080p"))] + [
        (k, bounds[k]) for k in ("K5", "K7")] + [
        (f"K6, 1080p {kind}-frame", b) for kind, b in bounds["K6"].items()] + [
        (f"K8, {name} P-frame", b) for name, b in bounds["K8"].items()] + [
        ("frame step, 1080p P-frame", bounds["FS"])]
    for name, b in sides:
        print(f"bound {name}: {b[0]:.5f} ms ({b[1]}): bytes {b[2]:.5f} ms, operations "
              f"{b[3]:.5f} ms ({card})")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
