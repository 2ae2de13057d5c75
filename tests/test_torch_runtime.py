"""The port's own copy of the C++ entropy/container runtime
(`pfv_torch.runtime`) against the JAX package's (`pfv_tpu.runtime`).

The port loads nothing of the JAX package: a fresh interpreter that imports
every module of pfv_torch and uses its runtime, loader, chunked decode, GOP
split and command-line tool has no module or shared library from
pfv_tpu/ and neither jax nor pfv_tpu in sys.modules. The copy's C++ source
is the reference's line for line but for the comments of its header block,
its Makefile byte for byte, and its demux forms, scalar decoder and
payload coders give equal arrays and bytes on three streams: a 128x96
clip from the JAX encoder, a 4112x32 random stream, and a stream with a
drop frame (an I-packet without payload) mid-stream."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from pfv_torch import dataloader as tdl
from pfv_torch import runtime as trt
from pfv_torch import synth
from pfv_torch.dec import split_packets
from pfv_tpu import runtime as jrt
from pfv_tpu.encoding import encode_video
from pfv_tpu.utils.synth import synth_yuv_frame

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def streams():
    ys, us, vs = map(np.stack, zip(*[synth_yuv_frame(t, 128, 96) for t in range(5)]))
    clip = encode_video(ys, us, vs, 30, quality=1, keyframes=3)
    wide = synth.random_stream(4112, 32, 4, seed=3, keyframes=2)
    info, packets = split_packets(synth.random_stream(96, 64, 5, seed=4, keyframes=3))
    dropped = synth.container(96, 64, info["qtables"],
                              packets[:2] + [(1, b"")] + packets[2:])
    return {"128x96": clip, "4112x32": wide, "96x64_drop": dropped}


def _code_and_comments(path):
    """Each line of a C++ source cut at its first `//`: (code, comment)."""
    code, comments = [], []
    with open(path, encoding="utf-8") as f:
        for line in f.read().split("\n"):
            head, sep, tail = line.partition("//")
            code.append(head.rstrip())
            comments.append(sep + tail)
    return code, comments


def test_the_copy_is_the_reference_source():
    """The C++ source equals the reference's line for line once `//`
    comments are cut, and its comments differ only in the header block
    (the lines before the first line of code); the Makefile is the same
    byte for byte."""
    port, ref = (_code_and_comments(os.path.join(ROOT, d, "runtime/native",
                                                 "pfv_bitstream.cpp"))
                 for d in ("pfv_torch", "pfv_tpu"))
    assert port[0] == ref[0]
    header = next(i for i, line in enumerate(port[0]) if line)
    assert header > 0 and port[1][header:] == ref[1][header:]
    with open(os.path.join(ROOT, "pfv_torch/runtime/native/Makefile"), "rb") as a, \
            open(os.path.join(ROOT, "pfv_tpu/runtime/native/Makefile"), "rb") as b:
        assert a.read() == b.read()


def test_port_loads_nothing_of_the_jax_package(streams, tmp_path):
    path = tmp_path / "clip.pfv"
    path.write_bytes(streams["96x64_drop"])
    code = (
        "import os, sys\n"
        "import pfv_torch\n"
        "from pfv_torch import cli, dataloader, encoding, loader, parallel, runtime\n"
        "from pfv_torch.parallel import devices, gops, streams\n"
        "from pfv_torch.utils import profiling\n"
        f"data = open({str(path)!r}, 'rb').read()\n"
        "n, y, u, v, _ = runtime.ref_decode(data)\n"
        "host = dataloader.demux_host(data)\n"
        "packed = dataloader.demux_host_packed(data)\n"
        "assert n == 5 and host[2].size and packed[2].size\n"
        f"cli.main(['verify', {str(path)!r}, '--device', 'cpu'])\n"
        "assert len(loader.decode_many_rgb([data], device='cpu')[0]) == 5\n"
        "assert len(list(dataloader.decode_video_rgb_chunks(data, 3, device='cpu'))) == 2\n"
        "assert len(gops.decode_video_gops(data, ['cpu'] * 2)[0]) == 5\n"
        "assert encoding.encode_video_gops and profiling.StageTimer and devices\n"
        f"ref = os.path.join({ROOT!r}, 'pfv_tpu') + os.sep\n"
        "files = [getattr(m, '__file__', None) or '' for m in list(sys.modules.values())]\n"
        "maps = open('/proc/self/maps').read().split('\\n')\n"
        "bad = [f for f in files if os.path.abspath(f).startswith(ref)]\n"
        "bad += [line for line in maps if ref in line]\n"
        "assert not bad, bad\n"
        "assert 'jax' not in sys.modules and 'pfv_tpu' not in sys.modules\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    lines = proc.stdout.splitlines()  # the tool's verdict, then the script's
    assert proc.returncode == 0 and len(lines) == 2, proc.stderr
    assert lines[0].startswith("OK: 5 frames") and lines[1] == "ok"


def _equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("name", ["128x96", "4112x32", "96x64_drop"])
def test_demuxes_and_reference_decoder_equal_the_reference_runtime(streams, name):
    data = streams[name]
    info, _ = trt.parse_header(data)
    g = tdl.geometry(info["width"], info["height"])
    assert _equal(trt.parse_header(data), jrt.parse_header(data))
    got = trt.ref_decode(data)
    assert _equal(got, jrt.ref_decode(data)) and got[0] == trt.count_frames(data)
    for pad in (1, 1 << 16):
        for tables in (None, tdl.pstep_tables(g)):
            a = trt.demux_file_sparse_packed(data, pad_to_multiple=pad,
                                             pstep_tables=tables)
            b = jrt.demux_file_sparse_packed(data, pad_to_multiple=pad,
                                             pstep_tables=tables)
            assert all(_equal(x, y) for x, y in zip(a, b))
    if tdl.failed_gate(g) is None:
        a = trt.demux_file_sparse_tiles(data, tdl.tile_tables(g), chunk=128)
        b = jrt.demux_file_sparse_tiles(data, tdl.tile_tables(g), chunk=128)
        assert all(_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["128x96", "4112x32", "96x64_drop"])
def test_payload_coders_equal_the_reference_runtime(streams, name):
    data = streams[name]
    info, packets = split_packets(data)
    nb = tdl.geometry(info["width"], info["height"]).nb
    coded = 0
    for ptype, payload in packets:
        if ptype == 1 and len(payload):
            a, b = trt.decode_iframe_payload(payload, nb), jrt.decode_iframe_payload(payload, nb)
            assert all(_equal(x, y) for x, y in zip(a, b))
            coeffs, qidx = a
            again = trt.encode_iframe_payload(coeffs, tuple(qidx))
            assert again == jrt.encode_iframe_payload(coeffs, tuple(qidx)) == bytes(payload)
            flat = coeffs.reshape(-1)
            idx = np.flatnonzero(flat)
            assert trt.encode_iframe_payload_sparse(idx, flat[idx], nb, tuple(qidx)) \
                == jrt.encode_iframe_payload_sparse(idx, flat[idx], nb, tuple(qidx))
            coded += 1
        elif ptype == 2:
            a, b = trt.decode_pframe_payload(payload, nb), jrt.decode_pframe_payload(payload, nb)
            assert all(_equal(x, y) for x, y in zip(a, b))
            coeffs, mvx, mvy, hc, qidx = a
            again = trt.encode_pframe_payload(coeffs, mvx, mvy, hc, tuple(qidx))
            assert again == jrt.encode_pframe_payload(coeffs, mvx, mvy, hc, tuple(qidx))
            flat = (coeffs * hc[:, None]).reshape(-1)
            idx = np.flatnonzero(flat)
            assert trt.encode_pframe_payload_sparse(idx, flat[idx], mvx, mvy, hc, tuple(qidx)) \
                == jrt.encode_pframe_payload_sparse(idx, flat[idx], mvx, mvy, hc, tuple(qidx))
            coded += 1
    assert coded >= 4
    ly, lc = (32, 4112), (16, 2064)
    mv = np.zeros(tdl.geometry(4112, 32).nb, np.int8)
    trt.validate_motion(mv, mv, ly, lc)
    mv[0] = -1
    for rt in (trt, jrt):
        with pytest.raises(ValueError, match="out of bounds"):
            rt.validate_motion(mv, mv, ly, lc)
