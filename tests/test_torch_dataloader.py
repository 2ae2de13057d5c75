"""The whole slice: pfv_torch.decode_video_yuv / _rgba / _rgb / _checksums
with device="cpu" (the kernels' plain versions) against the JAX package's
units path (forced as tests/test_units_kernel.py forces it) and against the
scalar reference decoder `runtime.ref_decode`. All comparisons are exact.

Clips: those of test_units_kernel.py (256x128 with an I-frame mid-stream,
128x96 with one keyframe, q0 with multi-chunk tiles), plus 136x90, whose
width is not a multiple of 128: only the port and ref_decode take it.

Streams the TPU kernels' contracts refuse, which the port's frame steps
take: the 128x96 clip with its I-packet re-encoded on q-table indices
(0, 1, 3), the same clip without its I-packet (the first frame is P), and a
4112x32 stream built from runtime payloads without its I-packet. The JAX
package takes them through its per-block XLA paths.

Streams wider than K1 takes (2*scp > 1024): 4112x32 with one keyframe and
with one every 3 frames (route "dense", K3), against ref_decode and the JAX
package; streams past the dense route's positions
cap (lowered here) cut into 2-4 chunks: inside a GOP, at a keyframe, at a
drop frame, with one keyframe, with a leading P-frame, all on q-table
indices per frame and plane."""

from __future__ import annotations

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import pfv_torch
from pfv_torch import dataloader as tdl
from pfv_torch import synth
from pfv_torch.dec import split_packets
from pfv_tpu import dataloader as jdl
from pfv_tpu import runtime
from pfv_tpu.encoding import encode_video
from pfv_tpu.utils.synth import synth_yuv_frame

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLIPS = {
    # name: (w, h, frames, t0, quality, keyframes, JAX units path takes it)
    "256x128_gop4": (256, 128, 7, 0, 2, 4, True),
    "128x96_one_key": (128, 96, 6, 3, 4, 100, True),
    "256x128_q0": (256, 128, 4, 7, 0, 4, True),
    "136x90": (136, 90, 5, 1, 3, 3, False),
}


def _jax_units(data, want):
    """The JAX package's decode through its units path (units + seq kernel,
    interpret mode on the CPU)."""
    env = {"PFV_STEP": "1", "PFV_SEQ": "1", "PFV_UNITS": "1",
           "PFV_GOP_CONCURRENT": "0", "PFV_LADDER": "plain"}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        jdl._make_decoder.cache_clear()
        try:
            info, _ = jdl._demux_packed_to_device(data, 0)
            assert info.get("units", 0) > 0, "units path not taken"
            return [np.asarray(p) for p in want(data)]
        finally:
            jdl._make_decoder.cache_clear()


@pytest.fixture(scope="module")
def clips():
    out = {}
    for name, (w, h, f, t0, q, key, jax_units) in CLIPS.items():
        ys, us, vs = map(np.stack, zip(*[synth_yuv_frame(t + t0, w, h)
                                         for t in range(f)]))
        data = encode_video(ys, us, vs, 30, quality=q, keyframes=key)
        out[name] = dict(data=data, ref=runtime.ref_decode(data)[1:4],
                         jax_units=jax_units)
    return out


@pytest.mark.parametrize("name", list(CLIPS))
def test_yuv_matches_jax_and_reference(clips, name):
    c = clips[name]
    got = [p.numpy() for p in pfv_torch.decode_video_yuv(c["data"], device="cpu")]
    for p, r in zip(got, c["ref"]):
        assert p.shape == r.shape and np.array_equal(p, r)
    if c["jax_units"]:
        want = _jax_units(c["data"], jdl.decode_video_yuv)
        for p, r in zip(got, want):
            assert np.array_equal(p, r)


def test_q0_clip_has_multichunk_tiles(clips):
    _, _, coff, _ = tdl.demux_host(clips["256x128_q0"]["data"])[1:]
    assert int(np.diff(coff).max()) > 1


@pytest.mark.parametrize("name", list(CLIPS))
def test_rgb_and_checksums_match_reference(clips, name):
    c = clips[name]
    ry, ru, rv = c["ref"]
    rgba = pfv_torch.decode_video_rgba(c["data"], device="cpu")
    assert rgba.dtype == torch.uint32 and tuple(rgba.shape) == ry.shape
    chans = pfv_torch.rgba_view(rgba).numpy()
    rgb = pfv_torch.decode_video_rgb(c["data"], device="cpu").numpy()
    up = [np.repeat(np.repeat(p, 2, axis=1), 2, axis=2)[:, :ry.shape[1], :ry.shape[2]]
          for p in (ru, rv)]
    want = jdl.yuv_to_rgb(ry, *up)  # the JAX package's XLA colour path
    assert np.array_equal(chans[..., :3], np.asarray(want))
    assert (chans[..., 3] == 255).all() and np.array_equal(rgb, chans[..., :3])
    sums = pfv_torch.decode_video_checksums(c["data"], device="cpu")
    assert np.array_equal(sums.numpy().astype(np.uint32),
                          jdl.plane_checksums(ry, ru, rv))


def test_rgba_rgb_checksums_match_jax_units_path(clips):
    data = clips["256x128_gop4"]["data"]
    for port, jax_fn in ((pfv_torch.decode_video_rgba, jdl.decode_video_rgba),
                         (pfv_torch.decode_video_rgb, jdl.decode_video_rgb),
                         (pfv_torch.decode_video_checksums,
                          jdl.decode_video_checksums)):
        (want,) = _jax_units(data, lambda d, fn=jax_fn: [fn(d)])
        got = port(data, device="cpu")
        if got.dtype == torch.uint32:
            got = got.view(torch.int32).numpy().view(np.uint32)
        else:
            got = got.numpy().astype(want.dtype)
        assert np.array_equal(got, want)


def test_gates_raise_by_name():
    """The gates left are the geometry's: K1's lanes and the dense rows; on
    the frames only the q-table index range, which raises."""
    assert tdl.failed_gate(tdl.geometry(4112, 128)) == "2*scp <= 1024"  # 4096 fits
    assert tdl.failed_gate(tdl.geometry(4096, 128)) is None
    assert tdl.dense_gate(tdl.geometry(4112, 128)) is None
    assert tdl.dense_gate(tdl.geometry(32768, 32768)) == "row_span < 2^24"
    qi = np.array([[0, 1, 2], [2, 3, 3], [3, 0, 1]], np.uint8)  # per frame, U != V
    assert tdl.stream_gate(qi, 4) is None
    with pytest.raises(ValueError, match="out of range"):
        tdl.stream_gate(qi, 3)
    info, packets = split_packets(synth.random_stream(64, 32, 2, seed=3))
    bad = synth.container(64, 32, info["qtables"][:3], packets)  # P-frames use table 3
    with pytest.raises(ValueError, match="out of range"):
        tdl.choose_route(bad)


def test_port_never_imports_jax(clips, tmp_path):
    path = tmp_path / "clip.pfv"
    path.write_bytes(clips["136x90"]["data"])
    code = (
        "import sys, pfv_torch\n"
        f"y, u, v = pfv_torch.decode_video_yuv(open({str(path)!r}, 'rb').read(),"
        " device='cpu')\n"
        "assert y.shape[0] == 5\n"
        f"dec = pfv_torch.Decoder(open({str(path)!r}, 'rb'), device='cpu')\n"
        "got = []\n"
        "while dec.advance_frame(got.append):\n"
        "    pass\n"
        "assert len(got) == 5 and (got[4].plane_y == y[4].numpy()).all()\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


FAULTS = {
    # name: (the TPU kernels' contract the stream fails, the port's route)
    "128x96_q013": ("uniform q indices per frame type, U == V", "units"),
    "128x96_first_p": ("first frame is intra", "units"),
    "4112x32": ("first frame is intra", "dense"),
}


@pytest.fixture(scope="module")
def fault_streams(clips):
    data = clips["128x96_one_key"]["data"]
    info, packets = split_packets(data)
    assert [t for t, _ in packets] == [1, 2, 2, 2, 2, 2]
    nb = tdl.geometry(128, 96).nb
    coeffs, _ = runtime.decode_iframe_payload(packets[0][1], nb)
    requant = (1, runtime.encode_iframe_payload(coeffs, (0, 1, 3)))
    return {
        "128x96_q013": synth.container(128, 96, info["qtables"],
                                       [requant] + packets[1:]),
        "128x96_first_p": synth.container(128, 96, info["qtables"], packets[1:]),
        "4112x32": synth.container(4112, 32, *_wide_without_first(12)),
    }


def _wide_without_first(seed):
    """A 4112x32 random stream's q-tables and packets without its first."""
    info, packets = split_packets(synth.random_stream(4112, 32, 4, seed=seed))
    return info["qtables"], packets[1:]


@pytest.mark.parametrize("name", list(FAULTS))
def test_fault_streams_take_the_frames_path_by_gate(fault_streams, name):
    """No gate sends these streams frame by frame any more: each takes its
    geometry's route, a leading P-frame from the starting canvas."""
    data = fault_streams[name]
    contract, kind = FAULTS[name]
    route = tdl.choose_route(data)
    assert (route.kind, route.gate) == (kind, None) and route.host is not None
    assert route.leading_p == (contract == "first frame is intra")
    if kind == "units":
        assert tdl.demux_host(data)[2].shape == route.host[2].shape
    else:
        with pytest.raises(ValueError, match=re.escape("gate '2*scp <= 1024'")):
            tdl.demux_host(data)
    _, canvases = tdl.decode_canvases(data, device="cpu")
    _, frames = tdl.decode_frames(data, device="cpu")
    for a, b in zip(tdl.slice_yuv(route.g, canvases), tdl.slice_yuv(route.g, frames)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(FAULTS))
def test_fault_streams_match_jax_and_reference(fault_streams, name):
    data = fault_streams[name]
    ry, ru, rv = runtime.ref_decode(data)[1:4]
    got = [p.numpy() for p in pfv_torch.decode_video_yuv(data, device="cpu")]
    want = [np.asarray(p) for p in jdl.decode_video_yuv(data)]
    for p, q, r in zip(got, want, (ry, ru, rv)):
        assert p.shape == r.shape and np.array_equal(p, r) and np.array_equal(p, q)
    chans = pfv_torch.rgba_view(pfv_torch.decode_video_rgba(data, device="cpu"))
    up = [np.repeat(np.repeat(p, 2, axis=1), 2, axis=2)[:, :ry.shape[1], :ry.shape[2]]
          for p in (ru, rv)]
    assert np.array_equal(chans[..., :3].numpy(), np.asarray(jdl.yuv_to_rgb(ry, *up)))
    sums = pfv_torch.decode_video_checksums(data, device="cpu")
    assert np.array_equal(sums.numpy().astype(np.uint32),
                          jdl.plane_checksums(ry, ru, rv))


@pytest.mark.parametrize("name", list(CLIPS))
def test_frames_path_matches_units_path(clips, name):
    data = clips[name]["data"]
    route = tdl.choose_route(data)
    assert route.gate is None and route.host is not None and route.kind == "units"
    g, units = tdl.decode_canvases(data, device="cpu")
    g2, frames = tdl.decode_frames(data, device="cpu")
    assert g2 == g and frames.shape == units.shape
    for a, b in zip(tdl.slice_yuv(g, frames), tdl.slice_yuv(g, units)):
        assert torch.equal(a, b)


WIDE = {
    # name: (keyframe interval, route)
    "4112x32_one_key": (1 << 30, "dense"),
    "4112x32_gop3": (3, "dense"),
}


@pytest.mark.parametrize("name", list(WIDE))
def test_wide_streams_take_the_dense_routes(name):
    key, kind = WIDE[name]
    data = synth.random_stream(4112, 32, 7, seed=21, keyframes=key)
    route = tdl.choose_route(data)
    assert (route.kind, route.gate, len(route.host)) == (kind, None, 1)
    assert tdl.failed_gate(route.g) == "2*scp <= 1024"
    with pytest.raises(ValueError, match="gate '2\\*scp <= 1024'"):
        tdl.demux_host(data)
    ry, ru, rv = runtime.ref_decode(data)[1:4]
    got = [p.numpy() for p in pfv_torch.decode_video_yuv(data, device="cpu")]
    want = [np.asarray(p) for p in jdl.decode_video_yuv(data)]
    for p, q, r in zip(got, want, (ry, ru, rv)):
        assert p.shape == r.shape and np.array_equal(p, r) and np.array_equal(p, q)
    chans = pfv_torch.rgba_view(pfv_torch.decode_video_rgba(data, device="cpu"))
    up = [np.repeat(np.repeat(p, 2, axis=1), 2, axis=2)[:, :ry.shape[1], :ry.shape[2]]
          for p in (ru, rv)]
    assert np.array_equal(chans[..., :3].numpy(), np.asarray(jdl.yuv_to_rgb(ry, *up)))
    sums = pfv_torch.decode_video_checksums(data, device="cpu")
    assert np.array_equal(sums.numpy().astype(np.uint32), jdl.plane_checksums(ry, ru, rv))
    g, canvases = tdl.decode_canvases(data, device="cpu")
    _, frames = tdl.decode_frames(data, device="cpu")
    for a, b in zip(tdl.slice_yuv(g, canvases), tdl.slice_yuv(g, frames)):
        assert torch.equal(a, b)


def test_dense_positions_limit_is_a_named_gate(monkeypatch):
    """The positions' limits no longer gate a route; they size the dense
    route's chunks. 4112x1024: 64*row_span = 7,864,320, so 273 frames fit
    int32 and 162 CHUNK_POSITIONS; 8K UHD: 24. A 4112x1024 stream whose
    P-frames repeat one packet, with the int32 limit lowered to 2 frames,
    is demuxed in chunks of 2 frames, the last chunk opening with a
    P-packet; only a geometry past the 24-bit rows goes frame by frame."""
    g = tdl.geometry(4112, 1024)
    assert 64 * tdl.pstep_tables(g)[2] == 7864320
    assert tdl.dense_chunk_frames(g) == 162
    assert tdl.dense_chunk_frames(tdl.geometry(7680, 4320)) == 24
    with monkeypatch.context() as mp:
        mp.setattr(tdl, "CHUNK_POSITIONS", 1 << 40)
        assert tdl.dense_chunk_frames(g) == 273
    info, packets = split_packets(synth.random_stream(4112, 1024, 2, seed=5))
    data = synth.container(4112, 1024, info["qtables"], packets[:1] + packets[1:] * 4)
    monkeypatch.setattr(tdl, "MAX_POSITIONS", 2 * 7864320 + 1)
    route = tdl.choose_route(data)
    assert (route.kind, route.gate, route.leading_p) == ("dense", None, False)
    metas = [tdl._frame_meta(h[4], g.nb) for h in route.host]
    assert [m[0].tolist() for m in metas] == [[1, 2], [2, 2], [2]]
    want = runtime.demux_file_sparse_packed(data, pstep_tables=tdl.pstep_tables(g))
    assert np.array_equal(np.concatenate([m[1] for m in metas]), want[5])
    huge = synth.container(32768, 32768, info["qtables"], [])
    route = tdl.choose_route(huge)
    assert (route.kind, route.gate, route.host) == ("frames", "row_span < 2^24", huge)


def _with_extra_packets(data: bytes, at: int) -> bytes:
    """`data` with a drop frame and an unknown packet after packet `at`."""
    info, packets = split_packets(data)
    packets = packets[:at + 1] + [(1, b""), (7, b"\x01\x02\x03")] + packets[at + 1:]
    return synth.container(info["width"], info["height"], info["qtables"], packets)


# (Y, U, V) q-table indices, frame f taking QIDX[f % 5]
QIDX = [(0, 1, 2), (3, 2, 1), (1, 3, 0), (2, 0, 3), (0, 0, 1)]
CHUNKED = {
    # name: (w, h, frames, keyframe interval, frames per chunk, chunks)
    "4112x16_cut_in_gop": (4112, 16, 9, 4, 3, 3),
    "4112x16_cut_at_key": (4112, 16, 8, 4, 4, 2),
    "4112x32_one_key": (4112, 32, 7, 1 << 30, 2, 4),
    "4112x32_drop_at_cut": (4112, 32, 6, 4, 3, 2),
    "4112x32_first_p": (4112, 32, 7, 3, 3, 3),
}


def chunked_stream(name: str) -> bytes:
    """The CHUNKED stream `name`, on QIDX: "drop_at_cut" with a drop frame
    and an unknown packet right before its cut, "first_p" without its
    I-packet."""
    w, h, f, key, _, _ = CHUNKED[name]
    data = synth.random_stream(w, h, f + name.endswith("first_p"), seed=f, keyframes=key,
                               qidx=QIDX)
    if name.endswith("drop_at_cut"):
        return _with_extra_packets(data, CHUNKED[name][4] - 1)
    if name.endswith("first_p"):
        info, packets = split_packets(data)
        return synth.container(w, h, info["qtables"], packets[1:])
    return data


@pytest.mark.parametrize("name", list(CHUNKED))
def test_chunked_dense_route_matches_jax_and_reference(name, monkeypatch):
    """A stream past the positions cap takes the dense route in 2-4 chunks,
    each chunk's K3 from the last canvas of the one before: YUV, RGBA, RGB
    and checksums equal `ref_decode`, YUV the JAX package's."""
    w, h, f, _, per_chunk, n_chunks = CHUNKED[name]
    data = chunked_stream(name)
    g = tdl.geometry(w, h)
    monkeypatch.setattr(tdl, "MAX_POSITIONS", per_chunk * 64 * tdl.pstep_tables(g)[2] + 1)
    route = tdl.choose_route(data)
    assert (route.kind, route.gate, len(route.host)) == ("dense", None, n_chunks)
    assert route.leading_p == name.endswith("first_p")
    assert [tdl._frame_meta(c[4], g.nb)[0].size for c in route.host] == \
        [min(per_chunk, f - a) for a in range(0, f, per_chunk)]
    ry, ru, rv = runtime.ref_decode(data)[1:4]
    assert ry.shape[0] == f
    got = [p.numpy() for p in pfv_torch.decode_video_yuv(data, device="cpu")]
    want = [np.asarray(p) for p in jdl.decode_video_yuv(data)]
    for p, q, r in zip(got, want, (ry, ru, rv)):
        assert p.shape == r.shape and np.array_equal(p, r) and np.array_equal(p, q)
    rgba = pfv_torch.decode_video_rgba(data, device="cpu")
    up = [np.repeat(np.repeat(p, 2, axis=1), 2, axis=2)[:, :ry.shape[1], :ry.shape[2]]
          for p in (ru, rv)]
    rgb = np.asarray(jdl.yuv_to_rgb(ry, *up))
    assert np.array_equal(pfv_torch.rgba_view(rgba)[..., :3].numpy(), rgb)
    assert np.array_equal(pfv_torch.decode_video_rgb(data, device="cpu").numpy(), rgb)
    sums = pfv_torch.decode_video_checksums(data, device="cpu")
    assert np.array_equal(sums.numpy().astype(np.uint32), jdl.plane_checksums(ry, ru, rv))
