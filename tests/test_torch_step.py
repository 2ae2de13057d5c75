"""K1's plain version and the table builders of pfv_torch against the JAX
package's units path, fed the same tile-demux output.

The JAX builders (_unpack_meta, _pstep_metadata, _pstep_qmul) are closures
of dataloader._make_decoder; the test reaches them through the closure
cells of the jitted entry point, so the reference stays untouched. The JAX
kernels take one multiplier set per clip, [I/P][luma/chroma]; the port one
(3, 64) table per frame: on a clip with uniform q-table indices the port's
tables equal the JAX set broadcast to (F, 3, 64), and K1's plain version is
held canvas for canvas against make_step_seq_units in interpret mode, fed
either. Streams with q-table indices that differ from frame to frame and
between U and V, and streams whose first frame is a P-frame (predicted
from the starting canvas), are held to `runtime.ref_decode`. All
comparisons are exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfv_torch import dataloader as tdl
from pfv_torch import synth
from pfv_torch.dec import split_packets
from pfv_torch.frame import initial_canvas
from pfv_torch.kernels.step import step_frames, step_frames_plain
from pfv_tpu import dataloader as jdl
from pfv_tpu import runtime
from pfv_tpu.encoding import encode_video
from pfv_tpu.ops.pallas.step_kernel import make_step_seq_units
from pfv_tpu.utils.synth import synth_yuv_frame


def _closure(fn, name):
    fn = getattr(fn, "__wrapped__", fn)
    return dict(zip(fn.__code__.co_freevars, fn.__closure__))[name].cell_contents


@pytest.fixture(scope="module")
def clip():
    """A 128x96 clip with an I-frame mid-stream and q1 (multi-chunk tiles),
    its port-side demux, and the JAX builders for its geometry."""
    w, h = 128, 96
    ys, us, vs = map(np.stack, zip(*[synth_yuv_frame(t + 5, w, h)
                                     for t in range(6)]))
    data = encode_video(ys, us, vs, 30, quality=1, keyframes=4)
    info, g, units, coff, meta = tdl.demux_host(data)
    dec = jdl.get_decoder(w, h, info["qtables"], "pstep",
                          units_chunk=tdl.UNITS_CHUNK)
    units_canvases = _closure(dec.decode_yuv_packed, "_units_canvases")
    return dict(data=data, info=info, g=g, units=units, coff=coff, meta=meta,
                unpack=_closure(dec.decode_yuv_packed, "_unpack_meta"),
                maps=_closure(units_canvases, "_pstep_metadata"),
                qmul=_closure(units_canvases, "_pstep_qmul"),
                canvas_dims=tuple(_closure(units_canvases, n)
                                  for n in ("chh", "cw")))


def _port_tables(c):
    meta = torch.from_numpy(c["meta"].astype(np.int32))
    mvx, mvy, hc, ftype, qidx = tdl.unpack_meta(meta, c["g"].nb)
    maps = tdl.block_maps(c["g"], mvx, mvy, hc)
    qmul = tdl.frame_multipliers(torch.from_numpy(c["info"]["qtables"]), qidx)
    return (mvx, mvy, hc, ftype, qidx), maps, qmul


def broadcast_clip_set(jq, ftype) -> torch.Tensor:
    """The JAX per-clip multipliers (2, 2, 64, 1) [I/P][luma/chroma] ->
    (F, 3, 64): frame f's Y row the luma set of its type, U and V rows the
    chroma set."""
    jq = torch.from_numpy(np.array(jq)[..., 0])
    mode = (torch.as_tensor(np.array(ftype)).long() != 1).long()
    return jq[mode][:, [0, 1, 1]].contiguous()


def _jax_tables(c):
    jmeta = c["unpack"](jnp.asarray(c["meta"]))
    mvx, mvy, hc, ftype, qidx = jmeta
    dyc, dxc, hcc, stab = c["maps"](mvx, mvy, hc)
    qmul = c["qmul"](ftype.astype(jnp.int32), hc, qidx)
    return jmeta, (dyc, dxc, hcc, stab), qmul


def test_geometry_and_tile_tables_match_jax(clip):
    g = clip["g"]
    assert (g.chh, g.cw) == clip["canvas_dims"]
    for w, h in ((128, 96), (256, 128), (136, 90), (1920, 1080)):
        want = jdl._tile_tables(w, h)
        got = tdl.tile_tables(tdl.geometry(w, h))
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert got[3] == want[3]


def test_table_builders_match_jax(clip):
    (pm, (dy, dx, hc), qmul) = _port_tables(clip)
    jm, (dyc, dxc, hcc, _), jq = _jax_tables(clip)
    for a, b in zip(pm, jm):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # the JAX maps hold each block's value over its 16 columns
    for a, b in ((dy, dyc), (dx, dxc), (hc, hcc)):
        got, b = a.repeat_interleave(16, dim=2).numpy(), np.asarray(b)
        assert got.dtype == b.dtype and np.array_equal(got, b)
    assert qmul.dtype == torch.int32 and qmul.shape == (pm[3].shape[0], 3, 64)
    assert torch.equal(qmul, broadcast_clip_set(jq, pm[3]))


def test_step_plain_matches_units_kernel(clip):
    g = clip["g"]
    assert int(np.diff(clip["coff"]).max()) > 1, "no multi-chunk tile"
    meta, (dy, dx, hc), qmul = _port_tables(clip)
    units = torch.from_numpy(clip["units"].view(np.int32))
    coff = torch.from_numpy(clip["coff"])
    args = (units, coff, dy, dx, hc, meta[3].contiguous(), qmul, g.chh, g.cw,
            g.gly, g.guw)
    got = step_frames_plain(*args)
    (_, _, _, jft, _), (dyc, dxc, hcc, stab), jq = _jax_tables(clip)
    seq = make_step_seq_units(g.chh, g.cw, g.gly, C=tdl.UNITS_CHUNK,
                              interpret=True)
    want = np.asarray(seq(jnp.asarray(clip["units"]), jnp.asarray(clip["coff"]),
                          dyc, dxc, hcc, jft.astype(jnp.int32), stab, jq))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    # fed the JAX set broadcast to (F, 3, 64), the same canvases
    clip_set = broadcast_clip_set(jq, jft)
    assert torch.equal(step_frames_plain(*args[:6], clip_set, *args[7:]), got)
    # the wrapper takes the plain version for a CPU tensor, without a launch
    before = step_frames.launches
    assert torch.equal(step_frames(*args), got)
    assert step_frames.launches == before
    # and the canvases slice to the reference decoder's planes
    _, ry, ru, rv, _ = runtime.ref_decode(clip["data"])
    for p, r in zip(tdl.slice_yuv(g, got), (ry, ru, rv)):
        assert np.array_equal(p.numpy(), r)


def test_step_rejects_what_the_kernel_cannot_take(clip):
    g = clip["g"]
    _, (dy, dx, hc), qmul = _port_tables(clip)
    f = dy.shape[0]
    units = torch.from_numpy(clip["units"].view(np.int32))
    coff = torch.from_numpy(clip["coff"])
    ftype = torch.ones(f, dtype=torch.int32)
    good = [units, coff, dy, dx, hc, ftype, qmul]
    bad = {
        0: units.to(torch.int64),
        1: coff[:-1],
        2: dy.to(torch.int32),
        4: hc.transpose(1, 2).contiguous(),
        6: qmul[:1],
    }
    for i, t in bad.items():
        args = list(good)
        args[i] = t
        with pytest.raises(ValueError):
            step_frames(*args, g.chh, g.cw, g.gly, g.guw)
    with pytest.raises(ValueError):
        step_frames(*good, g.chh, 4096 + 16, g.gly, g.guw)  # > 1024 lanes
    with pytest.raises(ValueError):
        step_frames(*good, g.chh, g.cw, g.gly, g.gcw)  # U's columns past the canvas
    canvas = initial_canvas(g, "cpu")
    for prev in (canvas[:-16], canvas.t(), canvas.to(torch.int16)):
        with pytest.raises(ValueError):
            step_frames(*good, g.chh, g.cw, g.gly, g.guw, prev)


@pytest.mark.parametrize("i", range(8))
def test_step_raises_on_an_input_on_another_device(clip, i):
    """The one check of a whole-clip call refuses an input on another device
    than the units, whichever it is, the starting canvas included."""
    g = clip["g"]
    meta, (dy, dx, hc), qmul = _port_tables(clip)
    args = [torch.from_numpy(clip["units"].view(np.int32)), torch.from_numpy(clip["coff"]),
            dy, dx, hc, meta[3].contiguous(), qmul, initial_canvas(g, "cpu")]
    args[i] = args[i].to("meta")
    with pytest.raises(ValueError, match="one device"):
        step_frames(*args[:7], g.chh, g.cw, g.gly, g.guw, args[7])


# (Y, U, V) q-table indices, frame f taking QIDX[f % 5]: every frame's
# differ from the frame before it, and U != V in four of five
QIDX = [(0, 1, 2), (3, 2, 1), (1, 3, 0), (2, 0, 3), (0, 0, 1)]


@pytest.mark.parametrize("w, h, leading", [(128, 48, "I"), (128, 48, "P"), (136, 90, "P"),
                                           (64, 32, "P")])
def test_step_plain_takes_per_frame_tables_and_a_starting_canvas(w, h, leading):
    """K1's plain version on streams the per-clip set could not take: q-table
    indices per frame and plane, and (leading "P") the first packet cut, so
    frame 0 predicts from the reference framebuffer."""
    data = synth.random_stream(w, h, 6, seed=w + h, keyframes=3, qidx=QIDX)
    if leading == "P":
        info, packets = split_packets(data)
        data = synth.container(w, h, info["qtables"], packets[1:])
    g, args = tdl.upload(tdl.demux_host(data), "cpu")
    ftype = args[5]
    assert (ftype[0].item() == 2) == (leading == "P")
    prev = initial_canvas(g, "cpu") if leading == "P" else None
    got = step_frames_plain(*args, g.chh, g.cw, g.gly, g.guw, prev)
    assert torch.equal(step_frames(*args, g.chh, g.cw, g.gly, g.guw, prev), got)
    _, ry, ru, rv, _ = runtime.ref_decode(data)
    for p, r in zip(tdl.slice_yuv(g, got), (ry, ru, rv)):
        assert np.array_equal(p.numpy(), r)
    # the q-table indices differ per frame and between U and V
    qidx = tdl.unpack_meta(torch.from_numpy(tdl.demux_host(data)[4].astype(np.int32)),
                           g.nb)[4]
    assert len({tuple(q) for q in qidx.tolist()}) > 2 and (qidx[:, 1] != qidx[:, 2]).any()
