"""K1's plain version and the per-clip table builders of pfv_torch against
the JAX package's units path, fed the same tile-demux output.

The JAX builders (_unpack_meta, _pstep_metadata, _pstep_qmul) are closures
of dataloader._make_decoder; the test reaches them through the closure
cells of the jitted entry point, so the reference stays untouched. K1's
plain version is held canvas for canvas against make_step_seq_units in
interpret mode. All comparisons are exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfv_torch import dataloader as tdl
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
    qmul = tdl.dequant_multipliers(torch.from_numpy(c["info"]["qtables"]),
                                   ftype, hc, qidx)
    return (mvx, mvy, hc, ftype, qidx), maps, qmul


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
    assert np.array_equal(qmul.numpy(), np.asarray(jq)[..., 0])


def test_step_plain_matches_units_kernel(clip):
    g = clip["g"]
    assert int(np.diff(clip["coff"]).max()) > 1, "no multi-chunk tile"
    meta, (dy, dx, hc), qmul = _port_tables(clip)
    units = torch.from_numpy(clip["units"].view(np.int32))
    coff = torch.from_numpy(clip["coff"])
    args = (units, coff, dy, dx, hc, meta[3].contiguous(), qmul, g.chh, g.cw,
            g.gly)
    got = step_frames_plain(*args)
    (_, _, _, jft, _), (dyc, dxc, hcc, stab), jq = _jax_tables(clip)
    seq = make_step_seq_units(g.chh, g.cw, g.gly, C=tdl.UNITS_CHUNK,
                              interpret=True)
    want = np.asarray(seq(jnp.asarray(clip["units"]), jnp.asarray(clip["coff"]),
                          dyc, dxc, hcc, jft.astype(jnp.int32), stab, jq))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
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
            step_frames(*args, g.chh, g.cw, g.gly)
    with pytest.raises(ValueError):
        step_frames(*good, g.chh, 4096 + 16, g.gly)  # > 1024 lanes


@pytest.mark.parametrize("i", range(7))
def test_step_raises_on_an_input_on_another_device(clip, i):
    """The one check of a whole-clip call refuses an input on another device
    than the units, whichever it is."""
    g = clip["g"]
    meta, (dy, dx, hc), qmul = _port_tables(clip)
    args = [torch.from_numpy(clip["units"].view(np.int32)), torch.from_numpy(clip["coff"]),
            dy, dx, hc, meta[3].contiguous(), qmul]
    args[i] = args[i].to("meta")
    with pytest.raises(ValueError, match="one device"):
        step_frames(*args, g.chh, g.cw, g.gly)
