"""The dense route of pfv_torch against the JAX package's scatter-fed pstep
path: the demux tables, the device densify, K3's and K4's plain versions
and the GOP decode, fed the same pstep demux output. All comparisons are
exact.

The clip: 256x128, 8 frames, a keyframe every 4 (two GOPs), quality 1, so
that coefficients span several i8 units. The JAX builders
(_densify_units_pstep, _pstep_metadata, _pstep_qmul) are closures of
dataloader._make_decoder, reached through the jitted entry point's closure
cells as tests/test_torch_step.py reaches them; K3's reference is
make_step_seq and K4's make_step, both in interpret mode. The JAX kernels
take one multiplier set per clip, the port's one (3, 64) table per frame:
the clip's q-table indices are uniform, so its tables equal the JAX set
broadcast to (F, 3, 64), and the plain versions fed either equal the JAX
kernels. 4112-wide random streams with q-table indices per frame and
plane (U != V), and with a leading P-frame predicted from the starting
canvas, are held to `runtime.ref_decode`, whole and cut into chunks."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfv_torch import dataloader as tdl
from pfv_torch import synth
from pfv_torch.dec import split_packets
from pfv_torch.frame import initial_canvas
from pfv_torch.kernels.dense_step import (seq_frames_dense, seq_frames_dense_plain,
                                          step_frames_batched_plain, step_gops,
                                          step_gops_plain)
from pfv_tpu import dataloader as jdl
from pfv_tpu import runtime
from pfv_tpu.encoding import encode_video
from pfv_tpu.ops.pallas.step_kernel import make_step, make_step_seq
from pfv_tpu.utils.synth import synth_yuv_frame

W, H, FRAMES, KEY = 256, 128, 8, 4
# (Y, U, V) q-table indices of the random streams, frame f taking
# QIDX[f % 5]: every frame's differ from the frame before it, U != V in four
QIDX = [(0, 1, 2), (3, 2, 1), (1, 3, 0), (2, 0, 3), (0, 0, 1)]


def _closure(fn, name):
    fn = getattr(fn, "__wrapped__", fn)
    return dict(zip(fn.__code__.co_freevars, fn.__closure__))[name].cell_contents


@pytest.fixture(scope="module")
def clip():
    ys, us, vs = map(np.stack, zip(*[synth_yuv_frame(t + 2, W, H)
                                     for t in range(FRAMES)]))
    data = encode_video(ys, us, vs, 30, quality=1, keyframes=KEY)
    host = tdl.demux_host_packed(data)
    info, g, deltas, vals, meta = host
    dec = jdl.get_decoder(W, H, info["qtables"], "pstep")
    packed = dec.decode_yuv_packed
    canvases = _closure(_closure(packed, "decode_yuv_impl_pstep"), "_pstep_canvases")
    jmeta = _closure(packed, "_unpack_meta")(jnp.asarray(meta))
    mvx, mvy, hc, ftype, qidx = jmeta
    dyc, dxc, hcc, stab = _closure(canvases, "_pstep_metadata")(mvx, mvy, hc)
    jq = _closure(canvases, "_pstep_qmul")(ftype.astype(jnp.int32), hc, qidx)
    jdense = _closure(packed, "_densify_units_pstep")(
        jnp.asarray(deltas), jnp.asarray(vals), FRAMES)
    g_, (coeffs, mvx_t, mvy_t, hc_t, ftype_t, qmul) = tdl.upload_packed(host, device="cpu")
    maps = tdl.block_maps(g, mvx_t, mvy_t, hc_t)
    return dict(data=data, host=host, g=g, coeffs=coeffs, maps=maps, ftype=ftype_t,
                qmul=qmul, jdense=jdense, jmaps=(dyc, dxc, hcc, stab), jq=jq,
                jftype=ftype.astype(jnp.int32))


def broadcast_clip_set(jq, ftype) -> torch.Tensor:
    """The JAX per-clip multipliers (2, 2, 64, 1) [I/P][luma/chroma] ->
    (F, 3, 64): frame f's Y row the luma set of its type, U and V rows the
    chroma set."""
    jq = torch.from_numpy(np.array(jq)[..., 0])
    mode = (torch.as_tensor(np.array(ftype)).long() != 1).long()
    return jq[mode][:, [0, 1, 1]].contiguous()


def _one_step(prev, coeffs, dy, dx, hc, ftype, qmul, chh, cw, gly, guw, out=None):
    """One step of `step_gops` for B frames, each from prev[b]: a call on
    [:, l:l+1] views of (B, 1, ...) tensors."""
    return step_gops(*(t.unsqueeze(1) for t in (coeffs, dy, dx, hc, ftype, qmul)),
                     chh, cw, gly, guw, prev=prev,
                     out=None if out is None else out.unsqueeze(1))[:, 0]


def test_pstep_tables_match_jax():
    for w, h in ((256, 128), (128, 96), (136, 90), (1920, 1080), (4112, 32),
                 (7680, 4320)):
        want = jdl._pstep_tables(w, h)
        got = tdl.pstep_tables(tdl.geometry(w, h))
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert got[2] == want[2]


def test_densify_matches_jax(clip):
    vals = clip["host"][3]
    assert np.abs(vals.astype(np.int32)).max() == 127, "no multi-unit coefficient"
    want = np.asarray(clip["jdense"])
    got = clip["coeffs"]
    assert got.dtype == torch.int16 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


def test_k3_plain_matches_make_step_seq(clip):
    g = clip["g"]
    dyc, dxc, hcc, stab = clip["jmaps"]
    seq = make_step_seq(g.chh, g.cw, g.gly, interpret=True, ladder="plain", sb=1)
    want = np.asarray(seq(clip["jdense"], dyc, dxc, hcc, clip["jftype"], stab,
                          clip["jq"]))
    clip_set = broadcast_clip_set(clip["jq"], clip["jftype"])
    assert torch.equal(clip["qmul"], clip_set)
    args = (clip["coeffs"], *clip["maps"], clip["ftype"], clip["qmul"], g.chh,
            g.cw, g.gly, g.guw)
    got = seq_frames_dense_plain(*args)
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    assert torch.equal(seq_frames_dense_plain(*args[:5], clip_set, *args[6:]), got)
    # the wrapper takes the plain version for a CPU tensor, without a launch
    before = seq_frames_dense.launches
    assert torch.equal(seq_frames_dense(*args), got)
    assert seq_frames_dense.launches == before
    _, ry, ru, rv, _ = runtime.ref_decode(clip["data"])
    for p, r in zip(tdl.slice_yuv(g, got), (ry, ru, rv)):
        assert np.array_equal(p.numpy(), r)


def test_k4_plain_batched_over_gops_matches_make_step(clip):
    g = clip["g"]
    dyc, dxc, hcc, stab = clip["jmaps"]
    step = make_step(g.chh, g.cw, g.gly, interpret=True, ladder="plain")
    canvas, want = jnp.zeros((g.chh, g.cw), jnp.uint8), []
    for f in range(FRAMES):
        canvas = step(canvas, clip["jdense"][f], dyc[f], dxc[f], hcc[f],
                      clip["jftype"][f], stab[f], clip["jq"])
        want.append(np.asarray(canvas))
    n_gops = FRAMES // KEY
    coeffs = clip["coeffs"].view(n_gops, KEY, 64, -1)
    dy, dx, hc = (m.view(n_gops, KEY, g.gch, g.gcw) for m in clip["maps"])
    ft = clip["ftype"].view(n_gops, KEY)
    qm = broadcast_clip_set(clip["jq"], clip["jftype"]).view(n_gops, KEY, 3, 64)
    out = torch.empty((n_gops, KEY, g.chh, g.cw), dtype=torch.uint8)
    # a P-frame reads its explicit previous canvas: random for the first step
    prev = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (n_gops, g.chh, g.cw), dtype=np.uint8))
    before = step_gops.launches
    for l in range(KEY):
        one = slice(l, l + 1)
        got = step_gops(coeffs[:, one], dy[:, one], dx[:, one], hc[:, one], ft[:, one],
                        qm[:, one], g.chh, g.cw, g.gly, g.guw, prev=prev, out=out[:, one])
        assert got.data_ptr() == out[:, l].data_ptr()
        args = (prev, coeffs[:, l], dy[:, l], dx[:, l], hc[:, l], ft[:, l],
                qm[:, l], g.chh, g.cw, g.gly, g.guw)
        assert torch.equal(step_frames_batched_plain(*args), out[:, l])
        prev = out[:, l]
    assert step_gops.launches == before
    assert np.array_equal(out.view(FRAMES, g.chh, g.cw).numpy(), np.stack(want))


def test_k4_rejects_what_the_kernel_cannot_take(clip):
    g = clip["g"]
    dy, dx, hc = (m[:2] for m in clip["maps"])
    canv = torch.zeros((3, g.chh, g.cw), dtype=torch.uint8)
    good = [canv[:2], clip["coeffs"][:2], dy, dx, hc, clip["ftype"][:2], clip["qmul"][:2]]
    bad = {
        0: canv[:2].transpose(1, 2),
        1: clip["coeffs"][:2, :, :-1],
        2: dy.to(torch.int32),
        5: clip["ftype"][:2].to(torch.int64),
        6: clip["qmul"][:1],
    }
    for i, t in bad.items():
        args = list(good)
        args[i] = t
        with pytest.raises(ValueError):
            _one_step(*args, g.chh, g.cw, g.gly, g.guw)
    for out in (canv[:2], canv[1:]):  # in place, or overlapping by one canvas
        with pytest.raises(ValueError, match="overlaps"):
            _one_step(*good, g.chh, g.cw, g.gly, g.guw, out=out)
    with pytest.raises(ValueError):
        seq_frames_dense(clip["coeffs"][:, :, ::2], *clip["maps"], clip["ftype"],
                         clip["qmul"], g.chh, g.cw, g.gly, g.guw)
    # K3's starting canvas: one (chh, cw) canvas apart from out
    out = torch.empty((FRAMES + 1, g.chh, g.cw), dtype=torch.uint8)
    args = (clip["coeffs"], *clip["maps"], clip["ftype"], clip["qmul"], g.chh, g.cw,
            g.gly, g.guw)
    for prev, o in ((canv[:2], None), (out[1], out[1:]), (out[0].t(), out[1:])):
        with pytest.raises(ValueError):
            seq_frames_dense(*args, prev=prev, out=o)
    assert seq_frames_dense(*args, prev=out[0], out=out[1:]).data_ptr() == out[1].data_ptr()


def _jax_gops(data, want):
    env = {"PFV_STEP": "1", "PFV_SEQ": "0", "PFV_LADDER": "plain"}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        jdl._make_decoder.cache_clear()
        try:
            info, args = jdl._demux_packed_to_device(data, 0)
            assert info["decode_mode"] == "pstep" and info["gop_shape"] == (2, KEY)
            dec = jdl.get_decoder(W, H, info["qtables"], info["decode_mode"])
            return dec.decode_packed_gops(*args, 2, KEY, want)
        finally:
            jdl._make_decoder.cache_clear()


@pytest.mark.parametrize("want", ["yuv", "rgba", "checksums"])
def test_decode_packed_gops_matches_jax(clip, want):
    before = step_gops.launches
    got = tdl.decode_packed_gops(clip["host"], 2, KEY, want, device="cpu")
    assert step_gops.launches == before
    ref = _jax_gops(clip["data"], want)
    if want == "yuv":
        for p, r in zip(got, ref):
            assert np.array_equal(p.numpy(), np.asarray(r))
    elif want == "rgba":
        assert np.array_equal(got.view(torch.int32).numpy().view(np.uint32),
                              np.asarray(ref))
    else:
        assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(ref))


def test_decode_packed_gops_rejects_a_wrong_gop_shape(clip):
    for g, l in ((2, 3), (1, KEY), (3, KEY)):
        with pytest.raises(ValueError):
            tdl.decode_packed_gops(clip["host"], g, l, "yuv", device="cpu")


def test_k4_whole_gops_plain_matches_make_step_under_vmap_of_scan(clip):
    """`step_gops` over (G, L, ...) tensors, each GOP from a random canvas,
    against make_step run as a lax.scan over the steps under vmap over the
    GOPs."""
    import jax

    g = clip["g"]
    n_gops = FRAMES // KEY
    dyc, dxc, hcc, stab = clip["jmaps"]
    step = make_step(g.chh, g.cw, g.gly, interpret=True, ladder="plain")
    prev = np.random.default_rng(1).integers(0, 256, (n_gops, g.chh, g.cw),
                                             dtype=np.uint8)

    def gop(canvas, *xs):
        def body(c, x):
            c = step(c, *x, clip["jq"])
            return c, c
        return jax.lax.scan(body, canvas, xs)[1]

    per_gop = [jnp.reshape(a, (n_gops, KEY) + a.shape[1:]) for a in
               (clip["jdense"], dyc, dxc, hcc, clip["jftype"], stab)]
    want = np.asarray(jax.vmap(gop)(jnp.asarray(prev), *per_gop))
    coeffs = clip["coeffs"].view(n_gops, KEY, 64, -1)
    maps = [m.view(n_gops, KEY, g.gch, g.gcw) for m in clip["maps"]]
    assert torch.equal(clip["qmul"], broadcast_clip_set(clip["jq"], clip["jftype"]))
    args = (coeffs, *maps, clip["ftype"].view(n_gops, KEY),
            clip["qmul"].view(n_gops, KEY, 3, 64), g.chh, g.cw, g.gly, g.guw)
    before = step_gops.launches
    got = step_gops(*args, prev=torch.from_numpy(prev))
    assert step_gops.launches == before
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    # without prev, step 0 predicts from zeros; into a given out, in place
    out = torch.empty((n_gops, KEY, g.chh, g.cw), dtype=torch.uint8)
    assert step_gops(*args, out=out).data_ptr() == out.data_ptr()
    zeros = np.asarray(jax.vmap(gop)(jnp.zeros_like(jnp.asarray(prev)), *per_gop))
    assert np.array_equal(out.numpy(), zeros)
    assert torch.equal(step_gops_plain(*args), out)


def _gop_args(clip):
    g = clip["g"]
    n_gops = FRAMES // KEY
    canv = torch.zeros((n_gops, g.chh, g.cw), dtype=torch.uint8)
    return dict(coeffs=clip["coeffs"].view(n_gops, KEY, 64, -1),
                dy=clip["maps"][0].view(n_gops, KEY, g.gch, g.gcw),
                dx=clip["maps"][1].view(n_gops, KEY, g.gch, g.gcw),
                hc=clip["maps"][2].view(n_gops, KEY, g.gch, g.gcw),
                ftype=clip["ftype"].view(n_gops, KEY),
                qmul=clip["qmul"].view(n_gops, KEY, 3, 64), prev=canv,
                out=torch.empty((n_gops, KEY, g.chh, g.cw), dtype=torch.uint8))


def _offset(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A copy of t in a buffer that starts nbytes past an aligned one."""
    buf = torch.zeros(t.numel() * t.element_size() + 64, dtype=torch.uint8)
    off = (-buf.data_ptr()) % 64 + nbytes
    view = buf[off:off + t.numel() * t.element_size()].view(t.dtype).view(t.shape)
    view.copy_(t)
    return view


BAD_GOP_INPUTS = {
    "coeffs dtype": lambda a: {"coeffs": a["coeffs"].to(torch.int32)},
    "coeffs shape": lambda a: {"coeffs": a["coeffs"][:, :, :, :-16]},
    "dy dtype": lambda a: {"dy": a["dy"].to(torch.int32)},
    "hc shape": lambda a: {"hc": a["hc"][..., :-1].contiguous()},
    "ftype dtype": lambda a: {"ftype": a["ftype"].to(torch.int64)},
    "qmul shape": lambda a: {"qmul": a["qmul"][:1]},
    "qmul items not contiguous": lambda a: {"qmul": a["qmul"].transpose(2, 3)},
    "prev shape": lambda a: {"prev": a["prev"][:1]},
    "canvas items not contiguous": lambda a: {"out": a["out"].transpose(2, 3)},
    "maps with other batch strides": lambda a: {
        "dx": torch.cat([a["dx"], a["dx"]], 1)[:, :KEY]},
    "prev overlaps out": lambda a: {"prev": a["out"][:, 0]},
    "out canvases share bytes": lambda a: {
        "out": a["out"][:, :1].expand(a["out"].shape)},
    "unaligned canvas view": lambda a: {"out": _offset(a["out"], 8)},
    "unaligned prev view": lambda a: {"prev": _offset(a["prev"], 4)},
    "unaligned coefficients": lambda a: {"coeffs": _offset(a["coeffs"], 2)},
    "mixed devices": lambda a: {"hc": a["hc"].to("meta")},
}


@pytest.mark.parametrize("case", sorted(BAD_GOP_INPUTS))
def test_k4_whole_gops_checks_raise_once_per_call(clip, case):
    """Every input that the per-step checks refused, refused by the one
    check of a whole-GOP call (and, where the input has a per-step form,
    by a one-step call on [:, :1] views too)."""
    g = clip["g"]
    args = _gop_args(clip)
    args.update(BAD_GOP_INPUTS[case](args))
    names = ("coeffs", "dy", "dx", "hc", "ftype", "qmul")
    with pytest.raises(ValueError):
        step_gops(*(args[k] for k in names), g.chh, g.cw, g.gly, g.guw, prev=args["prev"],
                  out=args["out"])
    step = {k: args[k][:, :1] if k != "prev" else args[k] for k in args}
    if case != "out canvases share bytes":
        with pytest.raises(ValueError):
            step_gops(*(step[k] for k in names), g.chh, g.cw, g.gly, g.guw,
                      prev=step["prev"], out=step["out"])
    if case in ("coeffs dtype", "dy dtype", "unaligned coefficients", "mixed devices",
                "qmul items not contiguous"):
        flat = {k: args[k].reshape((-1,) + args[k].shape[2:]) for k in names}
        with pytest.raises(ValueError):
            seq_frames_dense(*(flat[k] for k in names), g.chh, g.cw, g.gly, g.guw)


def _wide_stream(frames: int, keyframes: int, leading: str) -> bytes:
    """A 4112x32 random stream on QIDX; for leading "P" without its first
    packet, so that frame 0 is a P-frame."""
    data = synth.random_stream(4112, 32, frames + (leading == "P"), seed=frames,
                               keyframes=keyframes, qidx=QIDX)
    if leading == "I":
        return data
    info, packets = split_packets(data)
    return synth.container(4112, 32, info["qtables"], packets[1:])


@pytest.mark.parametrize("leading", ["I", "P"])
def test_k3_plain_takes_per_frame_tables_a_starting_canvas_and_chunks(leading):
    """K3's plain version on a stream the per-clip set could not take (q-table
    indices per frame and plane, U != V; frame 0 a P-frame predicted from the
    reference framebuffer), whole and cut at frames 3 and 5 (inside a GOP
    and at a keyframe), each piece from the last canvas of the one before:
    all equal `ref_decode`."""
    data = _wide_stream(8, 5 + (leading == "P"), leading)
    g, (coeffs, mvx, mvy, hc, ftype, qmul) = tdl.upload_packed(tdl.demux_host_packed(data),
                                                               device="cpu")
    assert (ftype[0].item() == 2) == (leading == "P") and ftype[5].item() == 1
    assert (qmul[:, 1] != qmul[:, 2]).any() and not (qmul[1:] == qmul[:-1]).all()
    maps = tdl.block_maps(g, mvx, mvy, hc)
    start = initial_canvas(g, "cpu") if leading == "P" else None
    dims = (g.chh, g.cw, g.gly, g.guw)
    whole = seq_frames_dense_plain(coeffs, *maps, ftype, qmul, *dims, prev=start)
    _, ry, ru, rv, _ = runtime.ref_decode(data)
    for p, r in zip(tdl.slice_yuv(g, whole), (ry, ru, rv)):
        assert np.array_equal(p.numpy(), r)
    out = torch.empty_like(whole)
    prev = start
    for a, b in ((0, 3), (3, 5), (5, 8)):
        piece = [t[a:b] for t in (coeffs, *maps, ftype, qmul)]
        assert seq_frames_dense(*piece, *dims, prev=prev, out=out[a:b]).data_ptr() == \
            out[a].data_ptr()
        prev = out[b - 1]
    assert torch.equal(out, whole)


def test_k4_plain_takes_per_frame_tables():
    """K4's plain version, G GOPs side by side, on q-table indices per frame
    and plane: equal to `ref_decode`, and step by step to the batched
    plain step."""
    data = _wide_stream(9, 3, "I")
    host = tdl.demux_host_packed(data)
    g, f, per_step, qmul = tdl.upload_gops(host, 3, 3, device="cpu")
    assert qmul.shape == (3, 3, 3, 64) and (qmul[..., 1, :] != qmul[..., 2, :]).any()
    dims = (g.chh, g.cw, g.gly, g.guw)
    got = step_gops(*per_step, qmul, *dims)
    _, ry, ru, rv, _ = runtime.ref_decode(data)
    for p, r in zip(tdl.slice_yuv(g, got.view(-1, g.chh, g.cw)), (ry, ru, rv)):
        assert np.array_equal(p.numpy(), r)
    prev = torch.zeros((3, g.chh, g.cw), dtype=torch.uint8)
    for l in range(3):
        step = step_frames_batched_plain(prev, *(t[:, l] for t in per_step), qmul[:, l], *dims)
        assert torch.equal(step, got[:, l])
        prev = step
