"""The port's forward transform, quantization and K6's plain versions
(pfv_torch.kernels.fdct) against the JAX package: the jnp ops, the Pallas
forward-DCT kernel in interpret mode (as tests/test_pallas.py runs it) and
pfv_tpu.ops.pframe's delta encode; the division by a reciprocal that kernel
K6 uses against the truncating division, for every numerator; the
frame-encode step's plain version on fused-canvas frames against the JAX
package's per-plane encode, and what its wrapper refuses; and
pfv_torch.synth's source frames against pfv_tpu.utils.synth. Inputs come
from numpy seeds; every comparison is exact (tolerance 0: the codec is
integer)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfv_torch import device as tdevice
from pfv_torch import synth as tsynth
from pfv_torch.frame import canvas_layout, canvas_planes, geometry
from pfv_torch.kernels import fdct as k6
from pfv_torch.ops.blocks import block_origins
from pfv_torch.ops import color as tcolor
from pfv_torch.ops import dct as tdct
from pfv_torch.ops import pframe as tpframe
from pfv_torch.ops import quant as tquant
from pfv_tpu.ops import color as jcolor
from pfv_tpu.ops import blocks as jblocks
from pfv_tpu.ops import dct as jdct
from pfv_tpu.ops import pframe as jpframe
from pfv_tpu.ops import quant as jquant
from pfv_tpu.ops.iframe import encode_blocks as jax_encode_blocks
from pfv_tpu.ops.pallas.dct_kernel import encode_blocks_pallas
from pfv_tpu.utils import synth as jsynth

PATTERNS = ["zeros", "max", "checker", "impulse", "vstripes"]


def _i32(rng, shape, lo, hi):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def _pattern_blocks(pattern: str) -> np.ndarray:
    """(6, 16, 16) u8 blocks of the adversarial patterns of
    tests/test_property.py (max high-frequency energy included)."""
    y = np.zeros((32, 48), np.uint8)
    if pattern == "max":
        y[:] = 255
    elif pattern == "checker":
        y[::2, ::2] = 255
        y[1::2, 1::2] = 255
    elif pattern == "impulse":
        y[7, 11] = 255
    elif pattern == "vstripes":
        y[:, ::2] = 255
    return y.reshape(2, 16, 3, 16).transpose(0, 2, 1, 3).reshape(6, 16, 16)


def _pallas_encode(blocks, q):
    return np.asarray(jax.jit(encode_blocks_pallas)(jnp.asarray(blocks), jnp.asarray(q)))


def _jax_delta(cur, win, q):
    res = jpframe.calc_residuals(jnp.asarray(cur), jnp.asarray(win))
    return np.asarray(jpframe.encode_delta_blocks(res, jnp.asarray(q)))


@pytest.mark.parametrize("lo,hi", [(-65280, 65281), (-(1 << 31), 1 << 31)])
def test_fdct8_and_fdct2d_match_jax(lo, hi):
    # the full int32 range exercises wrapping adds in both implementations
    rng = np.random.default_rng(hi)
    x = _i32(rng, (512, 8), lo, hi)
    assert np.array_equal(tdct.fdct8(torch.from_numpy(x)).numpy(),
                          np.asarray(jdct.fdct8(jnp.asarray(x))))
    m = _i32(rng, (64, 8, 8), lo, hi)
    assert np.array_equal(tdct.fdct2d(torch.from_numpy(m)).numpy(),
                          np.asarray(jdct.fdct2d(jnp.asarray(m))))
    # rows first: the other order differs (the truncations are not linear)
    other = tdct.fdct8_dim(tdct.fdct8_dim(torch.from_numpy(m), -2), -1)
    assert not torch.equal(other, tdct.fdct2d(torch.from_numpy(m)))


@pytest.mark.parametrize("per_block", [False, True])
def test_quantize_and_trunc_div_match_jax(per_block):
    rng = np.random.default_rng(3 + per_block)
    m = _i32(rng, (50, 4, 64), -(1 << 22), 1 << 22)
    shape = (50, 1, 64) if per_block else (64,)
    q = rng.integers(1, 200, size=shape).astype(np.int32)
    got = tquant.quantize(torch.from_numpy(m), torch.from_numpy(q))
    want = jquant.quantize(jnp.asarray(m), jnp.asarray(q))
    assert got.dtype == torch.int16 and np.array_equal(got.numpy(), np.asarray(want))
    n, d = _i32(rng, 4096, -(1 << 31) + 1, 1 << 31), _i32(rng, 4096, 1, 300)
    assert np.array_equal(
        tquant.trunc_div(torch.from_numpy(n), torch.from_numpy(d)).numpy(),
        np.asarray(jquant.trunc_div(jnp.asarray(n), jnp.asarray(d))))


def test_q_tables_match_jax():
    for name in ("DCT_SCALE_FACTOR", "Q_TABLE_INTRA", "Q_TABLE_INTER", "ZIGZAG_TABLE",
                 "INV_ZIGZAG_TABLE"):
        assert np.array_equal(getattr(tquant, name), getattr(jquant, name)), name
    for quality in range(11):
        got, want = tquant.derive_q_tables(quality), jquant.derive_q_tables(quality)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == np.int32 and np.array_equal(got[k], want[k]), (quality, k)
    for bad in (-1, 11):
        with pytest.raises(ValueError):
            tquant.derive_q_tables(bad)


@pytest.mark.parametrize("n", [1, 7, 128, 300])
def test_k6_plain_intra_matches_pallas_and_jax(n):
    rng = np.random.default_rng(40 + n)
    blocks = rng.integers(0, 256, size=(n, 16, 16), dtype=np.uint8)
    q = jquant.derive_q_tables(n % 11)["intra_l" if n % 2 else "intra_c"]
    got = k6.encode_blocks_plain(torch.from_numpy(blocks), torch.from_numpy(q))
    assert got.dtype == torch.int16 and tuple(got.shape) == (n, 4, 64)
    assert np.array_equal(got.numpy(), _pallas_encode(blocks, q))
    assert np.array_equal(got.numpy(), np.asarray(
        jax_encode_blocks(jnp.asarray(blocks), jnp.asarray(q))))
    # the wrapper takes the plain version for a CPU tensor, as does _best
    for fn in (k6.fdct_blocks, tdevice.encode_blocks_best):
        assert torch.equal(fn(torch.from_numpy(blocks), torch.from_numpy(q)), got)


@pytest.mark.parametrize("n", [1, 7, 300])
def test_k6_plain_delta_matches_jax(n):
    rng = np.random.default_rng(60 + n)
    cur = rng.integers(0, 256, size=(n, 16, 16), dtype=np.uint8)
    win = rng.integers(0, 256, size=(n, 16, 16), dtype=np.uint8)
    q = rng.integers(1, 40, size=64).astype(np.int32)
    args = (torch.from_numpy(cur), torch.from_numpy(win), torch.from_numpy(q))
    got = k6.encode_delta_blocks_plain(*args)
    assert got.dtype == torch.int16 and np.array_equal(got.numpy(), _jax_delta(cur, win, q))
    assert torch.equal(k6.fdct_blocks(args[0], args[2], args[1]), got)
    res = tpframe.calc_residuals(args[0], args[1])
    assert np.array_equal(res.numpy(), np.asarray(
        jpframe.calc_residuals(jnp.asarray(cur), jnp.asarray(win))))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_k6_plain_on_extreme_patterns(pattern):
    blocks = _pattern_blocks(pattern)
    inv = (255 - blocks).astype(np.uint8)
    for quality in (0, 5, 10):
        qt = jquant.derive_q_tables(quality)
        for q in (qt["intra_l"], qt["intra_c"]):
            got = k6.fdct_blocks(torch.from_numpy(blocks), torch.from_numpy(q))
            assert np.array_equal(got.numpy(), _pallas_encode(blocks, q)), quality
        for q in (qt["inter_l"], qt["inter_c"]):
            # residuals at both clamps: the pattern against its inverse
            for cur, win in ((blocks, inv), (inv, blocks)):
                got = k6.fdct_blocks(torch.from_numpy(cur), torch.from_numpy(q),
                                     torch.from_numpy(win))
                assert np.array_equal(got.numpy(), _jax_delta(cur, win, q)), quality


# every divisor up to 1024, then the powers of two and the limit with their
# neighbours, and a spread between
Q_RANGES = [(lo, lo + 128) for lo in range(1, 1025, 128)]
Q_LARGE = sorted({q for k in range(10, 16) for q in (2**k - 1, 2**k, 2**k + 1)}
                 | {1025, 1536, 3000, 5003, 10007, 20011, 40009, 50000, 65521, 65534,
                    65535, tquant.Q_MAX})


@pytest.mark.parametrize("qs", Q_RANGES + [Q_LARGE],
                         ids=[f"q{lo}-{hi - 1}" for lo, hi in Q_RANGES] + ["large"])
def test_division_by_reciprocal_is_the_truncating_division(qs):
    """Every numerator the quantizer can see (an int32 shifted right by 16)
    against every divisor of the range: the multiply K6 divides with equals
    `trunc_div`."""
    q = np.arange(*qs) if isinstance(qs, tuple) else np.array(qs)
    n = torch.arange(-32768, 32768, dtype=torch.int32)[:, None]
    recip = tquant.reciprocals(q)
    assert recip.dtype == np.uint32 and np.array_equal(
        recip.astype(np.int64), -(-(2**31) // q.astype(np.int64)))
    got = tquant.trunc_div_by_reciprocal(n, torch.from_numpy(recip.astype(np.int64)))
    want = tquant.trunc_div(n, torch.from_numpy(q.astype(np.int32)))
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("bad", [0, -3, 65536, 1 << 20])
def test_reciprocals_refuse_divisors_out_of_range(bad):
    q = np.full(64, 16, dtype=np.int32)
    q[17] = bad
    with pytest.raises(ValueError):
        tquant.reciprocals(q)
    with pytest.raises(ValueError):
        k6.FrameEncode(q, [(0, 0, 0, 16, 16)], "cpu")
    with pytest.raises(ValueError):
        k6.fdct_blocks(torch.zeros((1, 16, 16), dtype=torch.uint8), torch.from_numpy(q))


@pytest.mark.parametrize("quality", [0, 5, 10])
def test_quantize_by_reciprocal_matches_jax(quality):
    rng = np.random.default_rng(quality)
    m = _i32(rng, (40, 4, 64), -(1 << 31), 1 << 31)
    m[:4] = _i32(rng, (4, 4, 64), -(1 << 22), 1 << 22)  # what the transform gives
    # the extremes of the int32 range and of the numerator after the scale
    m[4, 0], m[4, 1], m[4, 2], m[4, 3] = -(1 << 31), (1 << 31) - 1, 0, -1
    for k, q in jquant.derive_q_tables(quality).items():
        got = tquant.quantize_by_reciprocal(torch.from_numpy(m), torch.from_numpy(q))
        want = np.asarray(jquant.quantize(jnp.asarray(m), jnp.asarray(q)))
        assert got.dtype == torch.int16 and np.array_equal(got.numpy(), want), k
        assert torch.equal(got, tquant.quantize(torch.from_numpy(m), torch.from_numpy(q)))


def _encode_frame(w, h, seed, intra):
    """A frame to encode at geometry w x h: (geometry, the three padded u8
    source planes, (mvy, mvx, hc) with random vectors kept in their planes
    and random flags, or None, (4, 64) q-tables, previous canvas)."""
    rng = np.random.default_rng(seed)
    g = geometry(w, h)
    src = [rng.integers(0, 256, size=s, dtype=np.uint8)
           for s in ((g.ly0, g.lyw), (g.lc0, g.lcw), (g.lc0, g.lcw))]
    prev = rng.integers(0, 256, size=(g.chh, g.cw), dtype=np.uint8)
    qtables = rng.integers(1, 60, size=(4, 64)).astype(np.int32)
    motion = None
    if not intra:
        mvy, mvx = (rng.integers(-20, 21, g.nb) for _ in range(2))
        for first, _, _, ph, pw in canvas_layout(g):
            by, bx = block_origins(ph, pw)
            sl = slice(first, first + len(by))
            mvy[sl] = np.clip(mvy[sl], -by, ph - 16 - by)
            mvx[sl] = np.clip(mvx[sl], -bx, pw - 16 - bx)
        hc = (rng.random(g.nb) < 0.6).astype(np.uint8)
        motion = tuple(torch.from_numpy(a) for a in (mvy.astype(np.int8),
                                                     mvx.astype(np.int8), hc))
    return g, [torch.from_numpy(p) for p in src], motion, qtables, torch.from_numpy(prev)


@pytest.mark.parametrize("intra", [True, False], ids=["I", "P"])
@pytest.mark.parametrize("w,h", [(48, 32), (136, 90)])
def test_frame_encode_matches_jax_per_plane(w, h, intra):
    g, src, motion, qtables, prev = _encode_frame(w, h, 3 * w + h + intra, intra)
    qidx = (1, 3, 0)  # U and V on different tables
    step = k6.FrameEncode(qtables, canvas_layout(g), "cpu")
    out = step(src, motion, qidx, prev, torch.full((g.nb, 256), 7, dtype=torch.int16))
    for (first, *_), plane, ref, qi in zip(canvas_layout(g), src, canvas_planes(g, prev),
                                           qidx):
        blocks = jblocks.plane_to_blocks(jnp.asarray(plane.numpy()))
        n, q = blocks.shape[0], jnp.asarray(qtables[qi])
        if intra:
            want = np.asarray(jax_encode_blocks(blocks, q))
        else:
            mvy, mvx, hc = (t[first:first + n].numpy() for t in motion)
            by, bx = block_origins(*plane.shape)
            win = np.stack([ref.numpy()[y:y + 16, x:x + 16]
                            for y, x in zip(by + mvy, bx + mvx)])
            want = _jax_delta(np.asarray(blocks), win, qtables[qi])
            want = want * (hc != 0)[:, None, None]  # skipped blocks zeroed
            assert want[hc != 0].any()
        assert np.array_equal(out[first:first + n].numpy(), want.reshape(n, 256))
    # the plain version alone, its origins made here, and strided sources
    canvas = torch.zeros((g.chh, g.cw), dtype=torch.uint8)
    for view, plane in zip(canvas_planes(g, canvas), src):
        view.copy_(plane)
    again = k6.frame_encode_plain(canvas_planes(g, canvas), motion,
                                  torch.from_numpy(qtables), qidx, step.layout, prev,
                                  torch.empty_like(out))
    assert torch.equal(again, out)


def test_frame_encode_takes_the_frame_steps_rule_for_vectors_off_the_plane():
    """Any int8 vector: the window starts where K7 and the frame step put
    it (`gather_predictions`), so encode and in-loop decode agree."""
    g, src, motion, qtables, prev = _encode_frame(96, 64, 5, False)
    rng = np.random.default_rng(6)
    motion = (*(torch.from_numpy(rng.integers(-128, 128, g.nb).astype(np.int8))
                for _ in range(2)), torch.ones(g.nb, dtype=torch.uint8))
    qidx = (2, 3, 3)
    out = k6.FrameEncode(qtables, canvas_layout(g), "cpu")(
        src, motion, qidx, prev, torch.empty((g.nb, 256), dtype=torch.int16))
    for (first, *_), plane, ref, qi in zip(canvas_layout(g), src, canvas_planes(g, prev),
                                           qidx):
        ph, pw = plane.shape
        by, bx = block_origins(ph, pw)
        n = len(by)
        sy, sx = (np.clip(np.where(s < 0, s + lim, s), 0, lim - 16) for s, lim in (
            (by + motion[0][first:first + n].numpy().astype(np.int32), ph),
            (bx + motion[1][first:first + n].numpy().astype(np.int32), pw)))
        win = np.stack([ref.numpy()[y:y + 16, x:x + 16] for y, x in zip(sy, sx)])
        want = _jax_delta(np.asarray(jblocks.plane_to_blocks(jnp.asarray(plane.numpy()))),
                          win, qtables[qi])
        assert np.array_equal(out[first:first + n].numpy(), want.reshape(n, 256))


@pytest.mark.parametrize("bad", [
    "src_dtype", "src_columns_strided", "src_rows_unaligned", "src_small", "src_count",
    "out_dtype", "out_shape", "out_short", "out_unaligned", "out_overlaps_prev",
    "out_overlaps_source", "motion_dtype", "motion_short", "motion_strided",
    "motion_without_prev", "prev_small", "prev_unaligned", "prev_dtype", "qidx_range",
    "qidx_count", "mixed_devices", "layout_unaligned", "layout_planes"])
def test_frame_encode_refuses_what_the_kernel_cannot_take(bad):
    g, src, motion, qtables, prev = _encode_frame(48, 32, 1, False)
    layout = canvas_layout(g)
    out = torch.zeros((g.nb, 256), dtype=torch.int16)
    qidx = (0, 1, 1)
    step = k6.FrameEncode(qtables, layout, "cpu")
    step(src, motion, qidx, prev, out)  # the good call passes
    step(src, None, qidx, None, out)
    if bad == "src_dtype":
        src[1] = src[1].to(torch.int16)
    elif bad == "src_columns_strided":
        src[0] = torch.zeros((g.ly0, 2 * g.lyw), dtype=torch.uint8)[:, ::2]
    elif bad == "src_rows_unaligned":
        src[2] = torch.zeros((g.lc0, g.lcw + 8), dtype=torch.uint8)[:, :g.lcw]
    elif bad == "src_small":
        src[0] = src[0][:-16]
    elif bad == "src_count":
        src = src[:2]
    elif bad == "out_dtype":
        out = out.to(torch.int32)
    elif bad == "out_shape":
        out = out.view(g.nb, 4, 64)
    elif bad == "out_short":
        out = out[:-1]
    elif bad == "out_unaligned":
        out = torch.zeros(g.nb * 256 + 4, dtype=torch.int16)[4:].view(g.nb, 256)
    elif bad in ("out_overlaps_prev", "out_overlaps_source"):
        store = torch.zeros(g.chh * g.cw + g.nb * 512, dtype=torch.uint8)
        inside = store[:g.chh * g.cw].view(g.chh, g.cw)
        out = store[16:16 + g.nb * 512].view(torch.int16).view(g.nb, 256)
        if bad == "out_overlaps_prev":
            prev = inside
        else:
            src[0] = inside[:g.ly0, :g.lyw]
    elif bad == "motion_dtype":
        motion = (motion[0], motion[1], motion[2].to(torch.bool))
    elif bad == "motion_short":
        motion = tuple(t[:-1] for t in motion)
    elif bad == "motion_strided":
        motion = (torch.zeros(2 * g.nb, dtype=torch.int8)[::2], *motion[1:])
    elif bad == "motion_without_prev":
        prev = None
    elif bad == "prev_small":
        prev = prev[:, :-16]
    elif bad == "prev_unaligned":
        prev = torch.zeros((g.chh, g.cw + 8), dtype=torch.uint8)[:, 8:]
    elif bad == "prev_dtype":
        prev = prev.to(torch.int8)
    elif bad == "qidx_range":
        qidx = (0, 1, 4)
    elif bad == "qidx_count":
        qidx = (0, 1)
    elif bad == "mixed_devices":
        out = out.to("meta")
    with pytest.raises(ValueError):
        if bad == "layout_unaligned":
            k6.FrameEncode(qtables, [(0, 0, 8, 16, 16)], "cpu")
        elif bad == "layout_planes":
            k6.FrameEncode(qtables, [(0, 0, 0, 16, 16)] * 4, "cpu")
        else:
            step(src, motion, qidx, prev, out)


@pytest.mark.parametrize("bad", ["dtype", "shape", "qdtype", "qshape", "strided",
                                 "winshape", "windtype"])
def test_k6_wrapper_rejects_bad_inputs(bad):
    blocks = torch.zeros((3, 16, 16), dtype=torch.uint8)
    q = torch.ones(64, dtype=torch.int32)
    win = None
    if bad == "dtype":
        blocks = blocks.to(torch.int32)
    elif bad == "shape":
        blocks = blocks.view(3, 256)
    elif bad == "qdtype":
        q = q.to(torch.int64)
    elif bad == "qshape":
        q = q.view(1, 64)
    elif bad == "strided":
        blocks = torch.zeros((6, 16, 16), dtype=torch.uint8)[::2]
    elif bad == "winshape":
        win = torch.zeros((4, 16, 16), dtype=torch.uint8)
    else:
        win = torch.zeros((3, 16, 16), dtype=torch.int16)
    with pytest.raises(ValueError):
        k6.fdct_blocks(blocks, q, win)


@pytest.mark.parametrize("t", [0, 5, 40])
def test_synth_frames_match_jax_package(t):
    w, h = 112, 80
    assert np.array_equal(tsynth.synth_rgb_frame(t, w, h), jsynth.synth_rgb_frame(t, w, h))
    for a, b in zip(tsynth.synth_yuv_frame(t, w, h, seed=7),
                    jsynth.synth_yuv_frame(t, w, h, seed=7)):
        assert a.dtype == np.uint8 and np.array_equal(a, b)
    for a, b in zip(tsynth.synth_pan_clip(3, w, h, t0=t), jsynth.synth_pan_clip(3, w, h, t0=t)):
        assert a.shape == b.shape and np.array_equal(a, b)
    rgb = tsynth.synth_rgb_frame(t, w, h)
    for a, b in zip(tcolor.rgb_to_yuv_np(rgb), jcolor.rgb_to_yuv_np(rgb)):
        assert np.array_equal(a, b)
