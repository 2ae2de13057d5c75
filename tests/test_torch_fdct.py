"""The port's forward transform, quantization and K6's plain versions
(pfv_torch.kernels.fdct) against the JAX package: the jnp ops, the Pallas
forward-DCT kernel in interpret mode (as tests/test_pallas.py runs it) and
pfv_tpu.ops.pframe's delta encode; and pfv_torch.synth's source frames
against pfv_tpu.utils.synth. Inputs come from numpy seeds; every
comparison is exact."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfv_torch import synth as tsynth
from pfv_torch.kernels import fdct as k6
from pfv_torch.ops import color as tcolor
from pfv_torch.ops import dct as tdct
from pfv_torch.ops import iframe as tiframe
from pfv_torch.ops import pframe as tpframe
from pfv_torch.ops import quant as tquant
from pfv_tpu.ops import color as jcolor
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
    for fn in (k6.fdct_blocks, tiframe.encode_blocks_best):
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
