"""pfv_torch.ops against pfv_tpu.ops: the integer iDCT, the truncating
division, the colour conversion and the copied quantization tables, on
inputs made from a numpy seed. Every comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfv_torch.ops import color as tcolor
from pfv_torch.ops import dct as tdct
from pfv_torch.ops import quant as tquant
from pfv_tpu.ops import color as jcolor
from pfv_tpu.ops import dct as jdct
from pfv_tpu.ops import quant as jquant


def _i32(rng, shape, lo, hi):
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_tdiv_pow2_matches_jax(k):
    rng = np.random.default_rng(k)
    x = np.concatenate([_i32(rng, 4096, -(1 << 31), 1 << 31),
                        np.arange(-40, 40, dtype=np.int32),
                        np.array([-(1 << 31), (1 << 31) - 1], np.int32)])
    want = np.asarray(jdct.tdiv_pow2(jnp.asarray(x), k))
    got = tdct.tdiv_pow2(torch.from_numpy(x), k).numpy()
    assert np.array_equal(got, want)
    # and it is Rust's truncating division
    assert np.array_equal(got, np.trunc(x.astype(np.float64) / (1 << k)))


@pytest.mark.parametrize("lo,hi", [(-4096, 4096), (-(1 << 31), 1 << 31)])
def test_idct8_matches_jax(lo, hi):
    # the full int32 range exercises wrapping adds in both implementations
    x = _i32(np.random.default_rng(hi), (512, 8), lo, hi)
    want = np.asarray(jdct.idct8(jnp.asarray(x)))
    assert np.array_equal(tdct.idct8(torch.from_numpy(x)).numpy(), want)


def test_idct8_dim_2d_matches_jax_idct2d():
    # columns then rows, as the frame step applies it
    x = _i32(np.random.default_rng(7), (64, 8, 8), -3000, 3000)
    want = np.asarray(jdct.idct2d(jnp.asarray(x)))
    t = torch.from_numpy(x)
    got = tdct.idct8_dim(tdct.idct8_dim(t, 1), 2).numpy()
    assert np.array_equal(got, want)


def test_yuv_to_rgb_matches_jax():
    rng = np.random.default_rng(11)
    y, u, v = (rng.integers(0, 256, size=(3, 64, 96), dtype=np.uint8)
               for _ in range(3))
    # every (u, v) pair at a few luma levels, to reach both saturations
    uu, vv = np.meshgrid(np.arange(256, dtype=np.uint8),
                         np.arange(256, dtype=np.uint8))
    for lum in (0, 16, 128, 235, 255):
        yy = np.full_like(uu, lum)
        y = np.concatenate([y.reshape(-1), yy.reshape(-1)])
        u = np.concatenate([u.reshape(-1), uu.reshape(-1)])
        v = np.concatenate([v.reshape(-1), vv.reshape(-1)])
    want = np.asarray(jcolor.yuv_to_rgb(jnp.asarray(y), jnp.asarray(u),
                                        jnp.asarray(v)))
    got = tcolor.yuv_to_rgb(torch.from_numpy(y), torch.from_numpy(u),
                            torch.from_numpy(v)).numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["DCT_SCALE_FACTOR", "ZIGZAG_TABLE",
                                  "INV_ZIGZAG_TABLE"])
def test_quant_tables_match_jax(name):
    got, want = getattr(tquant, name), getattr(jquant, name)
    assert got.dtype == want.dtype and np.array_equal(got, want)
