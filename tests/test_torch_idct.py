"""K5's plain version (pfv_torch.kernels.idct) and the ops it is built from
(dequantize, the block layouts, ops.iframe) against the JAX package: the
Pallas iDCT kernel in interpret mode (as tests/test_pallas.py runs it) and
pfv_tpu.ops.iframe.decode_blocks. Inputs come from numpy seeds; every
comparison is exact."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfv_torch import device as tdevice
from pfv_torch.kernels import idct as k5
from pfv_torch.ops import blocks as tblocks
from pfv_torch.ops import iframe as tiframe
from pfv_torch.ops import quant as tquant
from pfv_tpu.ops import blocks as jblocks
from pfv_tpu.ops import quant as jquant
from pfv_tpu.ops.iframe import decode_blocks as jax_decode_blocks
from pfv_tpu.ops.pallas.idct_kernel import decode_blocks_pallas


def _coeffs(rng, n, lim, zero_share=0.7):
    c = rng.integers(-lim, lim, size=(n, 4, 64))
    c[rng.random(size=c.shape) < zero_share] = 0
    return c.astype(np.int16)


@pytest.mark.parametrize("n", [1, 7, 128, 300])
def test_k5_plain_matches_pallas_and_jax(n):
    rng = np.random.default_rng(20 + n)
    coeffs = _coeffs(rng, n, 800)
    q = rng.integers(1, 60, size=64).astype(np.int32)
    got = k5.decode_blocks_plain(torch.from_numpy(coeffs), torch.from_numpy(q))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (n, 16, 16)
    pallas = jax.jit(decode_blocks_pallas)(jnp.asarray(coeffs), jnp.asarray(q))
    assert np.array_equal(got.numpy(), np.asarray(pallas))
    assert np.array_equal(got.numpy(), np.asarray(
        jax_decode_blocks(jnp.asarray(coeffs), jnp.asarray(q))))
    # the wrapper takes the plain version for a CPU tensor, as does _best
    assert torch.equal(k5.decode_blocks(torch.from_numpy(coeffs), torch.from_numpy(q)), got)
    assert torch.equal(tdevice.decode_blocks_best(torch.from_numpy(coeffs),
                                                  torch.from_numpy(q)), got)


def test_k5_plain_wraps_int32_like_jax():
    rng = np.random.default_rng(5)
    coeffs = _coeffs(rng, 64, 16000, zero_share=0.3)
    q = rng.integers(30000, 65536, size=64).astype(np.int32)
    # |coeff * SCALE * q| reaches ~4.5e10: the dequant products wrap
    assert np.abs(coeffs.astype(np.int64)).max() * 43 * q.max() > 2 ** 31
    got = k5.decode_blocks_plain(torch.from_numpy(coeffs), torch.from_numpy(q))
    want = jax.jit(decode_blocks_pallas)(jnp.asarray(coeffs), jnp.asarray(q))
    assert np.array_equal(got.numpy(), np.asarray(want))
    i32 = tiframe.decode_blocks_i32(torch.from_numpy(coeffs), torch.from_numpy(q))
    assert i32.dtype == torch.int32 and torch.equal(i32.to(torch.uint8), got)


@pytest.mark.parametrize("per_block", [False, True])
def test_dequantize_matches_jax(per_block):
    rng = np.random.default_rng(9)
    qm = _coeffs(rng, 50, 16000, zero_share=0.2)
    shape = (50, 1, 64) if per_block else (64,)
    q = rng.integers(1, 65536, size=shape).astype(np.int32)
    got = tquant.dequantize(torch.from_numpy(qm), torch.from_numpy(q))
    want = jquant.dequantize(jnp.asarray(qm), jnp.asarray(q))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("h,w", [(16, 16), (48, 80), (96, 128)])
def test_block_layouts_match_jax(h, w):
    rng = np.random.default_rng(h * w)
    plane = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    blocks = tblocks.plane_to_blocks(torch.from_numpy(plane))
    assert np.array_equal(blocks.numpy(),
                          np.asarray(jblocks.plane_to_blocks(jnp.asarray(plane))))
    assert np.array_equal(tblocks.blocks_to_plane(blocks, h, w).numpy(), plane)
    sub = tblocks.blocks_to_subblocks(blocks)
    assert np.array_equal(sub.numpy(), np.asarray(
        jblocks.blocks_to_subblocks(jnp.asarray(blocks.numpy()))))
    assert torch.equal(tblocks.subblocks_to_blocks(sub), blocks)
    for a, b in zip(tblocks.block_origins(h, w), jblocks.block_origins(h, w)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tblocks.block_grid(h, w) == jblocks.block_grid(h, w)
    for x in (h - 1, h, w + 3):
        assert tblocks.pad_dim(x) == jblocks.pad_dim(x)


@pytest.mark.parametrize("bad", ["dtype", "shape", "qdtype", "qshape", "strided"])
def test_k5_wrapper_rejects_bad_inputs(bad):
    coeffs = torch.zeros((3, 4, 64), dtype=torch.int16)
    q = torch.ones(64, dtype=torch.int32)
    if bad == "dtype":
        coeffs = coeffs.to(torch.int32)
    elif bad == "shape":
        coeffs = coeffs.view(3, 256)
    elif bad == "qdtype":
        q = q.to(torch.int64)
    elif bad == "qshape":
        q = q.view(1, 64)
    else:
        coeffs = torch.zeros((6, 4, 64), dtype=torch.int16)[::2]
    with pytest.raises(ValueError):
        k5.decode_blocks(coeffs, q)
