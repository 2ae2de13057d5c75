"""K7's plain version (pfv_torch.kernels.mc) and the ops around it
(gather_predictions, apply_residuals, decode_delta_blocks) against the JAX
package: the Pallas motion-compensation kernel in interpret mode (as
tests/test_pallas.py runs it) and the XLA gather path of
pfv_tpu.ops.pframe. K7 places each block at its origin in a plane, so the
JAX blocks are compared through blocks_to_plane. Inputs come from numpy
seeds; every comparison is exact."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfv_torch import device as tdevice
from pfv_torch.kernels import mc as k7
from pfv_torch.ops import motion as tmotion
from pfv_torch.ops import pframe as tpframe
from pfv_tpu.ops.blocks import block_origins, blocks_to_plane
from pfv_tpu.ops.motion import gather_predictions
from pfv_tpu.ops.pallas.mc_kernel import mc_reconstruct_pallas
from pfv_tpu.ops.pframe import apply_residuals, decode_delta_blocks

H, W = 64, 80


def _case(seed, lim=15, validated=True):
    """ref plane, origins, (N,16,16) res, motion clipped into the plane
    (unless not `validated`), coded flags."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 256, size=(H, W)).astype(np.uint8)
    by, bx = block_origins(H, W)
    n = len(by)
    res = rng.integers(0, 256, size=(n, 16, 16)).astype(np.uint8)
    mvx = rng.integers(-lim, lim + 1, size=n)
    mvy = rng.integers(-lim, lim + 1, size=n)
    if validated:
        mvx = np.clip(mvx, -bx, W - 16 - bx)
        mvy = np.clip(mvy, -by, H - 16 - by)
    hc = (rng.random(n) < 0.5).astype(np.uint8)
    return ref, by, bx, res, mvy.astype(np.int8), mvx.astype(np.int8), hc


def _port(ref, by, bx, res, mvy, mvx, hc, intra, out=None):
    t = torch.from_numpy
    return k7.mc_reconstruct_plain(t(res), t(ref), t(by), t(bx), t(mvy), t(mvx),
                                   t(hc), intra, out)


@pytest.mark.parametrize("intra", [False, True])
def test_k7_plain_matches_pallas(intra):
    ref, by, bx, res, mvy, mvx, hc = _case(22)
    got = _port(ref, by, bx, res, mvy, mvx, hc, intra)
    blocks = jax.jit(mc_reconstruct_pallas)(
        jnp.asarray(res), jnp.asarray(ref), jnp.asarray(by), jnp.asarray(bx),
        jnp.asarray(mvy), jnp.asarray(mvx), jnp.asarray(hc != 0),
        jnp.asarray(intra))
    assert np.array_equal(got.numpy(), np.asarray(blocks_to_plane(blocks, H, W)))
    # the wrapper takes the plain version for a CPU tensor
    t = torch.from_numpy
    via = k7.mc_reconstruct(t(res), t(ref), t(by), t(bx), t(mvy), t(mvx), t(hc),
                            intra)
    assert torch.equal(via, got)


def test_k7_unvalidated_start_clamps_like_gather_predictions():
    ref, by, bx, res, mvy, mvx, hc = _case(23, lim=100, validated=False)
    sy, sx = by + mvy, bx + mvx
    assert ((sy < 0) | (sy > H - 16)).any() and ((sx < 0) | (sx > W - 16)).any()
    got = _port(ref, by, bx, res, mvy, mvx, hc, False)
    pred = gather_predictions(jnp.asarray(ref), jnp.asarray(by), jnp.asarray(bx),
                              jnp.asarray(mvy), jnp.asarray(mvx))
    want = jnp.where(jnp.asarray(hc != 0)[:, None, None],
                     apply_residuals(jnp.asarray(res), pred), pred)
    assert np.array_equal(got.numpy(), np.asarray(blocks_to_plane(want, H, W)))
    tpred = tmotion.gather_predictions(*(torch.from_numpy(a)
                                         for a in (ref, by, bx, mvy, mvx)))
    assert np.array_equal(tpred.numpy(), np.asarray(pred))
    tres = tpframe.apply_residuals(torch.from_numpy(res), tpred)
    assert np.array_equal(tres.numpy(),
                          np.asarray(apply_residuals(jnp.asarray(res), pred)))


def test_decode_delta_blocks_matches_jax():
    ref, by, bx, _, mvy, mvx, hc = _case(24)
    rng = np.random.default_rng(24)
    coeffs = rng.integers(-300, 300, size=(len(by), 4, 64))
    coeffs[rng.random(coeffs.shape) < 0.8] = 0
    coeffs[hc == 0] = 0  # skipped blocks carry no coefficients
    coeffs = coeffs.astype(np.int16)
    q = rng.integers(1, 40, size=64).astype(np.int32)
    t = torch.from_numpy
    got = tdevice.decode_delta_blocks(t(coeffs), t(q), t(ref), t(by), t(bx),
                                      t(mvy), t(mvx), t(hc))
    want = decode_delta_blocks(
        jnp.asarray(coeffs), jnp.asarray(q), jnp.asarray(ref), jnp.asarray(by),
        jnp.asarray(bx), jnp.asarray(mvy).astype(jnp.int32),
        jnp.asarray(mvx).astype(jnp.int32), jnp.asarray(hc != 0))
    assert np.array_equal(got.numpy(), np.asarray(blocks_to_plane(want, H, W)))


def test_k7_writes_into_a_strided_canvas_view():
    ref, by, bx, res, mvy, mvx, hc = _case(25)
    canvas = torch.full((2, H + 16, W + 32), 7, dtype=torch.uint8)
    canvas[0, 16:, 32:] = torch.from_numpy(ref)
    out = canvas[1, 16:, 32:]
    got = _port(canvas[0, 16:, 32:].numpy(), by, bx, res, mvy, mvx, hc, False)
    t = torch.from_numpy
    k7.mc_reconstruct(t(res), canvas[0, 16:, 32:], t(by), t(bx), t(mvy), t(mvx),
                      t(hc), False, out)
    assert torch.equal(out, got)
    assert (canvas[1, :16] == 7).all() and (canvas[1, :, :32] == 7).all()


@pytest.mark.parametrize("bad", ["in_place", "overlap", "res_dtype", "mv_dtype",
                                 "shape", "out_shape", "strided_res"])
def test_k7_wrapper_rejects_bad_inputs(bad):
    ref, by, bx, res, mvy, mvx, hc = (torch.from_numpy(a) for a in _case(26))
    out = None
    if bad == "in_place":
        out = ref
    elif bad == "overlap":
        big = torch.zeros((H + 16, W), dtype=torch.uint8)
        ref, out = big[:H], big[16:]
    elif bad == "res_dtype":
        res = res.to(torch.int32)
    elif bad == "mv_dtype":
        mvx = mvx.to(torch.int32)
    elif bad == "shape":
        ref = torch.zeros((H, W + 8), dtype=torch.uint8)
    elif bad == "out_shape":
        out = torch.zeros((H, W + 16), dtype=torch.uint8)
    else:
        res = torch.zeros((2 * res.shape[0], 16, 16), dtype=torch.uint8)[::2]
    with pytest.raises(ValueError):
        k7.mc_reconstruct(res, ref, by, bx, mvy, mvx, hc, False, out)
