"""pfv_torch's motion search (kernel K8's plain version and its wrapper on
the CPU) against pfv_tpu.ops.motion.motion_search, and the device-side
padding of the encoders' source planes against the JAX package's host
padding. Inputs come from numpy seeds; every comparison is exact
(tolerance 0: integers all the way)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pfv_torch import device as tdevice
from pfv_torch import synth
from pfv_torch.frame import canvas_layout, canvas_planes, geometry
from pfv_torch.kernels.frame_step import plane_layout
from pfv_torch.kernels.motion import MAX_STRIDE, MotionSearch, motion_search_plain
from pfv_torch.ops import blocks as tblocks
from pfv_torch.ops import motion as tmotion
from pfv_torch.ops.pframe import skip_threshold
from pfv_tpu import device as jdevice
from pfv_tpu import encoding as jencoding
from pfv_tpu.ops import blocks as jblocks
from pfv_tpu.ops import motion as jmotion


def _noise(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w), dtype=np.uint8)


def _panned(h, w, dx, dy, seed):
    """(cur, ref): ref is a window of a texture, cur the window moved by
    (dx, dy), so that many blocks match best at that vector; the texture is
    smooth, as a log search needs it."""
    yy, xx = np.mgrid[:h + 32, :w + 32]
    tex = (128 + 50 * np.sin(xx / 13.0) + 50 * np.sin(yy / 11.0 + xx / 29.0)
           + _noise(h + 32, w + 32, seed) % 5).astype(np.uint8)
    return tex[16 + dy:16 + dy + h, 16 + dx:16 + dx + w], tex[16:16 + h, 16:16 + w]


def _case(name):
    if name.startswith("noise"):
        h, w = {"noise 48x32": (32, 48), "noise 16x16": (16, 16), "noise 16x64": (16, 64),
                "noise 64x16": (64, 16), "noise 96x64": (64, 96)}[name]
        return _noise(h, w, 1), _noise(h, w, 2)
    if name == "flat":
        return np.full((32, 48), 90, np.uint8), np.full((32, 48), 93, np.uint8)
    if name == "cur == ref":
        return _noise(32, 48, 3), _noise(32, 48, 3)
    if name in STRESS:  # the kernel's corners: pfv_torch.synth.search_stress
        kind, (h, w) = STRESS[name]
        return synth.search_stress(kind, h, w, seed=7)
    if name == "padding ties":  # a frame's edge: texture, then the clear value
        cur, ref = _noise(48, 64, 4), _noise(48, 64, 5)
        cur[20:, :], ref[20:, :] = 128, 128
        cur[:, 40:], ref[:, 40:] = 128, 128
        return cur, ref
    dx, dy = {"pan (3, 1)": (3, 1), "pan (-15, 15)": (-15, 15)}[name]
    return _panned(64, 96, dx, dy, 6)


STRESS = {"shifts 256x128": ("shifts", (128, 256)), "shifts 80x16": ("shifts", (16, 80)),
          "shifts 16x80": ("shifts", (80, 16)), "mirror ties": ("mirror ties", (48, 96)),
          "largest error": ("largest error", (32, 48)), "edges": ("edges", (64, 96))}
CASES = ["noise 48x32", "noise 16x16", "noise 16x64", "noise 64x16", "noise 96x64", "flat",
         "cur == ref", "padding ties", "pan (3, 1)", "pan (-15, 15)", *STRESS]
LARGEST_ERR = 16 * 16 * 255 ** 2  # a source of 255 over a previous plane of 0


def _jax_search(cur, ref):
    """pfv_tpu's search of the padded plane cur against ref -> numpy (mv_x,
    mv_y, best_err, best_win)."""
    by, bx = tblocks.block_origins(*ref.shape)
    blocks = jblocks.plane_to_blocks(jnp.asarray(cur))
    return [np.asarray(a) for a in jmotion.motion_search(
        blocks, jnp.asarray(ref), jnp.asarray(by), jnp.asarray(bx))]


@pytest.mark.parametrize("name", CASES)
def test_motion_search_matches_jax(name):
    cur, ref = _case(name)
    want = _jax_search(cur, ref)
    by, bx = (torch.from_numpy(o) for o in tblocks.block_origins(*ref.shape))
    tcur, tref = torch.from_numpy(np.ascontiguousarray(cur)), torch.from_numpy(
        np.ascontiguousarray(ref))
    got = tmotion.motion_search(tblocks.plane_to_blocks(tcur), tref, by, bx)
    for g, w_ in zip(got, want):
        assert np.array_equal(g.numpy(), w_)
    mvx, mvy = want[0], want[1]
    if name in ("flat", "cur == ref"):  # every candidate ties: the centre wins
        assert not mvx.any() and not mvy.any()
    if name == "padding ties":
        flat = (by.numpy() >= 32) | (bx.numpy() >= 48)
        assert flat.any() and not mvx[flat].any() and not mvy[flat].any()
    if name.startswith("pan"):
        dx, dy = (3, 1) if name == "pan (3, 1)" else (-15, 15)
        assert ((mvx == dx) & (mvy == dy)).mean() >= 0.3
    if name == "noise 16x16":
        assert mvx.tolist() == [0] and mvy.tolist() == [0]
    if name == "noise 16x64":
        assert not mvy.any()
    if name == "noise 64x16":
        assert not mvx.any()
    if name == "shifts 80x16":  # one block high: the walk moves along x alone
        assert not mvy.any() and set((mvx % 4).tolist()) == {0, 1, 2, 3}
    if name == "shifts 16x80":  # one block wide: along y alone
        assert not mvx.any() and len(set(mvy.tolist())) >= 4
    if name == "shifts 256x128":  # every dx and dy, so every column phase of a window
        assert set(mvx.tolist()) == set(mvy.tolist()) == set(range(-15, 16))
    if name == "mirror ties":  # left and right tie: the lower priority, to the left, wins
        assert mvx.any() and (mvx <= 0).all()
    if name == "largest error":
        assert (want[2] == LARGEST_ERR).all() and not mvx.any() and not mvy.any()


# every case at three thresholds, and the largest error just below and at its error
@pytest.mark.parametrize("name,min_err", [(n, t) for n in CASES for t in (0.0, 2304.0, 57600.0)]
                         + [("largest error", LARGEST_ERR - 1.0),
                            ("largest error", float(LARGEST_ERR))])
def test_motion_search_plain_matches_jax(name, min_err):
    """The frame form on one plane that is its own canvas, the rows filled
    with a sentinel before."""
    cur, ref = _case(name)
    mx, my, err, _ = _jax_search(cur, ref)
    tcur, tref = torch.from_numpy(np.ascontiguousarray(cur)), torch.from_numpy(
        np.ascontiguousarray(ref))
    n = mx.shape[0]
    motion = (torch.full((n,), 7, dtype=torch.int8), torch.full((n,), 7, dtype=torch.int8),
              torch.full((n,), 7, dtype=torch.uint8))
    layout = plane_layout(*ref.shape)
    out = motion_search_plain([tcur], tref, layout, min_err, motion)
    assert out is motion
    assert np.array_equal(motion[0].numpy(), my) and np.array_equal(motion[1].numpy(), mx)
    assert np.array_equal(motion[2].numpy(), err.astype(np.float32) > np.float32(min_err))
    again = tuple(torch.full_like(t, 7) for t in motion)
    MotionSearch(layout, min_err, "cpu")([tcur], tref, again)
    for a, b in zip(again, motion):
        assert torch.equal(a, b)


def _frame(w, h, seed):
    """A previous canvas of smooth planes and three padded source planes
    close to it: the planes moved by (2, -1) plus noise of a few levels, so
    that the qualities' thresholds split the blocks."""
    g = geometry(w, h)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:g.chh, :g.cw]
    prev = (128 + 50 * np.sin(xx / 13.0) + 50 * np.sin(yy / 11.0 + xx / 29.0)
            + rng.integers(0, 5, size=yy.shape)).astype(np.uint8)
    src = []
    for i, p in enumerate(canvas_planes(g, prev)):
        moved = np.roll(p, (1, -2), axis=(0, 1)).astype(np.int32)
        amp = (1, 4, 40)[i]
        src.append(np.clip(moved + rng.integers(-amp, amp + 1, size=p.shape), 0, 255)
                   .astype(np.uint8))
    return g, prev, src


@pytest.mark.parametrize("quality", [0, 2, 10])
@pytest.mark.parametrize("w,h", [(96, 64), (18, 10), (136, 90)])
def test_motion_search_wrapper_on_a_fused_canvas(w, h, quality):
    """`MotionSearch` on the CPU, U and V as views of one fused canvas,
    writes per plane the JAX search's vectors and float32(err) > min_err
    into the plane's rows, as `FrameEncoder.search` does."""
    g, prev, src = _frame(w, h, w + quality)
    min_err = skip_threshold(quality)
    layout = canvas_layout(g)
    tprev = torch.from_numpy(prev)
    tsrc = [torch.from_numpy(s) for s in src]
    headers = torch.full((3, g.nb + 2), 7, dtype=torch.int8)
    motion = (headers[0], headers[1], headers[2].view(torch.uint8))
    before = MotionSearch.launches
    MotionSearch(layout, min_err, "cpu")(tsrc, tprev, motion)
    assert MotionSearch.launches == before  # the count is of kernel launches
    coded = 0
    for (first, *_), s, ref in zip(layout, src, canvas_planes(g, prev)):
        mx, my, err, _ = _jax_search(s, np.ascontiguousarray(ref))
        sl = slice(first, first + mx.shape[0])
        assert np.array_equal(motion[0][sl].numpy(), my)
        assert np.array_equal(motion[1][sl].numpy(), mx)
        hc = err.astype(np.float32) > min_err
        assert np.array_equal(motion[2][sl].numpy(), hc)
        coded += int(hc.sum())
    assert (headers[:, g.nb:] == 7).all()  # nothing past the frame's blocks
    if quality == 0:
        assert coded == g.nb
    if quality == 10 and (w, h) != (18, 10):
        assert 0 < coded < g.nb
    # the encoders' FrameEncoder goes through the same search
    enc = tdevice.FrameEncoder(g, {k: np.ones(64, np.int32) for k in tdevice.QT_KEYS},
                               min_err, "cpu")
    enc.prev.copy_(tprev)
    rows = tuple(torch.zeros_like(t) for t in motion)
    enc.search(tsrc, rows)
    for a, b in zip(rows, motion):
        assert torch.equal(a[:g.nb], b[:g.nb])


def _far_rows(in_source, stride):
    """A call on one 16x16 plane whose source (in_source) or previous plane
    has rows `stride` bytes apart: (layout, sources, prev, motion). The
    storage between the rows is reserved, never written."""
    rng = np.random.default_rng(2)
    src, prev = (torch.from_numpy(rng.integers(0, 256, (16, 16), dtype=np.uint8))
                 for _ in range(2))
    far = torch.empty_strided((16, 16), (stride, 1), dtype=torch.uint8)
    far.copy_(src if in_source else prev)
    src, prev = (far, prev) if in_source else (src, far)
    motion = [torch.zeros(1, dtype=d) for d in (torch.int8, torch.int8, torch.uint8)]
    return plane_layout(16, 16), [src], prev, motion


def _bad_call(kind):
    if kind in ("source rows too far apart", "prev rows too far apart"):
        return _far_rows(kind.startswith("source"), MAX_STRIDE)
    g, prev, src = _frame(96, 64, 1)
    tprev, tsrc = torch.from_numpy(prev), [torch.from_numpy(s) for s in src]
    headers = torch.zeros((3, g.nb), dtype=torch.int8)
    motion = [headers[0], headers[1], headers[2].view(torch.uint8)]
    if kind == "two sources":
        tsrc = tsrc[:2]
    elif kind == "int16 source":
        tsrc[1] = tsrc[1].to(torch.int16)
    elif kind == "source too small":
        tsrc[0] = tsrc[0][:48]
    elif kind == "misaligned source rows":
        tsrc[2] = torch.zeros((g.lc0, g.lcw + 8), dtype=torch.uint8)[:, 8:]
    elif kind == "prev too small":
        tprev = tprev[:, :80]
    elif kind == "no prev":
        tprev = None
    elif kind == "short header rows":
        motion = [t[:g.nb - 1] for t in motion]
    elif kind == "int8 flags":
        motion[2] = headers[2]
    elif kind == "rows that overlap":
        motion[1] = motion[0]
    elif kind == "rows inside prev":
        motion[0] = tprev.view(-1)[:g.nb].view(torch.int8)
    return canvas_layout(g), tsrc, tprev, motion


@pytest.mark.parametrize("kind", ["two sources", "int16 source", "source too small",
                                  "misaligned source rows", "prev too small", "no prev",
                                  "short header rows", "int8 flags", "rows that overlap",
                                  "rows inside prev", "source rows too far apart",
                                  "prev rows too far apart"])
def test_motion_search_refuses(kind):
    layout, src, prev, motion = _bad_call(kind)
    with pytest.raises(ValueError):
        MotionSearch(layout, 0.0, "cpu")(src, prev, motion)


@pytest.mark.parametrize("in_source", [True, False])
def test_motion_search_takes_rows_just_below_the_stride_bound(in_source):
    """The kernel keeps row strides in 32-bit ints; the largest stride it
    takes, MAX_STRIDE - 16, passes the check and searches as a contiguous
    copy does."""
    layout, src, prev, motion = _far_rows(in_source, MAX_STRIDE - 16)
    MotionSearch(layout, 0.0, "cpu")(src, prev, motion)
    want = [torch.full_like(t, 7) for t in motion]
    motion_search_plain([src[0].contiguous()], prev.contiguous(), layout, 0.0, want)
    for a, b in zip(motion, want):
        assert torch.equal(a, b)


def test_motion_search_refuses_a_layout_of_part_blocks():
    with pytest.raises(ValueError):
        MotionSearch([(0, 0, 0, 24, 32)], 0.0, "cpu")
    _bad_call("")  # and the untouched call passes
    layout, src, prev, motion = _bad_call("")
    MotionSearch(layout, 0.0, "cpu")(src, prev, motion)


@pytest.mark.parametrize("form", ["clip", "frame"])
@pytest.mark.parametrize("w,h", [(18, 10), (136, 90), (96, 64)])
def test_device_padding_equals_the_host_padding(w, h, form):
    """`upload_padded` (the planes go up unpadded and are padded on the
    device) against the JAX package's host padding: `_pad_frames` for a
    clip, `pad_plane_host` for a frame into the planes an Encoder keeps.
    96x64 needs no padding; 18x10 and 136x90 pad every plane."""
    g = geometry(w, h)
    rng = np.random.default_rng(w)
    sizes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    shapes = tdevice.padded_shapes(g)
    assert shapes == ((g.ly0, g.lyw), (g.lc0, g.lcw), (g.lc0, g.lcw))
    if form == "clip":
        planes = [rng.integers(0, 256, size=(5, *s), dtype=np.uint8) for s in sizes]
        got = tdevice.upload_padded(g, planes, "cpu")
        for t, p, shape, clear in zip(got, planes, shapes, tdevice.PLANE_CLEAR):
            assert t.dtype == torch.uint8 and tuple(t.shape) == (5, *shape)
            assert np.array_equal(t.numpy(), jencoding._pad_frames(p, *shape, clear))
        # a run of a clip's frames, as encode_video_gops cuts it
        got = tdevice.upload_padded(g, [p[1:3] for p in planes], "cpu")
        for t, p, shape, clear in zip(got, planes, shapes, tdevice.PLANE_CLEAR):
            assert np.array_equal(t.numpy(), jencoding._pad_frames(p[1:3], *shape, clear))
        return
    kept = [torch.full(s, c, dtype=torch.uint8) for s, c in zip(shapes, tdevice.PLANE_CLEAR)]
    for _ in range(2):  # the second frame lands in the same planes
        planes = [rng.integers(0, 256, size=s, dtype=np.uint8) for s in sizes]
        got = tdevice.upload_padded(g, planes, "cpu", kept)
        for t, k, p, shape, clear in zip(got, kept, planes, shapes, tdevice.PLANE_CLEAR):
            assert (t is k) == (p.shape != shape)  # as it is where nothing is padded
            assert np.array_equal(t.numpy(),
                                  np.asarray(jdevice.pad_plane_host(p, *shape, clear)))


@pytest.mark.parametrize("w,h", [(18, 10), (96, 64)])
def test_device_padding_refuses_a_plane_that_is_not_uint8(w, h):
    """A plane of another type is refused, padded or not, never wrapped
    into bytes."""
    g = geometry(w, h)
    planes = [np.full(s, 300, dtype=np.int16)
              for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    with pytest.raises(ValueError):
        tdevice.upload_padded(g, planes, "cpu")
