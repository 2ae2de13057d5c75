"""The encoder's host mux on its kept native worker pool
(`runtime.encode_packets_sparse` over `native/pfv_mux.cpp`, behind
`encoding._mux`) against the per-frame coders it calls, byte for byte: the
packets of a clip equal the join of `runtime.encode_iframe_payload_sparse`
and `encode_pframe_payload_sparse` payloads, each behind its type byte and
length, and `_mux` wraps them in the container's header and the EOF packet.

The clips: compacted arrays drawn at 64x48, 200x48 and 1920x1080, with
several I-frames, P-frames with no coded block, with every block coded and
with no nonzero, and a one-frame clip, each at 1, 2, 3 and 8 workers; a
clip whose frames outgrow the slots an earlier call kept; the arrays of a
real `encode_video` call. Then: a coefficient past the format's 15-bit
limit raises as the per-frame coder does; threads at once, each reusing its
context across geometries; a forked child."""

from __future__ import annotations

import os
import struct
import sys
import threading
import time

import numpy as np
import pytest

from pfv_torch import encoding, runtime, synth
from pfv_torch.device import INTER_Q, INTRA_Q
from pfv_torch.enc import container_header
from pfv_torch.frame import geometry
from pfv_torch.ops.quant import derive_q_tables

THREADS = [1, 2, 3, 8]


def clip(w: int, h: int, kinds: str, seed: int = 0, density: float = 0.05):
    """`_compact`'s host arrays for a clip of w x h frames, one per letter
    of `kinds`: "I" a keyframe, "P" a P-frame with some blocks coded, "S" one
    with no coded block, "A" one with every block coded, "Z" one with
    every block coded and no nonzero. Skipped blocks hold no nonzero, as
    K6 writes them. -> (nb, is_key, idx, val, counts, mvx, mvy, hc)."""
    rng = np.random.default_rng(seed)
    nb = geometry(w, h).nb
    f = len(kinds)
    is_key = np.array([k == "I" for k in kinds])
    mvx = rng.integers(-15, 16, size=(f, nb)).astype(np.int8)
    mvy = rng.integers(-15, 16, size=(f, nb)).astype(np.int8)
    hc = np.ones((f, nb), dtype=np.uint8)
    idx, val, counts = [], [], []
    for t, k in enumerate(kinds):
        if k == "I":
            mvx[t] = mvy[t] = 0
        elif k == "P":
            hc[t] = rng.random(nb) < 0.4
        elif k == "S":
            hc[t] = 0
        flat = np.zeros(nb * 256, dtype=np.int16)
        if k != "Z":
            live = (rng.random(nb * 256) < density) & np.repeat(hc[t] > 0, 256)
            mag = np.where(rng.random(nb * 256) < 0.9, rng.integers(1, 4, nb * 256),
                           rng.integers(4, 1500, nb * 256))
            flat[live] = (mag * rng.choice([-1, 1], nb * 256))[live]
        i = np.flatnonzero(flat).astype(np.int32)
        idx.append(i)
        val.append(flat[i])
        counts.append(i.size)
    return (nb, is_key, np.concatenate(idx), np.concatenate(val),
            np.array(counts, dtype=np.int64), mvx, mvy, hc)


def per_frame(nb, is_key, idx, val, counts, mvx, mvy, hc) -> bytes:
    """The packets as the mux wrote them before it had a pool: one
    per-frame coder call a frame, in order."""
    out, lo = [], 0
    for t in range(len(is_key)):
        hi = lo + counts[t]
        if is_key[t]:
            p = runtime.encode_iframe_payload_sparse(idx[lo:hi], val[lo:hi], nb, INTRA_Q)
        else:
            p = runtime.encode_pframe_payload_sparse(idx[lo:hi], val[lo:hi], mvx[t], mvy[t],
                                                     hc[t], INTER_Q)
        out += [struct.pack("<BI", 1 if is_key[t] else 2, len(p)), p]
        lo = hi
    return b"".join(out)


def pooled(arrays, num_threads: int = 0) -> bytes:
    nb, is_key, idx, val, counts, mvx, mvy, hc = arrays
    return runtime.encode_packets_sparse(is_key, idx, val, counts, mvx, mvy, hc, nb,
                                         INTRA_Q, INTER_Q, num_threads).tobytes()


CLIPS = {
    "64x48 IPPIPP": (64, 48, "IPPIPP"),
    "200x48 ISAZPI": (200, 48, "ISAZPI"),
    "200x48 one frame": (200, 48, "I"),
    "1920x1080 IPSIZ": (1920, 1080, "IPSIZ"),
}


@pytest.fixture(scope="module")
def clips():
    return {name: clip(w, h, kinds, seed=n) for n, (name, (w, h, kinds)) in
            enumerate(CLIPS.items())}


@pytest.mark.parametrize("num_threads", THREADS)
@pytest.mark.parametrize("name", list(CLIPS))
def test_the_pooled_mux_is_the_per_frame_coder_s_join(clips, name, num_threads):
    arrays = clips[name]
    want = per_frame(*arrays)
    assert pooled(arrays, num_threads) == want
    w, h, _ = CLIPS[name]
    qt = derive_q_tables(2)
    assert encoding._mux(w, h, 30, qt, *arrays) == b"".join(
        [container_header(w, h, 30, qt), want, struct.pack("<BI", 0, 0)])


@pytest.mark.parametrize("num_threads", [1, 3])
def test_frames_that_outgrow_the_slots_an_earlier_call_kept(num_threads):
    """The same context (a `num_threads` no other test takes) first codes
    sparse frames, then frames with twenty times their nonzeros in the same
    slots, then the sparse ones again."""
    runtime.release_demux_memory()
    sparse = clip(200, 48, "IPPIPP", seed=5, density=0.01)
    dense = clip(200, 48, "IPPAPP", seed=6, density=0.2)
    for arrays in (sparse, dense, sparse):
        assert pooled(arrays, num_threads + 10) == per_frame(*arrays)


def test_the_arrays_of_an_encode_video_call(monkeypatch):
    frames = [synth.synth_yuv_frame(t, 64, 48) for t in range(7)]
    y, u, v = map(np.stack, zip(*frames))
    seen = []
    mux = encoding._mux
    monkeypatch.setattr(encoding, "_mux", lambda *a: seen.append(a) or mux(*a))
    out = encoding.encode_video(y, u, v, 30, 3, [1, 0, 0, 1, 0, 1, 0], device="cpu")
    (args,) = seen
    w, h, framerate, qt = args[:4]
    assert out == b"".join([container_header(w, h, framerate, qt), per_frame(*args[4:]),
                            struct.pack("<BI", 0, 0)])


@pytest.mark.parametrize("kind", ["I", "P"])
def test_a_coefficient_past_the_15_bit_limit_raises_as_the_coder_does(kind):
    arrays = clip(64, 48, "IP", seed=3)
    nb, is_key, idx, val, counts, mvx, mvy, hc = arrays
    val = val.copy()
    at = 0 if kind == "I" else counts[0] + counts[1] // 2
    val[at] = 16384
    bad = (nb, is_key, idx, val, counts, mvx, mvy, hc)
    with pytest.raises(ValueError, match=r"unencodable coefficients \(code -7\)"):
        per_frame(*bad)
    for n in (1, 8):
        with pytest.raises(ValueError, match=r"unencodable coefficients \(code -7\)"):
            pooled(bad, n)
    assert pooled(arrays, 8) == per_frame(*arrays)  # the context serves on


def test_inconsistent_arrays_raise_before_the_native_call():
    nb, is_key, idx, val, counts, mvx, mvy, hc = clip(64, 48, "IP", seed=4)
    with pytest.raises(ValueError, match="inconsistent clip arrays"):
        pooled((nb, is_key, idx[:-1], val[:-1], counts, mvx, mvy, hc))
    with pytest.raises(ValueError, match="inconsistent clip arrays"):
        pooled((nb + 1, is_key, idx, val, counts, mvx, mvy, hc))


def test_threads_at_once_reuse_their_contexts_across_geometries():
    arrays = [clip(w, h, kinds, seed=20 + n) for n, (w, h, kinds) in
              enumerate([(64, 48, "IPPSP"), (200, 48, "IAZPP"), (96, 64, "IPIPIP"),
                         (320, 240, "IPP")])]
    want = [per_frame(*a) for a in arrays]
    ok = {t: [] for t in range(4)}
    start = threading.Barrier(4)

    def work(t):
        start.wait(timeout=60)
        for r in range(6):
            k = (t + r) % len(arrays)
            ok[t].append(pooled(arrays[k], 3) == want[k])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert ok == {t: [True] * 6 for t in range(4)}


def test_a_forked_child_codes_with_workers_of_its_own():
    arrays = clip(200, 48, "IPPIPPPP", seed=9)
    want = per_frame(*arrays)
    assert pooled(arrays, 4) == want
    pid = os.fork()  # the parent's context, its workers started, is inherited
    if pid == 0:
        ok = False
        try:
            ok = pooled(arrays, 4) == want
        finally:
            os._exit(0 if ok else 1)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            break
        time.sleep(0.05)
    else:
        os.kill(pid, 9)
        os.waitpid(pid, 0)
        pytest.fail("the forked child's mux did not finish")
    assert os.waitstatus_to_exitcode(status) == 0
