"""The port's own copy of the C++ entropy/container runtime.

`native/pfv_bitstream.cpp` is the PFV bitstream layer (Huffman/RLE payload
coding, the container, every demux form, the scalar reference decoder),
kept byte for byte equal to the JAX package's copy. The port's own source,
`native/pfv_tile_demux.cpp`, includes that file and adds persistent
contexts for the tile demux (K1's route) and the pstep demux (the dense
route, and K4's input): workers that sleep between calls and unit buffers kept from
one call to the next, sized by what the streams really produced. This
module binds the part of the library the port uses through ctypes with
numpy-array views.

Both demuxes hold memory after a call: per context (one per concurrent
caller, kind and `num_threads`), the high-water mark of the calls it
served. `release_demux_memory()` frees the idle contexts' workers and
buffers.

The library is compiled with g++ at first use into `pfv_torch/build/`
(which git ignores), under a name keyed by the sources, the flags and the
instruction set `-march=native` resolves to on this host: a library built
on another machine with other CPU features is never loaded, and a changed
source is rebuilt.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import resource
import subprocess
import tempfile
import threading

import numpy as np

from pfv_torch.utils.profiling import count, recording, span

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_PATH = os.path.join(_HERE, "native", "pfv_tile_demux.cpp")  # includes the next
_SOURCES = (_SRC_PATH, os.path.join(_HERE, "native", "pfv_bitstream.cpp"))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
# -O2 measures equal-or-faster than -O3 on the branchy bit-twiddling loops
CXX_FLAGS = ["-O2", "-march=native", "-fPIC", "-std=c++17", "-shared", "-pthread"]

_lock = threading.Lock()
_lib = None


def so_path() -> str:
    """Where the library for these sources, these flags and this host's
    `-march=native` lives."""
    target = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                            check=True, capture_output=True, text=True).stdout
    key = hashlib.sha256()
    sources = [open(path, "rb").read() for path in _SOURCES]
    for part in (*sources, " ".join(CXX_FLAGS).encode(), target.encode()):
        key.update(hashlib.sha256(part).digest())
    return os.path.join(BUILD_DIR, f"libpfv_bitstream-{key.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = os.path.join(tmp, "lib.so")
        subprocess.run(["g++", *CXX_FLAGS, "-o", so, _SRC_PATH], check=True,
                       capture_output=True)
        os.replace(so, path)  # atomic: another process never loads half a file


def get_lib() -> ctypes.CDLL:
    """Load the native bitstream library, building it first if missing."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = so_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)

        i64 = ctypes.c_int64
        vp = ctypes.c_void_p
        p_i16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        p_i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        p_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        p_u16 = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        p_u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        p_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        p_u64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")

        lib.pfv_encode_iframe_payload.restype = i64
        lib.pfv_encode_iframe_payload.argtypes = [p_i16, i64, p_u8, p_u8, i64]
        lib.pfv_decode_iframe_payload.restype = i64
        lib.pfv_decode_iframe_payload.argtypes = [p_u8, i64, i64, p_i16, p_u8]
        lib.pfv_encode_iframe_payload_sparse.restype = i64
        lib.pfv_encode_iframe_payload_sparse.argtypes = [
            p_i32, p_i16, i64, i64, p_u8, p_u8, i64]
        lib.pfv_encode_pframe_payload_sparse.restype = i64
        lib.pfv_encode_pframe_payload_sparse.argtypes = [
            p_i32, p_i16, i64, p_i8, p_i8, p_u8, i64, p_u8, p_u8, i64]
        lib.pfv_encode_pframe_payload.restype = i64
        lib.pfv_encode_pframe_payload.argtypes = [
            p_i16, p_i8, p_i8, p_u8, i64, p_u8, p_u8, i64]
        lib.pfv_decode_pframe_payload.restype = i64
        lib.pfv_decode_pframe_payload.argtypes = [
            p_u8, i64, i64, p_i16, p_i8, p_i8, p_u8, p_u8]
        lib.pfv_parse_header.restype = i64
        lib.pfv_parse_header.argtypes = [p_u8, i64, p_i32, p_i32, i64]
        lib.pfv_ref_decode.restype = i64
        lib.pfv_ref_decode.argtypes = [p_u8, i64, vp, vp, vp, i64, p_i32]
        lib.pfv_count_frames.restype = i64
        lib.pfv_count_frames.argtypes = [p_u8, i64, i64]
        lib.pfv_demux_file_sparse.restype = i64
        lib.pfv_demux_file_sparse.argtypes = [
            p_u8, i64, i64, i64, i64, p_u16, vp, p_u8, p_u8, vp, vp, i64, vp,
            ctypes.c_int32]
        lib.pfv_demux_file_sparse_pstep.restype = i64
        lib.pfv_demux_file_sparse_pstep.argtypes = [
            p_u8, i64, i64, i64, i64, p_u16, vp, p_u8, p_u8, vp, vp, i64, vp,
            ctypes.c_int32, p_i32, p_i32, i64, i64]
        lib.pfv_demux_file_sparse_tiles.restype = i64
        lib.pfv_demux_file_sparse_tiles.argtypes = [
            p_u8, i64, i64, i64, i64, p_u16, vp, p_u8, p_u8, vp, i64, p_i32,
            i64, vp, ctypes.c_int32, p_i32, p_i32, p_i32, i64]
        lib.pfv_tile_demux_new.restype = vp
        lib.pfv_tile_demux_new.argtypes = [ctypes.c_int32]
        lib.pfv_tile_demux_free.restype = None
        lib.pfv_tile_demux_free.argtypes = [vp]
        lib.pfv_tile_demux_decode.restype = i64
        lib.pfv_tile_demux_decode.argtypes = [
            vp, p_u8, i64, i64, i64, i64, p_u16, p_i32, p_u8, p_u8, i64, p_i16,
            p_i32, p_i32, p_i32, i64, ctypes.POINTER(i64)]
        lib.pfv_tile_demux_splice.restype = i64
        lib.pfv_tile_demux_splice.argtypes = [vp, p_u32, i64, p_i32]
        lib.pfv_pstep_demux_new.restype = vp
        lib.pfv_pstep_demux_new.argtypes = [ctypes.c_int32]
        lib.pfv_pstep_demux_free.restype = None
        lib.pfv_pstep_demux_free.argtypes = [vp]
        lib.pfv_pstep_demux_decode.restype = i64
        lib.pfv_pstep_demux_decode.argtypes = [
            vp, p_u8, i64, i64, i64, i64, i64, i64, p_u64, p_i64, p_i16,
            ctypes.POINTER(i64)]
        lib.pfv_pstep_demux_splice.restype = i64
        lib.pfv_pstep_demux_splice.argtypes = [vp, p_u64, p_u64, p_i64, i64]
        _lib = lib
        return _lib


def _grow(payload_coder, *args) -> bytes:
    """Run an encoder that returns -1 while its buffer is too small (deep
    Huffman codes), doubling the buffer until it fits."""
    cap = args[-1]
    while True:
        out = np.empty(cap, dtype=np.uint8)
        with span("encode.entropy"):
            n = payload_coder(*args[:-1], out, cap)
        if n >= 0:
            count("encode.payload_bytes", n)
            return out[:n].tobytes()
        if n != -1:
            raise ValueError(f"unencodable coefficients (code {n})")
        cap *= 2


def encode_iframe_payload(coeffs: np.ndarray, qidx) -> bytes:
    """coeffs: (total_blocks, 256) int16 zigzag coefficients -> payload bytes."""
    coeffs = np.ascontiguousarray(coeffs, dtype=np.int16)
    return _grow(get_lib().pfv_encode_iframe_payload, coeffs.reshape(-1),
                 coeffs.shape[0], np.asarray(qidx, dtype=np.uint8),
                 coeffs.size * 4 + 1024)


def _out_array(out, shape, dtype) -> np.ndarray:
    """A new array, or `out` checked to be a C-contiguous one of that shape
    and dtype, flat."""
    if out is None:
        return np.empty(int(np.prod(shape)), dtype=dtype)
    if out.shape != shape or out.dtype != dtype or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous {shape} {np.dtype(dtype)} array, "
                         f"got {out.shape} {out.dtype}")
    return out.reshape(-1)


def decode_iframe_payload(payload: bytes, total_blocks: int, out=None):
    """payload -> ((total_blocks, 256) int16 coeffs, (3,) uint8 q-table idx);
    the coefficients are written into `out` (such an array) when given."""
    buf = np.frombuffer(payload, dtype=np.uint8)
    coeffs = _out_array(out, (total_blocks, 256), np.int16)
    qidx = np.empty(3, dtype=np.uint8)
    rc = get_lib().pfv_decode_iframe_payload(buf, len(payload), total_blocks * 4,
                                             coeffs, qidx)
    if rc != 0:
        raise ValueError(f"corrupt I-frame payload (code {rc})")
    return coeffs.reshape(total_blocks, 256), qidx


def encode_iframe_payload_sparse(idx, val, total_blocks: int, qidx) -> bytes:
    """Sparse frame coefficients (sorted frame-local flat idx, nonzero val)
    -> I-frame payload bytes, byte-identical to the dense encoder."""
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    val = np.ascontiguousarray(val, dtype=np.int16)
    return _grow(get_lib().pfv_encode_iframe_payload_sparse, idx, val,
                 idx.shape[0], total_blocks, np.asarray(qidx, dtype=np.uint8),
                 idx.shape[0] * 8 + total_blocks * 48 + 1024)


def encode_pframe_payload_sparse(idx, val, mvx, mvy, has_coeff, qidx) -> bytes:
    """Sparse twin of encode_pframe_payload (entries in skipped blocks are
    ignored, as the dense encoder never reads them)."""
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    val = np.ascontiguousarray(val, dtype=np.int16)
    total_blocks = mvx.shape[0]
    return _grow(get_lib().pfv_encode_pframe_payload_sparse, idx, val,
                 idx.shape[0], np.ascontiguousarray(mvx, dtype=np.int8),
                 np.ascontiguousarray(mvy, dtype=np.int8),
                 np.ascontiguousarray(has_coeff, dtype=np.uint8), total_blocks,
                 np.asarray(qidx, dtype=np.uint8),
                 idx.shape[0] * 8 + total_blocks * 48 + 1024)


def encode_pframe_payload(coeffs, mvx, mvy, has_coeff, qidx) -> bytes:
    """Dense per-block arrays -> P-frame payload bytes."""
    coeffs = np.ascontiguousarray(coeffs, dtype=np.int16)
    total_blocks = coeffs.shape[0]
    return _grow(get_lib().pfv_encode_pframe_payload, coeffs.reshape(-1),
                 np.ascontiguousarray(mvx, dtype=np.int8),
                 np.ascontiguousarray(mvy, dtype=np.int8),
                 np.ascontiguousarray(has_coeff, dtype=np.uint8), total_blocks,
                 np.asarray(qidx, dtype=np.uint8),
                 coeffs.size * 4 + 16 * total_blocks + 1024)


def decode_pframe_payload(payload: bytes, total_blocks: int, out=None):
    """payload -> (coeffs (N,256) i16, mvx (N,) i8, mvy (N,) i8,
    has_coeff (N,) u8, qidx (3,) u8); written into `out`, the four arrays
    (coeffs, mvx, mvy, has_coeff) of those shapes, when given."""
    buf = np.frombuffer(payload, dtype=np.uint8)
    n = total_blocks
    coeffs, mvx, mvy, has_coeff = (
        _out_array(o, s, d) for o, s, d in zip(
            (None,) * 4 if out is None else out,
            ((n, 256), (n,), (n,), (n,)), (np.int16, np.int8, np.int8, np.uint8)))
    qidx = np.empty(3, dtype=np.uint8)
    rc = get_lib().pfv_decode_pframe_payload(buf, len(payload), total_blocks,
                                             coeffs, mvx, mvy, has_coeff, qidx)
    if rc != 0:
        raise ValueError(f"corrupt P-frame payload (code {rc})")
    return coeffs.reshape(total_blocks, 256), mvx, mvy, has_coeff, qidx


def _pad16(x: int) -> int:
    return x + (16 - x % 16) % 16


def _plane_dims(info: dict):
    """(luma, chroma) padded plane shapes and (yb, cb) block counts."""
    w, h = info["width"], info["height"]
    ly = (_pad16(h), _pad16(w))
    lc = (_pad16(h // 2), _pad16(w // 2))
    return ly, lc, (ly[0] // 16) * (ly[1] // 16), (lc[0] // 16) * (lc[1] // 16)


def _mv_bounds(ly, lc):
    """Per-block legal motion ranges (lox, hix, loy, hiy) over the
    concatenated Y, U, V blocks, clipped into int8 (stream motion components
    are 7-bit, so a clipped bound is never the one violated)."""

    def plane(ph, pw):
        b = np.arange((ph // 16) * (pw // 16))
        by, bx = (b // (pw // 16)) * 16, (b % (pw // 16)) * 16
        return -bx, pw - 16 - bx, -by, ph - 16 - by

    parts = [plane(*ly), plane(*lc), plane(*lc)]
    return tuple(np.clip(np.concatenate([p[i] for p in parts]), -64, 63)
                 .astype(np.int8) for i in range(4))


def validate_motion(mvx, mvy, ly, lc) -> None:
    """Reject motion vectors whose 16x16 prediction window leaves the padded
    plane (the reference panics on such streams). mvx/mvy: (..., B) int8
    over the concatenated Y, U, V blocks."""
    lox, hix, loy, hiy = _mv_bounds(tuple(ly), tuple(lc))
    if ((mvx < lox).any() or (mvx > hix).any()
            or (mvy < loy).any() or (mvy > hiy).any()):
        raise ValueError("corrupt P-frame payload: motion vector out of bounds")


def _mv_bounds_packed(ly, lc) -> np.ndarray:
    """Per-block packed int8 motion bounds lox | hix << 8 | loy << 16 |
    hiy << 24 for the native validation in the sparse demuxes."""
    lox, hix, loy, hiy = (b.view(np.uint8).astype(np.uint32)
                          for b in _mv_bounds(ly, lc))
    return (lox | (hix << 8) | (loy << 16) | (hiy << 24)).view(np.int32)


def parse_header(data: bytes):
    """Parse a PFV header -> (info dict, first-packet byte offset)."""
    buf = np.frombuffer(data, dtype=np.uint8)
    dims = np.zeros(4, dtype=np.int32)
    # the format carries a u16 table count and the reference keeps them all
    nq_guess = int.from_bytes(data[18:20], "little") if len(data) >= 20 else 0
    qtables = np.zeros(max(nq_guess, 1) * 64, dtype=np.int32)
    off = get_lib().pfv_parse_header(buf, len(data), dims, qtables, qtables.size)
    if off < 0:
        raise ValueError(f"bad PFV header (code {off})")
    nq = int(dims[3])
    info = {"width": int(dims[0]), "height": int(dims[1]),
            "framerate": int(dims[2]),
            "qtables": qtables[: nq * 64].reshape(nq, 64).copy()}
    return info, int(off)


def count_frames(data: bytes) -> int:
    """The number of frames the stream emits (drop frames and unknown
    packets emit none)."""
    _, off = parse_header(data)
    nf = get_lib().pfv_count_frames(np.frombuffer(data, dtype=np.uint8),
                                    len(data), off)
    if nf < 0:
        raise ValueError(f"corrupt packet stream (code {nf})")
    return int(nf)


@contextlib.contextmanager
def _native_demux(data: bytes):
    """The span "pfv.decode.demux_native" around one native demux call of
    `data`, with counters while a profiler session records: the process's
    CPU seconds over the call, every thread's, user and kernel mode
    (`decode.demux_cpu_s`) and the kernel mode's part (`decode.demux_sys_s`),
    and the bytes it was given (`decode.demux_bytes`). The call releases the
    interpreter lock and joins its workers before it returns."""
    if not recording():
        yield
        return
    r0 = resource.getrusage(resource.RUSAGE_SELF)
    with span("decode.demux_native"):
        yield
    r1 = resource.getrusage(resource.RUSAGE_SELF)
    sys_s = r1.ru_stime - r0.ru_stime
    count("decode.demux_cpu_s", r1.ru_utime - r0.ru_utime + sys_s)
    count("decode.demux_sys_s", sys_s)
    count("decode.demux_bytes", len(data))


def demux_file_sparse_packed(data: bytes, num_threads: int = 0,
                             pad_to_multiple: int = 1, pstep_tables=None):
    """Sparse whole-file demux, device-upload form.

    Returns (info, deltas (n,) u16, vals (n,) i8, bh (F, B) u16,
    ftype (F,) u8, qidx (F, 3) u8):
    - deltas chain the flat position through an inclusive cumsum; the
      dense value at a position is the scatter-ADD of its units' vals
      (|v| > 127 spans several same-position units; zero-value units are
      no-ops). The final unit parks the position at F*span, one past the
      end; with pad_to_multiple > 1 the arrays are padded with zero units.
    - bh packs each block's header as (mvx & 127) | (mvy & 127) << 7 |
      has_coeff << 14.
    Without pstep_tables the position is (frame * B + block) * 256 + slot
    (span B*256). pstep_tables = (off_of_b (B,) i32, r_of_zz (64,) i32,
    row_span) chains it through the step kernel's dense coefficient space
    (frame, row r, stripe, lane), rows unzigzagged (span 64*row_span).
    F*span must be < 2^31 and row_span < 2^24. Motion vectors are
    bounds-validated natively."""
    lib = get_lib()
    info, off = parse_header(data)
    ly, lc, yb, cb = _plane_dims(info)
    total_blocks = yb + 2 * cb
    buf = np.frombuffer(data, dtype=np.uint8)
    nf = lib.pfv_count_frames(buf, len(data), off)
    if nf < 0:
        raise ValueError(f"corrupt packet stream (code {nf})")
    span = total_blocks * 256 if pstep_tables is None else 64 * int(pstep_tables[2])
    if nf * span >= 2**31:
        raise ValueError("video too large for sparse flat indexing; chunk it")
    # worst case 69 units per payload byte and 129 per coefficient slot,
    # plus gap escapes and per-frame tails (the native side enforces
    # per-frame caps); only the decoded prefix is ever touched
    cap = (min(69 * len(data), 129 * nf * span) + nf * (span // 65535 + 1)
           + 8 * nf + 1024 + pad_to_multiple)
    bh = np.empty((nf, total_blocks), dtype=np.uint16)
    ftype = np.empty(nf, dtype=np.uint8)
    qidx = np.empty((nf, 3), dtype=np.uint8)
    deltas = np.empty(cap, dtype=np.uint16)
    vals = np.empty(cap, dtype=np.int8)
    bounds = _mv_bounds_packed(ly, lc)
    mv_absmax = np.zeros(1, dtype=np.int16)
    common = (buf, len(data), off, total_blocks, nf, bh.reshape(-1),
              bounds.ctypes.data_as(ctypes.c_void_p), ftype, qidx.reshape(-1),
              deltas.ctypes.data_as(ctypes.c_void_p),
              vals.ctypes.data_as(ctypes.c_void_p), cap,
              mv_absmax.ctypes.data_as(ctypes.c_void_p), num_threads)
    if pstep_tables is not None:
        off_of_b, r_of_zz, row_span = pstep_tables
        if row_span >= 1 << 24:
            raise ValueError("geometry too wide for pstep unit layout")
        off_of_b = np.ascontiguousarray(off_of_b, dtype=np.int32)
        r_of_zz = np.ascontiguousarray(r_of_zz, dtype=np.int32)
        with _native_demux(data):
            nunits = lib.pfv_demux_file_sparse_pstep(*common, off_of_b, r_of_zz, row_span,
                                                     yb + cb)
    else:
        with _native_demux(data):
            nunits = lib.pfv_demux_file_sparse(*common)
    if nunits == -8:
        raise ValueError("corrupt P-frame payload: motion vector out of bounds")
    if nunits < 0:
        raise ValueError(f"sparse demux failed (code {nunits})")
    info["yb"], info["cb"], info["total_blocks"] = yb, cb, total_blocks
    info["mv_absmax"] = int(mv_absmax[0])
    info["unit_layout"] = "pstep" if pstep_tables is not None else "stream"
    m = pad_to_multiple
    padded = ((nunits + m - 1) // m) * m if m > 1 else nunits
    deltas[nunits:padded] = 0
    vals[nunits:padded] = 0
    return info, deltas[:padded], vals[:padded], bh, ftype, qidx


def _addresses(arrays) -> np.ndarray:
    """The data addresses of numpy arrays, for a native entry that takes
    one array per chunk (the caller keeps the arrays alive)."""
    return np.array([a.ctypes.data for a in arrays], dtype=np.uint64)


def demux_file_sparse_pstep(data: bytes, chunk_frames: int = 0, num_threads: int = 0):
    """The pstep demux of `data` in chunks of `chunk_frames` frames (0: one
    chunk of every frame), in the step kernels' layout for the stream's own
    frame size (`dataloader.pstep_tables`): a list with one (info, deltas
    (n,) u16, vals (n,) i8, meta (F*B + 4F,) u16) per chunk of F frames,
    each chunk's arrays its own and of exactly its size. meta packs [block
    headers (F, B) | ftype (F,) | qidx (F, 3)]; each field and the units
    are, byte for byte, what `demux_file_sparse_packed(chunk,
    pstep_tables=...)` gives for a stream of that chunk's frames alone, and
    so is info. Raises ValueError as that function does, a chunk's
    positions in place of the stream's.

    The work runs in a native context kept between calls, in one run of its
    workers for the whole stream (num_threads of them, 0 for one per
    hardware thread): its per-frame buffers at the high-water mark of the
    calls it served, and the tables of the last frame size
    (`release_demux_memory` frees them). While a profiler session records,
    counts `decode.pstep_grow_bytes`, the buffer bytes a call added, and
    `decode.pstep_calls_reused`, the calls that added none."""
    lib = get_lib()
    info, off = parse_header(data)
    _, _, yb, cb = _plane_dims(info)
    total_blocks = yb + 2 * cb
    buf = np.frombuffer(data, dtype=np.uint8)
    nf = lib.pfv_count_frames(buf, len(data), off)
    if nf < 0:
        raise ValueError(f"corrupt packet stream (code {nf})")
    per = chunk_frames if chunk_frames > 0 else max(nf, 1)
    frames = [min(per, nf - a) for a in range(0, nf, per)] or [0]
    metas = [np.empty(f * (total_blocks + 4), dtype=np.uint16) for f in frames]
    units = np.zeros(len(frames), dtype=np.int64)
    mv_absmax = np.zeros(len(frames), dtype=np.int16)
    grown = ctypes.c_int64(0)
    with _pstep_contexts.take(lib, num_threads) as ctx, _native_demux(data):
        n = lib.pfv_pstep_demux_decode(
            ctx, buf, len(data), off, info["width"], info["height"], nf, per,
            _addresses(metas), units, mv_absmax, ctypes.byref(grown))
        if n >= 0:
            deltas = [np.empty(u, dtype=np.uint16) for u in units]
            vals = [np.empty(u, dtype=np.int8) for u in units]
            rc = lib.pfv_pstep_demux_splice(ctx, _addresses(deltas), _addresses(vals),
                                            units, len(frames))
            if rc < 0:
                n = rc
        count("decode.pstep_grow_bytes", grown.value)
        count("decode.pstep_calls_reused", int(grown.value == 0))
    if n == -8:
        raise ValueError("corrupt P-frame payload: motion vector out of bounds")
    if n == -9:
        raise ValueError("video too large for sparse flat indexing; chunk it")
    if n == -10:
        raise ValueError("geometry too wide for pstep unit layout")
    if n < 0:
        raise ValueError(f"sparse demux failed (code {n})")
    info["yb"], info["cb"], info["total_blocks"] = yb, cb, total_blocks
    return [(dict(info, mv_absmax=int(m), unit_layout="pstep"), d, v, meta)
            for m, d, v, meta in zip(mv_absmax, deltas, vals, metas)]


class _Contexts:
    """The idle native demux contexts of one kind ("tile" or "pstep"), by
    `num_threads`. A call takes the idle one returned last or makes one, so
    concurrent callers (the loader's worker, a stream batch, the streaming
    Decoder) each hold their own, and one caller's calls find the buffers
    it grew."""

    def __init__(self, kind: str):
        self.kind = kind
        self.lock = threading.Lock()
        self.idle: list[tuple[int, int]] = []

    @contextlib.contextmanager
    def take(self, lib, num_threads: int):
        with self.lock:
            i = next((i for i in reversed(range(len(self.idle)))
                      if self.idle[i][0] == num_threads), None)
            ctx = None if i is None else self.idle.pop(i)[1]
        if ctx is None:
            ctx = getattr(lib, f"pfv_{self.kind}_demux_new")(num_threads)
            if not ctx:
                raise MemoryError(f"no memory for a {self.kind} demux context")
        try:
            yield ctx
        finally:
            with self.lock:
                self.idle.append((num_threads, ctx))

    def release(self, lib) -> None:
        with self.lock:
            idle, self.idle = self.idle, []
        for _, ctx in idle:
            getattr(lib, f"pfv_{self.kind}_demux_free")(ctx)

    def after_fork(self) -> None:
        # the lock may have been held by a thread the child does not have;
        # the contexts rebuild their workers on first use
        self.lock = threading.Lock()


_contexts = _Contexts("tile")
_pstep_contexts = _Contexts("pstep")
os.register_at_fork(after_in_child=_contexts.after_fork)
os.register_at_fork(after_in_child=_pstep_contexts.after_fork)


def release_demux_memory() -> None:
    """Free the workers and buffers that the tile and pstep demuxes keep
    between calls (each idle context holds the high-water mark of the calls
    it served). A context in use keeps its memory until it is next
    released. The next call makes a new context."""
    if _lib is not None:
        _contexts.release(_lib)
        _pstep_contexts.release(_lib)


def demux_file_sparse_tiles(data: bytes, tile_tables, chunk: int = 128,
                            num_threads: int = 0):
    """Tile-bucketed unit demux for the frame step's in-kernel densify.

    Units are grouped per (frame, stripe) tile in zero-padded chunks of
    `chunk`: units (n_chunks, chunk) u32 packs one unit per word,
    idx << 16 | (u16)(i16)val, idx = dense row r << 10 | lane (lane < 1024),
    val the sign-extended i8 addend (|v| > 127 spans several same-position
    units, in no set order). Chunk k of tile t = frame*gch + stripe lives at
    rows coff[t] <= k < coff[t+1]; padding words (idx 0, val 0) are no-ops.

    tile_tables = (stripe_of_b (B,) i32, lanebase_of_b (B,) i32,
    r_of_zz (64,) i32, gch). Returns (info, units, coff (F*gch + 1,) i32,
    bh (F, B) u16, ftype (F,) u8, qidx (F, 3) u8), every array new.

    The work runs in a native context kept between calls (its workers, and
    its per-frame unit buffers at the high-water mark of the calls it
    served; `release_demux_memory` frees them); num_threads workers, 0 for
    one per hardware thread. While a profiler session records, counts
    `decode.demux_grow_bytes`, the buffer bytes a call added, and
    `decode.demux_calls_reused`, the calls that added none."""
    lib = get_lib()
    info, off = parse_header(data)
    ly, lc, yb, cb = _plane_dims(info)
    total_blocks = yb + 2 * cb
    stripe_of_b, lanebase_of_b, r_of_zz, gch = tile_tables
    buf = np.frombuffer(data, dtype=np.uint8)
    nf = lib.pfv_count_frames(buf, len(data), off)
    if nf < 0:
        raise ValueError(f"corrupt packet stream (code {nf})")
    bh = np.empty((nf, total_blocks), dtype=np.uint16)
    ftype = np.empty(nf, dtype=np.uint8)
    qidx = np.empty((nf, 3), dtype=np.uint8)
    coff = np.empty(nf * gch + 1, dtype=np.int32)
    bounds = _mv_bounds_packed(ly, lc)
    mv_absmax = np.zeros(1, dtype=np.int16)
    grown = ctypes.c_int64(0)
    tables = [np.ascontiguousarray(t, dtype=np.int32)
              for t in (stripe_of_b, lanebase_of_b, r_of_zz)]
    with _contexts.take(lib, num_threads) as ctx, _native_demux(data):
        nchunks = lib.pfv_tile_demux_decode(
            ctx, buf, len(data), off, total_blocks, nf, bh.reshape(-1), bounds,
            ftype, qidx.reshape(-1), chunk, mv_absmax, *tables, gch,
            ctypes.byref(grown))
        if nchunks >= 0:
            units = np.empty((nchunks, chunk), dtype=np.uint32)
            rc = lib.pfv_tile_demux_splice(ctx, units.reshape(-1), nchunks, coff)
            if rc < 0:
                nchunks = rc
        count("decode.demux_grow_bytes", grown.value)
        count("decode.demux_calls_reused", int(grown.value == 0))
    if nchunks == -8:
        raise ValueError("corrupt P-frame payload: motion vector out of bounds")
    if nchunks < 0:
        raise ValueError(f"tile demux failed (code {nchunks})")
    info["yb"], info["cb"], info["total_blocks"] = yb, cb, total_blocks
    info["mv_absmax"] = int(mv_absmax[0])
    info["unit_layout"] = "tiles"
    return info, units, coff, bh, ftype, qidx


def ref_decode(data: bytes, emit: bool = True, max_frames: int = 1 << 30):
    """Scalar single-core decode of a whole .pfv buffer (the oracle).

    Returns (num_frames, Y (F,h,w) u8 | None, U, V, info)."""
    lib = get_lib()
    info, off = parse_header(data)
    w, h = info["width"], info["height"]
    buf = np.frombuffer(data, dtype=np.uint8)
    dims = np.zeros(4, dtype=np.int32)
    if not emit:
        n = lib.pfv_ref_decode(buf, len(data), None, None, None, 0, dims)
        if n < 0:
            raise ValueError(f"ref decode failed (code {n})")
        return int(n), None, None, None, info
    exact = int(lib.pfv_count_frames(buf, len(data), off))
    if exact < 0:
        raise ValueError(f"corrupt packet stream (code {exact})")
    cap = min(max_frames, exact)
    y = np.empty((cap, h, w), dtype=np.uint8)
    u = np.empty((cap, h // 2, w // 2), dtype=np.uint8)
    v = np.empty((cap, h // 2, w // 2), dtype=np.uint8)
    n = lib.pfv_ref_decode(buf, len(data), y.ctypes.data_as(ctypes.c_void_p),
                           u.ctypes.data_as(ctypes.c_void_p),
                           v.ctypes.data_as(ctypes.c_void_p), cap, dims)
    if n < 0:
        raise ValueError(f"ref decode failed (code {n})")
    return int(n), y[:n], u[:n], v[:n], info


__all__ = ["count_frames", "decode_iframe_payload", "decode_pframe_payload",
           "demux_file_sparse_packed", "demux_file_sparse_pstep", "demux_file_sparse_tiles",
           "encode_iframe_payload", "encode_iframe_payload_sparse",
           "encode_pframe_payload", "encode_pframe_payload_sparse",
           "get_lib", "parse_header", "ref_decode", "release_demux_memory",
           "validate_motion"]
