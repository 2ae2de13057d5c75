"""Build the hand-written CUDA kernels of `pfv_torch/csrc` and bind them.

`nvcc` compiles every `csrc/*.cu` for sm_90a, one process per source, all
started together, and links the objects into one shared library with a plain
C interface, at first use and again whenever a source or header is newer
than the library; `ctypes` binds it. The library lives in `pfv_torch/build/`,
which git ignores. Nothing here runs at import time: a machine without
`nvcc` or a card can import every module of the package.
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SO_PATH = os.path.join(BUILD_DIR, "libpfv_torch_kernels.so")
# -fmad=false: K2's float math must not be contracted into FMAs (exactness);
# -Xptxas -v: the log reports each kernel's registers and shared memory
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _run(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; wait for all; raise if any failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for c, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(c)} failed (exit {p.returncode}):\n{err}")
    return "".join(out + err for out, err in outs)


def build() -> str:
    """Compile the kernels into SO_PATH; returns nvcc's log."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in _sources()]
        log = _run([[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s]
                    for s, o in zip(_sources(), objs)])
        so = os.path.join(tmp, "lib.so")
        log += _run([[_nvcc(), "-shared", "-o", so, *objs]])
        os.replace(so, SO_PATH)  # atomic: another process never loads half a file
    return log


def _stale() -> bool:
    if not os.path.exists(SO_PATH):
        return True
    built = os.path.getmtime(SO_PATH)
    deps = glob.glob(os.path.join(CSRC_DIR, "*.cu*"))
    return any(os.path.getmtime(s) > built for s in deps)


def lib() -> ctypes.CDLL:
    """The kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            so = ctypes.CDLL(SO_PATH)
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            so.pfv_step_clip.argtypes = [p] * 9 + [i] * 6 + [p]
            so.pfv_step_clip.restype = i
            so.pfv_dense_seq_clip.argtypes = [p] * 8 + [i] * 6 + [p]
            so.pfv_dense_seq_clip.restype = i
            so.pfv_dense_gops.argtypes = [p, ll, p, ll, ll, p, p, p, ll, ll, p, ll,
                                          ll, p, ll, ll, p, ll, ll] + [i] * 7 + [p]
            so.pfv_dense_gops.restype = i
            so.pfv_canvas_rgba.argtypes = [p, p] + [i] * 7 + [p]
            so.pfv_canvas_rgba.restype = i
            so.pfv_idct_blocks.argtypes = [p, p, p, i, p]
            so.pfv_idct_blocks.restype = i
            so.pfv_mc_reconstruct.argtypes = [p, p, i, i, i] + [p] * 5 + [i, p, i, i, p]
            so.pfv_mc_reconstruct.restype = i
            so.pfv_frame_encode.argtypes = ([p] * 3 + [ll] * 3 + [p] * 3 + [i, p, i, i, i,
                                                                           p, ll, p, p, i, p])
            so.pfv_frame_encode.restype = i
            so.pfv_frame_step.argtypes = [p] * 4 + [i, p, i, i, i, p, ll, p, ll, p, i, p]
            so.pfv_frame_step.restype = i
            so.pfv_motion_search.argtypes = ([p] * 3 + [ll] * 3 + [p, ll, p, p, p,
                                                                  ctypes.c_float, p, i, p])
            so.pfv_motion_search.restype = i
            _lib = so
        return _lib


def launch(entry: str, device, *args) -> int:
    """Call the library's `entry` on `device`: CUDA's current device is
    `device` for the call (the kernels launch on the current device, and a
    caller's thread may stand on another), and the device's current stream
    goes in as the last argument. Returns the entry's CUDA error code."""
    import torch

    with torch.cuda.device(device):
        return getattr(lib(), entry)(*args, torch.cuda.current_stream(device).cuda_stream)


def count(wrapper, n: int = 1) -> None:
    """Add n kernel launches to `wrapper.launches`; threads of several
    devices count into the same wrapper."""
    with _count_lock:
        wrapper.launches += n
