"""Build the hand-written CUDA kernels of `pfv_torch/csrc` and bind them.

`nvcc` compiles every `csrc/*.cu` for sm_90a into one shared library with a
plain C interface, at first use and again whenever a source is newer than
the library; `ctypes` binds it. The library lives in `pfv_torch/build/`,
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
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def build() -> str:
    """Compile the kernels into SO_PATH; returns nvcc's log."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, SO_PATH)  # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return proc.stdout + proc.stderr


def _stale() -> bool:
    if not os.path.exists(SO_PATH):
        return True
    built = os.path.getmtime(SO_PATH)
    return any(os.path.getmtime(s) > built for s in _sources())


def lib() -> ctypes.CDLL:
    """The kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            so = ctypes.CDLL(SO_PATH)
            p, i = ctypes.c_void_p, ctypes.c_int
            so.pfv_step_frame.argtypes = [p] * 8 + [i] * 5 + [p]
            so.pfv_step_frame.restype = i
            so.pfv_canvas_rgba.argtypes = [p, p] + [i] * 7 + [p]
            so.pfv_canvas_rgba.restype = i
            _lib = so
        return _lib
