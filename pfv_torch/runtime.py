"""The shared C++ entropy/container runtime, loaded without `import pfv_tpu`.

`pfv_tpu/runtime/__init__.py` binds `libpfv_bitstream.so` (built with g++
next to its source on first use) and imports only ctypes, numpy, os,
subprocess and threading. Importing it as `pfv_tpu.runtime` would first run
`pfv_tpu/__init__.py`, which imports jax; loading the file by path under a
private module name keeps jax out of the process.
"""

from __future__ import annotations

import importlib.util
import os
import sys

_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "pfv_tpu", "runtime", "__init__.py")
_NAME = "pfv_torch._shared_runtime"


def _load():
    mod = sys.modules.get(_NAME)
    if mod is None:
        spec = importlib.util.spec_from_file_location(_NAME, _PATH)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[_NAME] = mod
    return mod


_rt = _load()

parse_header = _rt.parse_header
demux_file_sparse_tiles = _rt.demux_file_sparse_tiles
ref_decode = _rt.ref_decode
decode_iframe_payload = _rt.decode_iframe_payload
decode_pframe_payload = _rt.decode_pframe_payload
encode_iframe_payload = _rt.encode_iframe_payload
encode_pframe_payload = _rt.encode_pframe_payload
encode_iframe_payload_sparse = _rt.encode_iframe_payload_sparse
encode_pframe_payload_sparse = _rt.encode_pframe_payload_sparse
validate_motion = _rt.validate_motion

__all__ = ["parse_header", "demux_file_sparse_tiles", "ref_decode",
           "decode_iframe_payload", "decode_pframe_payload",
           "encode_iframe_payload", "encode_pframe_payload",
           "encode_iframe_payload_sparse", "encode_pframe_payload_sparse",
           "validate_motion"]
