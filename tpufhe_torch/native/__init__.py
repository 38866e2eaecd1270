"""The native (C++) ChaCha8 / uniform / CBD sampler, built with g++ at first
use.

``tpufhe_native.cpp`` is compiled with ``g++ -O3 -shared -fPIC`` into
``tpufhe_torch/_build/`` (named by a hash of the source, so an edited
source is rebuilt) and loaded with ctypes. ``lib()`` returns the library,
or None when no g++ is found or the build fails; ``error`` then says why,
and the callers in ``utils/rngs.py`` and ``utils/sampling.py`` draw the
same bytes in pure Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "tpufhe_native.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_tried = False
error: str | None = None


def _so_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(_BUILD, f"native-{h.hexdigest()[:16]}.so")


def _build(gxx: str, so: str) -> str | None:
    """Compile the library into `so`; returns an error message or None."""
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *_FLAGS, "-o", tmp, _SRC],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        return f"g++ exit {proc.returncode}: {proc.stderr.strip()}"
    os.replace(tmp, so)
    return None


def available() -> bool:
    """Whether the native sampler is built and loaded (tpufhe's
    native.available). It reports only: the callers that need the library
    take it from ``lib()``."""
    return lib() is not None


def lib():
    """The loaded CDLL, or None when it cannot be built (see ``error``)."""
    global _lib, _tried, error
    if _tried:
        return _lib
    _tried = True
    so = _so_path()
    if not os.path.exists(so):
        gxx = shutil.which("g++")
        if gxx is None:
            error = "g++ not found"
            return None
        error = _build(gxx, so)
        if error is not None:
            return None
    L = ctypes.CDLL(so)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    L.chacha_blocks.argtypes = [
        u32p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32,
        ctypes.c_uint64, ctypes.c_char_p,
    ]
    L.chacha_blocks.restype = None
    L.chacha_uniform_u64.argtypes = [
        u32p, ctypes.c_uint64, ctypes.c_uint32, u64p, u32p,
        ctypes.c_uint64, ctypes.c_uint64, u64p,
    ]
    L.chacha_uniform_u64.restype = None
    L.chacha_cbd.argtypes = [
        u32p, ctypes.c_uint64, ctypes.c_uint32, u64p, u32p,
        ctypes.c_uint32, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int64),
    ]
    L.chacha_cbd.restype = None
    _lib = L
    return _lib
