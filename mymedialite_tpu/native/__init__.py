"""Native (C++) components, loaded via ctypes.

The shared library is compiled lazily with g++ on first use and cached
next to the sources; everything degrades gracefully to the pure-Python
paths when no compiler is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fast_parser.cpp")
_LIB = os.path.join(_HERE, "libfastparser.so")
_HASH = _LIB + ".srchash"

_lock = threading.Lock()
_lib = None
_tried = False


def _src_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _build(src_hash: str) -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
             _SRC, "-o", _LIB + ".tmp"],
            check=True, capture_output=True, timeout=120)
        os.replace(_LIB + ".tmp", _LIB)
        with open(_HASH, "w") as f:
            f.write(src_hash)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _stale(src_hash: str) -> bool:
    # source-hash check, not mtime: git checkouts randomize mtime order,
    # which forced a spurious ~12 s g++ rebuild into the first model's
    # init_model on fresh clones (and an mtime tie could miss a REAL
    # source change committed together with a stale binary)
    if not os.path.exists(_LIB):
        return True
    try:
        with open(_HASH) as f:
            return f.read().strip() != src_hash
    except OSError:
        return True


def get_lib():
    """The loaded shared library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        src_hash = _src_hash()
        if _stale(src_hash):
            if not _build(src_hash):
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        lib.mml_parse.restype = ctypes.c_int64
        lib.mml_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ]
        lib.mml_free.restype = None
        lib.mml_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def parse_numeric_file(path: str, min_columns: int,
                       skip_first_line: bool = False):
    """Parse a numeric interaction file natively. Returns
    (users, items, values, times) numpy arrays (values/times None when not
    requested), or None if the native parser is unavailable or the file
    contains non-numeric ids (caller falls back to the Python reader)."""
    lib = get_lib()
    if lib is None:
        return None
    users_p = ctypes.POINTER(ctypes.c_int32)()
    items_p = ctypes.POINTER(ctypes.c_int32)()
    values_p = ctypes.POINTER(ctypes.c_float)()
    times_p = ctypes.POINTER(ctypes.c_int64)()
    n = lib.mml_parse(path.encode(), min_columns, int(skip_first_line),
                      ctypes.byref(users_p), ctypes.byref(items_p),
                      ctypes.byref(values_p), ctypes.byref(times_p))
    if n < 0:
        return None
    try:
        def take(ptr, dtype, count):
            if not ptr or count == 0:
                return np.zeros(0, dtype=dtype)
            return np.ctypeslib.as_array(ptr, shape=(count,)).astype(
                dtype, copy=True)

        users = take(users_p, np.int32, n)
        items = take(items_p, np.int32, n)
        values = take(values_p, np.float32, n) if min_columns >= 3 else None
        times = take(times_p, np.int64, n) if min_columns >= 4 else None
    finally:
        for p in (users_p, items_p, values_p, times_p):
            if p:
                lib.mml_free(ctypes.cast(p, ctypes.c_void_p))
    return users, items, values, times
