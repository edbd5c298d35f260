# -*- coding: utf-8 -*-
"""ctypes binding for the native C++ ASCII tokenizer with lazy build and
transparent fallback.

The reference is pure Python (SURVEY §2.12: no native sources anywhere);
this is the runtime-native layer of the rebuild's data loader — the Python
dialect parser remains the reference implementation and the semantics
oracle (tests assert byte-identical results on every dialect fixture).
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess

import numpy as np

log = logging.getLogger(__name__)

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libfastparse.so")
_SRC_PATH = os.path.join(_NATIVE_DIR, "fastparse.cpp")

_lib = None
_lib_tried = False


def _build() -> bool:
    """Builds the shared library in-tree (best effort)."""
    if not os.path.exists(_SRC_PATH):
        return False
    # build beside the target and rename: processes that build at once
    # never load a half-written library
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-std=c++17", "-shared",
             "-o", tmp, _SRC_PATH],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        log.debug("native parser build failed: %s", e)
        return False


def _stale() -> bool:
    """True when the library is missing or older than its source, so a
    library copied along from another build is never loaded."""
    if not os.path.exists(_LIB_PATH):
        return True
    return (os.path.exists(_SRC_PATH)
            and os.path.getmtime(_SRC_PATH) > os.path.getmtime(_LIB_PATH))


def _load():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if _stale() and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        log.debug("native parser load failed: %s", e)
        return None
    lib.mc_parse.restype = ctypes.c_void_p
    lib.mc_parse.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long]
    lib.mc_rows.restype = ctypes.c_long
    lib.mc_rows.argtypes = [ctypes.c_void_p]
    lib.mc_cols.restype = ctypes.c_long
    lib.mc_cols.argtypes = [ctypes.c_void_p]
    lib.mc_copy.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_double)]
    lib.mc_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def parse_text(text: str, skip_lines: int = 0):
    """Parses an ASCII table natively; returns float64 array or None if
    the native library is unavailable or found no data."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode("utf-8", "replace")
    handle = lib.mc_parse(raw, len(raw), skip_lines)
    try:
        rows, cols = lib.mc_rows(handle), lib.mc_cols(handle)
        if rows <= 0 or cols <= 0:
            return None
        out = np.empty(rows * cols, dtype=np.float64)
        lib.mc_copy(handle, out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_double)))
        return out.reshape(rows, cols)
    finally:
        lib.mc_free(handle)
