"""ctypes wrapper around the native host runtime (C++).

Builds `native_src/host_runtime.cpp` with g++ on first use (cached by
source hash, same scheme as oracle/native.py) and exposes the host-side
serving hot loop: expanding the device's packed (word_index, word_bits)
keypoint encoding into (x, y) arrays — single frame and threaded batch.

`available()` gates use; every caller keeps the numpy fallback
(ops.compact.expand_words_host), so environments without a toolchain
still work.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

from ..utils.native_build import build_shared_lib

_SRC = os.path.join(os.path.dirname(__file__), "native_src", "host_runtime.cpp")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is None and not _build_failed:
            try:
                lib = ctypes.CDLL(build_shared_lib(_SRC, ("-pthread",)))
            except (OSError, subprocess.SubprocessError):
                _build_failed = True
                return None
            i32 = ctypes.c_int32
            i64 = ctypes.c_int64
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            lib.fdf_expand_words.argtypes = [i32p, u32p, i32, i32, i64, u32p]
            lib.fdf_expand_words.restype = i64
            lib.fdf_expand_words_batch.argtypes = [
                i32p, u32p, i32, i32, i32, i64, u32p, i64p, i32,
            ]
            lib.fdf_expand_words_batch.restype = None
            lib.fdf_expand_supers.argtypes = [i32p, u32p, i32, i32, i32,
                                              i64, u32p]
            lib.fdf_expand_supers.restype = i64
            lib.fdf_expand_supers_batch.argtypes = [
                i32p, u32p, i32, i32, i32, i32, i64, u32p, i64p, i32,
            ]
            lib.fdf_expand_supers_batch.restype = None
            _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def expand_words(
    word_idx: np.ndarray, word_bits: np.ndarray, width: int,
    n_points_hint: int = 0,
) -> np.ndarray:
    """Native expansion of one frame's packed words -> (N, 2) uint32 (x, y),
    row-major order; bit-identical to ops.compact.expand_words_host."""
    lib = _load()
    assert lib is not None, "native runtime unavailable — check available()"
    widx = np.ascontiguousarray(word_idx, np.int32)
    wbits = np.ascontiguousarray(word_bits, np.uint32)
    cap = max(int(n_points_hint), 32 * 64)
    while True:
        out = np.empty((cap, 2), np.uint32)
        n = lib.fdf_expand_words(widx, wbits, widx.shape[0], int(width),
                                 cap, out.reshape(-1))
        if n >= 0:
            return out[:n].copy()
        cap *= 4


def expand_words_batch(
    word_idx: np.ndarray, word_bits: np.ndarray, width: int,
    per_frame_cap: int, threads: int = 0,
) -> List[np.ndarray]:
    """Threaded expansion of a (B, max_words) batch -> list of per-frame
    (N_i, 2) uint32 arrays."""
    lib = _load()
    assert lib is not None, "native runtime unavailable — check available()"
    widx = np.ascontiguousarray(word_idx, np.int32)
    wbits = np.ascontiguousarray(word_bits, np.uint32)
    b, mw = widx.shape
    cap = max(1, int(per_frame_cap))
    threads = threads or min(b, os.cpu_count() or 1)
    while True:
        out = np.empty((b, cap, 2), np.uint32)
        counts = np.empty((b,), np.int64)
        lib.fdf_expand_words_batch(
            widx.reshape(-1), wbits.reshape(-1), b, mw, int(width),
            cap, out.reshape(-1), counts, int(threads),
        )
        if (counts >= 0).all():
            return [out[i, : counts[i]].copy() for i in range(b)]
        cap *= 4


def expand_supers(
    super_idx: np.ndarray, super_bits: np.ndarray, width: int,
    n_points_hint: int = 0,
) -> np.ndarray:
    """Native expansion of one frame's superword encoding ((cap_s,) idx +
    (cap_s, span) bits; ops/compact.py) -> (N, 2) uint32 (x, y), row-major;
    bit-identical to ops.compact.expand_supers_host."""
    lib = _load()
    assert lib is not None, "native runtime unavailable — check available()"
    sidx = np.ascontiguousarray(super_idx, np.int32)
    sbits = np.ascontiguousarray(super_bits, np.uint32)
    ms, span = sbits.shape
    cap = max(int(n_points_hint), 32 * 64)
    while True:
        out = np.empty((cap, 2), np.uint32)
        n = lib.fdf_expand_supers(sidx, sbits.reshape(-1), ms, span,
                                  int(width), cap, out.reshape(-1))
        if n >= 0:
            return out[:n].copy()
        cap *= 4


def expand_supers_batch(
    super_idx: np.ndarray, super_bits: np.ndarray, width: int,
    per_frame_cap: int, threads: int = 0,
) -> List[np.ndarray]:
    """Threaded expansion of a (B, cap_s) + (B, cap_s, span) superword
    batch -> list of per-frame (N_i, 2) uint32 arrays."""
    lib = _load()
    assert lib is not None, "native runtime unavailable — check available()"
    sidx = np.ascontiguousarray(super_idx, np.int32)
    sbits = np.ascontiguousarray(super_bits, np.uint32)
    b, ms = sidx.shape
    span = sbits.shape[-1]
    cap = max(1, int(per_frame_cap))
    threads = threads or min(b, os.cpu_count() or 1)
    while True:
        out = np.empty((b, cap, 2), np.uint32)
        counts = np.empty((b,), np.int64)
        lib.fdf_expand_supers_batch(
            sidx.reshape(-1), sbits.reshape(-1), b, ms, span, int(width),
            cap, out.reshape(-1), counts, int(threads),
        )
        if (counts >= 0).all():
            return [out[i, : counts[i]].copy() for i in range(b)]
        cap *= 4
