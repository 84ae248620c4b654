"""Native (C++) host-side components, loaded via ctypes.

Built lazily with g++ into ``_build/`` on first use; every caller has a pure
NumPy fallback, so the package works without a toolchain.  See
``spada_native.cpp`` for what is implemented natively and why.

Copy of :mod:`spada_tpu.native` for spada_tpu_torch, held equal to it by
``tests/test_torch_host.py``.  It builds its own library from its own copy
of ``spada_native.cpp`` into ``spada_tpu_torch/_build/``, written under a
temporary name and renamed into place, so that processes building at
once never load a half-written library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "spada_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "_build")
_SO = os.path.join(_BUILD_DIR, "libspada_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it if needed; None if unavailable."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if not os.path.exists(_SO) or (
            os.path.getmtime(_SO) < os.path.getmtime(_SRC)
        ):
            if not _build():
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _build_failed = True
            return None
        lib.mtx_parse_body.restype = ctypes.c_int64
        lib.mtx_parse_body.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.plan_tile_cache.restype = ctypes.c_int64
        lib.plan_tile_cache.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.esc_plan.restype = ctypes.c_int
        lib.esc_plan.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.plan_panel_cache.restype = ctypes.c_int64
        lib.plan_panel_cache.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.traffic_simulate.restype = ctypes.c_int
        lib.traffic_simulate.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def mtx_parse_body(body: bytes, nnz: int, pattern: bool):
    """Native coordinate-body parse; returns (rows, cols, vals) or None."""
    lib = load()
    if lib is None:
        return None
    rows = np.empty(nnz, dtype=np.int64)
    cols = np.empty(nnz, dtype=np.int64)
    vals = np.empty(nnz, dtype=np.float64)
    n = lib.mtx_parse_body(
        body, len(body), nnz, int(pattern),
        _ptr(rows, ctypes.c_int64), _ptr(cols, ctypes.c_int64),
        _ptr(vals, ctypes.c_double),
    )
    if n != nnz:
        return None
    return rows, cols, vals


def traffic_simulate(a_indptr, a_indices, b_row_lens, row_order,
                     capacity_words: int, row_psum_nnz):
    """Native fiber-cache walk.

    Returns (counters[15], row_traffic_words, row_fills) or None — the
    per-row arrays are the full-K window task components for the latency
    accumulation (models/traffic.py windowed_cycles).
    """
    lib = load()
    if lib is None:
        return None
    a_indptr = np.ascontiguousarray(a_indptr, dtype=np.int64)
    a_indices = np.ascontiguousarray(a_indices, dtype=np.int32)
    b_row_lens = np.ascontiguousarray(b_row_lens, dtype=np.int64)
    row_order = np.ascontiguousarray(row_order, dtype=np.int64)
    row_psum_nnz = np.ascontiguousarray(row_psum_nnz, dtype=np.int64)
    out = np.zeros(15, dtype=np.int64)
    n_rows = len(a_indptr) - 1
    row_traffic = np.zeros(n_rows, dtype=np.int64)
    row_fills = np.zeros(n_rows, dtype=np.int64)
    rc = lib.traffic_simulate(
        _ptr(a_indptr, ctypes.c_int64), _ptr(a_indices, ctypes.c_int32),
        n_rows, _ptr(b_row_lens, ctypes.c_int64), len(b_row_lens),
        _ptr(row_order, ctypes.c_int64), capacity_words,
        _ptr(row_psum_nnz, ctypes.c_int64), _ptr(out, ctypes.c_int64),
        _ptr(row_traffic, ctypes.c_int64), _ptr(row_fills, ctypes.c_int64),
    )
    return (out, row_traffic, row_fills) if rc == 0 else None


def plan_tile_cache(tile_ids, n_slots: int, depth: int):
    """Native Belady slot plan; returns (slot, load, n_loads) or None."""
    lib = load()
    if lib is None:
        return None
    ids = np.ascontiguousarray(tile_ids, dtype=np.int64)
    slot = np.empty(len(ids), dtype=np.int32)
    ld = np.empty(len(ids), dtype=np.int32)
    n = lib.plan_tile_cache(
        _ptr(ids, ctypes.c_int64), len(ids), n_slots, depth,
        _ptr(slot, ctypes.c_int32), _ptr(ld, ctypes.c_int32),
    )
    if n < 0:
        return None
    return slot, ld, int(n)


def plan_panel_cache(tile_ids, run_ptr, n_slots: int, depth: int,
                     max_panel: int):
    """Native panel-adjacency plan; returns (slot, load, n_loads) or None."""
    lib = load()
    if lib is None:
        return None
    ids = np.ascontiguousarray(tile_ids, dtype=np.int64)
    ptr = np.ascontiguousarray(run_ptr, dtype=np.int64)
    slot = np.empty(len(ids), dtype=np.int32)
    ld = np.empty(len(ids), dtype=np.int32)
    n = lib.plan_panel_cache(
        _ptr(ids, ctypes.c_int64), len(ids),
        _ptr(ptr, ctypes.c_int64), len(ptr) - 1,
        n_slots, depth, max_panel,
        _ptr(slot, ctypes.c_int32), _ptr(ld, ctypes.c_int32),
    )
    if n < 0:
        return None
    return slot, ld, int(n)


def esc_plan(a_indptr, a_indices, b_indptr, b_indices, b_rows: int,
             cap: int, e_products: int):
    """Native ESC symbolic phase (ops/element.py).

    Returns (counts, c_indices, c_row_counts, class_L, class_n, esc_to_csr,
    ag, bg) with worst-case-sized arrays (caller trims via counts), or None
    if the native library is unavailable or the planner failed.
    """
    lib = load()
    if lib is None:
        return None
    a_indptr = np.ascontiguousarray(a_indptr, dtype=np.int64)
    a_indices = np.ascontiguousarray(a_indices, dtype=np.int32)
    b_indptr = np.ascontiguousarray(b_indptr, dtype=np.int64)
    b_indices = np.ascontiguousarray(b_indices, dtype=np.int32)
    m = len(a_indptr) - 1
    E = int(e_products)
    counts = np.zeros(6, dtype=np.int64)
    c_indices = np.empty(max(E, 1), dtype=np.int32)
    c_row_counts = np.empty(max(m, 1), dtype=np.int32)
    class_L = np.zeros(32, dtype=np.int32)
    class_n = np.zeros(32, dtype=np.int64)
    esc_to_csr = np.empty(E + E // max(cap, 1) + 2, dtype=np.int32)
    ag = np.empty(2 * E + 64, dtype=np.int32)
    bg = np.empty(2 * E + 64, dtype=np.int32)
    rc = lib.esc_plan(
        _ptr(a_indptr, ctypes.c_int64), _ptr(a_indices, ctypes.c_int32), m,
        _ptr(b_indptr, ctypes.c_int64), _ptr(b_indices, ctypes.c_int32),
        b_rows, cap,
        _ptr(counts, ctypes.c_int64), _ptr(c_indices, ctypes.c_int32),
        _ptr(c_row_counts, ctypes.c_int32), _ptr(class_L, ctypes.c_int32),
        _ptr(class_n, ctypes.c_int64), _ptr(esc_to_csr, ctypes.c_int32),
        _ptr(ag, ctypes.c_int32), _ptr(bg, ctypes.c_int32),
    )
    if rc != 0:
        return None
    return counts, c_indices, c_row_counts, class_L, class_n, esc_to_csr, ag, bg
