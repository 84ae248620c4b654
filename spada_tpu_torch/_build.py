"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` for ``sm_90a``, all
at once, and the objects link into one shared library with a plain C
interface, ``_build/libspada_kernels.so``, at first use; it is loaded with
:mod:`ctypes`.  Rebuilt when a source or header is newer than the library.
A failed build raises with nvcc's output: no caller falls back to another
engine.  :func:`sass_counts` counts an opcode per kernel in the built code
(``cuobjdump -sass``).

Each kernel wrapper adds one to :data:`launches` under its kernel's name
where it launches the kernel, and nowhere else, so a run can show which
kernels its main path went through.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import os
import shutil
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libspada_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel name -> number of launches since the last ``launches.clear()``
launches: collections.Counter = collections.Counter()

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the last build printed (the ptxas register / shared-memory report);
#: None when the library was already up to date
build_log: Optional[str] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # a_tiles, b_tiles, a_tid, b_tid, tile_ptr, mask (null: every slice),
    # c_tiles, n_c, tm, tk, tn, block (int* out: the block the launch ran
    # on), stream
    "tile_spgemm_f32": [_P] * 7 + [_I] * 4 + [_P, _P],
    "tile_spgemm_bf16": [_P] * 7 + [_I] * 4 + [_P, _P],
    # bf16, tm, tk, tn, block (int* out), blocks per SM (int* out)
    "tile_spgemm_occupancy": [_I] * 4 + [_P, _P],
    # a, b, out, n, stream
    "esc_stream_mul": [_P, _P, _P, ctypes.c_longlong, _P],
    # a, b, out, L, n_pad, slices, group, stream
    "esc_stream_red": [_P, _P, _P, ctypes.c_int, ctypes.c_longlong, _I, _I,
                       _P],
    # table (host int64 [n, 8]), n, n_blocks, stream
    "esc_stream_group": [_P, _I, ctypes.c_longlong, _P],
    # a, b, out, n, block, stages, grid_factor, stream
    "esc_stream_mul_blocked": [_P, _P, _P, ctypes.c_longlong,
                               ctypes.c_longlong, _I, _I, _P],
    # a, b, out, L, n_pad, slices, group, block, stages, grid_factor, stream
    "esc_stream_red_blocked": [_P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                               _I, _I, ctypes.c_longlong, _I, _I, _P],
    # a_tiles, b_tiles, a_tid, b_tid, o_tid, item_ptr, c_tiles, n_c, ogroup,
    # tm, tk, tn, nbuf, block (as tile_spgemm's), stream
    "tile_stream_f32": [_P] * 7 + [_I] * 6 + [_P, _P],
    "tile_stream_bf16": [_P] * 7 + [_I] * 6 + [_P, _P],
    # a_tiles_t, b_tiles, a_tid, b_tid, tile_ptr, c_tiles, n_c, tm, tk, tn,
    # out_bf16, block (as tile_spgemm's), stream
    "tile_panel_f32": [_P] * 6 + [_I] * 5 + [_P, _P],
    "tile_panel_bf16": [_P] * 6 + [_I] * 5 + [_P, _P],
    # a_tiles, b_tiles, a_tid, b_tid, o_tid, c_tiles, n_items, tm, tk, tn,
    # chunk (the thin path's items per block), block (as tile_spgemm's),
    # stream
    "tile_grid_f32": [_P] * 6 + [_I] * 5 + [_P, _P],
    "tile_grid_bf16": [_P] * 6 + [_I] * 5 + [_P, _P],
    # a_tiles, b_tiles, a_tid, b_tid, tile_ptr, c_tiles, n_c, tm, tk, tn,
    # a_slots, b_slots, mode, stream
    "tile_probe_f32": [_P] * 6 + [_I] * 7 + [_P],
    "tile_probe_bf16": [_P] * 6 + [_I] * 7 + [_P],
    # as tile_probe's, then stages, a_t, stream
    "tile_probe_mma_f32": [_P] * 6 + [_I] * 9 + [_P],
    "tile_probe_mma_bf16": [_P] * 6 + [_I] * 9 + [_P],
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of spada_tpu_torch "
                       "build only where the CUDA toolkit is installed")


def _sources(pattern: str = "*.cu"):
    return sorted(glob.glob(os.path.join(CSRC_DIR, pattern)))


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built
               for s in _sources() + _sources("*.cuh"))


def _run_all(cmds) -> str:
    """Run the commands at once; wait for all, raise if any failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [(cmd, p.communicate()[0], p.returncode) for cmd, p in procs]
    failed = [f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}"
              for cmd, out, rc in outs if rc]
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(out for _, out, _ in outs)


def _build() -> None:
    global build_log
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    tmp = f"{LIB_PATH}.{tag}"
    srcs = _sources()
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o")
            for s in srcs]
    try:
        log = _run_all([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                       for src, obj in zip(srcs, objs))
        _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, LIB_PATH)
    build_log = log


def load() -> ctypes.CDLL:
    """The kernel library, built first if it is missing or stale."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                _build()
            lib = ctypes.CDLL(LIB_PATH)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.spada_cuda_error_string.argtypes = [ctypes.c_int]
            lib.spada_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def sass_counts(opcode: str) -> dict:
    """{kernel's mangled name: number of ``opcode`` instructions} of every
    kernel in the built library, from ``cuobjdump -sass``; raises if the
    toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if not tool:
        raise RuntimeError("cuobjdump not found beside nvcc or on PATH: the "
                           "built kernels' instructions cannot be read")
    out = subprocess.run([tool, "-sass", LIB_PATH], capture_output=True,
                         text=True, check=True).stdout
    counts: dict = {}
    name = None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and any(
                tok.split(".")[0] == opcode
                for tok in line.split(";")[0].split()):
            counts[name] += 1
    return counts


def check(status: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if status != 0:
        name = load().spada_cuda_error_string(status).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed: {name} ({status})")


def current_stream(tensor) -> int:
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
