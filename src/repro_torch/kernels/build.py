"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), cached under ``build/kernels/`` at the repository root (or
``$REPRO_TORCH_BUILD_DIR``) by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags. Sources
build in parallel, one ``nvcc`` each. Every entry point takes pointers and
the stream as ``c_void_p`` and returns ``cudaGetLastError()``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("ragged_ffn", "ragged_dense_ffn", "flash_decode_paged",
           "grouped_quant_matmul", "flash_decode", "quant_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
#: C signatures: library → entry → argument types (return type is int).
SIGNATURES = {
    "ragged_ffn": {
        "ragged_gateup": [_P] * 11 + [_I] * 6 + [_P],
        "ragged_down": [_P] * 8 + [_I] * 6 + [_P],
    },
    "ragged_dense_ffn": {
        "ragged_dense_tensor_map": [_P, _P, _I, _P, _P, _P],
        "ragged_dense_occupancy": [_I] * 4,
        "ragged_dense_gateup": [_P] * 6 + [_I] * 8 + [_P],
        "ragged_dense_down": [_P] * 5 + [_I] * 8 + [_P],
    },
    "flash_decode_paged": {
        "flash_decode_paged": [_P] * 8 + [_F, _P],
    },
    "grouped_quant_matmul": {
        "grouped_quant_matmul": [_P] * 5 + [_I] * 10 + [_P],
    },
    "flash_decode": {
        "flash_decode": [_P] * 7 + [_F, _P],
    },
    "quant_matmul": {
        "quant_matmul": [_P] * 5 + [_I] * 9 + [_P],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    return CSRC.parents[3] / "build" / "kernels"


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> pathlib.Path:
    """The library path, tagged by a hash of the source, every shared
    header of ``csrc/`` and the flags (an edited header rebuilds)."""
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{tag}.so"


def build_all(verbose: bool = False) -> float:
    """Compile every source that has no up-to-date library, all ``nvcc``
    processes at once; returns the seconds it took. Raises with the
    compiler's output when a build fails."""
    t0 = time.perf_counter()
    todo = [n for n in SOURCES if not _target(n).exists()]
    if not todo:
        return time.perf_counter() - t0
    build_dir().mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = {}
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    errors = []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
            continue
        if verbose and out:
            print(out)
        os.replace(tmp, _target(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if not _target(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
