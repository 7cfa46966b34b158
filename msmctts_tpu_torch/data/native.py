"""ctypes binding of the port's native feature-IO core (``csrc/msmc_io.cc``,
the counterpart of ``msmctts_tpu/data/native.py``).

Reads .npy files (with a row slice) and .wav files through a C++ thread
pool with the GIL released: ``read_batch`` loads every file of a batch in
one call, which ``BaseDataset.parse_cases`` uses for the loader's collate.

The library builds with ``g++`` at first use into
``build/msmctts_tpu_torch/libmsmc_io-<hash>.so``, keyed by a hash of the
source and the flags as the CUDA kernels' libraries are
(``ops/cuda_build.py``). Where it cannot be built or loaded,
``native_available()`` is False and the datasets read file by file.
``batch_reads()`` counts the batches this process read natively, so a run
can show which path it took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from msmctts_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "msmc_io.cc"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LOCK = threading.Lock()
_lib = None
_load_failed = False
_BATCH_READS = [0]


def batch_reads() -> int:
    """Batches this process read through ``read_batch``."""
    return _BATCH_READS[0]


def library_path():
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmsmc_io-{h.hexdigest()[:12]}.so"


def _bind(path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    f32p, i64p, intp = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int)
    lib.msmc_read_npy.restype = ctypes.c_int
    lib.msmc_read_npy.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64, i64p, intp, ctypes.c_int64, ctypes.c_int64]
    lib.msmc_read_wav.restype = ctypes.c_int
    lib.msmc_read_wav.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64, i64p, intp]
    lib.msmc_read_batch.restype = None
    lib.msmc_read_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, intp, ctypes.POINTER(f32p), i64p, i64p, intp, intp,
        ctypes.c_int,
    ]
    return lib


def build() -> str:
    """Compile ``csrc/msmc_io.cc`` where its library is missing; returns the
    library's path. Raises with the compiler's output if the build fails."""
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    return str(path)


def _load():
    global _lib, _load_failed
    if _lib is None and not _load_failed:
        with _LOCK:
            if _lib is None and not _load_failed:
                try:
                    _lib = _bind(build())
                except Exception:  # no compiler, or a library that does not load
                    _load_failed = True
    return _lib


def native_available() -> bool:
    return _load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_npy(path: str, row_start: int = 0, row_count: int = -1, max_elems: Optional[int] = None) -> np.ndarray:
    """Rows ``[row_start, row_start + row_count)`` of a .npy file (all rows
    from ``row_start`` when ``row_count`` < 0) as float32."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native reader is not available")
    if max_elems is None:
        max_elems = max(os.path.getsize(path), 64)  # bytes bound the element count
    out = np.empty(max_elems, np.float32)
    shape = (ctypes.c_int64 * 8)()
    ndim = ctypes.c_int()
    rc = lib.msmc_read_npy(path.encode(), _f32p(out), max_elems, shape, ctypes.byref(ndim), row_start, row_count)
    if rc != 0:
        raise IOError(f"msmc_read_npy({path}) failed with code {rc}")
    dims = tuple(shape[i] for i in range(ndim.value))
    return out[: int(np.prod(dims))].reshape(dims).copy()


def read_wav(path: str, max_samples: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """A mono float32 waveform in [-1, 1] and its sample rate."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native reader is not available")
    if max_samples is None:
        max_samples = max(os.path.getsize(path), 64)
    out = np.empty(max_samples, np.float32)
    n, sr = ctypes.c_int64(), ctypes.c_int()
    rc = lib.msmc_read_wav(path.encode(), _f32p(out), max_samples, ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        raise IOError(f"msmc_read_wav({path}) failed with code {rc}")
    return out[: n.value].copy(), sr.value


def read_batch(paths: List[str], kinds: List[int], caps: Optional[List[int]] = None,
               n_threads: int = 0) -> Tuple[List[np.ndarray], List[int]]:
    """Every file of a batch in one call (kind 0 = npy, 1 = wav), read by
    C++ threads with the GIL released. Returns (arrays, sample rates); the
    sample rate of an npy entry is 0."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native reader is not available")
    n = len(paths)
    if caps is None:
        # a file's bytes bound its float count for every dtype it may hold
        caps = [max(os.path.getsize(p), 64) for p in paths]
    arenas = [np.empty(c, np.float32) for c in caps]
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    c_kinds = (ctypes.c_int * n)(*kinds)
    c_outs = (ctypes.POINTER(ctypes.c_float) * n)(*[_f32p(a) for a in arenas])
    c_caps = (ctypes.c_int64 * n)(*caps)
    c_shapes = (ctypes.c_int64 * (8 * n))()
    c_ndims = (ctypes.c_int * n)()
    c_status = (ctypes.c_int * n)()
    lib.msmc_read_batch(c_paths, n, c_kinds, c_outs, c_caps, c_shapes, c_ndims, c_status, n_threads)
    out, srs = [], []
    for i in range(n):
        if c_status[i] != 0:
            raise IOError(f"native read failed for {paths[i]} (code {c_status[i]})")
        dims = tuple(c_shapes[i * 8 + j] for j in range(c_ndims[i]))
        out.append(arenas[i][: int(np.prod(dims))].reshape(dims).copy())
        srs.append(int(c_shapes[i * 8 + 1]) if kinds[i] == 1 else 0)
    _BATCH_READS[0] += 1
    return out, srs
