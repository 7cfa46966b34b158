"""Build and bind the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, ``build/msmctts_tpu_torch/lib<name>-<hash>.so`` beside
the package. The hash covers the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source builds anew and a stale library is never loaded. Nothing is built at
import: a kernel builds at its first launch, or ahead of time through
:func:`build` (which runs one ``nvcc`` per source, all at once).

A launcher returns ``cudaGetLastError()`` after the launch; a non-zero code
raises here. Every :class:`CudaKernel` counts its successful launches in
``launches``, so a run can show that its path went through the kernel, and
:func:`build_count` counts the nvcc builds this process ran (a warmed server
reports 0 new ones under traffic).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "msmctts_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas=-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_BUILDS = [0]  # nvcc builds that completed in this process


def build_count() -> int:
    """Sources this process has compiled with nvcc (cached libraries not
    counted)."""
    return _BUILDS[0]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return path


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, keyed by a hash of that source,
    every header under ``csrc/`` (a source may include any of them) and the
    flags."""
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str]) -> Dict[str, dict]:
    """Compile the named sources in parallel (one nvcc each) where their
    library is missing. Returns {name: {"seconds", "log", "cached"}}; the
    log holds nvcc's ``-Xptxas=-v`` report (registers, shared memory,
    spills). Raises with the compiler's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        path = library_path(name)
        if path.exists():
            out[name] = {"seconds": 0.0, "log": "", "cached": True}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, path)
        _BUILDS[0] += 1
        out[name] = {"seconds": time.perf_counter() - t0, "log": log, "cached": False}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


class CudaKernel:
    """One exported launcher of one ``csrc`` library.

    ``argtypes`` lists the launcher's arguments before the trailing stream
    pointer; pointers are ``ctypes.c_void_p`` (a bare Python int would be
    cut to 32 bits)."""

    def __init__(self, source: str, symbol: str, argtypes: List):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        self._lib: Optional[ctypes.CDLL] = None

    def _load(self):
        if self._fn is None:
            with _LOCK:
                if self._fn is None:
                    path = library_path(self.source)
                    if not path.exists():
                        build([self.source])
                    lib = ctypes.CDLL(str(path))
                    fn = getattr(lib, self.symbol)
                    fn.argtypes = self.argtypes + [ctypes.c_void_p]
                    fn.restype = ctypes.c_int
                    lib.error_string.argtypes = [ctypes.c_int]
                    lib.error_string.restype = ctypes.c_char_p
                    self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args):
        fn = self._load()
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            msg = self._lib.error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        self.launches += 1
