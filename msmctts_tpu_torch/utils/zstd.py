"""zstd for orbax snapshots: the port's own frame decoder
(``csrc/zstd_decode.cc``, RFC 8878) through ctypes, and a raw-block frame
writer.

The decoder builds with ``g++`` at first use into
``build/msmctts_tpu_torch/libmsmc_zstd-<hash>.so``, keyed by a hash of the
source and the flags as ``data/native.py``'s reader is. There is no second
decoder to fall back to: where the library cannot be built or loaded,
:func:`decompress` raises with the compiler's message. ctypes releases the
GIL for the call, so threads can decode chunks side by side.

:func:`compress_raw` writes frames made only of raw blocks (at most
128 KiB each) with the frame content size set: valid zstd that orbax and
tensorstore read, without an entropy coder, about as large as the data.
The library also gives :func:`crc32c`, OCDBT's checksum.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

from msmctts_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "zstd_decode.cc"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
MAGIC = b"\x28\xb5\x2f\xfd"
BLOCK = 128 * 1024

_LOCK = threading.Lock()
_lib = None
_BUILDS = [0]


class ZstdError(ValueError):
    """A frame the decoder refuses; the message names the byte offset."""


def builds() -> int:
    """Times this process compiled the decoder (a cached library is not
    counted)."""
    return _BUILDS[0]


def library_path():
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmsmc_zstd-{h.hexdigest()[:12]}.so"


def build() -> str:
    """Compile ``csrc/zstd_decode.cc`` where its library is missing; returns
    the library's path. Raises with g++'s output if the build fails."""
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)], capture_output=True, text=True)
        except OSError as e:  # no g++ at all
            raise RuntimeError(f"building {SOURCE.name} failed: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
        _BUILDS[0] += 1
    return str(path)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _LOCK:
            if _lib is None:
                lib = ctypes.CDLL(build())
                u8p = ctypes.POINTER(ctypes.c_uint8)
                lib.msmc_zstd_decompress.restype = ctypes.c_int
                lib.msmc_zstd_decompress.argtypes = [
                    ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_size_t),
                    ctypes.c_char_p, ctypes.c_size_t,
                ]
                lib.msmc_zstd_decompress_into.restype = ctypes.c_int
                lib.msmc_zstd_decompress_into.argtypes = [
                    ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                    ctypes.c_size_t,
                ]
                lib.msmc_zstd_free.restype = None
                lib.msmc_zstd_free.argtypes = [u8p]
                lib.msmc_crc32c.restype = ctypes.c_uint32
                lib.msmc_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
                _lib = lib
    return _lib


def decompress(buf: bytes, size: int | None = None):
    """Every frame of ``buf`` decoded, as ``bytes``; with ``size``, into a
    new ``bytearray`` that must come out exactly ``size`` bytes long."""
    lib = _load()
    buf = bytes(buf)
    err = ctypes.create_string_buffer(512)
    if size is not None:
        out = bytearray(size)
        dst = (ctypes.c_char * size).from_buffer(out) if size else None
        rc = lib.msmc_zstd_decompress_into(buf, len(buf), dst, size, err, len(err))
        if rc:
            raise ZstdError(err.value.decode())
        return out
    ptr, n = ctypes.POINTER(ctypes.c_uint8)(), ctypes.c_size_t()
    if lib.msmc_zstd_decompress(buf, len(buf), ctypes.byref(ptr), ctypes.byref(n), err, len(err)):
        raise ZstdError(err.value.decode())
    try:
        data = ctypes.string_at(ptr, n.value)
    finally:
        lib.msmc_zstd_free(ptr)
    return data


def crc32c(buf: bytes) -> int:
    """CRC-32C (Castagnoli) of ``buf``: OCDBT's file checksum."""
    buf = bytes(buf)
    return int(_load().msmc_crc32c(buf, len(buf)))


def compress_raw(buf) -> bytes:
    """One zstd frame of raw blocks (at most 128 KiB each) holding ``buf``:
    single segment, an 8-byte frame content size, no checksum."""
    view = memoryview(buf).cast("B")
    n = len(view)
    parts = [MAGIC, bytes([0xE0]), n.to_bytes(8, "little")]  # FCS flag 3, single segment
    pos = 0
    while True:
        size = min(BLOCK, n - pos)
        last = pos + size == n
        parts.append((int(last) | (size << 3)).to_bytes(3, "little"))  # block type 0: raw
        parts.append(view[pos:pos + size])
        pos += size
        if last:
            return b"".join(parts)
