"""OCDBT, the key-value store under orbax snapshots: a reader and a minimal
one-process writer, without tensorstore.

The format is tensorstore's "OCDBT" (Optionally-Cooperative Distributed
B+Tree, ``kvstore/ocdbt`` in its documentation). A store is a directory:

* ``manifest.ocdbt``: the config (uuid, manifest kind, inline-value and
  node-size limits, version-tree arity, compression), a data-file table and
  the versions, each naming the root node of its B+tree;
* data files (``d/<hex>``) holding B+tree nodes and the values too large
  to sit inline in a leaf, each referred to by (data file, offset, length).

A manifest or a node is ``magic (u32 BE) | length (u64 LE) | version
(varint) | compression (varint: 0 none, 1 zstd) | body | CRC-32C (u32 LE)``.
Integers in a body are LEB128 varints, stored as arrays over the node's
entries. Keys are prefix-compressed within a node, and an interior node's
entry names the prefix its subtree shares; data-file paths are
``base_path + relative_path`` from the store's root, and a node read from a
file under a base path reads its own table under that base too. That is
how orbax's multi-process layout reads: the root ``manifest.ocdbt`` points
into ``d/`` and ``ocdbt.process_0/d/``.

The reader walks the latest version's tree once and reads each value by
key: an inline value from the leaf, an indirect one with one ``pread`` of
its byte range. The writer puts every value in one data file, splits leaves
and interior nodes at the config's decoded-node limit, and writes one
version and the manifest, with zstd bodies of raw blocks.
"""

from __future__ import annotations

import os
import struct
import time
import uuid
from typing import Dict, Iterator, List, Optional, Tuple

from msmctts_tpu_torch.utils import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MISSING = (1 << 64) - 1  # offset / length of an empty tree's root

# The config orbax's tensorstore writes (read from its manifests): a single
# manifest file, values above 1024 bytes out of line, nodes up to 1e8
# decoded bytes, version-tree arity 2**4, zstd at level 0, and three empty
# data-file prefixes.
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


class OcdbtError(ValueError):
    """A store the reader refuses."""


# ------------------------------------------------------------------ coding
class _Reader:
    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def fail(self, msg: str):
        raise OcdbtError(f"{self.what}: {msg} at byte {self.pos} of its body")

    def varint(self) -> int:
        value = shift = 0
        while True:
            if self.pos >= len(self.buf):
                self.fail("truncated varint")
            c = self.buf[self.pos]
            self.pos += 1
            value |= (c & 0x7F) << shift
            if c < 0x80:
                return value
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            self.fail(f"truncated ({n} bytes wanted)")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.raw(1)[0]


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        c = v & 0x7F
        v >>= 7
        if v:
            out.append(c | 0x80)
        else:
            out.append(c)
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def decode_file(buf: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node, its header and checksum verified."""
    if len(buf) < 18:
        raise OcdbtError(f"{what}: {len(buf)} bytes is too short")
    got_magic, length = struct.unpack(">I", buf[:4])[0], struct.unpack("<Q", buf[4:12])[0]
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(buf):
        raise OcdbtError(f"{what}: header says {length} bytes, has {len(buf)}")
    crc = struct.unpack("<I", buf[-4:])[0]
    if zstd.crc32c(buf[:-4]) != crc:
        raise OcdbtError(f"{what}: CRC-32C mismatch")
    r = _Reader(buf[:-4], what)
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    body = buf[r.pos:-4]
    if compression == 1:
        return zstd.decompress(body)
    if compression == 0:
        return body
    raise OcdbtError(f"{what}: compression format {compression}")


def encode_file(body: bytes, magic: int) -> bytes:
    """A manifest or node around ``body`` (zstd of raw blocks)."""
    payload = _varint(0) + _varint(1) + zstd.compress_raw(body)
    length = 4 + 8 + len(payload) + 4
    head = struct.pack(">I", magic) + struct.pack("<Q", length) + payload
    return head + struct.pack("<I", zstd.crc32c(head))


def _read_table(r: _Reader, base: bytes) -> List[Tuple[bytes, bytes]]:
    """A data-file table -> (base path, full path) of each file, under
    ``base``, the base path of the file that holds the table."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("data-file prefix longer than the path before it")
        path = prev[:prefix[i]] + r.raw(suffix[i])
        if base_len[i] > len(path):
            r.fail("base path longer than its path")
        files.append((base + path[:base_len[i]], base + path))
        prev = path
    return files


def _write_table(paths: List[bytes]) -> bytes:
    prefix = [_common(a, b) for a, b in zip(paths, paths[1:])]
    return (_varint(len(paths)) + _varints(prefix) + _varints(len(p) - c for p, c in zip(paths, [0] + prefix))
            + _varints(0 for _ in paths) + b"".join(p[c:] for p, c in zip(paths, [0] + prefix)))


def _read_keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], Optional[List[int]]]:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    shared = r.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("key prefix longer than the key before it")
        prev = prev[:prefix[i]] + r.raw(suffix[i])
        keys.append(prev)
    return keys, shared


def _write_keys(keys: List[bytes], shared: Optional[List[int]] = None) -> Tuple[bytes, bytes]:
    """(lengths, key bytes) of prefix-compressed ``keys``."""
    prefix = [_common(a, b) for a, b in zip(keys, keys[1:])]
    starts = [0] + prefix
    lengths = _varints(prefix) + _varints(len(k) - s for k, s in zip(keys, starts))
    if shared is not None:
        lengths += _varints(shared)
    return lengths, b"".join(k[s:] for k, s in zip(keys, starts))


# ------------------------------------------------------------------ reader
class OcdbtStore:
    """The latest version of the store at ``root``, indexed on open."""

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, "manifest.ocdbt")
        with open(path, "rb") as f:
            body = decode_file(f.read(), MANIFEST_MAGIC, path)
        r = _Reader(body, path)
        r.raw(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise OcdbtError(f"{path}: manifest kind {kind} (numbered manifests) is not read")
        r.varints(2)  # inline-value and node-size limits
        r.byte()  # version-tree arity
        method = r.varint()
        if method == 1:
            r.varint()  # zstd level
        elif method != 0:
            r.fail(f"compression method {method}")
        for _ in range(3):  # data-file prefixes
            r.raw(r.varint())
        files = _read_table(r, b"")
        n = r.varint()
        if n == 0:
            raise OcdbtError(f"{path}: no version")
        r.varints(n)  # generation numbers
        height = list(r.raw(n))
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        num_keys = r.varints(n)[-1]
        r.varints(n)  # tree bytes
        r.varints(n)  # indirect value bytes
        self._index: Dict[bytes, object] = {}
        if offset[-1] != MISSING:
            if file_id[-1] >= len(files):
                r.fail("root in a data file the table lacks")
            self._walk(files[file_id[-1]], offset[-1], length[-1], height[-1], b"")
        if len(self._index) != num_keys:
            raise OcdbtError(f"{path}: the tree holds {len(self._index)} keys, the manifest says {num_keys}")

    def _pread(self, file: Tuple[bytes, bytes], offset: int, length: int) -> bytes:
        full = os.path.join(self.root, file[1].decode())
        with open(full, "rb") as f:
            data = os.pread(f.fileno(), length, offset)
        if len(data) != length:
            raise OcdbtError(f"{full}: {length} bytes at {offset} wanted, {len(data)} there")
        return data

    def _walk(self, file: Tuple[bytes, bytes], offset: int, length: int, height: int, prefix: bytes):
        what = f"{os.path.join(self.root, file[1].decode())}@{offset}"
        body = decode_file(self._pread(file, offset, length), NODE_MAGIC, what)
        r = _Reader(body, what)
        if r.byte() != height:
            r.fail(f"node height differs from its parent's reference ({height})")
        files = _read_table(r, file[0])
        n = r.varint()
        keys, shared = _read_keys(r, n, height > 0)
        if height > 0:
            file_id, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            for _ in range(3):  # statistics
                r.varints(n)
            for i in range(n):
                if file_id[i] >= len(files):
                    r.fail("child in a data file the table lacks")
                self._walk(files[file_id[i]], offsets[i], lengths[i], height - 1, prefix + keys[i][:shared[i]])
            return
        value_len = r.varints(n)
        kind = r.varints(n)
        indirect = [i for i in range(n) if kind[i] == 1]
        if any(k > 1 for k in kind):
            r.fail("unknown value kind")
        file_id, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        for i, f, o in zip(indirect, file_id, offsets):
            if f >= len(files):
                r.fail("value in a data file the table lacks")
            self._index[prefix + keys[i]] = (files[f], o, value_len[i])
        for i in range(n):
            if kind[i] == 0:
                self._index[prefix + keys[i]] = r.raw(value_len[i])
        if r.pos != len(body):
            r.fail("bytes after the leaf's values")

    def keys(self) -> Iterator[bytes]:
        return iter(sorted(self._index))

    def __contains__(self, key: bytes) -> bool:
        return key in self._index

    def read(self, key: bytes) -> bytes:
        ref = self._index.get(key)
        if ref is None:
            raise KeyError(key)
        if isinstance(ref, bytes):
            return ref
        return self._pread(*ref)


# ------------------------------------------------------------------ writer
def _config() -> bytes:
    return (uuid.uuid4().bytes + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES) + _varint(MAX_DECODED_NODE_BYTES)
            + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(1) + _varint(0) + b"\x00\x00\x00")


def _split(sizes: List[int], limit: int) -> List[Tuple[int, int]]:
    """Consecutive runs of entries whose sizes add up to at most ``limit``
    (a run holds one entry at least)."""
    runs, start, total = [], 0, 0
    for i, s in enumerate(sizes):
        if i > start and total + s > limit:
            runs.append((start, i))
            start, total = i, 0
        total += s
    runs.append((start, len(sizes)))
    return runs


def write_store(root: str, items: Dict[bytes, bytes], max_decoded_node_bytes: int = MAX_DECODED_NODE_BYTES):
    """A new store at ``root`` holding ``items`` as its one version."""
    if not items:
        raise ValueError("an OCDBT store needs one key at least")
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    data_path = b"d/" + uuid.uuid4().hex.encode()
    table = _write_table([data_path])
    keys = sorted(items)
    chunks: List[bytes] = []
    size = 0

    def append(buf: bytes) -> int:
        nonlocal size
        chunks.append(buf)
        size += len(buf)
        return size - len(buf)

    # values out of line first, then the nodes bottom-up
    refs = {}
    for k in keys:
        v = items[k]
        refs[k] = v if len(v) <= MAX_INLINE_VALUE_BYTES else (append(v), len(v))
    entry_bytes = [len(k) + 60 + (len(refs[k]) if isinstance(refs[k], bytes) else 0) for k in keys]
    # one level: (first key, last key, offset, length, keys, tree bytes, indirect bytes) per node
    # a node's keys go without the prefix its parent names; the root's whole
    level = []
    runs = _split(entry_bytes, max_decoded_node_bytes)
    for a, b in runs:
        run = keys[a:b]
        shared = _common(run[0], run[-1]) if len(runs) > 1 else 0
        lengths, key_bytes = _write_keys([k[shared:] for k in run])
        inline = [refs[k] for k in run if isinstance(refs[k], bytes)]
        indirect = [refs[k] for k in run if not isinstance(refs[k], bytes)]
        body = (b"\x00" + table + _varint(len(run)) + lengths + key_bytes
                + _varints(len(items[k]) for k in run)
                + _varints(0 if isinstance(refs[k], bytes) else 1 for k in run)
                + _varints(0 for _ in indirect) + _varints(o for o, _ in indirect) + b"".join(inline))
        node = encode_file(body, NODE_MAGIC)
        level.append((run[0], run[-1], append(node), len(node), len(run), len(node), sum(n for _, n in indirect)))
    height = 0
    while len(level) > 1:
        height += 1
        upper = []
        runs = _split([len(n[0]) + 80 for n in level], max_decoded_node_bytes)
        for a, b in runs:
            run = level[a:b]
            shared = _common(run[0][0], run[-1][1]) if len(runs) > 1 else 0
            # each child's entry: its first key past this node's prefix, and
            # the prefix (past this node's) that its whole subtree shares
            child_keys = [c[0][shared:] for c in run]
            lengths, key_bytes = _write_keys(child_keys, [_common(c[0], c[1]) - shared for c in run])
            body = (bytes([height]) + table + _varint(len(run)) + lengths + key_bytes
                    + _varints(0 for _ in run) + _varints(c[2] for c in run) + _varints(c[3] for c in run)
                    + _varints(c[4] for c in run) + _varints(c[5] for c in run) + _varints(c[6] for c in run))
            node = encode_file(body, NODE_MAGIC)
            upper.append((run[0][0], run[-1][1], append(node), len(node), sum(c[4] for c in run),
                          len(node) + sum(c[5] for c in run), sum(c[6] for c in run)))
        level = upper
    with open(os.path.join(root, data_path.decode()), "wb") as f:
        for c in chunks:
            f.write(c)
    _, _, offset, length, n_keys, tree_bytes, indirect_bytes = level[0]
    body = (_config() + table + _varint(1) + _varint(1) + bytes([height]) + _varint(0) + _varint(offset)
            + _varint(length) + _varint(n_keys) + _varint(tree_bytes) + _varint(indirect_bytes)
            + struct.pack("<Q", time.time_ns()) + _varint(0))
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(encode_file(body, MANIFEST_MAGIC))
