"""Orbax's ``StandardCheckpointHandler`` layout over OCDBT and zarr v2, read
and written without orbax, tensorstore or JAX.

A snapshot's ``state/`` directory holds:

* ``_METADATA``: JSON ``tree_metadata``, one entry per leaf with the path's
  ``key_metadata`` (``key_type`` 1: a sequence index, 2: a dict key) and
  the leaf's ``value_metadata`` (``value_type`` ``np.ndarray``,
  ``jax.Array``, ``scalar``, or ``None`` / ``Dict`` / ``List`` / ``Tuple``
  with ``skip_deserialize``), with ``use_ocdbt`` and ``use_zarr3``;
* ``_CHECKPOINT_METADATA`` (timestamps, the handler's name);
* an OCDBT store (``utils/ocdbt.py``) whose keys are zarr v2 arrays named
  by the leaf's path joined with ``.``: ``<name>/.zarray`` (JSON metadata)
  and one key per chunk (``<name>/0.0``; ``<name>/0`` for a 0-d array).

The tree comes from ``_METADATA``, not from the store's keys (a key with a
``.`` in it reads two ways there). :func:`read_snapshot` returns what orbax
restores with no target: sequences as lists, dict keys as strings, ``None``
leaves as ``None``, empty containers as they were, ``scalar`` leaves as
Python ``bool`` / ``int`` / ``float``, and every array (a ``jax.Array``
too) as a numpy array assembled from its chunks.

:func:`write_snapshot` writes a tree of numpy arrays, Python scalars,
``None`` and (nested) dicts, lists and tuples as orbax would: one chunk per
array, zstd frames of raw blocks (``utils/zstd.compress_raw``).
"""

from __future__ import annotations

import json
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

from msmctts_tpu_torch.utils import zstd
from msmctts_tpu_torch.utils.ocdbt import OcdbtStore, write_store

# the dtypes of a trainer's state
DTYPES = ("<f2", "<f4", "<f8", "<i4", "<i8", "<u4", "|b1", "|u1")
SEQUENCE, DICT = 1, 2
HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_EMPTY = {"Dict": dict, "List": list, "Tuple": tuple}
READ_THREADS = 8  # arrays read at once: the decoder and pread release the GIL


class SnapshotError(ValueError):
    """A snapshot the reader refuses."""


# ------------------------------------------------------------------- read
def _read_array(store: OcdbtStore, name: str, where: str) -> np.ndarray:
    meta_key = f"{name}/.zarray".encode()
    if meta_key not in store:
        raise SnapshotError(f"{where}: no zarr array {name!r}")
    meta = json.loads(store.read(meta_key))
    if meta.get("zarr_format") != 2:
        raise SnapshotError(f"{where}: {name}: zarr_format {meta.get('zarr_format')}")
    dtype = meta["dtype"]
    if dtype not in DTYPES:
        raise SnapshotError(f"{where}: {name}: dtype {dtype!r} is not read (only {', '.join(DTYPES)})")
    if meta.get("order", "C") != "C":
        raise SnapshotError(f"{where}: {name}: order {meta['order']!r} is not read")
    if meta.get("filters"):
        raise SnapshotError(f"{where}: {name}: filters {meta['filters']!r} are not read")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise SnapshotError(f"{where}: {name}: compressor {compressor.get('id')!r} is not read")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks):
        raise SnapshotError(f"{where}: {name}: shape {shape} and chunks {chunks} differ in rank")
    sep = meta.get("dimension_separator", ".")
    dt = np.dtype(dtype)
    fill = meta.get("fill_value")
    out = np.empty(shape, dt)
    chunk_bytes = math.prod(chunks) * dt.itemsize
    for index in np.ndindex(*[-(-s // c) for s, c in zip(shape, chunks)]):
        key = f"{name}/{sep.join(map(str, index)) if index else '0'}".encode()
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        if key not in store:
            if fill is None:
                raise SnapshotError(f"{where}: {name}: chunk {key.decode()} is missing and fill_value is null")
            out[region] = fill
            continue
        raw = store.read(key)
        data = zstd.decompress(raw, chunk_bytes) if compressor is not None else raw
        if len(data) != chunk_bytes:
            raise SnapshotError(f"{where}: {name}: chunk {key.decode()} holds {len(data)} bytes, not {chunk_bytes}")
        block = np.frombuffer(data, dt).reshape(chunks)
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


def _assemble(entries: List[Tuple[List[Tuple[str, int]], object]]):
    """Leaves at their key paths -> nested lists and dicts."""
    def build(items, depth):
        first = items[0][0][depth][1]
        groups: Dict[str, list] = {}
        for path, value in items:
            key, key_type = path[depth]
            if key_type != first:
                raise SnapshotError(f"sequence and dict keys mixed under {path[:depth]}")
            groups.setdefault(key, []).append((path, value))
        built = {k: (v[0][1] if len(v[0][0]) == depth + 1 else build(v, depth + 1)) for k, v in groups.items()}
        if first == SEQUENCE:
            if sorted(int(k) for k in built) != list(range(len(built))):
                raise SnapshotError(f"sequence indices {sorted(built)} under {items[0][0][:depth]}")
            return [built[str(i)] for i in range(len(built))]
        return built
    return build(entries, 0) if entries else {}


def read_snapshot(state_dir: str):
    """The tree of a snapshot's ``state/`` directory, as orbax restores it
    without a target."""
    state_dir = os.path.abspath(state_dir)
    with open(os.path.join(state_dir, "_METADATA")) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise SnapshotError(f"{state_dir}: zarr v3 arrays are not read")
    if not meta.get("use_ocdbt", False):
        raise SnapshotError(f"{state_dir}: a snapshot without OCDBT is not read")
    store = OcdbtStore(state_dir)
    leaves, arrays = [], []
    for entry in meta["tree_metadata"].values():
        path = [(str(k["key"]), int(k["key_type"])) for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        kind = value["value_type"]
        if kind == "None":
            leaves.append([path, None])
        elif kind in _EMPTY:
            leaves.append([path, _EMPTY[kind]()])
        elif kind in ("np.ndarray", "jax.Array", "scalar"):
            leaves.append([path, kind])
            arrays.append(len(leaves) - 1)
        else:
            raise SnapshotError(f"{state_dir}: value_type {kind!r} of {[k for k, _ in path]} is not read")
    names = [".".join(k for k, _ in leaves[i][0]) for i in arrays]
    with ThreadPoolExecutor(READ_THREADS) as pool:
        values = list(pool.map(lambda n: _read_array(store, n, state_dir), names))
    for i, value in zip(arrays, values):
        leaves[i][1] = value.item() if leaves[i][1] == "scalar" else value
    return _assemble([tuple(x) for x in leaves])


# ------------------------------------------------------------------ write
class _Empty(str):
    """An empty container's ``value_type`` in place of its leaf."""


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        if not tree:
            yield path, _Empty("Dict")
        for k, v in tree.items():
            yield from _flatten(v, path + ((str(k), DICT),))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            yield path, _Empty("Tuple" if isinstance(tree, tuple) else "List")
        for i, v in enumerate(tree):
            yield from _flatten(v, path + ((str(i), SEQUENCE),))
    else:
        yield path, tree


def _zarray(shape, dtype: str) -> bytes:
    meta = {
        "chunks": [max(int(s), 1) for s in shape], "compressor": {"id": "zstd", "level": 1},
        "dimension_separator": ".", "dtype": dtype, "fill_value": None, "filters": None, "order": "C",
        "shape": [int(s) for s in shape], "zarr_format": 2,
    }
    return json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()


def write_snapshot(state_dir: str, tree):
    """Write ``tree`` as a snapshot's ``state/`` directory (which must not
    exist yet)."""
    os.makedirs(state_dir)
    started = time.time_ns()
    tree_meta, items = {}, {}
    for path, leaf in _flatten(tree):
        if not path:
            raise ValueError("a snapshot's tree must be a container")
        entry = {"key_metadata": [{"key": k, "key_type": t} for k, t in path]}
        keys = tuple(k for k, _ in path)
        if leaf is None or isinstance(leaf, _Empty):
            kind = "None" if leaf is None else str(leaf)
            entry["value_metadata"] = {"value_type": kind, "skip_deserialize": True}
        else:
            if isinstance(leaf, (bool, int, float)) and not isinstance(leaf, np.generic):
                kind = "scalar"
                array = np.asarray(leaf, np.bool_ if isinstance(leaf, bool) else np.int64 if isinstance(leaf, int) else np.float64)
            elif isinstance(leaf, (np.ndarray, np.generic)):
                kind, array = "np.ndarray", np.asarray(leaf)
            else:
                raise TypeError(f"unsupported leaf {type(leaf).__name__} at {keys}")
            dtype = array.dtype.str
            if dtype not in DTYPES:
                raise TypeError(f"dtype {dtype!r} at {keys} is not written (only {', '.join(DTYPES)})")
            name = ".".join(keys)
            if f"{name}/.zarray".encode() in items:
                raise ValueError(f"two leaves share the array name {name!r}")
            items[f"{name}/.zarray".encode()] = _zarray(array.shape, dtype)
            if array.size:
                chunk = ".".join("0" for _ in array.shape) or "0"
                items[f"{name}/{chunk}".encode()] = zstd.compress_raw(np.ascontiguousarray(array.reshape(-1)).view(np.uint8))
            entry["value_metadata"] = {"value_type": kind, "skip_deserialize": False}
        tree_meta[str(keys)] = entry
    if items:
        write_store(state_dir, items)
    with open(os.path.join(state_dir, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    with open(os.path.join(state_dir, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": started, "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)
