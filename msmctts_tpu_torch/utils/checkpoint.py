"""Reader and writer for ``msmctts_tpu/v1`` checkpoints, without JAX.

The format (``msmctts_tpu/utils/checkpoint.py:32-43``) is a pickle of
``{"iteration", "config", "state", "format"}`` where ``state`` is a nested
dict of numpy arrays in the JAX package's layout ({params, codebook,
model_state, ...} per module). ``weights.py`` maps that tree to the port's
``state_dict`` and back. Stripped checkpoints store float16; the reader
upcasts every floating array to float32, the precision of this slice.

A checkpoint that a JAX trainer wrote also pickles its optimizer state as
optax classes. The reader never imports them (the port runs where JAX is
not installed): every class of the JAX stack comes back as a
:class:`ForeignState`, its fields as a tuple, which the port does not read.

``filter_state_by_regex`` and ``merge_states`` stitch a state from parts
of several checkpoints (a trainer's ``restore_checkpoint_path`` given as
``[[regex, path], ...]``), on '/'-joined paths as the JAX package's do,
without flax.

``clean_checkpoint_directory`` keeps a run's snapshots every
``checkpoint_keep_interval`` steps and its newest two.

Both of the JAX package's backends are read and written. An orbax snapshot
(``checkpoint_backend: orbax``, ``msmctts_tpu/utils/checkpoint.py:59-119``)
is a directory: ``meta.pkl`` (iteration, config, format
``msmctts_tpu/orbax-v1``) and ``state/`` in orbax's layout, which
``utils/orbax_format.py`` reads and writes without orbax. The state comes
back as orbax restores it with no target (lists for tuples, string dict
keys). :func:`save_checkpoint_orbax` renames ``meta.pkl`` into place and
writes ``state/`` on a worker thread, under a temporary name renamed on
commit; :func:`wait_for_pending_saves` waits for it and raises its error.
A relative path is resolved against the working directory (the JAX reader
refuses one).
"""

from __future__ import annotations

import os
import pickle
import re
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from msmctts_tpu_torch.utils import orbax_format

FORMAT = "msmctts_tpu/v1"
ORBAX_FORMAT = "msmctts_tpu/orbax-v1"
CKPT_PREFIX = "model_"


JAX_STACK = ("jax", "jaxlib", "flax", "optax")


class ForeignState(tuple):
    """What an object of a JAX-stack class in a checkpoint (an optax
    optimizer state) reads back as: its constructor's arguments."""

    def __new__(cls, *fields):
        return super().__new__(cls, fields)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in JAX_STACK:
            return type(name, (ForeignState,), {"__module__": f"{__name__}.{module}"})
        return super().find_class(module, name)


def map_leaves(tree, fn):
    """``fn`` over every leaf of nested dicts, lists and tuples (named
    tuples included)."""
    if isinstance(tree, dict):
        return {k: map_leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [map_leaves(v, fn) for v in tree]
        return type(tree)(items) if type(tree) in (list, tuple) else type(tree)(*items)
    return fn(tree)


def _upcast(x):
    if isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.floating):
        return x.astype(np.float32)
    return x


def _as_array(x):
    # plain Python leaves (an optimizer's hyper-parameters) stay as they are
    return x if x is None or isinstance(x, (bool, int, float, str)) else np.asarray(x)


def read_checkpoint(path: str) -> dict:
    """Read a checkpoint as it was stored (a stripped checkpoint's float16
    stays float16): a ``msmctts_tpu/v1`` pickle, or an orbax snapshot
    directory.

    Only load checkpoints this project wrote: unpickling runs code."""
    if os.path.isdir(path):
        return _read_snapshot(os.path.abspath(path))
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path}: format {payload.get('format')!r}, expected {FORMAT!r}")
    return payload


def _read_snapshot(path: str) -> dict:
    wait_for_pending_saves()  # a snapshot this process may still be writing
    meta = os.path.join(path, "meta.pkl")
    if not os.path.isfile(meta):
        raise FileNotFoundError(f"{path} is a directory without meta.pkl: not a snapshot")
    with open(meta, "rb") as f:
        payload = _Unpickler(f).load()
    if payload.get("format") != ORBAX_FORMAT:
        raise ValueError(f"{meta}: format {payload.get('format')!r}, expected {ORBAX_FORMAT!r}")
    state = os.path.join(path, "state")
    if not os.path.isdir(state):
        raise FileNotFoundError(f"{path} has no state/: its save did not complete")
    payload["state"] = orbax_format.read_snapshot(state)
    return payload


def load_checkpoint(path: str) -> dict:
    """``read_checkpoint`` with every floating array as float32."""
    payload = read_checkpoint(path)
    payload["state"] = map_leaves(payload["state"], _upcast)
    return payload


def save_checkpoint(path: str, state_tree: dict, iteration: int, config: dict):
    """Write ``state_tree`` (nested dict of numpy arrays, JAX layout) with
    the config embedded, atomically via rename."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "iteration": int(iteration),
        "config": config,
        "state": map_leaves(state_tree, _as_array),
        "format": FORMAT,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=4)
    os.replace(tmp, path)


# One worker thread writes the snapshots' state/ in the order they were
# saved; its errors wait in the futures for wait_for_pending_saves().
_WRITER = ThreadPoolExecutor(max_workers=1, thread_name_prefix="snapshot-writer")
_PENDING: List[Future] = []
_PENDING_LOCK = threading.Lock()


def _host_copy(x):
    """A leaf as host numpy that the next step cannot change."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    if isinstance(x, (np.ndarray, np.generic)):
        return np.array(x)
    return x


def _commit_state(path: str, tree):
    tmp = os.path.join(path, "state.tmp")
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    orbax_format.write_snapshot(tmp, tree)
    os.replace(tmp, os.path.join(path, "state"))


def save_checkpoint_orbax(path: str, state_tree, iteration: int, config: dict) -> str:
    """Write an orbax snapshot directory at ``path`` (made absolute):
    ``meta.pkl`` now, ``state/`` on the writer thread from host copies of
    the leaves taken here. Returns the absolute path."""
    path = os.path.abspath(path)
    tree = map_leaves(state_tree, _host_copy)
    tmp = path + ".tmp"
    if os.path.isdir(tmp):  # a crashed save's
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "meta.pkl"), "wb") as f:
        pickle.dump({"iteration": int(iteration), "config": config, "format": ORBAX_FORMAT}, f, protocol=4)
    if os.path.exists(path):
        # a re-save to the same path: a write in flight into it lands first
        wait_for_pending_saves()
        if os.path.isdir(path):
            shutil.rmtree(path)
        else:
            os.remove(path)
    os.replace(tmp, path)  # meta.pkl visible; state/ comes on commit
    with _PENDING_LOCK:
        _PENDING.append(_WRITER.submit(_commit_state, path, tree))
    return path


def wait_for_pending_saves():
    """Block until every snapshot this process has saved is on disk; raise
    the first error a write met (each error is raised once)."""
    with _PENDING_LOCK:
        pending = list(_PENDING)
        _PENDING.clear()
    error = None
    for future in pending:
        e = future.exception()
        if e is not None and error is None:
            error = e
    if error is not None:
        raise RuntimeError(f"an orbax snapshot write failed: {error}") from error


def checkpoint_step(path: str) -> int:
    m = re.search(r"model_(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else -1


def _is_complete_snapshot(path: str) -> bool:
    """A pickle (written whole by rename), or a snapshot directory with
    ``meta.pkl`` and ``state/`` (a save in flight has no ``state/`` yet)."""
    if not os.path.isdir(path):
        return True
    return os.path.isfile(os.path.join(path, "meta.pkl")) and os.path.isdir(os.path.join(path, "state"))


def _candidates(save_dir: str) -> List[str]:
    return [os.path.join(save_dir, f) for f in os.listdir(save_dir) if f.startswith(CKPT_PREFIX) and not f.endswith(".tmp")]


def find_latest_checkpoint(save_dir: str) -> Optional[str]:
    """The complete ``model_<step>`` pickle or snapshot directory with the
    highest step in ``save_dir`` (auto-resume), or None."""
    if not os.path.isdir(save_dir):
        return None
    cands = [p for p in _candidates(save_dir) if _is_complete_snapshot(p)]
    return max(cands, key=checkpoint_step) if cands else None


def clean_checkpoint_directory(save_dir: str, interval: int, keep_last: int = 2):
    """Delete the ``model_<step>`` checkpoints (pickles and snapshot
    directories) whose step is not a multiple of ``interval``, except the
    newest ``keep_last`` (a trainer's ``checkpoint_keep_interval``;
    ``msmctts_tpu/utils/checkpoint.py:151-173``)."""
    if not os.path.isdir(save_dir):
        return
    for path in sorted(_candidates(save_dir), key=checkpoint_step)[:-keep_last]:
        if interval > 0 and checkpoint_step(path) % interval != 0:
            if os.path.isdir(path):
                shutil.rmtree(path)
            else:
                os.remove(path)


def _flatten(tree: dict, prefix=()) -> dict:
    """Nested dicts -> {path tuple: leaf}; empty dicts vanish (flax's
    ``flatten_dict``)."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def filter_state_by_regex(state: dict, pattern: str) -> dict:
    """The subtree of a nested state whose '/'-joined paths match
    ``pattern`` (``re.search``): the module-regex partial load of checkpoint
    stitching (``msmctts_tpu/utils/checkpoint.py:176-185``)."""
    rx = re.compile(pattern)
    return _unflatten({k: v for k, v in _flatten(state).items() if rx.search("/".join(map(str, k)))})


def merge_states(base: dict, overlay: dict) -> dict:
    """``base`` with every leaf that ``overlay`` has at the same path
    replaced; paths only ``overlay`` has are dropped
    (``msmctts_tpu/utils/checkpoint.py:188-200``)."""
    flat = _flatten(base)
    for k, v in _flatten(overlay).items():
        if k in flat:
            flat[k] = v
    return _unflatten(flat)
