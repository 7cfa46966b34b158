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
``checkpoint_keep_interval`` steps and its newest two. Orbax checkpoints
(directories) are neither read nor written yet (ROADMAP A7d).
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Optional

import numpy as np

FORMAT = "msmctts_tpu/v1"
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
    """Read a ``msmctts_tpu/v1`` pickle as it was stored (a stripped
    checkpoint's float16 stays float16).

    Only load checkpoints this project wrote: unpickling runs code."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an orbax checkpoint directory; the port reads "
            f"'{FORMAT}' pickles only"
        )
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path}: format {payload.get('format')!r}, expected {FORMAT!r}")
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


def checkpoint_step(path: str) -> int:
    m = re.search(r"model_(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else -1


def find_latest_checkpoint(save_dir: str) -> Optional[str]:
    """The ``model_<step>`` pickle with the highest step in ``save_dir``
    (auto-resume), or None."""
    if not os.path.isdir(save_dir):
        return None
    cands = [
        os.path.join(save_dir, f) for f in os.listdir(save_dir)
        if f.startswith(CKPT_PREFIX) and not f.endswith(".tmp") and os.path.isfile(os.path.join(save_dir, f))
    ]
    return max(cands, key=checkpoint_step) if cands else None


def clean_checkpoint_directory(save_dir: str, interval: int, keep_last: int = 2):
    """Delete the ``model_<step>`` pickles whose step is not a multiple of
    ``interval``, except the newest ``keep_last`` (a trainer's
    ``checkpoint_keep_interval``; ``msmctts_tpu/utils/checkpoint.py:151-173``).
    Pickles only: the port writes no orbax directory."""
    if not os.path.isdir(save_dir):
        return
    cands = sorted(
        (
            os.path.join(save_dir, f) for f in os.listdir(save_dir)
            if f.startswith(CKPT_PREFIX) and not f.endswith(".tmp") and os.path.isfile(os.path.join(save_dir, f))
        ),
        key=checkpoint_step,
    )
    for path in cands[:-keep_last]:
        if interval > 0 and checkpoint_step(path) % interval != 0:
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
