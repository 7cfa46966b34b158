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

Orbax checkpoints (directories) are not read yet.
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


def load_checkpoint(path: str) -> dict:
    """Read a ``msmctts_tpu/v1`` pickle; floats come back as float32.

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
