"""Reader and writer for ``msmctts_tpu/v1`` checkpoints, without JAX.

The format (``msmctts_tpu/utils/checkpoint.py:32-43``) is a pickle of
``{"iteration", "config", "state", "format"}`` where ``state`` is a nested
dict of numpy arrays in the JAX package's layout ({params, codebook,
model_state, ...} per module). ``weights.py`` maps that tree to the port's
``state_dict`` and back. Stripped checkpoints store float16; the reader
upcasts every floating array to float32, the precision of this slice.

Orbax checkpoints (directories) are not read yet.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

FORMAT = "msmctts_tpu/v1"


def _map_arrays(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_arrays(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_arrays(v, fn) for v in tree)
    return fn(tree)


def _upcast(x):
    if isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.floating):
        return x.astype(np.float32)
    return x


def load_checkpoint(path: str) -> dict:
    """Read a ``msmctts_tpu/v1`` pickle; floats come back as float32.

    Only load checkpoints this project wrote: unpickling runs code."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an orbax checkpoint directory; the port reads "
            f"'{FORMAT}' pickles only"
        )
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("format") != FORMAT:
        raise ValueError(f"{path}: format {payload.get('format')!r}, expected {FORMAT!r}")
    payload["state"] = _map_arrays(payload["state"], _upcast)
    return payload


def save_checkpoint(path: str, state_tree: dict, iteration: int, config: dict):
    """Write ``state_tree`` (nested dict of numpy arrays, JAX layout) with
    the config embedded, atomically via rename."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "iteration": int(iteration),
        "config": config,
        "state": _map_arrays(state_tree, np.asarray),
        "format": FORMAT,
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=4)
    os.replace(tmp, path)
