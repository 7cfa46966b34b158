"""YAML configuration system (the port's own copy of ``msmctts_tpu/config.py``).

Keeps the reference's public config surface (attribute-style nested dicts,
``_name``-keyed component selection, defaults, recursive update; see reference
``msmctts/utils/config.py:6-110``) while remaining a plain-Python layer with
no framework dependencies.

Semantics preserved from the reference:
  * scientific-notation floats like ``1e-5`` parse as floats (SafeLoader
    misses them without an extra resolver),
  * the string ``'none'`` maps to ``None``,
  * keys beginning with ``_`` are meta keys (``_name``, ``_mode``,
    ``_checkpoint``, ``_config``, ``_trainable``, ``_default``) and are
    stripped before a component's kwargs are built,
  * ``Config`` layers user YAML over ``DEFAULTS`` with a recursive update.
"""

from __future__ import annotations

import json
import re

import yaml

# Global defaults layered under every config (reference config.py:6-27 keeps
# torch/cudnn knobs; these are the JAX package's, kept so YAML recipes and
# embedded checkpoint configs read the same in both packages).
DEFAULTS = {
    "training_steps": 1_000_000,
    "iters_per_checkpoint": 50_000,
    "seed": 1234,
    "resume_training": True,
    "pretrain_checkpoint_path": "",
    "restore_checkpoint_path": "",
    "save_checkpoint_dir": "checkpoints",
    # numerical precision of activations inside the train step
    # ("float32" | "bfloat16"); parameters and VQ/EMA state stay float32.
    "precision": "float32",
    # mesh axis sizes for pjit data parallelism; -1 = all visible devices.
    "mesh": {"data": -1},
    "dataloader": {"batch_size": 16, "num_workers": 4},
}

_FLOAT_RE = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
    re.X,
)


class _Loader(yaml.SafeLoader):
    pass


_Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float", _FLOAT_RE, list("-+0123456789.")
)


def load_yaml(path: str) -> dict:
    with open(path, "r") as f:
        return yaml.load(f, Loader=_Loader)


class ConfigDict(dict):
    """dict with attribute access, recursive wrapping and 'none' -> None."""

    def __init__(self, data=None):
        super().__init__()
        if data:
            for key, value in data.items():
                self[key] = self._wrap(value)

    @staticmethod
    def _wrap(value):
        # Always wrap as plain ConfigDict: subclasses (Config) layer
        # defaults in __init__ and must not re-apply them to nested nodes.
        if isinstance(value, ConfigDict):
            return value
        if isinstance(value, dict):
            return ConfigDict(value)
        if isinstance(value, (list, tuple)):
            return [ConfigDict._wrap(v) for v in value]
        if isinstance(value, str) and value.lower() == "none":
            return None
        return value

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        self[name] = self._wrap(value)

    def __setitem__(self, name, value):
        super().__setitem__(name, self._wrap(value))

    def __deepcopy__(self, memo):
        return ConfigDict(self.to_dict())

    def merge(self, other: dict):
        """Recursive update (reference config.py:86-93)."""
        for key, value in other.items():
            if (
                key in self
                and isinstance(self[key], ConfigDict)
                and isinstance(value, dict)
            ):
                self[key].merge(value)
            else:
                self[key] = value
        return self

    def to_dict(self) -> dict:
        out = {}
        for key, value in self.items():
            out[key] = _unwrap(value)
        return out

    def get_path(self, dotted: str, default=None):
        node = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node


def _unwrap(value):
    if isinstance(value, ConfigDict):
        return value.to_dict()
    if isinstance(value, list):
        return [_unwrap(v) for v in value]
    return value


class Config(ConfigDict):
    """DEFAULTS overlaid with a YAML file or dict (reference config.py:96)."""

    def __init__(self, source=None):
        super().__init__(DEFAULTS)
        if source is None:
            return
        if isinstance(source, str):
            source = load_yaml(source)
        self.merge(source)


def component_kwargs(node: dict) -> dict:
    """Non-meta keys of a component config, i.e. its constructor kwargs.

    Meta keys (``_name`` etc.) select and wire the component; everything else
    is passed through (reference networks/__init__.py:9).
    """
    return {k: _unwrap(v) for k, v in node.items() if not k.startswith("_")}


def config_to_json(config: dict) -> str:
    data = config.to_dict() if isinstance(config, ConfigDict) else config
    return json.dumps(data, indent=2, default=str)
