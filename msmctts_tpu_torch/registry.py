"""Explicit component registries (counterpart of ``msmctts_tpu/registry.py``).

A config node's ``_name`` picks the class; the node's non-underscore keys
are its kwargs. Only the components of the ported slices register.
"""

from __future__ import annotations

NETWORKS: dict = {}
TASKS: dict = {}
TRAINERS: dict = {}
DATASETS: dict = {}


def _make_register(table: dict, kind: str):
    def register(name: str):
        def wrap(cls):
            if name in table:
                raise ValueError(f"duplicate {kind} registration: {name}")
            table[name] = cls
            return cls

        return wrap

    return register


register_network = _make_register(NETWORKS, "network")
register_task = _make_register(TASKS, "task")
register_trainer = _make_register(TRAINERS, "trainer")
register_dataset = _make_register(DATASETS, "dataset")


def _resolve(table: dict, name: str, kind: str):
    if name not in table:
        _populate()
    if name not in table:
        known = ", ".join(sorted(table))
        raise KeyError(f"unknown {kind} '{name}' (known: {known})")
    return table[name]


def _populate():
    # Importing these modules runs their @register_* decorators.
    from msmctts_tpu_torch import tasks as _tasks  # noqa: F401
    from msmctts_tpu_torch.data import datasets as _datasets  # noqa: F401
    from msmctts_tpu_torch.models import (  # noqa: F401
        hifigan as _hifigan,
        msmc_vqgan as _msmc_vqgan,
        msmc_vqgan_emb as _msmc_vqgan_emb,
        predictor as _predictor,
    )
    from msmctts_tpu_torch.training import (  # noqa: F401
        emb_vqgan_trainer as _emb_vqgan_trainer,
        predictor_trainer as _predictor_trainer,
        vqgan_trainer as _vqgan_trainer,
    )


def get_network(name: str):
    return _resolve(NETWORKS, name, "network")


def get_task(name: str):
    return _resolve(TASKS, name, "task")


def get_trainer(name: str):
    return _resolve(TRAINERS, name, "trainer")


def get_dataset(name: str):
    return _resolve(DATASETS, name, "dataset")
