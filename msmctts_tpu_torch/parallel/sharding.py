"""Tensor parallelism over a 2-D ``data`` x ``model`` group (counterpart of
``msmctts_tpu/parallel/sharding.py``).

The JAX package gives parameters Megatron-style PartitionSpecs over a
``model`` mesh axis and lets GSPMD insert the collectives. Here each rank
holds its shard of those parameters and the layers run the collectives
themselves, one all-reduce per paired block in the forward:

  * FFT-block attention (``models/transformer.MultiHeadAttention``): the
    fused ``qkv`` projection is column-parallel, split by whole heads (the
    port's ``linear`` is head-major), the ``out`` projection (``fc``)
    row-parallel, its bias added once after the reduce;
  * FFT-block ConvFFN: ``w1`` column-parallel, ``w2`` row-parallel;
  * HiFi-GAN MRF pairs (``models/hifigan.ResBlock1.forward_ncl``): ``conv1_i``
    column-parallel (its weight-norm ``g`` and bias follow the out-channel
    split), ``conv2_i`` row-parallel, its per-output-channel norm taken
    over every in-channel shard (the squared norm all-reduced in the graph,
    :func:`sum_over_model`), its ``g`` and bias replicated.

Each pair enters through :func:`copy_to_model` (identity forward,
all-reduce backward) and leaves through :func:`reduce_from_model`
(all-reduce forward, identity backward). Everything else (codebooks,
embeddings, norms, upsamplers, discriminators) is replicated over
``model``.

Which leaves are split is decided as the JAX package decides it: the
regular expressions of ``msmctts_tpu/parallel/sharding.py:63-80``, applied
to each parameter's JAX path (:func:`jax_paths` reads it through the
trainer's ``state_tree``, i.e. ``weights.py``'s name mapping), with
replication where the dimension does not divide the model axis. Where the
JAX package would split a pair that the port cannot split alike, the pair
stays replicated: an attention whose head count does not divide the axis
(GSPMD cuts through a head; the numbers do not change, only the layout).

The ``data`` group carries what handles rows (the loader's shard, loss
shares, the codebook statistics, global-batch draws, the gradient sum);
the ``model`` group the collectives above; the whole world agreement,
barriers and saving. Rank = d * M + m: the model axis varies fastest, as in
``make_mesh_2d``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from msmctts_tpu_torch.parallel import mesh

# (JAX path regex, dim to shard), as msmctts_tpu/parallel/sharding.py:63-80:
# -1 output (column-parallel), -2 input (row-parallel), both counted from the
# end of the JAX kernel's [..., in, out]; 0 a 1-D per-output-channel vector
_COLUMN = -1
_ROW = -2
RULES = [
    (re.compile(r"/qkv/(kernel|v)$"), _COLUMN),
    (re.compile(r"/qkv/bias$"), 0),
    (re.compile(r"/out/(kernel|v)$"), _ROW),
    (re.compile(r"/w1/(kernel|v)$"), _COLUMN),
    (re.compile(r"/w1/(bias|g)$"), 0),
    (re.compile(r"/w2/(kernel|v)$"), _ROW),
    (re.compile(r"/conv1_\d+/v$"), _COLUMN),
    (re.compile(r"/conv1_\d+/(bias|g)$"), 0),
    (re.compile(r"/conv2_\d+/v$"), _ROW),
]
# the JAX rule's dim -> the dim of the port's tensor: torch keeps [out, in, ...]
_TORCH_DIM = {_COLUMN: 0, _ROW: 1, 0: 0}


def jax_rule(path: str, shape, n_model: int) -> Optional[int]:
    """The dim (``_COLUMN``, ``_ROW`` or 0) the JAX package splits the leaf
    at ``path`` of ``shape`` along over ``n_model`` ranks, or None
    (replicated), as ``msmctts_tpu/parallel/sharding.py::_spec_for``."""
    for pattern, dim in RULES:
        if pattern.search(path):
            if dim == 0:
                return 0 if len(shape) == 1 and shape[0] % n_model == 0 else None
            axis = len(shape) + dim
            return dim if 0 <= axis < len(shape) and shape[axis] % n_model == 0 else None
    return None


# ------------------------------------------------------------------ groups


def make_group_2d(group: Optional[mesh.Group], n_data: int, n_model: int):
    """(data group, model group) of this rank in ``group`` split into
    ``n_data`` x ``n_model`` (their product its size); rank = d * n_model + m.
    Every rank calls it at the same point (``dist.new_group`` is
    collective)."""
    r = mesh.rank(group)
    backend = group.backend if group is not None else "gloo"

    def axis(groups: List[List[int]], name: str) -> mesh.Group:
        mine = None
        for ranks in groups:  # every rank makes every group, in one order
            pg = dist.new_group(ranks) if len(ranks) > 1 else None
            control = pg if backend == "gloo" or pg is None else dist.new_group(ranks, backend="gloo")
            if r in ranks:
                mine = mesh.Group(backend, ranks.index(r), len(ranks), pg, control, name=name, ranks=ranks)
        return mine

    return (axis([[d * n_model + m for d in range(n_data)] for m in range(n_model)], "data"),
            axis([[d * n_model + m for m in range(n_model)] for d in range(n_data)], "model"))


# ------------------------------------------------- the Megatron functions


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a
    column-parallel layer, whose gradient is the sum of every shard's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mesh.all_reduce_sum(g.clone(), ctx.group), None


# row-parallel outputs reduced since the last reset: one per split block a
# forward pass runs (the pair's one all-reduce)
PAIR_REDUCES = [0]


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward, identity backward: the output of a row-parallel
    layer, a sum of partial products that every rank then uses alike."""

    @staticmethod
    def forward(ctx, x, group):
        PAIR_REDUCES[0] += 1
        return mesh.all_reduce_sum(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group: Optional[mesh.Group]) -> torch.Tensor:
    return x if mesh.world(group) == 1 else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Optional[mesh.Group]) -> torch.Tensor:
    return x if mesh.world(group) == 1 else _ReduceFromModel.apply(x, group)


def sum_over_model(x: torch.Tensor, group: Optional[mesh.Group]) -> torch.Tensor:
    """A sum over the shards that every rank then uses (a weight norm over
    split input channels): all-reduce forward and backward."""
    return mesh.sum_over_ranks(x, group)


def row_parallel(layer: nn.Module, x: torch.Tensor, group: mesh.Group) -> torch.Tensor:
    """A ``precision.Linear`` / ``precision.Conv1d`` whose weight holds this
    rank's input channels: the partial product, reduced over ``group``,
    then the (replicated) bias once."""
    dt = torch.promote_types(torch.promote_types(x.dtype, layer.weight.dtype), layer.bias.dtype)
    if isinstance(layer, nn.Linear):
        y = F.linear(x.to(dt), layer.weight.to(dt))
        return reduce_from_model(y, group) + layer.bias.to(dt)
    y = layer._conv_forward(x.to(dt), layer.weight.to(dt), None)
    return reduce_from_model(y, group) + layer.bias.to(dt)[:, None]


# ----------------------------------------------------------------- plans


def jax_paths(modules: List[nn.Module], state_tree) -> Dict[int, str]:
    """id(parameter) -> its JAX path under ``state_tree()["params"]``
    ("/params/<network>/.../<leaf>"), found by filling every parameter with
    a tag of its own, reading the tree and putting the values back."""
    params, seen = [], set()
    for module in modules:
        for p in module.parameters():
            if id(p) not in seen:
                seen.add(id(p))
                params.append(p)
    saved = [p.detach().clone() for p in params]
    try:
        with torch.no_grad():
            for i, p in enumerate(params):
                p.fill_(float(i + 1))
        tree = state_tree()["params"]
    finally:
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
            return
        values = np.unique(np.asarray(node, np.float64))
        if values.size == 1 and float(values[0]).is_integer() and 1 <= values[0] <= len(params):
            out[id(params[int(values[0]) - 1])] = path

    walk(tree, "/params")
    return out


@dataclasses.dataclass
class Plan:
    """What a trainer splits: ``dims`` id(parameter) -> torch dim, the
    modules to switch (``modules``), the leaves the JAX rules mark
    (``marked``: JAX path -> torch dim) and the marked leaves kept whole
    (``replicated``: JAX path -> the reason)."""

    dims: Dict[int, int]
    modules: List[nn.Module]
    marked: Dict[str, int]
    replicated: Dict[str, str]


def _jax_shape(p: torch.Tensor):
    """The JAX leaf's shape of a port parameter, as far as the rules read
    it: [..., in, out] from torch's [out, in, ...]; a bias, or a weight-norm
    ``g`` [out, 1, 1], is the JAX vector [out]."""
    if all(s == 1 for s in p.shape[1:]):
        return (p.shape[0],)
    return (*p.shape[2:], p.shape[1], p.shape[0])


def make_plan(modules: List[nn.Module], state_tree, n_model: int) -> Plan:
    """Apply the JAX rules to every parameter under ``modules`` and keep
    the pairs the port's layers split (each layer's ``tp_layout(n_model)``:
    its parameters' torch dims, and why it stays whole, or None)."""
    paths = jax_paths(modules, state_tree)
    marked, rule_dim = {}, {}
    for module in modules:
        for p in module.parameters():
            path = paths.get(id(p))
            dim = None if path is None else jax_rule(path, _jax_shape(p), n_model)
            if dim is not None:
                marked[path] = rule_dim[id(p)] = _TORCH_DIM[dim]
    dims, switched, replicated = {}, [], {}
    for module in modules:
        for layer in module.modules():
            if not hasattr(layer, "tp_layout"):
                continue
            roles, why = layer.tp_layout(n_model)
            params = dict(layer.named_parameters())
            wanted = {id(params[n]): d for n, d in roles.items()}
            if why is None and all(rule_dim.get(i) == d for i, d in wanted.items()):
                dims.update(wanted)
                switched.append(layer)
            else:
                for i in wanted:
                    if i in rule_dim:
                        replicated[paths[i]] = why or "its pair is not split alike"
    return Plan(dims, switched, marked, replicated)


# ------------------------------------------------------------ state moves


def _narrow(t: torch.Tensor, dim: int, group: mesh.Group) -> torch.Tensor:
    n = t.shape[dim] // group.world
    return t.narrow(dim, group.rank * n, n).clone()


def _gather(t: torch.Tensor, dim: int, group: mesh.Group) -> torch.Tensor:
    g = mesh.all_gather_rows(t.movedim(dim, 0).contiguous(), group)
    return g.movedim(0, dim).contiguous()


def _moments(optimizers) -> Dict[int, dict]:
    """id(parameter) -> its optimizer state (Adam's moments), where it has one."""
    return {id(p): opt.opt.state[p] for opt in optimizers for p in opt.params if p in opt.opt.state}


@torch.no_grad()
def split_(plan: Plan, group: mesh.Group, optimizers=()):
    """Keep this rank's shard of every planned parameter and of its
    optimizer moments, and switch the planned modules to their split
    forward."""
    moments = _moments(optimizers)
    for module in plan.modules:
        for p in module.parameters():
            dim = plan.dims.get(id(p))
            if dim is None or getattr(p, "tp_dim", None) is not None:
                continue
            state = moments.get(id(p), {})
            for k, v in state.items():
                if isinstance(v, torch.Tensor) and v.shape == p.shape:
                    state[k] = _narrow(v, dim, group)
            p.data = _narrow(p.data, dim, group)
            p.tp_dim = dim
        module.set_model_group(group)
    for opt in optimizers:  # replicated gradients from model rank 0; the clip's norm over the split leaves
        opt.tp = group


@torch.no_grad()
def gather_(plan: Plan, group: mesh.Group, optimizers=()):
    """The inverse of :func:`split_`: every planned parameter and its
    moments whole on every rank, the modules back to their one-rank
    forward."""
    moments = _moments(optimizers)
    for module in plan.modules:
        for p in module.parameters():
            dim = getattr(p, "tp_dim", None)
            if dim is None:
                continue
            state = moments.get(id(p), {})
            for k, v in state.items():
                if isinstance(v, torch.Tensor) and v.shape == p.shape:
                    state[k] = _gather(v, dim, group)
            p.data = _gather(p.data, dim, group)
            del p.tp_dim
        module.set_model_group(None)
    for opt in optimizers:
        opt.tp = None
