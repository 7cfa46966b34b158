"""Data-parallel execution over ``torch.distributed`` (counterpart of
``msmctts_tpu/parallel/mesh.py``).

The JAX package shards a global batch over a device mesh from one process
and lets XLA insert the collectives. Here one process drives one GPU: W
processes ("ranks") each hold a replica of the parameters and codebooks,
take a contiguous block of every global batch, and sum over ranks whatever
the global step sums over the batch: gradients, loss denominators and the
codebook's EMA statistics. W ranks then compute what one rank computes on
the whole batch, to reduction rounding.

A :class:`Group` is what :func:`init_distributed` returns and what every
function here takes. ``None`` stands for "no group": one process, and no
collective ever runs; a group of size 1 behaves the same. The backend
is the caller's explicit choice:

  * ``nccl``: every rank owns a card (the multi-GPU default);
  * ``gloo``: CPU tensors, or ranks that share one card (NCCL refuses two
    ranks on one device); gloo reduces CUDA tensors through host memory by
    itself.

Host-side flags (:func:`agree_any`) travel over gloo on CPU tensors in
every case, so agreeing on one never waits for the device.

Every collective that runs is counted, calls and bytes, in
:data:`COLLECTIVES` by the name of the group it ran over (``world``, or the
``data`` / ``model`` subgroups of ``parallel/sharding.py``) and its kind; a
path that must not communicate (the inference snap) is tested by that count
staying 0.

Serving over a group (``serving.BatchingEngine(group=...)``) adds host-side
messages: :func:`broadcast_object` sends rank 0's control header and padded
numpy batch to every rank, :func:`all_gather_objects` brings every rank's
status back, both over gloo on the host; :func:`all_reduce_max` is the
max-reduce.
"""

from __future__ import annotations

import dataclasses
import datetime
import pickle
from typing import Any, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")

# collectives run by this process since the last reset:
# {(group name, kind): [calls, bytes]}
COLLECTIVES: dict = {}
KINDS = ("all_reduce", "broadcast", "all_gather")


def reset_collective_counts():
    COLLECTIVES.clear()


def collective_counts(by_group: bool = False) -> dict:
    """{kind: {"calls": n, "bytes": payload bytes}} since the last reset,
    summed over groups (every kind present); with ``by_group`` keyed
    "<group name> <kind>" instead, only the kinds that ran."""
    if by_group:
        return {f"{g} {k}": {"calls": v[0], "bytes": v[1]} for (g, k), v in sorted(COLLECTIVES.items())}
    out = {k: {"calls": 0, "bytes": 0} for k in KINDS}
    for (_, k), (calls, nbytes) in COLLECTIVES.items():
        out[k]["calls"] += calls
        out[k]["bytes"] += nbytes
    return out


def _count(kind: str, t, group: Optional["Group"] = None):
    nbytes = t if isinstance(t, int) else t.numel() * t.element_size()
    entry = COLLECTIVES.setdefault((group.name if group is not None else "world", kind), [0, 0])
    entry[0] += 1
    entry[1] += nbytes


@dataclasses.dataclass
class Group:
    """The ranks of one data-parallel run, as this process sees them."""

    backend: str  # one of BACKENDS
    rank: int
    world: int
    pg: Optional[dist.ProcessGroup]  # carries tensor collectives
    control: Optional[dist.ProcessGroup]  # gloo, carries host-side flags
    name: str = "world"  # "data" / "model" for the subgroups of parallel/sharding.py
    ranks: Optional[List[int]] = None  # global ranks of the members, in group order (None: 0..world-1)

    def global_rank(self, r: int) -> int:
        """The global rank of this group's member ``r``."""
        return r if self.ranks is None else self.ranks[r]


def world(group: Optional[Group]) -> int:
    return 1 if group is None else group.world


def rank(group: Optional[Group]) -> int:
    return 0 if group is None else group.rank


def init_distributed(backend: str, rank: int, world: int, init_method: str,
                     device=None, timeout_s: float = 600.0) -> Group:
    """Join the run's process group. ``init_method`` is a
    ``tcp://host:port`` or ``file://path`` rendezvous that every rank names
    alike. With a CUDA ``device`` it becomes this process's current device,
    so that kernels and collectives launch on its streams."""
    if backend not in BACKENDS:
        raise ValueError(f"backend '{backend}' is not one of {BACKENDS}")
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    elif backend == "nccl":
        raise ValueError("backend 'nccl' needs a CUDA device for every rank")
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
    )
    pg = dist.group.WORLD
    control = dist.new_group(backend="gloo") if backend == "nccl" else pg
    return Group(backend, rank, world, pg, control)


def new_control_group(group: Optional[Group], timeout_s: float) -> Optional[dist.ProcessGroup]:
    """A gloo group of the same ranks with its own ``timeout_s``: the
    serving followers wait on it for rank 0's next header, as long as the
    daemon stays idle. Every rank calls it at the same point."""
    if world(group) == 1:
        return None
    return dist.new_group(ranks=group.ranks, backend="gloo", timeout=datetime.timedelta(seconds=timeout_s))


def shutdown(group: Optional[Group]):
    if group is not None and dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------ collectives


def all_reduce_sum(t: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Sum of ``t`` over ranks, in place; ``t`` itself without a group."""
    if world(group) == 1:
        return t
    _count("all_reduce", t, group)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group.pg)
    return t


def all_reduce_max(t: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Elementwise max of ``t`` over ranks, in place; ``t`` itself without
    a group."""
    if world(group) == 1:
        return t
    _count("all_reduce", t, group)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group.pg)
    return t


def broadcast(t: torch.Tensor, group: Optional[Group], src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place."""
    if world(group) == 1:
        return t
    _count("broadcast", t, group)
    dist.broadcast(t, src=group.global_rank(src), group=group.pg)
    return t


def _to_bytes(obj: Any) -> torch.Tensor:
    return torch.frombuffer(bytearray(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)), dtype=torch.uint8)


def broadcast_object(obj: Any, group: Optional[Group], src: int = 0, control=None) -> Any:
    """Rank ``src``'s picklable ``obj`` (a control header, a padded numpy
    batch, a state tree) on every rank, over gloo on the host (``control``,
    by default the group's): its length, then its pickled bytes. Other
    ranks pass anything; it is ignored."""
    if world(group) == 1:
        return obj
    pg, root = control or group.control, group.global_rank(src)
    payload = _to_bytes(obj) if group.rank == src else None
    n = torch.tensor([0 if payload is None else payload.numel()], dtype=torch.int64)
    dist.broadcast(n, src=root, group=pg)
    if payload is None:
        payload = torch.empty(int(n.item()), dtype=torch.uint8)
    dist.broadcast(payload, src=root, group=pg)
    _count("broadcast", payload, group)
    return pickle.loads(payload.numpy().tobytes())


def all_gather_objects(obj: Any, group: Optional[Group]) -> List[Any]:
    """Every rank's picklable ``obj``, in rank order, over gloo on the host:
    the lengths, then the pickled bytes padded to the longest."""
    if world(group) == 1:
        return [obj]
    payload = _to_bytes(obj)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(group.world)]
    dist.all_gather(sizes, torch.tensor([payload.numel()], dtype=torch.int64), group=group.control)
    longest = max(int(n.item()) for n in sizes)
    parts = [torch.empty(longest, dtype=torch.uint8) for _ in range(group.world)]
    dist.all_gather(parts, torch.nn.functional.pad(payload, (0, longest - payload.numel())), group=group.control)
    _count("all_gather", payload, group)
    return [pickle.loads(p[: int(n.item())].numpy().tobytes()) for p, n in zip(parts, sizes)]


def all_gather_rows(t: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
    order."""
    if world(group) == 1:
        return t
    _count("all_gather", t, group)
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(group.world)]
    dist.all_gather(parts, src, group=group.pg)
    return torch.cat(parts, dim=0)


class _SumOverRanks(torch.autograd.Function):
    """all-reduce whose backward is the all-reduce of the incoming gradient:
    the adjoint of a sum that every rank then uses."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.clone(), ctx.group), None


def sum_over_ranks(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Differentiable :func:`all_reduce_sum` (out of place). For a global
    quantity that is not a sum of per-rank terms (a ratio of norms): every
    rank forms it from the summed parts and takes ``1 / world`` of it as its
    share of the loss."""
    if world(group) == 1:
        return x
    return _SumOverRanks.apply(x, group)


def agree_any(flag: bool, group: Optional[Group]) -> bool:
    """True on every rank iff ``flag`` is true on any: how ranks agree to
    stop (a preempted rank must not leave the others inside a collective).
    A CPU tensor over gloo: it never waits for the device."""
    if world(group) == 1:
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0])
    _count("all_reduce", t, group)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group.control)
    return bool(t.item() > 0)


def barrier(group: Optional[Group]):
    if world(group) > 1:
        dist.barrier(group=group.control)


# ------------------------------------------------------------------ state


def _flat_state(modules: Iterable[torch.nn.Module]) -> List[torch.Tensor]:
    tensors = []
    for m in modules:
        tensors += [p.data for p in m.parameters()]
        tensors += [b for b in m.buffers()]
    return [t for t in tensors if t.is_floating_point()]


def replicate_state(modules: Iterable[torch.nn.Module], group: Optional[Group]):
    """Rank 0's parameters and buffers on every rank (one broadcast of one
    flat buffer): the counterpart of placing the state replicated."""
    if world(group) == 1:
        return
    tensors = _flat_state(modules)
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    broadcast(flat, group)
    offset = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[offset : offset + t.numel()].view_as(t))
            offset += t.numel()


def max_deviation_from_rank0(modules: Iterable[torch.nn.Module], group: Optional[Group]) -> float:
    """max over ranks, parameters and buffers of |x - x on rank 0|, the same
    number on every rank; 0.0 means the state is bit-equal across ranks."""
    if world(group) == 1:
        return 0.0
    tensors = _flat_state(modules)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    ref = broadcast(flat.clone(), group)
    dev = (flat - ref).abs().max().reshape(1)
    dev = torch.where(torch.isnan(dev), torch.full_like(dev, float("inf")), dev)
    return float(all_reduce_sum(dev, group).item())


# ---------------------------------------------------------------- batches


def pad_batch_to_devices(batch: dict, n: int) -> dict:
    """Pad every leaf's leading dimension up to a multiple of ``n`` by
    repeating real rows from the start, so that any batch size splits over
    ``n`` ranks (numpy; the rule of the JAX package's function of this
    name)."""
    B = next(iter(batch.values())).shape[0]
    if B % n == 0:
        return batch
    pad = n - (B % n)

    def f(x):
        x = np.asarray(x)
        if x.ndim == 0 or x.shape[0] != B:
            return x
        return np.concatenate([x, x[np.arange(pad) % B]], axis=0)

    return {k: f(v) for k, v in batch.items()}


def shard_rows(batch: dict, rank: int, world: int) -> dict:
    """Rank ``rank``'s contiguous block of every leaf with a batch
    dimension: rows ``[rank * B / world, (rank + 1) * B / world)``, the
    layout of the loader's ``shard=(rank, world)``. The batch must divide."""
    if world == 1:
        return batch
    B = next(iter(batch.values())).shape[0]
    if B % world:
        raise ValueError(f"batch size {B} does not divide the {world} ranks")
    b = B // world
    return {
        k: v[rank * b : (rank + 1) * b] if getattr(v, "ndim", 0) >= 1 and v.shape[0] == B else v
        for k, v in batch.items()
    }
