"""Start W ranks of one data-parallel run on this host and collect what
they return.

``run_ranks(fn, world, ...)`` spawns ``world`` fresh processes. Each joins
the group (:func:`~msmctts_tpu_torch.parallel.mesh.init_distributed`, over a
file rendezvous in a temporary directory, so no port is chosen) and calls
``fn(group, device, *args)``; the list of return values comes back in rank
order. A rank that raises, dies or outlives ``timeout_s`` ends the whole
run: the others are killed and ``RuntimeError`` names the rank. ``fn`` and
its arguments must pickle (a module-level function).

``devices`` names each rank's device: ``["cpu", "cpu"]`` for the CPU,
``["cuda:0", "cuda:1"]`` for a card each (backend ``nccl``),
``["cuda:0", "cuda:0"]`` for ranks that share one card (backend ``gloo``);
:func:`rank_devices` reads them from an entry point's options. The
group's own collectives time out after ``group_timeout_s``. An exception in
the caller (a signal turned into one) kills the ranks before it propagates.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Sequence

import torch
import torch.distributed
import torch.multiprocessing as mp


def rank_devices(n: int, device: str = "cuda", devices: str = None, backend: str = None):
    """(devices, backend) of an entry point's ``--mesh-devices N`` /
    ``--nproc N`` with ``--device``, ``--devices`` (comma-separated CUDA
    indices) and ``--backend``: N ranks on the CPU over gloo, else one per
    listed card (N = 0 or -1: every local card), over nccl unless two ranks
    share a card (gloo)."""
    if device == "cpu":
        if n < 1:
            raise ValueError("on the CPU the number of ranks must be given (N >= 1)")
        return ["cpu"] * n, backend or "gloo"
    ids = devices.split(",") if devices else [str(i) for i in range(n if n > 0 else torch.cuda.device_count())]
    if n > 0 and len(ids) != n:
        raise ValueError(f"{n} ranks do not match the devices {devices}")
    if not ids:
        raise ValueError("no CUDA device for the ranks")
    return [f"cuda:{i}" for i in ids], backend or ("gloo" if len(set(ids)) < len(ids) else "nccl")


def _rank_main(rank: int, fn: Callable, world: int, backend: str, devices: Sequence[str], tmp: str,
               threads: int, group_timeout_s: float, args: tuple):
    from msmctts_tpu_torch.parallel import mesh

    if threads:
        torch.set_num_threads(threads)
    try:
        group = mesh.init_distributed(backend, rank, world, f"file://{tmp}/rendezvous", devices[rank],
                                      timeout_s=group_timeout_s)
        # the ranks' last meeting, on pairs of its own: a run whose group
        # timed out (a failed serving batch) still ends in order
        done = mesh.new_control_group(group, timeout_s=group_timeout_s)
        result = fn(group, torch.device(devices[rank]), *args)
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        if done is not None:
            torch.distributed.barrier(group=done)
        mesh.shutdown(group)
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _kill(ctx):
    for p in ctx.processes:
        if p.is_alive():
            p.kill()
    for p in ctx.processes:
        p.join(10)


def run_ranks(fn: Callable, world: int, backend: str, devices: Sequence[str], *args,
              timeout_s: float = 300.0, threads: int = 0, group_timeout_s: float = 600.0) -> List:
    if len(devices) != world:
        raise ValueError(f"{world} ranks need {world} devices, got {list(devices)}")
    tmp = tempfile.mkdtemp(prefix="msmctts_ranks_")
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, backend, list(devices), tmp, threads, group_timeout_s, args),
        nprocs=world, join=False, start_method="spawn",
    )
    deadline = time.monotonic() + timeout_s
    try:
        try:
            failure = _wait(ctx, deadline, timeout_s)
        except BaseException:  # interrupted: no rank outlives the caller
            _kill(ctx)
            raise
        if failure is not None:
            _kill(ctx)
            errors = []
            for r in range(world):
                path = os.path.join(tmp, f"error_{r}.txt")
                if os.path.exists(path):
                    errors.append(f"--- rank {r} ---\n{open(path).read()}")
            raise RuntimeError(f"run of {world} ranks ({backend}) failed: {failure}\n" + "\n".join(errors))
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"result_{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _wait(ctx, deadline: float, timeout_s: float):
    """Wait for every rank; a failure's description, or None."""
    while True:
        try:
            if ctx.join(timeout=1.0):
                return None
        except Exception as e:  # a rank raised or died; the context has ended the others
            return str(e)
        if time.monotonic() > deadline:
            return f"timed out after {timeout_s:.0f} s"
