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
``["cuda:0", "cuda:0"]`` for ranks that share one card (backend ``gloo``).
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
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, world: int, backend: str, devices: Sequence[str], tmp: str,
               threads: int, args: tuple):
    from msmctts_tpu_torch.parallel import mesh

    if threads:
        torch.set_num_threads(threads)
    try:
        group = mesh.init_distributed(backend, rank, world, f"file://{tmp}/rendezvous", devices[rank])
        result = fn(group, torch.device(devices[rank]), *args)
        with open(os.path.join(tmp, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        mesh.barrier(group)
        mesh.shutdown(group)
    except BaseException:
        with open(os.path.join(tmp, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_ranks(fn: Callable, world: int, backend: str, devices: Sequence[str], *args,
              timeout_s: float = 300.0, threads: int = 0) -> List:
    if len(devices) != world:
        raise ValueError(f"{world} ranks need {world} devices, got {list(devices)}")
    tmp = tempfile.mkdtemp(prefix="msmctts_ranks_")
    ctx = mp.start_processes(
        _rank_main, args=(fn, world, backend, list(devices), tmp, threads, args),
        nprocs=world, join=False, start_method="spawn",
    )
    deadline = time.monotonic() + timeout_s
    failure = None
    try:
        while True:
            try:
                if ctx.join(timeout=1.0):
                    break
            except Exception as e:  # a rank raised or died; the context has ended the others
                failure = str(e)
                break
            if time.monotonic() > deadline:
                failure = f"timed out after {timeout_s:.0f} s"
                break
        if failure is not None:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join(10)
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
