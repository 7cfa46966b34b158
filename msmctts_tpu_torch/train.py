"""Training CLI of the port, on the GPU.

    python -m msmctts_tpu_torch.train -c examples/csmsc/configs/msmc_vq_gan.yaml \\
        [--max-steps N] [--log-every N] [--profile DIR] [--device cpu]

The counterpart of the root ``train.py``: the same YAML recipes, the same
checkpoints. ``--profile DIR`` writes a ``torch.profiler`` Chrome trace of
steps 10-14 under DIR (``BaseTrainer.train``). Runs on ``cuda`` unless ``--device`` says otherwise; without a
GPU it refuses to run.

One process drives one device. A data-parallel run is W such processes, each
started with the same ``--coordinator host:port`` and ``--num-processes W``
and its own ``--process-id`` (the arguments of the root ``train.py``), or
under ``torchrun``, whose ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT`` / ``LOCAL_RANK`` are read when the arguments are absent.
``--backend`` names the collective backend: ``nccl`` (default on a GPU: a
card per rank) or ``gloo`` (CPU, or ranks sharing one card; see
``parallel/mesh.py``). The config's ``batch_size`` is the global batch.
``python -m msmctts_tpu_torch.train_dist`` starts the ranks of one host.
"""

from __future__ import annotations

import argparse
import os

from msmctts_tpu_torch.config import Config, component_kwargs
from msmctts_tpu_torch.parallel import mesh
from msmctts_tpu_torch.registry import get_trainer
from msmctts_tpu_torch.tasks import build_task
from msmctts_tpu_torch.utils.device import resolve_device


def _join_group(args, device):
    """The run's group from the arguments, else from torchrun's
    environment; None for a single process."""
    env = os.environ
    world = args.num_processes if args.num_processes is not None else int(env.get("WORLD_SIZE", 1))
    if world <= 1:
        return None
    rank = args.process_id if args.process_id is not None else int(env.get("RANK", 0))
    coordinator = args.coordinator
    if coordinator is None and "MASTER_ADDR" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if coordinator is None:
        raise SystemExit("a run of several processes needs --coordinator host:port (or torchrun's MASTER_ADDR)")
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    group = mesh.init_distributed(backend, rank, world, f"tcp://{coordinator}", device)
    print(f"rank {rank} of {world} on {device}, backend {backend}, coordinator {coordinator}", flush=True)
    return group


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-c", "--config", required=True)
    p.add_argument("--max-steps", type=int, default=None, help="stop after N steps")
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--profile", default=None, metavar="DIR", help="write a torch.profiler trace of a few steps to DIR")
    p.add_argument("--device", default=None, help="cuda (default; cuda:<LOCAL_RANK> under torchrun), cuda:N or cpu")
    p.add_argument("--coordinator", default=None, help="host:port of rank 0, for a run of several processes")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--backend", default=None, choices=mesh.BACKENDS,
                   help="collective backend (default: nccl on a GPU, gloo on the CPU)")
    args = p.parse_args(argv)

    device = args.device
    if device is None and "LOCAL_RANK" in os.environ:
        device = f"cuda:{os.environ['LOCAL_RANK']}"
    device = resolve_device(device)
    group = _join_group(args, device)
    try:
        config = Config(args.config)
        task = build_task(config, device=device, mode="train")
        trainer = get_trainer(config.trainer["_name"])(config, task, group=group, **component_kwargs(config.trainer))
        trainer.train(max_steps=args.max_steps, log_every=args.log_every, profile_dir=args.profile)
    finally:
        mesh.shutdown(group)
    return trainer


if __name__ == "__main__":
    main()
