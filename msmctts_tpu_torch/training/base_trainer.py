"""Common training loop (counterpart of
``msmctts_tpu/training/base_trainer.py``).

Data loader and optimizers from the config, auto-resume (the latest
``model_*`` in the save dir, else ``restore_checkpoint_path``, else a fresh
seeded init plus an optional ``pretrain_checkpoint_path``), logging every
``log_every`` steps, checkpoints every ``iters_per_checkpoint`` steps with
the full config embedded, and a clean save-and-exit on SIGTERM / SIGINT.

Where the JAX package threads one immutable state tree through a jitted
step, the state here lives in the task's modules (parameters and codebook
buffers, updated in place), one :class:`~msmctts_tpu_torch.training.optim.Optimizer`
per module, the iteration count and the trainer's ``torch.Generator``, from
which every random draw of a step comes (dropout, window starts).

Checkpoints keep the ``msmctts_tpu/v1`` layout: ``state['params']`` and
``state['codebook']`` are the JAX package's trees, so the port's inference
task and the JAX package both load them. Optimizer moments and the
generator's state sit beside them under keys of their own
(``torch_opt_state``, ``torch_rng``), which the JAX package ignores: it
resumes such a checkpoint with fresh moments.

Data parallelism (counterpart of the JAX trainer's ``data`` mesh axis):
given a ``parallel.mesh.Group``, this process is one of W ranks, each on its
own device with a replica of the whole state. The config's ``batch_size``
is the *global* batch: the loader hands this rank a contiguous block of
``batch_size // W`` rows of every global batch. Every rank's generator holds
the same state and draws for the global batch, so the ranks' states stay
bit-equal and W ranks train what one rank trains, to reduction rounding.
After the resume ladder rank 0's state is broadcast. Rank 0 alone writes
checkpoints; every rank reads them and keeps a log of its own. SIGTERM /
SIGINT on any rank is agreed on after every step (one flag over gloo), so
that all ranks leave the loop at the same iteration.

fp32 only; the ``model`` axis of a ``mesh:`` node (tensor parallelism),
bf16, the profiler hook and periodic evaluation summaries are not ported.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch

from msmctts_tpu_torch.config import component_kwargs
from msmctts_tpu_torch.data.loader import DataLoader, to_device
from msmctts_tpu_torch.ops.dropout import bind_generator
from msmctts_tpu_torch.parallel import mesh
from msmctts_tpu_torch.registry import get_dataset
from msmctts_tpu_torch.training.optim import Optimizer
from msmctts_tpu_torch.utils.checkpoint import find_latest_checkpoint, load_checkpoint, map_leaves, save_checkpoint
from msmctts_tpu_torch.weights import init_random


def build_dataset_from_config(config, training: bool = True, id_list=None):
    """The config's ``dataset``; ``id_list`` (a list file or a test-list
    YAML) replaces the config's, as ``infer.py`` does with ``-t``."""
    node = dict(config.dataset)
    name = node.pop("_name")
    kwargs = component_kwargs(node)
    if id_list is not None:
        kwargs["id_list"] = id_list
    kwargs["training"] = training
    kwargs.setdefault("seed", config.get("seed", 1234))
    return get_dataset(name)(**kwargs)


def metrics_to_host(metrics: dict) -> Dict[str, float]:
    """A dict of 0-d tensors -> floats, with one device-to-host transfer."""
    names = sorted(metrics)
    if not names:
        return {}
    values = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32).detach().reshape(()) for k in names])
    return dict(zip(names, values.cpu().tolist()))


class TextLogger:
    """Appends time-stamped lines to ``train_rank<rank>_<stamp>.log`` in the
    save dir and echoes them to stdout."""

    def __init__(self, log_dir: str, rank: int = 0):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"train_rank{rank}_{time.strftime('%Y%m%d-%H%M%S')}.log")

    def text(self, message: str):
        line = f"[{time.strftime('%H:%M:%S')}] {message}"
        with open(self.path, "a") as f:
            f.write(line + "\n")
        print(line, flush=True)


def check_mesh_config(config, world: int):
    """The config's ``mesh: {data: N, model: M}`` node against the run: N
    (-1 or absent = any) is the number of ranks to expect."""
    node = dict(config.get("mesh") or {})
    if int(node.get("model", 1) or 1) > 1:
        raise NotImplementedError("mesh.model > 1 (tensor parallelism) is not ported")
    n_data = int(node.get("data", -1) or -1)
    if n_data != -1 and n_data != world:
        raise ValueError(f"the config asks for mesh.data = {n_data} but the run has {world} rank(s)")


class BaseTrainer:
    def __init__(self, config, task, group=None):
        if task.mode != "train":
            raise ValueError("a trainer needs a task built with mode='train'")
        precision = str(config.get("precision", "float32")).lower()
        if precision not in ("fp32", "float32"):
            raise NotImplementedError(f"precision '{precision}' is not ported (fp32 only)")
        self.config = config
        self.task = task
        self.group = group
        self.rank, self.world = mesh.rank(group), mesh.world(group)
        check_mesh_config(config, self.world)
        self.device = task.device
        self.save_dir = config.get("save_checkpoint_dir", "checkpoints")
        self.training_steps = int(config.get("training_steps", 1_000_000))
        self.iters_per_checkpoint = int(config.get("iters_per_checkpoint", 50_000))
        self.seed = int(config.get("seed", 1234))
        self.iteration = 0
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.optimizers: Dict[str, Optimizer] = {}
        for module in task.networks.values():
            bind_generator(module, self.generator, shard=(self.rank, self.world))

    # ------------------------------------------------------ to be overridden
    def train_step(self, batch: dict, iteration: int) -> dict:
        """One optimization step on a device batch; returns a dict of 0-d
        metric tensors."""
        raise NotImplementedError

    def state_tree(self) -> dict:
        """The model state as the JAX package's checkpoint tree."""
        raise NotImplementedError

    def load_state_tree(self, state: dict):
        raise NotImplementedError

    def restart_optimizer_counts(self, iteration: int):
        """Schedule positions after resuming a checkpoint that carries no
        optimizer state of this stack."""
        for opt in self.optimizers.values():
            opt.count = iteration

    # ----------------------------------------------------------------- state
    def init_state(self):
        """Fresh seeded weights for every trainable network
        (``weights.init_random``; no init batch, no EMA update)."""
        for i, name in enumerate(sorted(self.task.networks)):
            init_random(self.task.networks[name], self.seed + i)
            self.task.networks[name].train()

    def attempt_resume(self):
        """The resume ladder of the JAX package's trainer."""
        self.init_state()
        latest = find_latest_checkpoint(self.save_dir) if self.config.get("resume_training", True) else None
        restore = self.config.get("restore_checkpoint_path") or None
        pretrain = self.config.get("pretrain_checkpoint_path") or None
        path = latest or restore
        if isinstance(path, (list, tuple)):
            raise NotImplementedError("checkpoint stitching ([[regex, path], ...]) is not ported")
        if path:
            self.load(path)
        elif pretrain:
            self.load_state_tree(load_checkpoint(pretrain)["state"])  # weights only
        mesh.replicate_state(self.task.networks.values(), self.group)

    def load(self, path: str):
        ckpt = load_checkpoint(path)
        state = ckpt["state"]
        self.load_state_tree(state)
        self.iteration = int(ckpt["iteration"])
        if "torch_opt_state" in state:
            as_tensor = lambda x: torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) else x
            for name, opt in self.optimizers.items():
                opt.load_state_dict(map_leaves(state["torch_opt_state"][name], as_tensor))
            self.generator.set_state(torch.from_numpy(np.asarray(state["torch_rng"], np.uint8)))
        else:
            self.restart_optimizer_counts(self.iteration)

    def save(self) -> Optional[str]:
        """Write ``model_<iteration>``; under a group rank 0 alone does (the
        state is replicated)."""
        self._last_saved_iteration = self.iteration
        if self.rank != 0:
            return None
        path = os.path.join(self.save_dir, f"model_{self.iteration}")
        state = self.state_tree()
        as_numpy = lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
        state["torch_opt_state"] = {n: map_leaves(o.state_dict(), as_numpy) for n, o in self.optimizers.items()}
        state["torch_rng"] = self.generator.get_state().cpu().numpy()
        cfg = self.config.to_dict() if hasattr(self.config, "to_dict") else dict(self.config)
        save_checkpoint(path, state, self.iteration, cfg)
        return path

    # ------------------------------------------------------------------ loop
    def train(self, max_steps: Optional[int] = None, log_every: int = 50):
        dl_cfg = self.config.get("dataloader", {})
        # the config's batch_size is global; this rank loads its block of it
        global_batch = int(dl_cfg.get("batch_size", 16))
        if global_batch % self.world:
            raise ValueError(f"batch_size {global_batch} does not divide the {self.world} ranks")
        dataset = build_dataset_from_config(self.config, training=True)
        loader = DataLoader(
            dataset,
            batch_size=global_batch // self.world,
            shuffle=True,
            num_workers=int(dl_cfg.get("num_workers", 4)),
            seed=self.seed,
            shard=(self.rank, self.world),
        )
        batches = iter(loader)
        self.attempt_resume()

        logger = TextLogger(self.save_dir, self.rank)
        stop_at = min(
            self.training_steps,
            self.iteration + max_steps if max_steps is not None else self.training_steps,
        )

        # SIGTERM/SIGINT set a flag; the loop finishes the step in flight,
        # saves a resumable checkpoint and returns. Ranks agree on the flag
        # after every step, so a signal to one stops all at one iteration.
        preempted = []
        prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, lambda signum, frame: preempted.append(signum))
            except ValueError:  # not the main thread
                break

        t0 = time.time()
        self._last_saved_iteration = None
        try:
            stop = mesh.agree_any(bool(preempted), self.group)
            while self.iteration < stop_at and not stop:
                self.iteration += 1
                batch = to_device(next(batches), self.device)
                metrics = self.train_step(batch, self.iteration)
                if self.iteration % log_every == 0:
                    host = metrics_to_host(metrics)
                    host["steps_per_sec"] = log_every / max(time.time() - t0, 1e-9)
                    logger.text(f"step {self.iteration} " + " ".join(f"{k}={v:.4f}" for k, v in host.items()))
                    t0 = time.time()
                if self.iteration % self.iters_per_checkpoint == 0:
                    self.save()
                stop = mesh.agree_any(bool(preempted), self.group)
            if stop:
                what = f"signal {preempted[0]} received" if preempted else "another rank was signalled"
                logger.text(f"{what} - checkpointing at iteration {self.iteration} and exiting")
            if self._last_saved_iteration != self.iteration:
                self.save()  # final / preemption snapshot
            mesh.barrier(self.group)  # the checkpoint is on disk when any rank returns
        finally:
            batches.close()  # stops the loader's threads
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
        return self
