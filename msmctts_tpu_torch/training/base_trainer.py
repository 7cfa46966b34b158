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

One GPU, fp32; no mesh, profiler hook, multi-host or periodic evaluation
summaries yet.
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
from msmctts_tpu_torch.registry import get_dataset
from msmctts_tpu_torch.training.optim import Optimizer
from msmctts_tpu_torch.utils.checkpoint import find_latest_checkpoint, load_checkpoint, map_leaves, save_checkpoint
from msmctts_tpu_torch.weights import init_random


def build_dataset_from_config(config, training: bool = True):
    node = dict(config.dataset)
    name = node.pop("_name")
    kwargs = component_kwargs(node)
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
    """Appends time-stamped lines to ``train_rank0_<stamp>.log`` in the save
    dir and echoes them to stdout."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"train_rank0_{time.strftime('%Y%m%d-%H%M%S')}.log")

    def text(self, message: str):
        line = f"[{time.strftime('%H:%M:%S')}] {message}"
        with open(self.path, "a") as f:
            f.write(line + "\n")
        print(line, flush=True)


class BaseTrainer:
    def __init__(self, config, task):
        if task.mode != "train":
            raise ValueError("a trainer needs a task built with mode='train'")
        precision = str(config.get("precision", "float32")).lower()
        if precision not in ("fp32", "float32"):
            raise NotImplementedError(f"precision '{precision}' is not ported (fp32 only)")
        self.config = config
        self.task = task
        self.device = task.device
        self.save_dir = config.get("save_checkpoint_dir", "checkpoints")
        self.training_steps = int(config.get("training_steps", 1_000_000))
        self.iters_per_checkpoint = int(config.get("iters_per_checkpoint", 50_000))
        self.seed = int(config.get("seed", 1234))
        self.iteration = 0
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.optimizers: Dict[str, Optimizer] = {}
        for module in task.networks.values():
            bind_generator(module, self.generator)

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

    def save(self) -> str:
        self._last_saved_iteration = self.iteration
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
        dataset = build_dataset_from_config(self.config, training=True)
        loader = DataLoader(
            dataset,
            batch_size=int(dl_cfg.get("batch_size", 16)),
            shuffle=True,
            num_workers=int(dl_cfg.get("num_workers", 4)),
            seed=self.seed,
        )
        batches = iter(loader)
        self.attempt_resume()

        logger = TextLogger(self.save_dir)
        stop_at = min(
            self.training_steps,
            self.iteration + max_steps if max_steps is not None else self.training_steps,
        )

        # SIGTERM/SIGINT set a flag; the loop finishes the step in flight,
        # saves a resumable checkpoint and returns.
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
            while self.iteration < stop_at and not preempted:
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
            if preempted:
                logger.text(f"signal {preempted[0]} received - checkpointing at iteration {self.iteration} and exiting")
            if self._last_saved_iteration != self.iteration:
                self.save()  # final / preemption snapshot
        finally:
            batches.close()  # stops the loader's threads
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
        return self
