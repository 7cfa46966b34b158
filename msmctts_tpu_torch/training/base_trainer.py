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

Logging goes through ``utils/logger.Logger``: the text log (and stdout)
every ``log_every`` steps, window means of the metrics to its tensorboard
writer where there is one. Every ``eval_interval`` steps (a trainer's
``eval_inteval_iters``; 0 = never) the loop calls ``evaluate(batch, logger,
iteration)`` on the step's batch; a failure there is logged and training
goes on (``msmctts_tpu/training/base_trainer.py:326-331``).

``restore_checkpoint_path`` may be a list ``[[regex, path], ...]``: the
state is then stitched from the parts of those checkpoints whose
'/'-joined paths match each regex, over the fresh init, with no optimizer
state and the iteration left at 0 (``utils/checkpoint.filter_state_by_regex``,
``merge_states``).

``checkpoint_keep_interval: N`` keeps the snapshots every N steps and the
newest two (``utils/checkpoint.clean_checkpoint_directory``), as the JAX
trainer does; ``checkpoint_backend: orbax`` raises when the trainer is built
(ROADMAP A7c), not at the first save.

``train(profile_dir=...)`` takes a ``torch.profiler`` trace of steps
[``profile_start``, ``profile_start + profile_steps``), with the card's
kernels when the run is on one, and writes it as a Chrome trace under
``profile_dir`` (the JAX trainer's ``jax.profiler`` window); a run that stops
inside the window writes what it traced.

``precision: bfloat16`` (``parallel/precision.py``): the optimizers keep
the fp32 masters, and each trainer runs its forward passes on bf16 casts of
them where the JAX trainer casts (``compute_dtype``). The ``model`` axis of
a ``mesh:`` node (tensor parallelism) is not ported.
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
from msmctts_tpu_torch.parallel.precision import compute_dtype
from msmctts_tpu_torch.registry import get_dataset
from msmctts_tpu_torch.training.optim import Optimizer
from msmctts_tpu_torch.utils.checkpoint import (
    filter_state_by_regex,
    find_latest_checkpoint,
    load_checkpoint,
    map_leaves,
    clean_checkpoint_directory,
    merge_states,
    save_checkpoint,
)
from msmctts_tpu_torch.utils.logger import Logger
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


def check_mesh_config(config, world: int):
    """The config's ``mesh: {data: N, model: M}`` node against the run: N
    (-1 or absent = any) is the number of ranks to expect."""
    node = dict(config.get("mesh") or {})
    if int(node.get("model", 1) or 1) > 1:
        raise NotImplementedError("mesh.model > 1 (tensor parallelism) is not ported (ROADMAP A11b)")
    n_data = int(node.get("data", -1) or -1)
    if n_data != -1 and n_data != world:
        raise ValueError(f"the config asks for mesh.data = {n_data} but the run has {world} rank(s)")


class BaseTrainer:
    def __init__(self, config, task, group=None):
        if task.mode != "train":
            raise ValueError("a trainer needs a task built with mode='train'")
        backend = str(config.get("checkpoint_backend", "pickle"))
        if backend == "orbax":
            raise NotImplementedError("checkpoint_backend: orbax is not ported (ROADMAP A7c); the port writes pickles")
        self.config = config
        self.task = task
        self.group = group
        self.rank, self.world = mesh.rank(group), mesh.world(group)
        check_mesh_config(config, self.world)
        self.device = task.device
        # bf16 compute over the fp32 masters the optimizers hold (parallel/precision.py)
        self.compute_dtype = compute_dtype(config)
        self.save_dir = config.get("save_checkpoint_dir", "checkpoints")
        self.training_steps = int(config.get("training_steps", 1_000_000))
        self.iters_per_checkpoint = int(config.get("iters_per_checkpoint", 50_000))
        self.seed = int(config.get("seed", 1234))
        self.iteration = 0
        self.eval_interval = 0  # a trainer's eval_inteval_iters
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

    def evaluate(self, batch: dict, logger: Logger, iteration: int):
        """Periodic qualitative summaries (audio, images) to ``logger``."""

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
        if isinstance(path, (list, tuple)):  # stitching: [[module_regex, path], ...]
            state = self.state_tree()
            for pattern, part_path in path:
                state = merge_states(state, filter_state_by_regex(load_checkpoint(part_path)["state"], pattern))
            self.load_state_tree(state)
        elif path:
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
        keep = self.config.get("checkpoint_keep_interval")
        if keep:
            clean_checkpoint_directory(self.save_dir, int(keep))
        return path

    # ------------------------------------------------------------------ loop
    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        profiler = profile(activities=activities)
        profiler.start()
        return profiler

    def _stop_profiler(self, profiler, profile_dir: str, first: int, logger: Logger):
        """Stop ``profiler`` and write its Chrome trace of steps [first,
        self.iteration] under ``profile_dir``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, f"steps_{first}-{self.iteration}_rank{self.rank}.json")
        profiler.export_chrome_trace(path)
        logger.text(f"profiler trace written to {path}")

    def train(
        self,
        max_steps: Optional[int] = None,
        log_every: int = 50,
        profile_dir: Optional[str] = None,
        profile_start: int = 10,
        profile_steps: int = 5,
    ):
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

        logger = Logger(self.save_dir, rank=self.rank)
        logger.log_config(self.config.to_dict() if hasattr(self.config, "to_dict") else dict(self.config))
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
        profiler = None
        try:
            stop = mesh.agree_any(bool(preempted), self.group)
            while self.iteration < stop_at and not stop:
                self.iteration += 1
                if profile_dir and self.iteration == profile_start:
                    profiler = self._start_profiler()
                batch = to_device(next(batches), self.device)
                metrics = self.train_step(batch, self.iteration)
                if profiler is not None and self.iteration >= profile_start + profile_steps - 1:
                    self._stop_profiler(profiler, profile_dir, profile_start, logger)
                    profiler = None
                if self.iteration % log_every == 0:
                    host = metrics_to_host(metrics)
                    host["steps_per_sec"] = log_every / max(time.time() - t0, 1e-9)
                    logger.log(self.iteration, {"loss": host})
                    logger.text(f"step {self.iteration} " + " ".join(f"{k}={v:.4f}" for k, v in host.items()))
                    t0 = time.time()
                if self.eval_interval and self.iteration % self.eval_interval == 0:
                    try:
                        self.evaluate(batch, logger, self.iteration)
                    except Exception as e:  # evaluation must never stop training
                        logger.text(f"evaluate() failed at {self.iteration}: {e}")
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
            if profiler is not None:  # the run stopped inside the window
                self._stop_profiler(profiler, profile_dir, profile_start, logger)
            batches.close()  # stops the loader's threads
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
            logger.close()
        return self
