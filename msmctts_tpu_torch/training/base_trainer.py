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
trainer does. ``checkpoint_backend: orbax`` writes each checkpoint as an
orbax snapshot directory, its ``state/`` on a writer thread while training
goes on (``utils/checkpoint.save_checkpoint_orbax``); the loop's ``finally``
waits for it. A snapshot resumes into the optimizers as orbax's layout
gives it back: ``load`` turns the state's string keys back into parameter
indices and ``betas`` back into a tuple.

The feed (``data/wire.py``): a ``DevicePrefetcher`` encodes each batch in
the wire format of ``dataloader.wire_compression`` (default true: int16
waveforms) and copies it to the device on a stream of its own,
``dataloader.device_prefetch`` batches (default 2) ahead of the step, as the
JAX trainer's loop does (``msmctts_tpu/training/base_trainer.py:246-257``);
the train steps decode it first, and ``evaluate()`` gets it decoded.

``train(profile_dir=...)`` takes a ``torch.profiler`` trace of steps
[``profile_start``, ``profile_start + profile_steps``), with the card's
kernels when the run is on one, and writes it as a Chrome trace under
``profile_dir`` (the JAX trainer's ``jax.profiler`` window); a run that stops
inside the window writes what it traced.

``precision: bfloat16`` (``parallel/precision.py``): the optimizers keep
the fp32 masters, and each trainer runs its forward passes on bf16 casts of
them where the JAX trainer casts (``compute_dtype``).

Tensor parallelism (``mesh: {data: N, model: M}`` with M > 1; the JAX
trainer's ``model`` mesh axis, ``parallel/sharding.py``): the run's W ranks
must be N x M (N -1: W / M). ``self.group`` is then the ``data`` group:
everything that handles rows (the loader's shard, loss shares, the codebook
statistics, global-batch draws, the gradient sum) runs over it, and
``self.rank`` / ``self.world`` are the data rank and size; ``self.tp`` is
the ``model`` group, ``self.world_group`` the whole run, which agrees on
signals, meets at barriers and saves (global rank 0). The trainable
networks are split after the resume ladder (:meth:`shard`, also at a
step's start) by the JAX package's rules; a checkpoint is gathered first
(:meth:`full_state`) and is the JAX layout, which one rank and the JAX
package load; a resume gathers, loads and splits again. ``evaluate()``
runs on the gathered weights.
"""

from __future__ import annotations

import contextlib
import os
import signal
import time
from typing import Dict, Optional

import numpy as np
import torch

from msmctts_tpu_torch.config import component_kwargs
from msmctts_tpu_torch.data.loader import DataLoader
from msmctts_tpu_torch.data.wire import DevicePrefetcher, decode_batch
from msmctts_tpu_torch.ops.dropout import bind_generator
from msmctts_tpu_torch.parallel import mesh, sharding
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
    save_checkpoint_orbax,
    wait_for_pending_saves,
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
    """The config's ``mesh: {data: N, model: M}`` node against the run's
    ``world`` ranks -> (N, M): N (-1 or absent = the rest) x M must be the
    world."""
    node = dict(config.get("mesh") or {})
    n_model = int(node.get("model", 1) or 1)
    n_data = int(node.get("data", -1) or -1)
    if n_model == 1 and n_data != -1 and n_data != world:
        raise ValueError(f"the config asks for mesh.data = {n_data} but the run has {world} rank(s)")
    if n_data == -1:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"the config's mesh data {n_data} x model {n_model} needs {n_data * n_model} ranks; "
                         f"the run has {world}")
    return n_data, n_model


def _torch_optimizer_state(state: dict) -> dict:
    """A port ``Optimizer.state_dict()`` as a checkpoint gives it back, in
    the types torch's ``load_state_dict`` needs: an orbax snapshot returns
    the per-parameter state under string keys (torch would keep them apart
    from the parameters, and the moments would start cold) and ``betas`` as
    a list."""
    opt = dict(state["opt"])
    opt["state"] = {int(k): v for k, v in opt["state"].items()}
    opt["param_groups"] = [
        {k: tuple(v) if k == "betas" else v for k, v in group.items()} for group in opt["param_groups"]
    ]
    return {**state, "opt": opt}


class BaseTrainer:
    def __init__(self, config, task, group=None):
        if task.mode != "train":
            raise ValueError("a trainer needs a task built with mode='train'")
        self.checkpoint_backend = str(config.get("checkpoint_backend", "pickle"))
        if self.checkpoint_backend not in ("pickle", "orbax"):
            raise ValueError(f"checkpoint_backend {self.checkpoint_backend!r}: pickle or orbax")
        self.config = config
        self.task = task
        self.world_group = group
        self.global_rank = mesh.rank(group)
        n_data, n_model = check_mesh_config(config, mesh.world(group))
        self.tp = None  # the model group of tensor parallelism
        self._plan = None  # what shard() splits (parallel/sharding.Plan), made at its first call
        if n_model > 1:
            group, self.tp = sharding.make_group_2d(group, n_data, n_model)
        self.group = group  # the data group: rows
        self.rank, self.world = mesh.rank(group), mesh.world(group)
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

    def global_metrics(self, metrics: dict, shared) -> dict:
        """The step's metrics as every rank reports them: the ``shared`` ones
        (loss shares) summed over the data group; under tensor parallelism
        all of them model rank 0's (a card does not reproduce a replicated
        forward bit for bit in another process)."""
        if mesh.world(self.group) > 1:
            total = mesh.all_reduce_sum(torch.stack([metrics[k].float().reshape(()) for k in shared]), self.group)
            metrics.update(zip(shared, total.unbind()))
        if self.tp is not None:
            names = sorted(metrics)
            values = mesh.broadcast(torch.stack([metrics[k].float().reshape(()) for k in names]), self.tp)
            metrics.update(zip(names, values.unbind()))
        return metrics

    # ------------------------------------------------------ tensor parallelism
    def _trainable(self):
        """The networks an optimizer steps: the ones split."""
        stepped = {id(p) for opt in self.optimizers.values() for p in opt.params}
        return [m for m in self.task.networks.values() if any(id(p) in stepped for p in m.parameters())]

    def shard(self):
        """Keep this rank's shard of the trainable networks and their
        moments (no-op without a model group, or when split already)."""
        if self.tp is None or getattr(self, "_sharded", False):
            return
        if self._plan is None:
            self._plan = sharding.make_plan(self._trainable(), self.state_tree, self.tp.world)
        sharding.split_(self._plan, self.tp, self.optimizers.values())
        self._sharded = True

    def unshard(self):
        """Gather the split parameters and moments whole on every rank."""
        if getattr(self, "_sharded", False):
            sharding.gather_(self._plan, self.tp, self.optimizers.values())
            self._sharded = False

    @contextlib.contextmanager
    def full_state(self):
        """The whole state on every rank for the block (every rank enters
        it), split again after."""
        was = getattr(self, "_sharded", False)
        self.unshard()
        try:
            yield
        finally:
            if was:
                self.shard()

    # ----------------------------------------------------------------- state
    def init_state(self):
        """Fresh seeded weights for every trainable network
        (``weights.init_random``; no init batch, no EMA update)."""
        for i, name in enumerate(sorted(self.task.networks)):
            init_random(self.task.networks[name], self.seed + i)
            self.task.networks[name].train()

    def attempt_resume(self):
        """The resume ladder of the JAX package's trainer (on the whole
        state; :meth:`shard` splits it after)."""
        self.unshard()
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
        mesh.replicate_state(self.task.networks.values(), self.world_group)

    def load(self, path: str):
        self.unshard()
        ckpt = load_checkpoint(path)
        state = ckpt["state"]
        self.load_state_tree(state)
        self.iteration = int(ckpt["iteration"])
        if "torch_opt_state" in state:
            as_tensor = lambda x: torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) else x
            for name, opt in self.optimizers.items():
                opt.load_state_dict(_torch_optimizer_state(map_leaves(state["torch_opt_state"][name], as_tensor)))
            self.generator.set_state(torch.from_numpy(np.asarray(state["torch_rng"], np.uint8)))
        else:
            self.restart_optimizer_counts(self.iteration)

    def checkpoint_state(self) -> dict:
        """What a checkpoint stores: the model state as the JAX package's
        tree, the optimizers' state dicts and the generator's state."""
        state = self.state_tree()
        as_numpy = lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x
        state["torch_opt_state"] = {n: map_leaves(o.state_dict(), as_numpy) for n, o in self.optimizers.items()}
        state["torch_rng"] = self.generator.get_state().cpu().numpy()
        return state

    def save(self) -> Optional[str]:
        """Write ``model_<iteration>``; under a group rank 0 alone does (the
        state is replicated; split parameters are gathered by every rank
        first)."""
        self._last_saved_iteration = self.iteration
        with self.full_state():
            return self._save() if self.global_rank == 0 else None

    def _save(self) -> str:
        path = os.path.join(self.save_dir, f"model_{self.iteration}")
        state = self.checkpoint_state()
        cfg = self.config.to_dict() if hasattr(self.config, "to_dict") else dict(self.config)
        if self.checkpoint_backend == "orbax":  # state/ is written on the writer thread
            path = save_checkpoint_orbax(path, state, self.iteration, cfg)
        else:
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
        path = os.path.join(profile_dir, f"steps_{first}-{self.iteration}_rank{self.global_rank}.json")
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
        self.shard()
        # A worker thread wire-encodes each batch (int16 PCM; data/wire.py)
        # and copies it to the device on its own stream while the step
        # before it runs; the steps decode it (decode_batch) first.
        feed = DevicePrefetcher(
            batches,
            self.device,
            mode=dl_cfg.get("wire_compression", True),
            depth=int(dl_cfg.get("device_prefetch", 2)),
        )

        logger = Logger(self.save_dir, rank=self.global_rank)
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
            stop = mesh.agree_any(bool(preempted), self.world_group)
            while self.iteration < stop_at and not stop:
                self.iteration += 1
                if profile_dir and self.iteration == profile_start:
                    profiler = self._start_profiler()
                batch = next(feed)  # encoded and uploaded in the background
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
                    with self.full_state():  # eval() folds whole weights only
                        try:
                            self.evaluate(decode_batch(batch), logger, self.iteration)
                        except Exception as e:  # evaluation must never stop training
                            logger.text(f"evaluate() failed at {self.iteration}: {e}")
                if self.iteration % self.iters_per_checkpoint == 0:
                    self.save()
                stop = mesh.agree_any(bool(preempted), self.world_group)
            if stop:
                what = f"signal {preempted[0]} received" if preempted else "another rank was signalled"
                logger.text(f"{what} - checkpointing at iteration {self.iteration} and exiting")
            if self._last_saved_iteration != self.iteration:
                self.save()  # final / preemption snapshot
            mesh.barrier(self.world_group)  # the checkpoint is on disk when any rank returns
        finally:
            if profiler is not None:  # the run stopped inside the window
                self._stop_profiler(profiler, profile_dir, profile_start, logger)
            feed.close()
            batches.close()  # stops the loader's threads
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
            wait_for_pending_saves()  # the last snapshot is on disk, or its error raised
            logger.close()
        return self
