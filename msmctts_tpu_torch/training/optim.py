"""Per-module optimizers and LR schedules (counterpart of
``msmctts_tpu/training/optim.py:20-101``, on ``torch.optim``).

Each sub-module of the task gets one :class:`Optimizer`: a ``torch.optim``
optimizer with the shared multiplicative schedule applied before every
step, optional global-norm clipping in front of it and optional freezing of
regex-matched parameters behind it. Three details follow optax, which the
JAX package uses, so that both stacks move the same weights the same way:

  * the schedule counts from 0: the first update runs at ``schedule(0)``;
  * clipping scales every gradient by ``clip / max(norm, clip)``
    (``optax.clip_by_global_norm``), not by ``clip / (norm + 1e-6)`` as
    ``torch.nn.utils.clip_grad_norm_`` does;
  * the norm is taken over every gradient, frozen parameters included, and
    a frozen parameter then gets no update at all;
  * a parameter that the step's graph did not reach (the waveform decoder
    during warmup) has a zero gradient, not none: its moments and its step
    count move on, and decoupled weight decay still applies to it.
    ``torch.optim`` alone would skip it and start its bias correction late.

Under data parallelism (``group``) every rank's loss is its share of the
global loss, so the global gradient is the sum of the ranks' gradients:
``step`` adds them with one ``all_reduce`` over one flat buffer, after the
zero fill (every rank then reduces the same tensors) and before the clip
(the norm is the global one, equal on all ranks, as optax's is). It is done
by hand, not with ``DistributedDataParallel``: the GAN step runs two
backwards, toggles ``requires_grad`` on the discriminator and leaves the
waveform decoder without a gradient during warmup.

Under tensor parallelism ``group`` is the ``data`` group (the gradients are
summed over it only) and ``tp`` the ``model`` group, set while the
parameters are split (``parallel/sharding.split_``): the replicated
leaves' gradients are model rank 0's on every model rank (one broadcast;
they are equal in exact arithmetic, but a card's backward is not
bit-reproducible, and the replicated state must stay bit-equal), and the
clip's global norm sums the squares of the split leaves over ``tp`` and
counts the replicated ones once, so it is one rank's norm.
"""

from __future__ import annotations

import math
import re
from typing import Iterable, Optional, Tuple

import torch

from msmctts_tpu_torch.parallel.mesh import all_reduce_sum, broadcast, world


def make_lr_schedule(base_lr: float, cfg: Optional[dict]):
    """ExponentialDecayLRScheduler semantics: scale 1 until warmup_steps,
    then decay_learning_rate^((step - warmup)/decay_scale), floored at
    final_learning_rate. ``step`` counts updates made so far."""
    if cfg and cfg.get("_name") not in (None, "ExponentialDecayLRScheduler"):
        raise ValueError(f"unknown lr scheduler {cfg.get('_name')}")
    cfg = cfg or {}
    warmup = float(cfg.get("warmup_steps", 0))
    decay_scale = float(cfg.get("decay_scale", 1))
    decay_lr = float(cfg.get("decay_learning_rate", 1.0))
    final_lr = float(cfg.get("final_learning_rate", 0.0))

    def schedule(step) -> float:
        step = float(step)
        scale = 1.0 if step < warmup else math.pow(decay_lr, (step - warmup) / decay_scale)
        return max(base_lr * scale, final_lr)

    return schedule


def _over(grads, collective):
    """Run ``collective`` on one flat buffer of ``grads`` and copy it back."""
    flat = collective(torch.cat([g.reshape(-1) for g in grads]))
    torch._foreach_copy_(grads, [c.view_as(g) for c, g in zip(flat.split([g.numel() for g in grads]), grads)])


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all tensors, from one multi-tensor pass."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))


class Optimizer:
    """One module's optimizer: clip -> ``torch.optim`` step at the scheduled
    rate -> frozen parameters untouched. ``count`` is the number of updates
    made, the schedule's argument."""

    def __init__(self, named_params, opt, schedule, grad_clip: Optional[float], freeze_patterns, group=None):
        self.opt = opt
        self.group = group
        self.tp = None  # the model group while the parameters are split
        self.schedule = schedule
        self.grad_clip = float(grad_clip) if grad_clip is not None and grad_clip > 0 else None
        self.count = 0
        self.params = [p for _, p in named_params]
        regexes = [re.compile(p) for p in (freeze_patterns or [])]
        # patterns are written for '/'-joined paths; a torch name matches with
        # its dots read as slashes
        self.frozen = [p for n, p in named_params if any(r.search(n.replace(".", "/")) for r in regexes)]

    @torch.no_grad()
    def step(self) -> Optional[torch.Tensor]:
        """One update; returns the global norm of the (summed) gradients
        before the clip (optax's ``global_norm`` of the gradient tree)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if world(self.group) > 1 and grads:
            _over(grads, lambda flat: all_reduce_sum(flat, self.group))
        if world(self.tp) > 1:
            # the replicated leaves' gradients are one value in exact arithmetic on every model rank,
            # but the card's backward (atomics in weight gradients) differs run to run: model rank 0's
            whole = [g for p, g in zip(self.params, grads) if getattr(p, "tp_dim", None) is None]
            if whole:
                _over(whole, lambda flat: broadcast(flat, self.tp))
        norm = self._norm(grads) if grads else None
        if self.grad_clip is not None and grads:
            scale = self.grad_clip / torch.clamp(norm, min=self.grad_clip)
            torch._foreach_mul_(grads, scale)
        for p in self.frozen:
            p.grad = None  # torch.optim skips a parameter without a gradient
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1
        return norm

    def _norm(self, grads) -> torch.Tensor:
        split = [g for p, g in zip(self.params, grads) if getattr(p, "tp_dim", None) is not None]
        if world(self.tp) == 1 or not split:
            return global_norm(grads)
        whole = [g for p, g in zip(self.params, grads) if getattr(p, "tp_dim", None) is None]
        squares = lambda gs: torch.square(global_norm(gs)) if gs else grads[0].new_zeros(())
        return torch.sqrt(squares(whole) + all_reduce_sum(squares(split).reshape(1), self.tp)[0])

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {"count": self.count, "opt": self.opt.state_dict()}

    def load_state_dict(self, state: dict):
        self.count = int(state["count"])
        self.opt.load_state_dict(state["opt"])


def build_optimizer(named_params: Iterable[Tuple[str, torch.nn.Parameter]], opt_cfg: dict,
                    lr_cfg: Optional[dict], grad_clip: Optional[float] = None,
                    freeze_patterns=None, group=None) -> Optimizer:
    """One :class:`Optimizer` from an ``optimizer.<module>`` config node.
    Supported ``_name``: Adam (weight decay as an L2 term on the gradient),
    AdamW (decoupled decay), RAdam."""
    named_params = list(named_params)
    params = [p for _, p in named_params]
    name = opt_cfg.get("_name", "Adam")
    lr = float(opt_cfg.get("learning_rate", 2e-4))
    betas = tuple(float(b) for b in opt_cfg.get("betas", [0.9, 0.999]))
    eps = float(opt_cfg.get("eps", 1e-8))
    wd = float(opt_cfg.get("weight_decay", 0.0))
    if name == "Adam":
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=eps, weight_decay=wd)
    elif name == "AdamW":
        opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=eps, weight_decay=wd)
    elif name == "RAdam":
        opt = torch.optim.RAdam(params, lr=lr, betas=betas, eps=eps, weight_decay=wd)
    else:
        raise ValueError(f"unknown optimizer '{name}'")
    return Optimizer(named_params, opt, make_lr_schedule(lr, lr_cfg), grad_clip, freeze_patterns, group)


def optimizer_config_for(config: dict, module_name: str) -> dict:
    """``optimizer.<name>`` with ``optimizer._default`` fallback."""
    opt = config.get("optimizer", {}) or {}
    return dict(opt.get(module_name, opt.get("_default", {"_name": "Adam"})))
