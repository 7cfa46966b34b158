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
"""

from __future__ import annotations

import math
import re
from typing import Iterable, Optional, Tuple

import torch


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


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all tensors, from one multi-tensor pass."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))


class Optimizer:
    """One module's optimizer: clip -> ``torch.optim`` step at the scheduled
    rate -> frozen parameters untouched. ``count`` is the number of updates
    made, the schedule's argument."""

    def __init__(self, named_params, opt, schedule, grad_clip: Optional[float], freeze_patterns):
        self.opt = opt
        self.schedule = schedule
        self.grad_clip = float(grad_clip) if grad_clip is not None and grad_clip > 0 else None
        self.count = 0
        self.params = [p for _, p in named_params]
        regexes = [re.compile(p) for p in (freeze_patterns or [])]
        # patterns are written for '/'-joined paths; a torch name matches with
        # its dots read as slashes
        self.frozen = [p for n, p in named_params if any(r.search(n.replace(".", "/")) for r in regexes)]

    @torch.no_grad()
    def step(self):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.grad_clip is not None and grads:
            norm = global_norm(grads)
            scale = self.grad_clip / torch.clamp(norm, min=self.grad_clip)
            torch._foreach_mul_(grads, scale)
        for p in self.frozen:
            p.grad = None  # torch.optim skips a parameter without a gradient
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1

    def zero_grad(self):
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {"count": self.count, "opt": self.opt.state_dict()}

    def load_state_dict(self, state: dict):
        self.count = int(state["count"])
        self.opt.load_state_dict(state["opt"])


def build_optimizer(named_params: Iterable[Tuple[str, torch.nn.Parameter]], opt_cfg: dict,
                    lr_cfg: Optional[dict], grad_clip: Optional[float] = None,
                    freeze_patterns=None) -> Optimizer:
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
    return Optimizer(named_params, opt, make_lr_schedule(lr, lr_cfg), grad_clip, freeze_patterns)


def optimizer_config_for(config: dict, module_name: str) -> dict:
    """``optimizer.<name>`` with ``optimizer._default`` fallback."""
    opt = config.get("optimizer", {}) or {}
    return dict(opt.get(module_name, opt.get("_default", {"_name": "Adam"})))
