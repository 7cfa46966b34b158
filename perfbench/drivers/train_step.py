"""Back-to-back GAN-phase train steps of the autoencoder recipe.

Set-up builds the program's trainer (``registry.get_trainer``) over the
seeded weights (``perfbench/weights.py``), notes its known state (each
optimizer's state before any update, the generator's state), draws the
mix's pool of distinct batches on the device from the seed, each padded to
its frame bucket as the loader pads it (mel -4, wav 0), with each
utterance's window start, and runs the first ``checked_steps`` steps on the
first batches: they warm every shape. The window then runs
``trainer.train_step`` on the pool's batches in turn, the same trainer
object, until ``--seconds`` have passed, and ends with a ``synchronize``.

After the window the same warm trainer is put back into the known state
(the seeded weights and codebooks loaded, each optimizer's state and the
generator's restored) and runs the checked steps again through the same
call. Both runs of the checked steps, the set-up's and the one after the
window, are what the plain reference follows: each step's losses, the norm
of each leaf's first gradient as the optimizer got it (its first moment
after one step over ``1 - beta1``), and each leaf's change after the last
checked step, codebook buffers included. Dropout draws from the
trainer's generator, so both runs draw the masks the reference draws.
"""

from __future__ import annotations

import copy
import gc
import time
from typing import List

import numpy as np
import torch

from perfbench import weights
from perfbench.core import untraced_rest
from perfbench.reference.judge_train import norms, on_host
from perfbench.trace import Ranges, Tracer

IDLE_LABEL = "between steps"


def build(cell):
    from msmctts_tpu_torch.config import Config, component_kwargs
    from msmctts_tpu_torch.registry import get_trainer
    from msmctts_tpu_torch.tasks import build_task

    cfg = Config(cell.config["program"])
    task = build_task(cfg, device=cell.device, mode="train")
    trainer = get_trainer(cfg.trainer["_name"])(cfg, task, **component_kwargs(cfg.trainer))
    spec = weights.spec_of(task.networks)
    W = weights.make(spec, cell.config["weight_seed"], cell.device, cell.config.get("overrides"))
    weights.load(task.networks, W)
    return trainer, task, spec, W


def batches(seed: int, mix: dict, program: dict, device) -> List[dict]:
    """The pool: batch b holds one length from each of ``batch_size`` equal
    strata of [min_frames, max_frames], so every seed gets the same lengths
    and every batch the same frame bucket; rows, strata and window starts
    are shuffled and drawn by the seed."""
    B, P = mix["batch_size"], mix["pool"]
    lo, hi = mix["min_frames"], mix["max_frames"]
    ds = program["dataset"]
    n_mel = ds["dimension"][ds["feature"].index("mel")]
    shift = ds["frameshift"][ds["feature"].index("mel")]
    pad_mel = ds["padding_value"][ds["feature"].index("mel")]
    frames = int(program["trainer"]["sample_lengths"]) // shift
    rng = np.random.default_rng(int(seed))
    grid = lo + ((np.arange(B * P) + 0.5) * (hi - lo + 1) / (B * P)).astype(np.int64)  # stratum s: s*P .. s*P+P-1
    which = np.stack([rng.permutation(P) for _ in range(B)])  # [B strata, P batches]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pool = []
    for b in range(P):
        lengths = rng.permutation(grid[np.arange(B) * P + which[:, b]])
        T = next(x for x in mix["frame_buckets"] if x >= lengths.max())
        starts = np.floor(rng.random(B) * np.maximum(lengths - frames, 1)).astype(np.int64)
        n = torch.as_tensor(lengths, device=device)
        valid = torch.arange(T, device=device)[None] < n[:, None]
        mel = torch.where(valid[..., None], torch.randn((B, T, n_mel), generator=gen, device=device) * 0.5,
                          torch.full((), float(pad_mel), device=device))
        wav = torch.randn((B, T * shift), generator=gen, device=device) * 0.1 * valid.repeat_interleave(shift, 1)
        pool.append({"mel": mel, "mel_length": n, "wav": wav, "starts": torch.as_tensor(starts, device=device)})
    return pool


def _known_state(trainer) -> tuple:
    """What the checked steps start from besides the seeded weights: each
    optimizer's state before its first update, and the generator's."""
    return ({name: copy.deepcopy(opt.state_dict()) for name, opt in trainer.optimizers.items()},
            trainer.generator.get_state())


def _restore(trainer, task, W0, known) -> None:
    """Put the trainer back into the known state, in place."""
    weights.load(task.networks, W0)
    opts, rng = known
    for name, opt in trainer.optimizers.items():
        opt.load_state_dict(copy.deepcopy(opts[name]))
    trainer.generator.set_state(rng)


def _checked(trainer, task, spec, W0, step, n: int) -> dict:
    """Steps 1..n from the known state: each step's losses, each leaf's
    first-gradient norm after step 1 and its change after step n (on the
    host, for the judge's element-wise rule)."""
    losses, first_grad = [], {}
    for i in range(1, n + 1):
        m = step(i)
        losses.append({k: float(m[k]) for k in ("g_loss", "d_loss")})
        if i == 1:
            for group, opt in trainer.optimizers.items():
                beta1 = opt.opt.param_groups[0]["betas"][0]
                for name, p in task.networks[group].named_parameters():
                    st = opt.opt.state.get(p, {})
                    if "exp_avg" in st:
                        first_grad[f"{group}.{name}"] = st["exp_avg"] / (1.0 - beta1)
            first_grad = norms(first_grad)
    state = {f"{g}.{k}": v for g, mod in task.networks.items() for k, v in mod.state_dict().items()}
    change = on_host({k: state[k] - W0[k] for k, _ in spec})
    return {"losses": losses, "first_grad": first_grad, "change": change}


def _mark_phases(trainer, ranges: Ranges) -> None:
    """Ranges inside a step for the trace: each forward of the autoencoder
    and of the discriminator (forward hooks), each optimizer update, each
    codebook statistics call (``models/quantizer.py`` looks
    ``vq_nearest_stats_sharded`` up in its module at each call); the rest of
    a step is its losses and backwards."""
    from msmctts_tpu_torch.models import quantizer

    for name, module in trainer.task.networks.items():
        ranges.module(module, name)
    for opt in trainer.optimizers.values():
        ranges.around(opt, "step", "optimizer")
    ranges.around(quantizer, "vq_nearest_stats_sharded", "vq_stats")


def run(cell) -> dict:
    mix, cfg = cell.mix, cell.config
    program = cfg["program"]
    trainer, task, spec, W0 = build(cell)
    known = _known_state(trainer)
    pool = batches(cell.seed, mix, program, cell.device)
    sync = torch.cuda.synchronize if cell.device.type == "cuda" else (lambda: None)

    def step(i: int):
        b = pool[(i - 1) % len(pool)]
        return trainer.train_step({k: b[k] for k in ("mel", "mel_length", "wav")}, i, starts=b["starts"])

    n_checked = mix["checked_steps"]
    sides = [_checked(trainer, task, spec, W0, step, n_checked)]
    del W0
    gc.collect()

    tracer = Tracer(cell.device.type == "cuda") if cell.trace else None
    ranges = Ranges()
    spans: List[tuple] = []
    if tracer is not None:
        _mark_phases(trainer, ranges)
        tracer.prime()
        tracer.start()
        ranges.active = True
    sync()
    start_at = time.perf_counter()
    setup_s = start_at - cell.t_start
    end_at = start_at + cell.seconds
    trace_end = resume = None
    i, n = n_checked, 0
    while time.perf_counter() < end_at:
        i += 1
        t0 = time.perf_counter()
        ranges.enter("step")
        step(i)
        ranges.exit()
        spans.append((t0, time.perf_counter(), i))
        n += 1
        if ranges.active and time.perf_counter() >= start_at + mix["trace_seconds"]:
            sync()
            trace_end = time.perf_counter()
            ranges.active = False
            tracer.stop()
            resume = time.perf_counter()
    sync()
    window_end = time.perf_counter()
    if ranges.active:
        trace_end = window_end
        ranges.active = False
        tracer.stop()
    ranges.close()
    memory_peak = torch.cuda.max_memory_allocated() if cell.device.type == "cuda" else 0
    e2e = {"step_ms": (window_end - start_at) / max(n, 1) * 1e3, "setup_s": setup_s}

    # the checked steps again, on the warm trainer that ran the window
    W0 = weights.make(spec, cfg["weight_seed"], cell.device, cfg.get("overrides"))
    _restore(trainer, task, W0, known)
    sides.append(_checked(trainer, task, spec, W0, step, n_checked))

    shapes = [(int(b["mel"].shape[0]), int(b["mel"].shape[1]), b["mel_length"].tolist()) for b in pool]
    record = {"program": program, "spans": spans, "window": (start_at, trace_end or window_end),
              "untraced": untraced_rest(resume, window_end),
              "trace": tracer.trace if tracer is not None else None, "idle_label": IDLE_LABEL, "call_range": "step",
              "shapes": shapes, "pool": len(pool)}
    checked = pool[:n_checked]
    del trainer, task, pool, W0
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()

    from perfbench.reference.judge_train import judge

    readings = judge(spec, cfg, cell.device, checked, sides)
    checks = {k: (v, cell.workload["limits"][k]) for k, v in readings.items()}
    return {"e2e": e2e, "record": record, "checks": checks, "attempted": n, "failed": 0,
            "memory_peak_bytes": memory_peak,
            "judged": {"spec": spec, "checked": checked, "program": sides}}
