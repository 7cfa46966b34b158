"""MSMC-VQ-GAN trainer (counterpart of
``msmctts_tpu/training/vqgan_trainer.py``): warmup phase and GAN phase of
the autoencoder's train step.

  * warmup (iteration <= warmup_steps): autoencoder forward without the
    waveform decoder; loss = lambda_vq * commitment + lambda_pr * prior +
    lambda_frame * masked mel MSE.
  * GAN phase: per-utterance random windows of ``sample_lengths`` samples;
    the loss adds lambda_stft * (mel | multi-resolution STFT), LSGAN
    adversarial and feature-matching terms. The discriminator is updated
    first, on (fake.detach(), real); the generator loss is then evaluated
    against the *updated* discriminator with a fresh pass over fake and real.
  * ``lambda_fm: auto`` scales feature matching to the current generator
    loss (detached).

The autoencoder's forward runs once per step. Its graph is kept for the
generator's backward: the discriminator's update sees only the detached
fake. In that one forward each quantizer stage launches the statistics
kernel once (``ops/vq.vq_nearest_stats_sharded``) and moves its codebook EMA. While
the generator loss is evaluated the discriminator's parameters need no
gradient and are frozen, so its backward computes input gradients only.

At iteration == warmup_steps the step still runs the warmup graph, as the
JAX package does.

``evaluate`` (every ``eval_inteval_iters`` steps, where the logger has a
writer): the analysis-synthesis of the step batch's first row through the
autoencoder in ``eval()`` (the card's VQ and MRF kernels), its waveform and
its predicted mel as a [0, 1] image.

Data-parallel (``group``, see ``training/base_trainer.py``): the batch a
step gets is this rank's block of the global batch. Every loss term is the
rank's share of the global term (``training/losses.py``), each optimizer
sums the gradients over ranks before it clips, the quantizers sum their
statistics, window starts and dropout masks are drawn for the global batch,
and ``lambda_fm: auto`` uses the global losses. The metrics returned are the
global values, equal on every rank. Per step that is one all-reduce per
quantizer stage, one per optimizer, one of the metrics and one per masked
denominator.

CUDA graphs (``utils/graphs.py``): on a card, a GAN step runs the calls of
the autoencoder and the discriminator (the autoencoder's forward, the
discriminator's two passes of the update and its two with frozen
parameters, and their backwards) as graphs, per input shape (rows, frame
bucket, window). A shape's first step runs eagerly on the capture's side
stream, which warms it; its second is captured as it runs, in a
``train.capture`` span; the later ones replay. The losses, the codebook
statistics with their EMA update and the optimizers stay eager. The graphs
of the :data:`GRAPHED_SHAPES` shapes captured last stay live, in one
memory pool. A step runs eagerly without fp32, under a model group (its
split convs run collectives inside the forward), over a group whose
backend is not NCCL (gloo's collectives run on the host), in the warmup
phase and where a hook sits on a module inside the networks (a replay
would skip its Python); a change of the dropouts' generator or shard
drops the shape's graphs. ``train.step`` says which ran (``graphed``).

Under ``precision: bfloat16`` (``parallel/precision.py``) the autoencoder's
forward runs on bf16 casts of its parameters and of ``mel``, and both
discriminator passes on bf16 casts of the discriminator's parameters and of
the target window (``msmctts_tpu/training/vqgan_trainer.py:198-199,340-371``);
the losses read the fp32 ``mel`` and target, and the optimizers update the
fp32 masters. ``evaluate`` runs the fp32 masters, as the JAX trainer's does.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Optional

import torch

from msmctts_tpu_torch.data.wire import decode_batch
from msmctts_tpu_torch.models.msmc_vqgan import crop_windows
from msmctts_tpu_torch.ops.dropout import Dropout
from msmctts_tpu_torch.parallel.mesh import all_reduce_sum
from msmctts_tpu_torch.parallel.precision import cast_floats, functional
from msmctts_tpu_torch.registry import register_trainer
from msmctts_tpu_torch.training.base_trainer import BaseTrainer
from msmctts_tpu_torch.training.losses import (
    feature_matching_loss,
    frame_loss,
    lsgan_d_loss,
    lsgan_g_loss,
    mel_loss,
    multi_resolution_stft_loss,
    paired_disc_apply,
    quantizer_loss,
)
from msmctts_tpu_torch.training.optim import build_optimizer, optimizer_config_for
from msmctts_tpu_torch.utils import graphs
from msmctts_tpu_torch.utils.tracing import span
from msmctts_tpu_torch.weights import train_state_from_jax, train_state_to_jax


GRAPHED_SHAPES = 4  # input shapes whose step graphs stay live, the most recently used


@contextlib.contextmanager
def _no_param_grads(module):
    """Within the block the module's parameters take no gradient; gradients
    still flow through it to its inputs."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


@register_trainer("VQGANTrainer")
class VQGANTrainer(BaseTrainer):
    def __init__(
        self,
        config,
        task,
        group=None,
        warmup_steps: int = 0,
        lambda_frame: float = 1.0,
        eval_inteval_iters: int = 1000,  # the reference's spelling, kept for YAML parity
        grad_clip_thresh: float = 1.0,
        sample_lengths: int = 24000,
        lambda_vq: float = 1.0,
        lambda_pr: float = 1.0,
        lambda_fm=2.0,
        lambda_stft: float = 45.0,
        stft_loss_func: str = "mel_loss",
        stft_loss_config: Optional[dict] = None,
    ):
        super().__init__(config, task, group)
        self.warmup_steps = int(warmup_steps)
        self.lambda_frame = lambda_frame
        self.lambda_vq = lambda_vq
        self.lambda_pr = lambda_pr
        self.lambda_fm = lambda_fm
        self.lambda_stft = lambda_stft
        ds = config.dataset
        self.frameshift = ds["frameshift"][list(ds["feature"]).index("mel")]
        self.sample_lengths = sample_lengths
        self.frame_lengths = -1 if sample_lengths == -1 else sample_lengths // self.frameshift
        self.stft_loss_func = stft_loss_func
        self.stft_loss_config = dict(stft_loss_config or {})
        self.samplerate = ds["samplerate"]
        self.eval_interval = int(eval_inteval_iters or 0)

        self.ae = task.networks["autoencoder"]
        self.disc = task.networks["discriminator"]
        lr_cfg = config.get("lr_scheduler")
        # the clip and the freeze patterns are the autoencoder's only
        self.ae_opt = build_optimizer(
            self.ae.named_parameters(), optimizer_config_for(config, "autoencoder"), lr_cfg,
            grad_clip_thresh, freeze_patterns=config.get("freeze"), group=self.group,
        )
        self.d_opt = build_optimizer(
            self.disc.named_parameters(), optimizer_config_for(config, "discriminator"), lr_cfg, None, group=self.group
        )
        self.ae.set_group(self.group)
        self.optimizers = {"autoencoder": self.ae_opt, "discriminator": self.d_opt}
        self._graphs = OrderedDict()  # (rows, frames, window) -> (dropouts' binding, StepGraphs), oldest first
        self._inner = None  # the modules inside the two networks
        self._graph_pool = None  # the memory pool of this trainer's graphs

    # ----------------------------------------------------------------- state
    def state_tree(self) -> dict:
        return train_state_to_jax(self.ae, self.disc)

    def load_state_tree(self, state: dict):
        if "discriminator" in state.get("params", {}):
            train_state_from_jax(state, self.ae, self.disc)
        else:  # a stripped checkpoint: autoencoder only
            self.task.load_variables(state)

    def restart_optimizer_counts(self, iteration: int):
        self.ae_opt.count = iteration
        self.d_opt.count = max(iteration - self.warmup_steps, 0)  # it steps in the GAN phase only

    # ------------------------------------------------------------ loss parts
    def _stft_loss(self, fake, target, windows=None):
        """The waveform terms; ``windows`` as in ``training/losses.py``."""
        if self.stft_loss_func == "mel_loss":
            kwargs = dict(
                sample_rate=self.samplerate, win_size=self.samplerate // 20,
                hop_size=self.samplerate // 80, num_mels=128,
            )
            kwargs.update(self.stft_loss_config)
            # fft_size follows the (possibly overridden) win_size unless pinned
            kwargs.setdefault("fft_size", 2048 if kwargs["win_size"] > 1024 else 1024)
            return {"mel_loss": mel_loss(
                fake, target, kwargs["sample_rate"], fft_size=kwargs["fft_size"],
                hop_size=kwargs["hop_size"], win_size=kwargs["win_size"], num_mels=kwargs["num_mels"],
                group=self.group, windows=windows,
            )}
        return multi_resolution_stft_loss(fake, target, **self.stft_loss_config, group=self.group, windows=windows)

    def _codebook_health(self):
        """Per-stage codeword usage perplexity from the EMA cluster sizes
        (replicated state: the same on every rank, never summed)."""
        metrics = {}
        for i, q in enumerate(self.ae.quantizer.quantizer):
            cs = q.cluster_size
            p = cs / torch.clamp(cs.sum(dim=-1, keepdim=True), min=1e-9)
            entropy = -torch.sum(torch.where(p > 0, p * torch.log(torch.clamp(p, min=1e-38)), torch.zeros_like(p)), dim=-1)
            metrics[f"codebook_perplexity_vq_{i}"] = torch.mean(torch.exp(entropy))
        return metrics

    def _base_g_loss(self, out, mel, mel_length):
        """VQ + prior + frame losses shared by both phases."""
        metrics = self._codebook_health()
        vq, vq_metrics = quantizer_loss(
            out["encoder_diffs"], out["encoder_lengths"], out.get("decoder_diffs"),
            lambda_vq=self.lambda_vq, lambda_pr=self.lambda_pr, group=self.group,
        )
        metrics.update(vq_metrics)
        g = vq
        if "mel_outputs" in out:
            fl = frame_loss(out["mel_outputs"], mel, mel_length, self.group)
            metrics["frame_loss"] = fl
            g = g + self.lambda_frame * fl
        return g, metrics

    # ----------------------------------------------------------------- steps
    def _warmup_step(self, batch):
        mel, mel_length = batch["mel"], batch["mel_length"]
        self.ae_opt.zero_grad()
        dt = self.compute_dtype
        with span("train.ae_forward"):
            out = functional(self.ae, dt)(cast_floats(mel, dt), mel_length, warmup=True)
        with span("train.g_loss"):
            g, metrics = self._base_g_loss(out, mel, mel_length)
        with span("train.g_backward"):
            g.backward()
        with span("train.g_optimizer"):
            self.ae_opt.step()
        metrics["g_loss"] = g
        return metrics

    def _draw_starts(self, mel_length):
        """Per-utterance window starts in [0, max(len - frames, 1)). One
        draw covers the global batch; this rank keeps its own rows."""
        maxval = torch.clamp(mel_length - self.frame_lengths, min=1)
        B = mel_length.shape[0]
        u = torch.rand((B * self.world,), generator=self.generator, device=mel_length.device, dtype=torch.float64)
        u = u[self.rank * B : (self.rank + 1) * B]
        return torch.minimum((u * maxval).long(), maxval - 1)

    def _gan_step(self, batch, starts=None):
        mel, mel_length, wav = batch["mel"], batch["mel_length"], batch["wav"]
        if self.frame_lengths == -1:  # whole utterances, no windows
            starts, target = None, wav
        else:
            if starts is None:
                starts = self._draw_starts(mel_length)
            target = crop_windows(wav, starts * self.frameshift, self.sample_lengths)
        self.ae_opt.zero_grad()
        self.d_opt.zero_grad()

        # one autoencoder forward; its graph waits for the generator loss
        dt = self.compute_dtype
        window = {} if starts is None else dict(window_starts=starts, window_frames=self.frame_lengths)
        with span("train.ae_forward"):
            out = functional(self.ae, dt)(cast_floats(mel, dt), mel_length, warmup=False, **window)
            fake = out["decoder_outputs"][..., 0]
            target_c = cast_floats(target, dt)  # the discriminator's input; the STFT terms read target

        # discriminator update on (detached fake, real)
        with span("train.d_forward"):
            fs, _, rs, _ = paired_disc_apply(functional(self.disc, dt), fake.detach(), target_c)
            d_real, d_fake = lsgan_d_loss(rs, fs, self.group)
            d_loss = d_real + d_fake
        with span("train.d_backward"):
            d_loss.backward()
        with span("train.d_optimizer"):
            self.d_opt.step()

        # generator loss against the updated discriminator
        with span("train.g_loss"):
            g, metrics = self._base_g_loss(out, mel, mel_length)
            stft_terms = self._stft_loss(fake, target)
            stft_sum = sum(stft_terms.values())
            metrics.update(stft_terms)
            metrics["stft_loss"] = stft_sum
            g = g + self.lambda_stft * stft_sum
            with span("train.g_disc_forward"), _no_param_grads(self.disc):
                fs, ff, _, rf = paired_disc_apply(functional(self.disc, dt), fake, target_c)
            adv = lsgan_g_loss(fs, self.group)
            fm = feature_matching_loss(ff, rf, self.group)
            if self.lambda_fm == "auto":  # from the global losses
                g_fm = all_reduce_sum(torch.stack([g.detach(), fm.detach()]), self.group)
                lam = g_fm[0] / torch.clamp(g_fm[1], min=1e-12)
            else:
                lam = self.lambda_fm
            adv_total = adv + fm * lam
            g_total = g + adv_total
        with span("train.g_backward"):
            g_total.backward()
        with span("train.g_optimizer"):
            self.ae_opt.step()

        metrics.update(fm_loss=fm, adv_loss=adv_total, g_loss=g_total,
                       d_loss=d_loss, d_loss_real=d_real, d_loss_fake=d_fake)
        return metrics

    # ------------------------------------------------------------ CUDA graphs
    def _graph_binding(self):
        """The dropouts' binding (generator, shard) that a GAN step's graphs
        hold fixed, where the step may run as graphs; else None."""
        if not (graphs.available(self.device) and self.tp is None
                and (self.group is None or self.group.backend == "nccl") and self.compute_dtype == torch.float32):
            return None
        if self._inner is None:
            self._inner = [m for net in (self.ae, self.disc) for m in list(net.modules())[1:]]
        hooks = torch.nn.modules.module
        if (hooks._global_forward_hooks or hooks._global_forward_pre_hooks or hooks._global_backward_hooks
                or hooks._global_backward_pre_hooks
                or any(m._forward_hooks or m._forward_pre_hooks or m._backward_hooks or m._backward_pre_hooks
                       for m in self._inner)):
            return None
        return tuple((id(m.generator), m.shard) for m in self._inner if isinstance(m, Dropout))

    def _graphed_gan_step(self, batch, starts, binding):
        """The GAN step at a shape's first sight eagerly, on the capture's
        stream (the warm-up: every plan, workspace and constant the step
        makes at first use then exists), at its second captured as it runs,
        later replayed -> (metrics, whether it ran as graphs)."""
        key = (int(batch["mel"].shape[0]), int(batch["mel"].shape[1]), self.frame_lengths)
        seen = self._graphs.pop(key, None)
        if seen is not None and seen[0] == binding and seen[1] is not None:
            self._graphs[key] = seen  # the most recently used last
            return seen[1].replay(lambda: self._gan_step(batch, starts)), True
        if self._graph_pool is None and self.device.type == "cuda":
            self._graph_pool = torch.cuda.graph_pool_handle()
        stream = graphs.capture_stream(self.device)
        if seen is None or seen[0] != binding:  # first sight, or graphs of another binding dropped
            self._graphs[key] = (binding, None)
            with graphs.side_stream(stream):
                return self._gan_step(batch, starts), False
        with span("train.capture", rows=key[0], frames=key[1], window=key[2]), graphs.side_stream(stream):
            steps = graphs.StepGraphs((self.ae, self.disc), self._graph_pool, self.generator)
            metrics = steps.capture(lambda: self._gan_step(batch, starts))
        self._graphs[key] = (binding, steps)
        for old in [k for k, (_, g) in self._graphs.items() if g is not None][:-GRAPHED_SHAPES]:
            del self._graphs[old]
        return metrics, True

    # ------------------------------------------------------------------ api
    def _eval_inputs(self, batch):
        """(positional, keyword) inputs of the autoencoder's forward for the
        batch's first row, and that row's length."""
        return (batch["mel"][:1], batch["mel_length"][:1]), {}, batch["mel_length"][:1]

    def evaluate(self, batch, logger, iteration):
        """Analysis-synthesis of the batch's first row (on a group, this
        rank's first; only rank 0 has a writer) to the logger: the waveform
        and the normalized predicted mel (``msmctts_tpu/training/vqgan_trainer.py:409-446``).
        Nothing without a writer."""
        if logger.writer is None:
            return
        args, kwargs, length = self._eval_inputs(batch)
        self.ae.eval()
        try:
            with torch.inference_mode():
                out = self.ae(*args, **kwargs)
        finally:
            self.ae.train()
        n = int(length[0])
        wav = out["decoder_outputs"]
        ratio = wav.shape[1] // args[0].shape[1]
        payload = {"audio": {"eval/wav": (wav[0, : n * ratio, 0].float().cpu().numpy(), self.samplerate)}}
        if out.get("mel_outputs") is not None:
            m = out["mel_outputs"][0, :n].float().cpu().numpy().T  # [D, T]
            m = (m - m.min()) / max(m.max() - m.min(), 1e-6)
            payload["image"] = {"eval/pred_mel": m[..., None]}
        logger.log(iteration, payload)

    def train_step(self, batch, iteration, starts=None):
        """One step on a device batch {'mel', 'mel_length', 'wav'}: the
        warmup graph while ``iteration <= warmup_steps``, else the GAN step.
        ``starts`` [B] fixes the GAN windows (tests compare two stacks whose
        random streams differ); by default they come from the trainer's
        generator. Under a group, ``batch`` and ``starts`` hold this rank's
        rows. Returns 0-d metric tensors, detached: the global values.

        The step is the span ``train.step`` (``iteration``), its phases its
        children: ``train.ae_forward``, ``train.d_forward``,
        ``train.d_backward``, ``train.d_optimizer``, ``train.g_loss`` (which
        holds ``train.g_disc_forward``, the discriminator's pass with its
        parameters frozen), ``train.g_backward``, ``train.g_optimizer`` and
        ``train.metrics``; the warmup graph has the generator's alone.
        ``graphed`` is 1 where the networks' calls ran as CUDA graphs
        (captured, inside ``train.capture``, or replayed), else 0."""
        with span("train.step", iteration=int(iteration)) as step:
            self.shard()  # split over the model group (a no-op without one)
            batch = decode_batch(batch)  # the wire format (data/wire.py); a plain batch passes as it is
            self.ae.train()
            self.disc.train()
            graphed = False
            if iteration <= self.warmup_steps:
                metrics = self._warmup_step(batch)
            elif (binding := self._graph_binding()) is not None:
                metrics, graphed = self._graphed_gan_step(batch, starts, binding)
            else:
                metrics = self._gan_step(batch, starts)
            step.attrs["graphed"] = int(graphed)
            with span("train.metrics"):
                metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
                return self.global_metrics(metrics,
                                           sorted(k for k in metrics if not k.startswith("codebook_perplexity")))
