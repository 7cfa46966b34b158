"""QS-TTS trainers (counterpart of ``msmctts_tpu/training/emb_vqgan_trainer.py``):
``EmbVQGANTrainer`` for the SSL-embedding synthesizer and
``NASynEmbFSTrainer`` for the predictor trained against it.

``EmbVQGANTrainer`` is ``VQGANTrainer`` over an ``MSMCVQGANEmb`` batch
(``emb``, ``emb_length``, ``mel``, ``wav``, and ``pitch`` / ``energy`` where
the recipe has them), in three phases keyed by two flags:

  * ``decode = iteration > frame_loss_supervised_step``: the waveform
    decoder runs on windows; before that the step is supervised only (VQ,
    prior and frame losses);
  * ``gan = decode and iteration > stft_loss_supervised_step``: the
    discriminator is updated and the adversarial and feature-matching
    terms join the generator loss; in between, the windows add the STFT
    term only.

``warmup_steps`` defaults to ``frame_loss_supervised_step``. Windows: with
``sample_batch_size`` > 0 that many rows of the global batch are drawn
without replacement (a permutation cut to size, sorted), else every row;
then one start per drawn row, uniform in [0, max(length - frames, 1)). Both
come from the trainer's generator for the global batch, so every rank draws
the same. A rank decodes only the drawn rows it holds, which may be none;
the STFT, frame-matching and GAN terms are its share of the global mean
over the ``n_win`` windows (``training/losses.py``, ``windows=``), and a rank
with no window decodes one stand-in row with weight 0, so that it joins
every collective of the step.

The adversarial prosody estimator (``prosody_estimator``, an
``AttrPredictor``) is updated first each step, on the detached content
representation, with its gradients scaled by 0.01 before its optimizer; the
generator then subtracts 0.01 x the same loss, evaluated with the updated
estimator (whose parameters take no gradient there). The discriminator is
updated before the generator's gradient is pulled back, as in
``VQGANTrainer``. The autoencoder's forward runs once per step: its
quantizer stages launch the statistics kernel twice per step
(``ops/vq.vq_nearest_stats_sharded``, ``csrc/vq_stats.cu``), and the ECAPA
global encoder's batch norms move their running statistics once. Under
``precision: bfloat16`` the autoencoder runs on bf16 casts of its
parameters and of every float input but the lengths, and both
discriminator passes as in ``VQGANTrainer``; the prosody estimator stays
fp32 (``msmctts_tpu/training/emb_vqgan_trainer.py:138-141,262-265,319-322``).

``NASynEmbFSTrainer`` is ``PredictorTrainer`` with a teacher whose
``analysis`` reads ``emb`` (and ``pitch`` / ``energy`` where given): the
teacher loads lazily, stays in ``eval()`` without gradient and snaps each of
its stages through ``csrc/vq_nearest.cu``, 2 launches per step.

Checkpoints hold the JAX trainer's tree: ``params`` {autoencoder,
discriminator, prosody_estimator}, ``codebook`` and ``model_state.batch_stats``.
``EmbVQGANTrainer.evaluate`` is ``VQGANTrainer``'s over the batch's first
row of ``emb`` with its ``pitch``, ``energy`` and ``mel`` where the batch has
them (``msmctts_tpu/training/emb_vqgan_trainer.py:377-420``).
"""

from __future__ import annotations

import numpy as np
import torch

from msmctts_tpu_torch.data.wire import decode_batch
from msmctts_tpu_torch.models.msmc_vqgan import crop_windows
from msmctts_tpu_torch.parallel.mesh import all_reduce_sum
from msmctts_tpu_torch.parallel.precision import cast_floats, functional
from msmctts_tpu_torch.registry import register_trainer
from msmctts_tpu_torch.training.losses import (
    feature_matching_loss,
    frame_loss,
    lsgan_d_loss,
    lsgan_g_loss,
    paired_disc_apply,
    quantizer_loss,
)
from msmctts_tpu_torch.training.optim import build_optimizer, optimizer_config_for
from msmctts_tpu_torch.training.predictor_trainer import PredictorTrainer
from msmctts_tpu_torch.training.vqgan_trainer import VQGANTrainer, _no_param_grads
from msmctts_tpu_torch.utils.tracing import span
from msmctts_tpu_torch.weights import (
    attr_predictor_to_jax,
    emb_autoencoder_to_jax,
    state_dict_numpy,
    univnet_discriminator_to_jax,
)

PROSODY_SCALE = 0.01  # of the estimator's gradients, and of its loss in the generator's


@register_trainer("EmbVQGANTrainer")
class EmbVQGANTrainer(VQGANTrainer):
    def __init__(self, config, task, group=None, sample_batch_size: int = -1, frame_loss_supervised_step: int = 0,
                 stft_loss_supervised_step: int = 0, **kwargs):
        kwargs.setdefault("warmup_steps", frame_loss_supervised_step)
        super().__init__(config, task, group, **kwargs)
        if self.frame_lengths <= 0:
            raise ValueError("EmbVQGANTrainer decodes windows: sample_lengths must be positive")
        self.sample_batch_size = int(sample_batch_size)
        self.frame_loss_supervised_step = int(frame_loss_supervised_step)
        self.stft_loss_supervised_step = int(stft_loss_supervised_step)
        self.prosody = task.networks.get("prosody_estimator")
        if self.prosody is not None:
            self.pr_opt = build_optimizer(
                self.prosody.named_parameters(), optimizer_config_for(config, "prosody_estimator"),
                config.get("lr_scheduler"), None, group=self.group,
            )
            self.optimizers["prosody_estimator"] = self.pr_opt

    # ----------------------------------------------------------------- state
    def state_tree(self) -> dict:
        ae = emb_autoencoder_to_jax(state_dict_numpy(self.ae))
        params = {"autoencoder": ae["params"],
                  "discriminator": univnet_discriminator_to_jax(state_dict_numpy(self.disc), periods=self.disc.mpd.periods)}
        if self.prosody is not None:
            params["prosody_estimator"] = attr_predictor_to_jax(state_dict_numpy(self.prosody))
        return {"params": params, "codebook": ae["codebook"], "model_state": {"batch_stats": ae["batch_stats"]}}

    def load_state_tree(self, state: dict):
        self.task.load_variables(state)  # every network the tree holds

    def restart_optimizer_counts(self, iteration: int):
        self.ae_opt.count = iteration
        # the discriminator steps in the GAN phase only
        self.d_opt.count = max(iteration - max(self.frame_loss_supervised_step, self.stft_loss_supervised_step), 0)
        if self.prosody is not None:
            self.pr_opt.count = iteration

    def _eval_inputs(self, batch):
        kwargs = {k: batch[k][:1] for k in ("pitch", "energy", "mel") if k in batch}
        return (batch["emb"][:1], batch["emb_length"][:1]), kwargs, batch["emb_length"][:1]

    # ----------------------------------------------------------------- draws
    def draw_windows(self, B: int):
        """(window rows [n_win], sorted, of the global batch of ``B * world``
        rows; uniform draws [n_win] in [0, 1) that place each window)."""
        n = B * self.world
        dev = self.device
        if self.sample_batch_size > n:
            raise ValueError(f"sample_batch_size {self.sample_batch_size} exceeds the global batch of {n}")
        if self.sample_batch_size > 0:
            rows = torch.sort(torch.randperm(n, generator=self.generator, device=dev)[: self.sample_batch_size]).values
        else:
            rows = torch.arange(n, device=dev)
        u = torch.rand((rows.shape[0],), generator=self.generator, device=dev, dtype=torch.float64)
        return rows, u

    def local_windows(self, rows, place, lengths, starts_given: bool = False):
        """This rank's windows of the global draw: (local rows, starts,
        weights, n_win). ``place`` holds the uniform draws, or the starts
        themselves with ``starts_given``. A rank holding no drawn row gets
        one stand-in window (its row 0 at start 0) of weight 0."""
        B = lengths.shape[0]
        lo = self.rank * B
        keep = (rows >= lo) & (rows < lo + B)
        local, place = rows[keep].long() - lo, place[keep]
        if starts_given:
            starts = place.long()
        else:
            maxval = torch.clamp(lengths[local].long() - self.frame_lengths, min=1)
            starts = torch.minimum((place * maxval).long(), maxval - 1)
        weights = torch.ones(local.shape[0], device=lengths.device)
        if local.shape[0] == 0:
            local = torch.zeros(1, dtype=torch.long, device=lengths.device)
            starts, weights = torch.zeros_like(local), torch.zeros(1, device=lengths.device)
        return local, starts, weights, int(rows.shape[0])

    # ----------------------------------------------------------------- steps
    def _prosody_step(self, content, target, lengths):
        """The estimator's update on the detached content representation."""
        self.pr_opt.zero_grad()
        _, pred = self.prosody(content.detach(), lengths)
        loss = frame_loss(pred, target, lengths, self.group)
        loss.backward()
        for p in self.prosody.parameters():
            if p.grad is not None:
                p.grad.mul_(PROSODY_SCALE)
        self.pr_opt.step()
        return loss

    def _emb_step(self, batch, decode: bool, gan: bool, windows=None):
        emb, lengths, mel = batch["emb"], batch["emb_length"], batch["mel"]
        cond = {k: batch[k] for k in ("pitch", "energy") if k in batch}
        kwargs = dict(decode=decode, mel=mel, **cond)
        share = target = None
        if decode:
            if windows is None:
                rows, u = self.draw_windows(emb.shape[0])
                local, starts, weights, n_win = self.local_windows(rows, u, lengths)
            else:  # given global (rows, starts), as tests give both stacks the same windows
                rows, starts = (torch.as_tensor(np.array(w), device=emb.device) for w in windows)
                local, starts, weights, n_win = self.local_windows(rows, starts, lengths, starts_given=True)
            share = (weights, n_win)
            kwargs.update(window_indices=local, window_starts=starts, window_frames=self.frame_lengths)
            target = crop_windows(batch["wav"][local], starts * self.frameshift, self.sample_lengths)
        self.ae_opt.zero_grad()
        self.d_opt.zero_grad()
        dt = self.compute_dtype  # every float input but the lengths cast (emb_vqgan_trainer.py:138-141)
        with span("train.ae_forward"):
            out = functional(self.ae, dt)(cast_floats(emb, dt), lengths, **cast_floats(kwargs, dt))
            target_c = cast_floats(target, dt)
        metrics = {}

        content = out.get("content_representations")
        use_prosody = self.prosody is not None and content is not None
        if use_prosody:
            prosody_target = torch.cat([batch["pitch"], batch["energy"]], dim=-1)
            metrics["d_prosody_loss"] = self._prosody_step(content, prosody_target, lengths)

        fake = out["decoder_outputs"][..., 0] if decode else None
        if gan:
            with span("train.d_forward"):
                fs, _, rs, _ = paired_disc_apply(functional(self.disc, dt), fake.detach(), target_c)
                d_real, d_fake = lsgan_d_loss(rs, fs, self.group, windows=share)
                d_loss = d_real + d_fake
            with span("train.d_backward"):
                d_loss.backward()
            with span("train.d_optimizer"):
                self.d_opt.step()
            metrics.update(d_loss=d_loss, d_loss_real=d_real, d_loss_fake=d_fake)

        # the generator's loss, against the updated estimator and discriminator
        with span("train.g_loss"):
            g, vq_metrics = quantizer_loss(out["encoder_diffs"], out["encoder_lengths"], out.get("decoder_diffs"),
                                           lambda_vq=self.lambda_vq, lambda_pr=self.lambda_pr, group=self.group)
            metrics.update(vq_metrics)
            if "mel_outputs" in out:
                metrics["frame_loss"] = frame_loss(out["mel_outputs"], mel, lengths, self.group)
                g = g + self.lambda_frame * metrics["frame_loss"]
            if decode:
                stft_terms = self._stft_loss(fake, target, windows=share)
                metrics.update(stft_terms)
                metrics["stft_loss"] = sum(stft_terms.values())
                g = g + self.lambda_stft * metrics["stft_loss"]
            if use_prosody:
                with _no_param_grads(self.prosody):
                    _, pred = self.prosody(content, lengths)
                metrics["g_prosody_loss"] = frame_loss(pred, prosody_target, lengths, self.group)
                g = g - PROSODY_SCALE * metrics["g_prosody_loss"]  # the generator maximizes the estimator's error
            if gan:
                with span("train.g_disc_forward"), _no_param_grads(self.disc):
                    fs, ff, _, rf = paired_disc_apply(functional(self.disc, dt), fake, target_c)
                adv = lsgan_g_loss(fs, self.group, windows=share)
                fm = feature_matching_loss(ff, rf, self.group, windows=share)
                if self.lambda_fm == "auto":  # from the global losses
                    g_fm = all_reduce_sum(torch.stack([g.detach(), fm.detach()]), self.group)
                    lam = g_fm[0] / torch.clamp(g_fm[1], min=1e-12)
                else:
                    lam = self.lambda_fm
                g = g + adv + fm * lam
                metrics.update(fm_loss=fm, adv_loss=adv)
        metrics["g_loss"] = g
        with span("train.g_backward"):
            g.backward()
        with span("train.g_optimizer"):
            self.ae_opt.step()
        return metrics

    def train_step(self, batch, iteration, windows=None):
        """One step on a device batch of ``EmbDataset`` (under a group, this
        rank's rows). ``windows`` = (global rows, starts) fixes the windows
        (tests compare two stacks whose random streams differ); by default
        they are drawn from the trainer's generator. Returns 0-d metric
        tensors, detached: the global values. The spans are
        ``VQGANTrainer.train_step``'s; its steps run eagerly (``graphed`` 0)."""
        with span("train.step", iteration=int(iteration), graphed=0):
            self.shard()  # split over the model group (a no-op without one)
            batch = decode_batch(batch)  # the wire format (data/wire.py); a plain batch passes as it is
            for module in (self.ae, self.disc, self.prosody):
                if module is not None:
                    module.train()
            decode = iteration > self.frame_loss_supervised_step
            gan = decode and iteration > self.stft_loss_supervised_step
            metrics = self._emb_step(batch, decode, gan, windows)
            with span("train.metrics"):
                metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
                return self.global_metrics(metrics, sorted(metrics))  # every term is a share


@register_trainer("NASynEmbFSTrainer")
class NASynEmbFSTrainer(PredictorTrainer):
    """The QS-TTS predictor's trainer: ``PredictorTrainer`` whose teacher
    analyses SSL embeddings (``emb_vqgan_trainer.py:423-554``). The JAX
    trainer reads no ``precision``: it runs fp32 under ``bfloat16`` too,
    and so does this one."""

    def __init__(self, config, task, group=None, **kwargs):
        super().__init__(config, task, group, **kwargs)
        self.compute_dtype = torch.float32

    def teacher_states(self, batch):
        return self.frozen_autoencoder().analysis(
            batch["emb"], batch["emb_length"], pitch=batch.get("pitch"), energy=batch.get("energy"))
