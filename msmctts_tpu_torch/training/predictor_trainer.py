"""Acoustic-model (MultiStagePredictor) trainer (counterpart of
``msmctts_tpu/training/predictor_trainer.py``).

Per step: the frozen autoencoder's ``analysis``, in ``eval()`` mode and
under ``no_grad``, gives the teacher's coarsest-first codewords
(straight-through values), indices and lengths. Every stage snaps through
``ops/vq.vq_nearest_sharded`` (``csrc/vq_nearest.cu`` on the card, one
launch per stage) and the codebooks do not move: the JAX package runs this
analysis with its ``codebook`` collection immutable. The predictor then runs
teacher-forced in ``train()`` mode, dropout drawn from the trainer's
generator. The loss is the per-stage embedding losses of
``training_methods`` weighted by ``loss_weights``
(``MSMCVQGAN.compute_embedding_loss``) plus ``lambda_dur`` times the masked
duration MSE of the raw predicted durations, and one clipped optimizer step
updates the predictor alone. ``grad_norm`` is the gradients' global norm
before the clip.

The teacher loads lazily, at the first step, from
``task.autoencoder._checkpoint`` (with ``_config``, else the checkpoint's
embedded config), so a trainer is built without the file on disk. It is not
one of the task's networks: it is neither initialised, saved nor
broadcast, and its parameters take no gradient.

Checkpoints hold ``{"params": {"predictor": ...}}`` in the JAX layout, so the
JAX package's inference task loads them.

Data-parallel (``group``, see ``training/base_trainer.py``): the batch is
this rank's block of the global batch. The teacher snaps the rank's rows
and communicates nothing; every loss term is the rank's share of the global
term; dropout masks are drawn for the global batch; the optimizer sums the
gradients over ranks before it clips. The metrics returned are the global
values, equal on every rank. Per step that is one all-reduce per masked
denominator (one per embedding-loss stage and one for the durations), one of
the gradients and one of the metrics.

Under ``precision: bfloat16`` the teacher's float parameters are rounded to
bf16 when it loads (its codebooks stay fp32), ``mel`` is cast before its
``analysis``, and the predictor runs on bf16 casts of its fp32 masters
(``msmctts_tpu/training/predictor_trainer.py:72-78,113,127``).
"""

from __future__ import annotations

import torch

from msmctts_tpu_torch.data.wire import decode_batch
from msmctts_tpu_torch.parallel.precision import cast_floats, functional
from msmctts_tpu_torch.registry import register_trainer
from msmctts_tpu_torch.tasks import load_frozen_autoencoder
from msmctts_tpu_torch.training.base_trainer import BaseTrainer
from msmctts_tpu_torch.training.losses import duration_loss
from msmctts_tpu_torch.training.optim import build_optimizer, optimizer_config_for
from msmctts_tpu_torch.weights import (
    load_numpy_state,
    multi_stage_predictor_from_jax,
    multi_stage_predictor_to_jax,
    state_dict_numpy,
)


@register_trainer("PredictorTrainer")
class PredictorTrainer(BaseTrainer):
    def __init__(
        self,
        config,
        task,
        group=None,
        grad_clip_thresh: float = 1.0,
        eval_inteval_iters: int = 1000,  # accepted for YAML parity; the JAX trainer runs no evaluate() either
        training_methods=("mse",),
        loss_weights=(1.0,),
        lambda_dur: float = 1.0,
    ):
        super().__init__(config, task, group)
        self.training_methods = list(training_methods)
        self.loss_weights = [list(w) if isinstance(w, (list, tuple)) else w for w in loss_weights]
        self.lambda_dur = lambda_dur
        self.predictor = task.networks["predictor"]
        self.ae = None  # the frozen teacher, see frozen_autoencoder
        self.opt = build_optimizer(
            self.predictor.named_parameters(), optimizer_config_for(config, "predictor"),
            config.get("lr_scheduler"), grad_clip_thresh, freeze_patterns=config.get("freeze"), group=self.group,
        )
        self.optimizers = {"predictor": self.opt}

    def frozen_autoencoder(self):
        """The teacher, loaded at the first call, in ``eval()`` mode."""
        if self.ae is None:
            node = self.config.task["autoencoder"]
            # the teacher runs in the compute dtype, its codebooks fp32 (predictor_trainer.py:72-78)
            self.ae, _ = load_frozen_autoencoder(node["_checkpoint"], node.get("_config"), self.device,
                                                 self.compute_dtype)
            self.ae.requires_grad_(False)
            self.ae.quantizer.set_group(self.group)  # the embedding losses' global denominators
        return self.ae

    # ----------------------------------------------------------------- state
    def state_tree(self) -> dict:
        return {"params": {"predictor": multi_stage_predictor_to_jax(state_dict_numpy(self.predictor))}}

    def load_state_tree(self, state: dict):
        load_numpy_state(self.predictor, multi_stage_predictor_from_jax(state["params"]["predictor"]))

    # ------------------------------------------------------------------ api
    def teacher_states(self, batch):
        """The frozen teacher's quantizer states of the batch's features
        (``mel`` in the compute dtype, ``predictor_trainer.py:113``)."""
        return self.frozen_autoencoder().analysis(cast_floats(batch["mel"], self.compute_dtype), batch["mel_length"])

    def train_step(self, batch, iteration):
        """One step on a device batch {'text', 'text_length', 'dur', 'mel',
        'mel_length'} (under a group, this rank's rows). Returns 0-d metric
        tensors, detached: the global values."""
        self.shard()  # split over the model group (a no-op without one)
        batch = decode_batch(batch)  # the wire format (data/wire.py); a plain batch passes as it is
        with torch.no_grad():  # the teacher's quantizer states
            q = self.teacher_states(batch)
        self.predictor.train()
        self.opt.zero_grad()
        text_length, dur = batch["text_length"], batch["dur"]
        out = functional(self.predictor, self.compute_dtype)(
            batch["text"], text_length, dur=dur, feat=q["quantizer_outputs"], feat_length=q["quantizer_lengths"])
        emb = self.ae.compute_embedding_loss(out["feat"], out["feat_length"], q, self.training_methods,
                                             self.loss_weights)
        metrics = {k: v for k, v in emb.items() if k != "total_loss"}
        metrics["duration_loss"] = duration_loss(out["duration"], dur, text_length, self.group) * self.lambda_dur
        total = emb["total_loss"] + metrics["duration_loss"]
        metrics["total_loss"] = total
        total.backward()
        metrics["grad_norm"] = self.opt.step()  # of the summed gradients: global already
        metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
        return self.global_metrics(metrics, sorted(k for k in metrics if k != "grad_norm"))  # the loss shares
