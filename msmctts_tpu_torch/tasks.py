"""Task layer (counterpart of ``msmctts_tpu/tasks.py:60-100, 204-820``):
build the networks from the ``task:`` config subtree, load their weights,
and run inference.

``MSMCTTS.infer_step`` keeps the JAX package's two modes:
``train_autoencoder`` -> analysis-synthesis round trip, ``train_predictor``
-> text -> predictor -> snapped MSMCR -> ``autoencoder.synthesis`` ->
waveform, with the frozen autoencoder loaded from
``task.autoencoder._checkpoint`` / ``_config``. Prediction keeps its two
phases: durations first, then one frame bucket for the batch, then
expansion and synthesis.

``build_task(config, mode="train")`` also builds the training-only
networks of the recipe (the GAN discriminator) and leaves every network in
``train()`` mode for a trainer of ``msmctts_tpu_torch/training``.

Everything runs in fp32 on ``device`` (``cuda`` unless the caller asks for
the CPU). No mesh, int8 decoder or streaming yet.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from msmctts_tpu_torch.config import Config, component_kwargs
from msmctts_tpu_torch.data.datasets import FRAME_BUCKETS, bucket_length
from msmctts_tpu_torch.registry import get_network, get_task, register_task
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint
from msmctts_tpu_torch.utils.device import exact_fp32, resolve_device
from msmctts_tpu_torch.weights import (
    load_numpy_state,
    msmc_vqgan_from_jax,
    multi_stage_predictor_from_jax,
    univnet_discriminator_from_jax,
)

_FROM_JAX = {
    "MSMCVQGAN": lambda state, name, module: msmc_vqgan_from_jax(
        {"params": state["params"][name], "codebook": state["codebook"],
         "batch_stats": state.get("model_state", {}).get("batch_stats")}
    ),
    "MultiStagePredictor": lambda state, name, module: multi_stage_predictor_from_jax(state["params"][name]),
    "UnivNetDiscriminator": lambda state, name, module: univnet_discriminator_from_jax(
        state["params"][name], periods=module.mpd.periods
    ),
}


def _build_network(node, device):
    cls = get_network(node["_name"])
    return cls(**component_kwargs(node)).to(device).eval()


def _load_network(module, node_name: str, state: dict, name: str):
    if node_name not in _FROM_JAX:
        raise NotImplementedError(f"no weight mapping for network '{node_name}'")
    load_numpy_state(module, _FROM_JAX[node_name](state, name, module))


# The networks inference runs. Others in a recipe (the GAN discriminator)
# are training state and are built in train mode only.
INFERENCE_NETWORKS = ("autoencoder", "predictor")


class BaseTask:
    """Holds the module for every ``task:`` entry with a ``_name``: in
    ``infer`` mode the networks inference runs, in ``eval()``; in ``train``
    mode all of them, in ``train()``."""

    def __init__(self, config, device=None, mode: str = "infer"):
        if mode not in ("infer", "train"):
            raise ValueError(f"unknown task mode '{mode}'")
        self.config = config
        self.mode = mode
        self.device = resolve_device(device)
        exact_fp32()
        self.networks: Dict[str, torch.nn.Module] = {}
        self.network_configs: Dict[str, dict] = {}
        for name, node in config.get("task", {}).items():
            if name.startswith("_") or not isinstance(node, dict) or "_name" not in node:
                continue  # checkpoint-only entries (a frozen autoencoder)
            if mode == "infer" and name not in INFERENCE_NETWORKS:
                continue
            self.networks[name] = _build_network(node, self.device).train(mode == "train")
            self.network_configs[name] = node


def build_task(config, device=None, mode: str = "infer"):
    return get_task(config.task["_name"])(config, device, mode)


def load_frozen_autoencoder(checkpoint_path: str, config_path: Optional[str] = None, device=None):
    """Load a frozen MSMCVQGAN (module with weights, config) from a
    checkpoint, using its embedded config when no config file is given."""
    ckpt = load_checkpoint(checkpoint_path)
    cfg = Config(config_path) if config_path else Config(ckpt["config"])
    node = cfg.task["autoencoder"]
    module = _build_network(node, resolve_device(device))
    _load_network(module, node["_name"], ckpt["state"], "autoencoder")
    return module, cfg


def extract_codebooks(autoencoder) -> list:
    """Coarsest-first list of [H, d, K] codebooks for predictor snapping
    (the reference wires ``predictor.quantizers =
    autoencoder.quantizer.quantizer``)."""
    return [q.embed for q in autoencoder.quantizer.quantizer]


@register_task("MSMCTTS")
class MSMCTTS(BaseTask):
    def __init__(self, config, device=None, mode: str = "infer"):
        super().__init__(config, device, mode)
        ds = config.dataset
        self.samplerate = ds["samplerate"]
        self.training_mode = config.task.get("_mode", "train_autoencoder")
        self._loaded_modules = False

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # ------------------------------------------------------------ loading
    def load_variables(self, state: dict):
        """Attach weights from a checkpoint state tree (JAX layout)."""
        for name, module in self.networks.items():
            if name in state.get("params", {}):
                _load_network(module, self.network_configs[name]["_name"], state, name)

    def pre_infer(self):
        self._loaded_modules = True
        node = self.config.task.get("autoencoder", {})
        if "_checkpoint" in node and "autoencoder" not in self.networks:
            module, _ = load_frozen_autoencoder(node["_checkpoint"], node.get("_config"), self.device)
            self.networks["autoencoder"] = module

    # ------------------------------------------------------------- infer
    def infer_step(self, batch: dict) -> dict:
        if self.training_mode == "train_autoencoder":
            return self.analysis_synthesis(batch)
        if not self._loaded_modules:
            self.pre_infer()
        return self.predict(batch)

    @torch.inference_mode()
    def analysis_synthesis(self, batch: dict) -> dict:
        """Full AE round trip: mel [B, T, n_mel] -> wav per utterance."""
        if "emb" in batch:
            raise NotImplementedError("SSL-embedding autoencoders are not ported")
        ae = self.networks["autoencoder"]
        if ae.training:
            raise RuntimeError("analysis_synthesis needs the autoencoder in eval() mode")
        T = int(batch["mel"].shape[1])
        out = ae(self._tensor(batch["mel"], torch.float32), self._tensor(batch["mel_length"], torch.long))
        wav = out["decoder_outputs"][..., 0].cpu().numpy()
        ratio = wav.shape[1] // T
        return {
            "wav": [w[: int(l) * ratio] for w, l in zip(wav, batch["mel_length"])],
            "mel_length": batch["mel_length"],
        }

    @torch.inference_mode()
    def _predict_phase1(self, batch: dict) -> dict:
        """Durations (predicted, or forced by ``dur`` in the batch), rounded
        and masked, and the batch's frame bucket: the frame total rounded up
        to ``FRAME_BUCKETS``, at least lcm(n_pred_scale)."""
        predictor = self.networks["predictor"]
        scales = list(predictor.n_pred_scale)
        lcm = math.lcm(*scales) if scales else 1
        text = self._tensor(batch["text"], torch.long)
        text_length = self._tensor(batch["text_length"], torch.long)
        if "dur" in batch:
            given = np.asarray(batch["dur"], np.float32)
            mask = np.arange(given.shape[1])[None, :] < np.asarray(batch["text_length"])[:, None]
            given = np.round(np.maximum(given, 0.0)) * mask
            durations = self._tensor(given, torch.float32)
            total = given.sum(axis=1).astype(np.int64)
        else:
            dur = predictor.predict_durations(text, text_length)
            mask = torch.arange(dur.shape[1], device=self.device)[None, :] < text_length[:, None]
            durations = dur * mask
            total = durations.sum(dim=1).long().cpu().numpy()  # one small D2H
        max_frames = bucket_length(max(int(total.max()), lcm), FRAME_BUCKETS)
        return dict(text=text, text_length=text_length, durations=durations, total=total, max_frames=max_frames)

    @torch.inference_mode()
    def predict(self, batch: dict) -> dict:
        """text -> MSMCR -> waveform (msmc_tts.py:109-127)."""
        predictor = self.networks["predictor"]
        ae = self.networks["autoencoder"]
        p1 = self._predict_phase1(batch)
        out = predictor(
            p1["text"], p1["text_length"], dur=p1["durations"],
            max_frames=p1["max_frames"], codebooks=extract_codebooks(ae),
        )
        wav = ae.synthesis(out["feat"], out["feat_length"])[..., 0].cpu().numpy()
        fine = out["feat"][-1].cpu().numpy()
        total = p1["total"]
        ratio = wav.shape[1] // fine.shape[1]
        wav_lengths = (total * ratio).astype(np.int64)
        return {
            "wav": [w[:l] for w, l in zip(wav, wav_lengths)],
            "embedding": [f[: int(t)] for f, t in zip(fine, total)],
            "duration": p1["durations"].cpu().numpy(),
            "mel_length": total,
        }
