"""Task layer (counterpart of ``msmctts_tpu/tasks.py:60-100, 204-820``):
build the networks from the ``task:`` config subtree, load their weights,
and run inference.

``MSMCTTS.infer_step`` keeps the JAX package's two modes:
``train_autoencoder`` -> analysis-synthesis round trip (mel, or for the
QS-TTS family SSL embeddings), ``train_predictor``
-> text -> predictor -> snapped MSMCR -> ``autoencoder.synthesis`` ->
waveform, with the frozen autoencoder loaded from
``task.autoencoder._checkpoint`` / ``_config``. The task is also registered
under the QS-TTS recipes' names ``NASynTTSEmb`` and ``NASynTTSv2``; over
an SSL-embedding autoencoder ``predict`` runs its ``synthesis`` (no speaker
reference), as the JAX package does, and ``predict_stream`` is refused, as
the JAX package has no such path. Prediction keeps its two
phases: durations first, then one frame bucket for the batch, then
expansion and synthesis.

``build_task(config, mode="train")`` also builds the training-only
networks of the recipe (the GAN discriminator) and leaves every network in
``train()`` mode for a trainer of ``msmctts_tpu_torch/training``.

``MSMCTTS.use_mesh(group)`` makes ``predict`` and ``analysis_synthesis``
data-parallel over the ranks of a ``parallel.mesh.Group`` (the JAX
package's ``use_mesh``): every rank calls them with the same global batch,
computes its contiguous block of rows with its replica of the weights
(every snap through ``ops/vq.vq_nearest_sharded``, which communicates
nothing) and the outputs are gathered in rank order, so every rank returns
the whole batch's result. ``predict_stream`` gathers each chunk in rank
order, so every rank yields the global batch's chunks; the int8 decoder
calibrates on the features of the global batch, gathered to every rank
(its per-tensor scales at site k + 1 depend on how site k was quantized
over the whole batch, so a max over the ranks' own calibrations is not the
same), and every rank then holds the same scales and SmoothQuant fold.

``predict_stream`` is the streaming surface (``msmctts_tpu/tasks.py:666-707``):
the same two phases up to the decoder's input features
(``predict_features``), then the HiFi-GAN decode in windows of
``chunk + 2R`` frames sliced from the device-resident features
(``streaming.StreamingDecoder``), chunk by chunk. ``max_frames_cap`` clamps
every utterance's frame total (the serving cap that makes the reachable
(text bucket x frame bucket) set finite), and ``static_max_frames`` pins one
frame bucket, so that nothing returns to the host before the waveform.
``shapes`` records every shape the task has run, keyed like the JAX
package's ``_jit_cache``: ``("dur", Lt)``, ``("syn", Lt, F)``,
``("stream", chunk, Lt, F)``, ``("ae", T)`` and ``("ae_emb", T, inputs)``; it is the eager port's
counterpart of "this graph is compiled", and serving counts the shapes first
run after its warmup (``serving.py``).

``int8_decoder`` (``infer`` / ``serve --int8``) swaps the HiFi-GAN decoder of
``analysis_synthesis``, ``predict`` and ``predict_stream`` for the int8 one
of ``ops/int8_generator.py``, built lazily over the autoencoder's decoder and
calibrated on the first batch the task decodes (under the serving daemon,
warmup's), as the JAX package's ``_int8`` is (``msmctts_tpu/tasks.py:367-387``);
its shapes are recorded as ``("ae8", T)``, ``("syn8", Lt, F)`` and
``("stream8", chunk, Lt, F)``. A weight load drops it. It covers the
``HifiGANGenerator`` decoder of the mel autoencoder only, and streaming
covers that decoder only: an ``ISTFTGenerator`` decodes monolithically, as
in the JAX package.

``precision: bfloat16`` (``parallel/precision.py``) is applied as the JAX
task's ``_cast`` applies it (``msmctts_tpu/tasks.py:241-243,289-296``): the
inference networks hold their float parameters in bf16, cast when they are
built and so rounded by every load, the frozen autoencoder's when it loads;
codebooks and BatchNorm statistics are buffers and stay fp32, and the
weight-norm caches are folded in fp32 from the rounded pairs. The inputs
stay fp32, so most activations promote back to fp32 (the JAX package's
promotion, which the port's layers follow). The int8 decoder is built in the
compute dtype, as the JAX task builds its own (``msmctts_tpu/tasks.py:382``):
under bf16 it quantizes the rounded decoder weights, calibrates on the
features the bf16 autoencoder gives it and returns a bf16 waveform, which
the task hands on as fp32 arrays (every bf16 value is one).

``TTS`` is the legacy v1 task (``msmctts_tpu/tasks.py:100-198``): a generic
``acoustic_model`` -> mel, then the autoencoder's ``synthesis`` over the mel
split into per-stage chunks and average-pooled by the cumulative
``downsample_scales``, or a ``vocoder`` network, or with neither the mel
itself.

Everything runs on ``device`` (``cuda`` unless the caller asks for the CPU).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from msmctts_tpu_torch.config import Config, component_kwargs
from msmctts_tpu_torch.data.datasets import FRAME_BUCKETS, bucket_length
from msmctts_tpu_torch.models.hifigan import receptive_field_frames
from msmctts_tpu_torch.models.msmc_vqgan import MSMCVQGAN, MultiStageQuantizer, _ceil_div, avg_pool_1d
from msmctts_tpu_torch.ops.int8_generator import Int8Decoder
from msmctts_tpu_torch.parallel import mesh
from msmctts_tpu_torch.parallel.precision import cast_parameters_, compute_dtype
from msmctts_tpu_torch.registry import get_network, get_task, register_task
from msmctts_tpu_torch.streaming import StreamingDecoder
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint
from msmctts_tpu_torch.utils.device import exact_fp32, resolve_device
from msmctts_tpu_torch.weights import (
    attr_predictor_from_jax,
    emb_autoencoder_from_jax,
    generator_from_jax,
    load_numpy_state,
    msmc_vqgan_from_jax,
    multi_stage_predictor_from_jax,
    univnet_discriminator_from_jax,
)


def _autoencoder_variables(state: dict, name: str) -> dict:
    """The autoencoder's variables in a JAX checkpoint state: its params and
    the state's codebook and batch-stats collections."""
    return {"params": state["params"][name], "codebook": state.get("codebook") or {},
            "batch_stats": state.get("model_state", {}).get("batch_stats")}


_FROM_JAX = {
    "MSMCVQGAN": lambda state, name, module: msmc_vqgan_from_jax(_autoencoder_variables(state, name)),
    "MSMCVQGANEmb": lambda state, name, module: emb_autoencoder_from_jax(_autoencoder_variables(state, name)),
    "KMeansVQGANEmb": lambda state, name, module: emb_autoencoder_from_jax(_autoencoder_variables(state, name)),
    "EmbVC": lambda state, name, module: emb_autoencoder_from_jax(_autoencoder_variables(state, name)),
    "MultiStagePredictor": lambda state, name, module: multi_stage_predictor_from_jax(state["params"][name]),
    "NASynCascadeFastSpeech": lambda state, name, module: multi_stage_predictor_from_jax(state["params"][name]),
    "AttrPredictor": lambda state, name, module: attr_predictor_from_jax(state["params"][name]),
    "UnivNetDiscriminator": lambda state, name, module: univnet_discriminator_from_jax(
        state["params"][name], periods=module.mpd.periods
    ),
    # a legacy TTS task's vocoder
    "HifiGANGenerator": lambda state, name, module: generator_from_jax(state["params"][name]),
    "MSGenerator": lambda state, name, module: generator_from_jax(state["params"][name]),
    "ISTFTGenerator": lambda state, name, module: generator_from_jax(state["params"][name]),
}


def _build_network(node, device):
    cls = get_network(node["_name"])
    return cls(**component_kwargs(node)).to(device).eval()


def _load_network(module, node_name: str, state: dict, name: str):
    if node_name not in _FROM_JAX:
        raise NotImplementedError(f"no weight mapping for network '{node_name}'")
    load_numpy_state(module, _FROM_JAX[node_name](state, name, module))


# The networks inference runs (the legacy TTS task's acoustic model and
# vocoder among them). Others in a recipe (the GAN discriminator) are
# training state and are built in train mode only.
INFERENCE_NETWORKS = ("autoencoder", "predictor", "acoustic_model", "vocoder")


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


def load_frozen_autoencoder(checkpoint_path: str, config_path: Optional[str] = None, device=None,
                            dtype: torch.dtype = torch.float32):
    """Load a frozen autoencoder, any registered network with a weight
    mapping (``MSMCVQGAN``, ``MSMCVQGANEmb``, ...), in ``eval()`` mode
    (module with weights, config) from a checkpoint, using its embedded
    config when no config file is given; its float parameters rounded to
    ``dtype`` (its codebooks stay fp32)."""
    ckpt = load_checkpoint(checkpoint_path)
    cfg = Config(config_path) if config_path else Config(ckpt["config"])
    node = cfg.task["autoencoder"]
    module = _build_network(node, resolve_device(device))
    _load_network(module, node["_name"], ckpt["state"], "autoencoder")
    return cast_parameters_(module, dtype), cfg


def extract_codebooks(autoencoder) -> list:
    """Coarsest-first list of [H, d, K] codebooks for predictor snapping
    (the reference wires ``predictor.quantizers =
    autoencoder.quantizer.quantizer``)."""
    return [q.embed for q in autoencoder.quantizer.quantizer]


@register_task("MSMCTTS")
@register_task("NASynTTSEmb")  # the QS-TTS recipes' names for the same task
@register_task("NASynTTSv2")
class MSMCTTS(BaseTask):
    def __init__(self, config, device=None, mode: str = "infer"):
        super().__init__(config, device, mode)
        ds = config.dataset
        self.samplerate = ds["samplerate"]
        self.training_mode = config.task.get("_mode", "train_autoencoder")
        self._loaded_modules = False
        self._group = None  # data-parallel inference, see use_mesh
        # When set (frames), predict() uses this one frame bucket and reads
        # nothing back before the waveform (no host bucket pick).
        self.static_max_frames: Optional[int] = None
        # When set (frames), every utterance's frame total is clamped to it
        # (audio past it is truncated): the serving cap.
        self.max_frames_cap: Optional[int] = None
        # Frames of padding the frame bucket keeps after the longest
        # utterance (up to the cap's bucket). Serving sets it to
        # padding_reach_frames(), so that a request decodes the same in any
        # batch; 0, the JAX package's bucket choice, otherwise.
        self.frame_margin: int = 0
        self.shapes: set = set()  # see the module docstring
        self._streamers: Dict[tuple, StreamingDecoder] = {}
        # the opt-in int8 HiFi-GAN decoder (see the module docstring), its
        # SmoothQuant strength (None disables the fold) and the site-name
        # prefixes it keeps in float
        self.int8_decoder: bool = False
        self.int8_smooth_alpha: Optional[float] = 1.0
        self.int8_float_sites: tuple = ()
        self._int8_state: Optional[Int8Decoder] = None
        self.compute_dtype = compute_dtype(config)
        if mode == "infer":  # the JAX task's _cast, before any load: loads then round as they copy
            for module in self.networks.values():
                cast_parameters_(module, self.compute_dtype)

    # -------------------------------------------------------------- mesh
    def use_mesh(self, group) -> "MSMCTTS":
        """Data-parallel inference over ``group``; batch sizes must divide
        by its size. ``None`` returns to one process."""
        self._group = group
        self._int8_state = None
        return self

    def _local_rows(self, batch: dict) -> dict:
        """This rank's block of a global numpy batch."""
        W = mesh.world(self._group)
        B = int(np.asarray(next(iter(batch.values()))).shape[0])
        if B % W:
            raise ValueError(f"batch size {B} does not divide the {W}-rank inference group")
        return mesh.shard_rows({k: np.asarray(v) for k, v in batch.items()}, mesh.rank(self._group), W)

    def _gather(self, t: torch.Tensor) -> np.ndarray:
        """Every rank's rows of ``t`` in rank order, on the host."""
        return mesh.all_gather_rows(t, self._group).cpu().numpy()

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # ------------------------------------------------------------ loading
    def load_variables(self, state: dict):
        """Attach weights from a checkpoint state tree (JAX layout). The int8
        decoder built over the previous weights is dropped: the next batch
        quantizes and calibrates anew (``msmctts_tpu/tasks.py:312-317``)."""
        for name, module in self.networks.items():
            if name in state.get("params", {}):
                _load_network(module, self.network_configs[name]["_name"], state, name)
        self._int8_state = None

    def pre_infer(self):
        self._loaded_modules = True
        node = self.config.task.get("autoencoder", {})
        if "_checkpoint" in node and "autoencoder" not in self.networks:
            module, _ = load_frozen_autoencoder(node["_checkpoint"], node.get("_config"), self.device,
                                                self.compute_dtype)
            self.networks["autoencoder"] = module

    # ------------------------------------------------------------- infer
    def infer_step(self, batch: dict) -> dict:
        if self.training_mode == "train_autoencoder":
            return self.analysis_synthesis(batch)
        if not self._loaded_modules:
            self.pre_infer()
        return self.predict(batch)

    def debug_step(self, batch: dict) -> dict:
        """``infer --debug`` (``msmctts_tpu/tasks.py:343-366``): ``infer_step``'s
        outputs and, in the autoencoder mode, the per-stage codeword
        ``indices`` [B, T_i, H] and quantized ``embedding`` [B, T_i, H * d]
        of ``analysis`` (coarsest first, numpy), for inspecting the
        representation. Over an SSL-embedding autoencoder it raises: the JAX
        package's runs the mel ``analysis`` there too, which that family
        does not have."""
        ae = self.networks.get("autoencoder")
        if self.training_mode == "train_autoencoder" and not isinstance(ae, MSMCVQGAN):
            raise NotImplementedError(f"debug_step reads a mel analysis; a {type(ae).__name__} has none")
        out = self.infer_step(batch)
        if self.training_mode == "train_autoencoder":
            local = self._local_rows({k: batch[k] for k in ("mel", "mel_length")})
            with torch.inference_mode():
                q = ae.analysis(self._tensor(local["mel"], torch.float32), self._tensor(local["mel_length"], torch.long))
            out["indices"] = [self._gather(x).astype(np.int32) for x in q["quantizer_indices"]]
            out["embedding"] = [self._gather(x) for x in q["quantizer_outputs"]]
        return out

    def padding_reach_frames(self) -> int:
        """How many frames of the padding after an utterance reach its
        waveform, which the frame bucket otherwise decides: the decoder's
        activations over padded frames are not the zeros its convs pad with
        at the end of the bucket (its receptive field, plus the iSTFT window
        of an ``ISTFTGenerator``), and the autoencoder's residual chain
        convolves the padded residual in its prior predictors and learned
        upsamplers, as the JAX package's does
        (``MultiStageQuantizer.padding_reach_frames``). A frame decoder
        zeroes the padded frames between the two, so the larger reach
        counts; without one the two add up. An utterance followed by at
        least this many padded frames decodes the same in any larger bucket.
        Loads the frozen autoencoder, as the first ``infer_step`` would."""
        if self.training_mode != "train_autoencoder" and not self._loaded_modules:
            self.pre_infer()
        ae = self.networks.get("autoencoder")
        if ae is None:
            return 0
        cfg = ae.decoder_config
        reach = receptive_field_frames(cfg)
        if cfg.get("_name") == "ISTFTGenerator":
            spec_frames = math.prod(int(u) for u in cfg["upsample_rates"])
            reach += -(-int(cfg.get("istft_n_fft", 40)) // (int(cfg.get("istft_hop", 10)) * spec_frames))
        if isinstance(getattr(ae, "quantizer", None), MultiStageQuantizer):
            chain = ae.quantizer.padding_reach_frames()
            reach = max(reach, chain) if getattr(ae, "frame_decoder", None) is not None else reach + chain
        return reach

    def _int8(self) -> Int8Decoder:
        """The int8 decoder over the autoencoder's trained decoder, built at
        first use (``msmctts_tpu/tasks.py:367-387``)."""
        if self._int8_state is None:
            ae = self.networks["autoencoder"]
            if not isinstance(ae, MSMCVQGAN):
                raise NotImplementedError("int8 PTQ is wired for the mel autoencoder path only")
            name = ae.decoder_config.get("_name", "HifiGANGenerator")
            if name != "HifiGANGenerator":
                raise NotImplementedError(f"int8 PTQ kernels cover the HifiGANGenerator decoder only, not {name}")
            self._int8_state = Int8Decoder(ae.decoder, ae.decoder_config, dtype=self.compute_dtype,
                                           smooth_alpha=self.int8_smooth_alpha, float_sites=self.int8_float_sites)
        return self._int8_state

    def _calibrate_int8(self, feats):
        """Calibrate the int8 decoder on the first batch's decoder inputs: the
        global batch's, gathered to every rank under a group (the JAX
        package calibrates on the globally sharded array,
        ``msmctts_tpu/tasks.py:409-410, 734-738``)."""
        i8 = self._int8()
        if i8.scales is None:
            i8.calibrate(mesh.all_gather_rows(feats, self._group))
        return i8

    def _decode(self, feats):
        """Decoder input features [B, T, C] -> waveform [B, T * ratio]: the
        autoencoder's decoder, or the int8 one, calibrated on the first batch
        it decodes."""
        if not self.int8_decoder:
            return self.networks["autoencoder"].decoder(feats)[..., 0]
        return self._calibrate_int8(feats).apply(feats)[..., 0].float()

    @torch.inference_mode()
    def analysis_synthesis(self, batch: dict) -> dict:
        """Full AE round trip: mel [B, T, n_mel] -> wav per utterance; an
        ``emb`` batch goes to :meth:`_analysis_synthesis_emb`."""
        ae = self.networks["autoencoder"]
        if ae.training:
            raise RuntimeError("analysis_synthesis needs the autoencoder in eval() mode")
        if "emb" in batch:
            return self._analysis_synthesis_emb(batch)
        T = int(batch["mel"].shape[1])
        local = self._local_rows(batch)
        mel, mel_length = self._tensor(local["mel"], torch.float32), self._tensor(local["mel_length"], torch.long)
        self.shapes.add(("ae8" if self.int8_decoder else "ae", T))
        wav = self._gather(self._decode(ae.encode_features(mel, mel_length)))
        ratio = wav.shape[1] // T
        return {
            "wav": [w[: int(l) * ratio] for w, l in zip(wav, batch["mel_length"])],
            "mel_length": batch["mel_length"],
        }

    def _analysis_synthesis_emb(self, batch: dict) -> dict:
        """The round trip of an SSL-embedding autoencoder (``MSMCVQGANEmb``
        and its family): emb [B, T, d] with ``pitch`` / ``energy`` (pitch
        conditioning) and ``mel`` (the global speaker encoder's reference)
        where the batch has them -> wav per utterance, trimmed to
        ``emb_length`` x the decoder's ratio (``msmctts_tpu/tasks.py:446-484``)."""
        if self.int8_decoder:
            raise NotImplementedError("int8 PTQ is wired for the mel autoencoder path only")
        ae = self.networks["autoencoder"]
        T = int(batch["emb"].shape[1])
        opt = tuple(k for k in ("pitch", "energy", "mel") if k in batch)
        self.shapes.add(("ae_emb", T, opt))
        local = self._local_rows({k: batch[k] for k in ("emb", "emb_length", *opt)})
        kw = {k: self._tensor(local[k], torch.float32) for k in opt}
        out = ae(self._tensor(local["emb"], torch.float32), self._tensor(local["emb_length"], torch.long), **kw)
        wav = self._gather(out["decoder_outputs"][..., 0])
        ratio = wav.shape[1] // T
        return {
            "wav": [w[: int(l) * ratio] for w, l in zip(wav, batch["emb_length"])],
            "mel_length": batch["emb_length"],
        }

    @torch.inference_mode()
    def _predict_phase1(self, batch: dict) -> dict:
        """Durations (predicted, or forced by ``dur`` in the batch), rounded
        and masked, of this rank's rows, and the global batch's frame
        bucket: the largest frame total (clamped to ``max_frames_cap``)
        rounded up to ``FRAME_BUCKETS``, at least lcm(n_pred_scale).
        ``total`` covers the global batch; with ``static_max_frames`` and
        predicted durations it is None, the bucket is the static one, and
        the totals stay on the device (``total_dev``, this rank's rows)."""
        predictor = self.networks["predictor"]
        scales = list(predictor.n_pred_scale)
        lcm = math.lcm(*scales) if scales else 1
        text = self._tensor(batch["text"], torch.long)
        text_length = self._tensor(batch["text_length"], torch.long)
        Lt = int(text.shape[1])
        cap = int(self.max_frames_cap) if self.max_frames_cap else None
        total_dev = None
        if "dur" in batch:
            given = np.asarray(batch["dur"], np.float32)
            mask = np.arange(given.shape[1])[None, :] < np.asarray(batch["text_length"])[:, None]
            given = np.round(np.maximum(given, 0.0)) * mask
            durations = self._tensor(given, torch.float32)
            total = given.sum(axis=1).astype(np.int64)
            if cap:
                total = np.minimum(total, cap)
        else:
            self.shapes.add(("dur", Lt))
            dur = predictor.predict_durations(text, text_length)
            mask = torch.arange(dur.shape[1], device=self.device)[None, :] < text_length[:, None]
            durations = dur * mask
            total_dev = durations.sum(dim=1).long()
            if self.static_max_frames is not None:
                total = None  # nothing crosses to the host before the waveform
            else:
                total = total_dev.cpu().numpy()  # one small D2H
                if cap:
                    total = np.minimum(total, cap)
        if total is not None and mesh.world(self._group) > 1:  # one bucket for the whole batch
            total = self._gather(torch.as_tensor(total, device=self.device))
        if total is None:
            max_frames = bucket_length(max(int(self.static_max_frames), lcm), FRAME_BUCKETS)
        else:
            max_frames = bucket_length(max(int(total.max()) + self.frame_margin, lcm), FRAME_BUCKETS)
            if cap:  # the margin never opens a bucket past the cap's
                max_frames = min(max_frames, bucket_length(max(cap, lcm), FRAME_BUCKETS))
        return dict(text=text, text_length=text_length, Lt=Lt, durations=durations, total=total,
                    total_dev=total_dev, max_frames=max_frames)

    def _totals(self, p1: dict) -> np.ndarray:
        """The global batch's frame totals, at most the frame bucket (read
        from the device in static-frames mode)."""
        total = p1["total"]
        if total is None:
            total = self._gather(p1["total_dev"])
        return np.minimum(total.astype(np.int64), p1["max_frames"])

    @torch.inference_mode()
    def predict_features(self, batch: dict):
        """Phases 1-2 of ``predict`` up to (excluding) the HiFi-GAN decoder,
        on this rank's rows. Returns ``(p1, out, feats)`` with ``feats``
        [B, max_frames, C] left on the device: the streaming decode slices
        its windows out of it."""
        predictor = self.networks["predictor"]
        ae = self.networks["autoencoder"]
        p1 = self._predict_phase1(self._local_rows(batch))
        out = predictor(
            p1["text"], p1["text_length"], dur=p1["durations"],
            max_frames=p1["max_frames"], codebooks=extract_codebooks(ae),
        )
        return p1, out, ae.synthesis_features(out["feat"], out["feat_length"])

    @torch.inference_mode()
    def predict(self, batch: dict) -> dict:
        """text -> MSMCR -> waveform (msmc_tts.py:109-127)."""
        p1, out, feats = self.predict_features(batch)
        self.shapes.add(("syn8" if self.int8_decoder else "syn", p1["Lt"], p1["max_frames"]))
        wav = self._gather(self._decode(feats))
        fine = self._gather(out["feat"][-1])
        total = self._totals(p1)
        ratio = wav.shape[1] // fine.shape[1]
        wav_lengths = (total * ratio).astype(np.int64)
        return {
            "wav": [w[:l] for w, l in zip(wav, wav_lengths)],
            "embedding": [f[: int(t)] for f, t in zip(fine, total)],
            "duration": self._gather(p1["durations"]),
            "mel_length": total,
        }

    def _streaming_decoder(self, chunk_frames: int) -> StreamingDecoder:
        """The cached StreamingDecoder of the autoencoder's HiFi-GAN decoder,
        fp32 or int8, for one chunk size. It reaches the decoder through the
        module (fp32) or the task's current int8 decoder (int8), so a weight
        reload reaches it. Only a ``HifiGANGenerator`` streams
        (``msmctts_tpu/tasks.py:615-620``)."""
        key = (chunk_frames, bool(self.int8_decoder))
        sd = self._streamers.get(key)
        if sd is None:
            ae = self.networks["autoencoder"]
            name = ae.decoder_config.get("_name", "HifiGANGenerator")
            if name != "HifiGANGenerator":
                raise NotImplementedError(
                    f"streaming decode implements the HifiGANGenerator receptive-field contract only, not {name}; "
                    "the ISTFT decoder is already tail-cheap: use the monolithic path"
                )
            if self.int8_decoder:
                sd = StreamingDecoder.from_feature_fn(lambda f: self._int8().apply(f).float(), ae.decoder_config,
                                                      chunk_frames)
            else:
                sd = StreamingDecoder.from_generator(ae.decoder, ae.decoder_config, chunk_frames)
            self._streamers[key] = sd
        return sd

    def predict_stream(self, batch: dict, chunk_frames: int = 64):
        """Streaming synthesis for low time-to-first-audio: text -> MSMCR ->
        waveform CHUNKS, whose concatenation is the monolithic decode.

        Returns ``(meta, chunks)``: ``meta`` has per-utterance
        ``wav_length`` / ``mel_length`` (host ints, for trimming), ``hop``
        and ``duration``; ``chunks`` is a generator of float32
        [B, <=chunk_frames*hop] arrays, left to right. Utterance i's samples
        are the first ``wav_length[i]`` of the concatenation. It stops once
        every utterance is covered: the padded tail of the frame bucket is
        never decoded. Each step of the generator runs under its own
        ``torch.inference_mode()`` (``StreamingDecoder.stream`` takes it per
        step), in whichever thread consumes it. Under a group each rank
        decodes the windows of its own rows and every chunk is gathered in
        rank order, so every rank yields the global batch's chunks (and
        must drain them: each is a collective)."""
        ae = self.networks.get("autoencoder")
        if ae is not None and not isinstance(ae, MSMCVQGAN):
            raise NotImplementedError(
                f"streaming over a {type(ae).__name__} autoencoder: the JAX package has no such path either "
                "(its predict_stream runs the autoencoder's synthesis_features, which the SSL-embedding family lacks)"
            )
        sd = self._streaming_decoder(chunk_frames)
        p1, _, feats = self.predict_features(batch)
        if self.int8_decoder:
            self._calibrate_int8(feats)
        self.shapes.add(("stream8" if self.int8_decoder else "stream", chunk_frames, p1["Lt"], p1["max_frames"]))
        total = self._totals(p1)
        wav_length = total * sd.hop
        meta = {
            "mel_length": total,
            "wav_length": wav_length,
            "hop": sd.hop,
            "duration": self._gather(p1["durations"]),
        }

        def chunks():
            need = int(wav_length.max())
            produced = 0
            for chunk in sd.stream(feats):
                if mesh.world(self._group) > 1:
                    chunk = self._gather(torch.as_tensor(chunk, device=self.device))
                yield chunk
                produced += chunk.shape[1]
                if produced >= need:
                    return

        return meta, chunks()


@register_task("TTS")
class TTS(BaseTask):
    """The legacy v1 task (``msmctts_tpu/tasks.py:100-198``): an
    ``acoustic_model`` network takes the batch and gives a mel (or a dict
    with ``mel`` and ``mel_length``); the autoencoder, where the task has
    one with loaded weights, synthesizes from it, else a ``vocoder``
    network, else the mel is the output. Its networks are loaded with the
    state's params and codebook, as the JAX task loads them; it keeps no
    precision policy, as that one keeps none."""

    def __init__(self, config, device=None, mode: str = "infer"):
        super().__init__(config, device, mode)
        self.samplerate = config.dataset["samplerate"]
        self.loaded: set = set()  # networks with weights

    def load_variables(self, state: dict):
        for name, module in self.networks.items():
            if name in state.get("params", {}):
                _load_network(module, self.network_configs[name]["_name"], state, name)
                self.loaded.add(name)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _synthesize(self, mel, mel_length):
        """The mel split into one chunk of channels per stage, each pooled
        by the cumulative ``downsample_scales`` (``msmctts_tpu/tasks.py:158-176``),
        through the autoencoder's ``synthesis`` -> [B, T * ratio, 1]."""
        ae = self.networks["autoencoder"]
        scales = list(ae.encoder.downsample_scales)
        C = mel.shape[-1]
        if C % len(scales):
            raise ValueError(f"a mel of {C} channels does not split into {len(scales)} stages")
        preds, lengths, cum = [], [], 1
        for scale, chunk in zip(scales, mel.split(C // len(scales), dim=-1)):
            cum *= scale
            preds.append(avg_pool_1d(chunk, cum))
            lengths.append(_ceil_div(mel_length, cum))
        return ae.synthesis(preds[::-1], lengths[::-1])

    @torch.inference_mode()
    def infer_step(self, batch: dict) -> dict:
        mel_length = np.asarray(batch.get("mel_length", batch.get("text_length")))
        am_out = self.networks["acoustic_model"](**{k: self._tensor(v) for k, v in batch.items()})
        out = {}
        if isinstance(am_out, dict):
            mel = am_out["mel"]
            out["mel_length"] = np.asarray(am_out["mel_length"].cpu() if "mel_length" in am_out else mel_length)
        else:
            mel = am_out
            out["mel_length"] = mel_length
        if "autoencoder" in self.networks and "autoencoder" in self.loaded:
            wav = self._synthesize(mel, self._tensor(mel_length).long())
        elif "vocoder" in self.networks and "vocoder" in self.loaded:
            wav = self.networks["vocoder"](mel)
        else:
            mel = mel.float().cpu().numpy()
            out["mel"] = [m[: int(l)] for m, l in zip(mel, out["mel_length"])]
            return out
        wav = wav.float().cpu().numpy()
        ratio = wav.shape[1] // mel.shape[1]
        out["wav"] = [w[: int(l) * ratio, 0] for w, l in zip(wav, out["mel_length"])]
        return out
