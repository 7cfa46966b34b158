"""Exported TTS artifacts (the counterpart of ``msmctts_tpu/export.py``).

The whole text -> waveform program of an infer-mode ``MSMCTTS`` task, with
its weights embedded, as one ``torch.export`` program per (batch, text
bucket) and device, saved as a ``.pt2`` file: duration prediction, length
regulation, the multi-stage cascade with its codebook snaps and the
HiFi-GAN decode, in one call that returns nothing to the host before the
waveform. A serving runtime loads it with no model code, config or
checkpoint (``ExportedTTS``).

    forward(text[B, Lt, S] int32, text_length[B] int32) ->
        (wav[B, max_frames * ratio] f32, wav_length[B] i32, mel_length[B] i32)

The program is ``MSMCTTS.predict`` in ``static_max_frames`` mode at the
export's frame count. On the card its snaps and MRF layers launch the
port's kernels through their operators (``msmctts::vq_nearest``,
``msmctts::fused_resblock_layer``; ``ops/cuda_build.py``), and an ``--int8``
artifact's products go through ``msmctts::int8_conv1d``. The quantized
kernels and static activation scales of a calibrated ``Int8Decoder``
freeze into it.

``save_artifacts`` writes ``tts_b{B}_l{Lt}_f{F}.{platform}.pt2`` per text
bucket and platform (``cpu``, ``cuda``) and a ``manifest.json`` with the JAX
package's keys. ``ExportedTTS(art_dir, device)`` loads each bucket's program
at its first use (once per process: deserializing a program takes seconds)
and serves it to ``serving.BatchingEngine``
(``infer_step``, ``n_streams``, ``buckets``). This module imports the
port's operators and nothing of its models at import time; the export side
imports the task layer when it is called.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

# the operators an exported program calls: importing registers them
from msmctts_tpu_torch.ops import int8_generator as _int8_ops  # noqa: F401
from msmctts_tpu_torch.ops import resblock as _resblock_ops  # noqa: F401
from msmctts_tpu_torch.ops import vq as _vq_ops  # noqa: F401

MANIFEST = "manifest.json"
KIND = "msmctts-tpu torch.export tts"
PLATFORMS = ("cpu", "cuda")
# loaded programs by file (path, mtime, size): a process that opens one
# artifact twice (a check, then a daemon) deserializes each program once
_PROGRAMS: dict = {}


def _flatten(tree: dict, prefix: str, out: dict) -> dict:
    """A nested dict of tensors (or None) -> {buffer name: tensor} and the
    same nesting with each leaf replaced by its buffer name (or None)."""
    spec = {}
    for k, v in tree.items():
        name = f"{prefix}__{k}".replace("/", "_")
        if isinstance(v, dict):
            spec[k] = _flatten(v, name, out)
        elif v is None:
            spec[k] = None
        else:
            out[name] = v
            spec[k] = name
    return spec


class TTSProgram(torch.nn.Module):
    """The text -> waveform function of a loaded infer-mode ``MSMCTTS``
    task (``msmctts_tpu/export.py::build_tts_fn``). Its modules and buffers
    are the task's, so the program's weights are the task's weights; with
    ``int8`` the calibrated int8 decoder's quantized kernels and static
    scales are buffers of its own."""

    def __init__(self, task, max_frames: int, int8: bool = False):
        super().__init__()
        from msmctts_tpu_torch.models.hifigan import generator_upsample_ratio

        if not task._loaded_modules:
            task.pre_infer()
        self.predictor = task.networks["predictor"]
        self.autoencoder = task.networks["autoencoder"]
        self.max_frames = int(max_frames)
        self.hop = generator_upsample_ratio(self.autoencoder.decoder_config)
        self.int8 = bool(int8)
        if int8:
            i8 = task._int8()
            if i8.scales is None:
                raise ValueError("int8 export needs calibrated activation scales: run one inference with "
                                 "task.int8_decoder = True first")
            device = next(self.autoencoder.parameters()).device
            buffers: dict = {}
            self._qspec = _flatten(i8._on("qparams", device), "i8q", buffers)
            scales = {site: {"s": s, "inv": inv} for site, (s, inv) in i8._on("scales", device).items()}
            self._sspec = _flatten(scales, "i8s", buffers)
            for name, t in buffers.items():
                self.register_buffer(name, t)
            self._i8_config = i8.decoder_config
            self._i8_dtype = i8.dtype

    def _tree(self, spec: dict) -> dict:
        return {k: (self._tree(v) if isinstance(v, dict) else None if v is None else getattr(self, v))
                for k, v in spec.items()}

    def _decode(self, feats):
        if not self.int8:
            return self.autoencoder.decoder(feats)[..., 0]
        from msmctts_tpu_torch.ops.int8_generator import int8_generator_apply

        scales = {site: (v["s"], v["inv"]) for site, v in self._tree(self._sspec).items()}
        wav = int8_generator_apply(self._tree(self._qspec), feats, self._i8_config, act_scales=scales,
                                   dtype=self._i8_dtype)
        return wav[..., 0].float()

    def forward(self, text, text_length):
        from msmctts_tpu_torch.tasks import extract_codebooks

        text, text_length = text.long(), text_length.long()
        dur = self.predictor.predict_durations(text, text_length)  # rounded, at least 0
        mask = torch.arange(dur.shape[1], device=dur.device)[None, :] < text_length[:, None]
        dur = dur * mask
        total = dur.sum(dim=1).long()
        out = self.predictor(text, text_length, dur=dur, max_frames=self.max_frames,
                             codebooks=extract_codebooks(self.autoencoder))
        wav = self._decode(self.autoencoder.synthesis_features(out["feat"], out["feat_length"]))
        mel_length = torch.clamp(total, max=self.max_frames)
        # frames are the finest stage's; the waveform's samples per frame come
        # from the traced shapes (msmctts_tpu/export.py:96-103)
        ratio = wav.shape[1] // out["feat"][-1].shape[1]
        return wav.float(), (mel_length * ratio).int(), mel_length.int()


def build_tts_fn(task, max_frames: int, int8: bool = False) -> TTSProgram:
    """The program of ``task`` at ``max_frames`` frames, in ``eval()``."""
    return TTSProgram(task, max_frames, int8=int8).eval()


def _n_streams(task) -> int:
    n_symbols = task.networks["predictor"].n_symbols
    return len(n_symbols) if isinstance(n_symbols, (list, tuple)) else 1


def export_tts(task, batch_size: int, text_length: int, max_frames: int, int8: bool = False,
               program: Optional[TTSProgram] = None, device=None):
    """``torch.export`` of the (B, Lt, F) program on ``device`` (the task's,
    where ``program`` is not given) -> ``torch.export.ExportedProgram``."""
    program = program or build_tts_fn(task, max_frames, int8=int8)
    device = task.device if device is None else device
    args = (torch.ones((batch_size, text_length, _n_streams(task)), dtype=torch.int32, device=device),
            torch.full((batch_size,), text_length, dtype=torch.int32, device=device))
    with torch.no_grad():
        return torch.export.export(program, args, strict=False)


def artifact_name(batch_size: int, text_length: int, max_frames: int, platform: str) -> str:
    return f"tts_b{batch_size}_l{text_length}_f{max_frames}.{platform}.pt2"


def save_artifacts(task, out_dir: str, batch_size: int, text_lengths: Sequence[int], max_frames: int,
                   sample_rate: int, platforms: Sequence[str] = PLATFORMS, int8: bool = False) -> dict:
    """One program per text bucket and platform, and the manifest. A
    platform other than the task's device is exported from a copy of the
    program moved there. Returns the manifest; its ``export_s`` holds the
    seconds each file took."""
    platforms = list(platforms)
    for p in platforms:
        if p not in PLATFORMS:
            raise ValueError(f"unknown platform {p!r}: the port exports for {PLATFORMS}")
    os.makedirs(out_dir, exist_ok=True)
    import copy
    import time

    program = build_tts_fn(task, max_frames, int8=int8)
    modules, seconds = {}, {}
    for platform in platforms:
        here = torch.device(task.device).type == platform
        prog = program if here else copy.deepcopy(program).to(platform)
        device = task.device if here else torch.device(platform)
        for lt in sorted(set(int(l) for l in text_lengths)):
            t0 = time.perf_counter()
            ep = export_tts(task, batch_size, lt, max_frames, program=prog, device=device)
            name = artifact_name(batch_size, lt, max_frames, platform)
            torch.export.save(ep, os.path.join(out_dir, name))
            modules.setdefault(str(lt), {})[platform] = name
            seconds[name] = time.perf_counter() - t0
    manifest = {
        "kind": KIND,
        "batch_size": int(batch_size),
        "max_frames": int(max_frames),
        "hop": int(program.hop),
        "sample_rate": int(sample_rate),
        "n_streams": _n_streams(task),
        "platforms": platforms,
        "int8": bool(int8),
        "modules": modules,
        "io": "forward(text[B,Lt,S] i32, text_length[B] i32) -> "
              "(wav[B, max_frames*ratio] f32, wav_length[B] i32, mel_length[B] i32)",
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return dict(manifest, export_s=seconds)


class ExportedTTS:
    """Synthesis from a ``save_artifacts`` directory on ``device``: no model
    code, config or checkpoint; each text bucket's program loads at its first
    use. The engine's task surface (``infer_step``, ``n_streams``,
    ``buckets``), so ``BatchingEngine`` and ``serve --artifact`` run on it.
    Batch size and text buckets are the export's; streaming needs the task
    path (an exported program is one monolithic decode)."""

    def __init__(self, art_dir: str, device="cuda"):
        from msmctts_tpu_torch.utils.device import exact_fp32, resolve_device

        with open(os.path.join(art_dir, MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("kind") != KIND:
            raise ValueError(f"{art_dir} is not a {KIND} artifact (kind {self.manifest.get('kind')!r})")
        self.dir = art_dir
        self.device = resolve_device(device)
        exact_fp32()  # the programs' cuDNN convs and products in fp32, as the task runs them
        self.platform = self.device.type
        if self.platform not in self.manifest["platforms"]:
            raise ValueError(f"{art_dir} holds no {self.platform} programs (platforms "
                             f"{self.manifest['platforms']})")
        self.batch_size = int(self.manifest["batch_size"])
        self.max_frames = int(self.manifest["max_frames"])
        self.sample_rate = int(self.manifest["sample_rate"])
        self.n_streams = int(self.manifest.get("n_streams", 1))
        self.buckets = sorted(int(k) for k in self.manifest["modules"])
        self.shapes: set = set()  # ("exported", Lt) per bucket run, as MSMCTTS.shapes

    def _module(self, lt: int):
        path = os.path.abspath(os.path.join(self.dir, self.manifest["modules"][str(lt)][self.platform]))
        st = os.stat(path)
        key = (path, st.st_mtime_ns, st.st_size)
        mod = _PROGRAMS.get(key)
        if mod is None:
            mod = _PROGRAMS[key] = torch.export.load(path).module()
        return mod

    def run(self, text, text_length):
        """The program of ``text``'s bucket on a padded batch -> (wav [B, S],
        wav_length [B], mel_length [B]) as device tensors."""
        lt = int(text.shape[1])
        if lt not in self.buckets:
            raise ValueError(f"no exported module for text length {lt}; have {self.buckets}")
        if int(text.shape[0]) != self.batch_size:
            raise ValueError(f"the artifact takes batches of {self.batch_size}, got {int(text.shape[0])}")
        text = torch.as_tensor(np.asarray(text), dtype=torch.int32, device=self.device)
        text_length = torch.as_tensor(np.asarray(text_length), dtype=torch.int32, device=self.device)
        with torch.no_grad():
            out = self._module(lt)(text, text_length)
        self.shapes.add(("exported", lt))
        return out

    def synthesize(self, text, text_length):
        """A padded batch in, each utterance's float32 waveform out."""
        wav, wav_length, _ = self.run(text, text_length)
        wav, wav_length = wav.cpu().numpy(), wav_length.cpu().numpy()
        return [w[:n] for w, n in zip(wav, wav_length)]

    # the engine's task surface (serving.BatchingEngine reads ``exported``
    # once: no networks, frame buckets, streaming or reload)
    exported = True

    def infer_step(self, batch: dict) -> dict:
        return {"wav": self.synthesize(batch["text"], batch["text_length"])}

    def predict_stream(self, batch: dict, chunk_frames: int = 64):
        raise NotImplementedError("streaming needs the task path (serve -m <checkpoint>); "
                                  "an exported program is one monolithic decode")
