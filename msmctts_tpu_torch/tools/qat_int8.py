"""Int8 QAT fine-tune of a trained MSMC-VQ-GAN's HiFi-GAN decoder
(counterpart of the root ``tools/qat_int8.py``):

    python -m msmctts_tpu_torch.tools.qat_int8 --ckpt <model_N> --id-list train.list \\
        [--out <model_N>_qat] [--steps 2000] [--batch 8] [--window-frames 64] [--lr 1e-5] \\
        [--refresh-every 500] [--smooth-alpha 1.0] [--seed 0] [--device cpu]

It distills the decoder's own float output, so nothing else in the
checkpoint moves (encoder, quantizer, codebooks), through the serving
quantization grid (``ops/qat_int8.py``): the decoder inputs and float
targets of each utterance come from the autoencoder in ``eval()``
(``encode_features``, then the decoder: the card's VQ and MRF kernels);
windows of ``--window-frames`` frames are drawn from
``numpy.random.default_rng(--seed)`` in the JAX tool's order, so one seed
draws the same windows in both packages; each step is one Adam step
(``torch.optim.Adam``, optax's ``adam``) over the folded kernels on the
log-mel L1 (``training/losses.mel_loss``) plus ``--l1`` x the waveform L1;
the calibration is re-derived from the current weights every
``--refresh-every`` steps. The fake-quant log-mel gap on 4 fixed windows
is printed before and after, the fine-tuned kernels are written back into
the weight-norm pairs of a new standard checkpoint, which serves through
``infer`` / ``serve --int8`` unchanged, and the last line is the JAX
tool's JSON line. Runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from msmctts_tpu_torch.config import Config
from msmctts_tpu_torch.data.loader import finite_loader
from msmctts_tpu_torch.ops.qat_int8 import (
    calibrate_from_folded,
    fold_decoder_params,
    qat_generator_apply,
    unfold_to_weight_norm,
)
from msmctts_tpu_torch.tasks import build_task
from msmctts_tpu_torch.training.base_trainer import build_dataset_from_config
from msmctts_tpu_torch.training.losses import mel_loss
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from msmctts_tpu_torch.utils.device import resolve_device

EVAL_SEED = 12345  # the 4 fixed windows of the gap, as the JAX tool draws them
EVAL_BATCHES = 4


@torch.inference_mode()
def precompute(autoencoder, dataset, max_utts: int, hop: int, device):
    """Per utterance: the decoder's input features [T, C] and the float
    decoder's waveform [T * hop] (numpy), through the autoencoder in
    ``eval()``, one utterance at a time, at most ``max_utts``."""
    feats_db, wav_db = [], []
    for batch in finite_loader(dataset, 1):
        T = int(batch["mel_length"][0])
        mel = torch.as_tensor(np.asarray(batch["mel"]), dtype=torch.float32, device=device)
        length = torch.as_tensor(np.asarray(batch["mel_length"]), dtype=torch.long, device=device)
        f = autoencoder.encode_features(mel, length)
        w = autoencoder.decoder(f)[..., 0]
        feats_db.append(f[0, :T].float().cpu().numpy())
        wav_db.append(w[0, : T * hop].float().cpu().numpy())
        if len(feats_db) >= max_utts:
            break
    return feats_db, wav_db


def sample_windows(rng, feats_db, wav_db, batch: int, W: int, hop: int):
    """``batch`` windows of ``W`` frames (features) and ``W * hop`` samples
    (targets) from ``rng``, in the JAX tool's order of draws; an utterance
    shorter than W is tiled."""
    fw = np.empty((batch, W, feats_db[0].shape[-1]), np.float32)
    ww = np.empty((batch, W * hop), np.float32)
    for b in range(batch):
        i = int(rng.integers(len(feats_db)))
        T = feats_db[i].shape[0]
        s = int(rng.integers(max(T - W, 1))) if T > W else 0
        if T >= W:
            fw[b] = feats_db[i][s: s + W]
            ww[b] = wav_db[i][s * hop: (s + W) * hop]
        else:
            reps = -(-W // T)
            fw[b] = np.tile(feats_db[i], (reps, 1))[:W]
            ww[b] = np.tile(wav_db[i], reps)[: W * hop]
    return fw, ww


class QAT:
    """The fine-tune's state: the folded kernels (trainable leaves on
    ``device``), their Adam moments and the current calibration (static
    scales and SmoothQuant vectors, as device tensors)."""

    def __init__(self, folded: dict, decoder_config: dict, sample_rate: int, lr: float, l1: float,
                 smooth_alpha, calib_feats):
        self.folded = {site: {k: None if v is None else v.detach().clone().requires_grad_(True)
                              for k, v in node.items()} for site, node in folded.items()}
        self.decoder_config = decoder_config
        self.sample_rate = int(sample_rate)
        self.l1 = float(l1)
        self.smooth_alpha = smooth_alpha
        self.calib_feats = calib_feats
        self.device = calib_feats.device
        self.opt = torch.optim.Adam(self.leaves(), lr=lr)
        self.calibrate()

    def leaves(self):
        return [v for node in self.folded.values() for v in node.values() if v is not None]

    def calibrate(self):
        """Re-derive the grid from the current weights, as a fresh serving
        calibration on them would."""
        self._set_grid(*calibrate_from_folded(self.folded, self.calib_feats, self.decoder_config,
                                              smooth_alpha=self.smooth_alpha))

    def _set_grid(self, scales: dict, smooth):
        self.scales, self.smooth = scales, smooth
        self._scales = {k: torch.full((), float(np.float32(v)), device=self.device) for k, v in self.scales.items()}
        self._smooth = {k: torch.as_tensor(v, device=self.device) for k, v in (self.smooth or {}).items()}

    def forward(self, fw):
        return qat_generator_apply(self.folded, fw, self.decoder_config, self._scales, self._smooth)[..., 0]

    def _tensors(self, fw, ww):
        return (torch.as_tensor(fw, dtype=torch.float32, device=self.device),
                torch.as_tensor(ww, dtype=torch.float32, device=self.device))

    def step(self, fw, ww) -> torch.Tensor:
        """One Adam step on a window batch; returns [mel loss, waveform L1]
        (detached, on the device)."""
        fw, ww = self._tensors(fw, ww)
        self.opt.zero_grad(set_to_none=True)
        y = self.forward(fw)
        ml = mel_loss(y, ww, self.sample_rate)
        l1 = torch.mean(torch.abs(y - ww))
        (ml + self.l1 * l1).backward()
        self.opt.step()
        return torch.stack([ml, l1]).detach()

    @torch.no_grad()
    def gap(self, batches) -> float:
        """Mean fake-quant log-mel L1 against the float targets over
        ``batches`` of windows."""
        vals = []
        for fw, ww in batches:
            fw, ww = self._tensors(fw, ww)
            vals.append(float(mel_loss(self.forward(fw), ww, self.sample_rate)))
        return float(np.mean(vals))


def run(qat: QAT, feats_db, wav_db, steps: int, batch: int, W: int, hop: int, refresh_every: int, seed: int,
        log_every: int = 0, on_step=None) -> int:
    """The fine-tune's loop: ``steps`` Adam steps on windows drawn from
    ``numpy.random.default_rng(seed)``, the calibration refreshed every
    ``refresh_every`` steps but the last and once after the last.
    ``on_step(step, metrics)`` is called after each step (before its
    refresh). Returns the number of refreshes inside the loop."""
    rng = np.random.default_rng(seed)
    refreshes = 0
    t0 = time.time()
    for step in range(1, steps + 1):
        m = qat.step(*sample_windows(rng, feats_db, wav_db, batch, W, hop))
        if on_step is not None:
            on_step(step, m)
        if step % refresh_every == 0 and step < steps:
            qat.calibrate()
            refreshes += 1
        if log_every and step % log_every == 0:
            m = m.cpu().numpy()
            print(f"[qat] step {step} mel={m[0]:.4f} l1={m[1]:.5f} ({step / (time.time() - t0):.1f} steps/s)",
                  flush=True)
    qat.calibrate()
    return refreshes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="trained AE checkpoint")
    ap.add_argument("--id-list", required=True, help="training id list (corpus train.list)")
    ap.add_argument("--out", default=None, help="output checkpoint path (default <ckpt>_qat)")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--window-frames", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--l1", type=float, default=0.1, help="waveform L1 weight next to the log-mel L1")
    ap.add_argument("--max-utts", type=int, default=160)
    ap.add_argument("--log-every", type=int, default=200)
    ap.add_argument("--refresh-every", type=int, default=500,
                    help="re-derive activation scales and the SmoothQuant fold from the current weights "
                         "every N steps (keeps the grid matched to what a fresh serving calibration builds)")
    ap.add_argument("--smooth-alpha", type=float, default=1.0, help="SmoothQuant strength (<0 disables)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)  # before any work: no silent CPU run
    ckpt = load_checkpoint(args.ckpt)
    config = Config(ckpt["config"])
    sr = int(config.dataset["samplerate"])
    dec_cfg = {k: (list(v) if isinstance(v, (list, tuple)) else v)
               for k, v in dict(config.task["autoencoder"]["decoder_config"]).items()}
    if dec_cfg.get("_name", "HifiGANGenerator") != "HifiGANGenerator":
        raise SystemExit("QAT covers the HifiGANGenerator decoder only")
    task = build_task(config, device=device)
    task.load_variables(ckpt["state"])
    ae = task.networks["autoencoder"]
    hop = int(np.prod(dec_cfg["upsample_rates"]))

    dataset = build_dataset_from_config(config, training=False, id_list=args.id_list)
    feats_db, wav_db = precompute(ae, dataset, args.max_utts, hop, task.device)
    print(f"[qat] {len(feats_db)} utterances, hop {hop}, sr {sr}", flush=True)

    alpha = None if args.smooth_alpha < 0 else args.smooth_alpha
    calib = torch.as_tensor(feats_db[0][None], device=task.device)
    qat = QAT(fold_decoder_params(ae.decoder), dec_cfg, sr, args.lr, args.l1, alpha, calib)
    print(f"[qat] calibrated {len(qat.scales)} sites, smooth at {len(qat.smooth or {})}", flush=True)

    W = args.window_frames
    eval_rng = np.random.default_rng(EVAL_SEED)
    eval_batches = [sample_windows(eval_rng, feats_db, wav_db, args.batch, W, hop) for _ in range(EVAL_BATCHES)]
    gap0 = qat.gap(eval_batches)
    print(f"[qat] initial fake-quant log-mel gap {gap0:.4f}", flush=True)

    run(qat, feats_db, wav_db, args.steps, args.batch, W, hop, args.refresh_every, args.seed, args.log_every)
    gap1 = qat.gap(eval_batches)
    print(f"[qat] final fake-quant log-mel gap {gap1:.4f} ({(1 - gap1 / max(gap0, 1e-9)) * 100:.1f}% reduction)",
          flush=True)

    state = ckpt["state"]
    dec_params = state["params"]["autoencoder"]["decoder"]
    state["params"]["autoencoder"] = dict(state["params"]["autoencoder"],
                                          decoder=unfold_to_weight_norm(qat.folded, dict(dec_params), dec_cfg))
    out = args.out or (args.ckpt + "_qat")
    save_checkpoint(out, state, ckpt["iteration"], ckpt["config"])
    line = {"out": out, "steps": args.steps, "fake_quant_logmel_gap": {"before": round(gap0, 4), "after": round(gap1, 4)}}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
