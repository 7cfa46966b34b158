"""Plain PyTorch reference of one GAN-phase training step of the MSMC-VQ-GAN
autoencoder with its UnivNet discriminator, as hhguo/MSMC-TTS trains it.

The step: the autoencoder's forward (encoder FFT blocks per stage, the
residual multi-stage quantizer with its EMA codebook update, prior
predictors and post-processors, the frame decoder, the mel predictor), the
HiFi-GAN decoder over each utterance's window; the discriminator (five
spectrogram discriminators and five period discriminators) updated on the
detached fake and the real window with LSGAN; then the generator's loss
(commitment, prior prediction, masked mel MSE, log-mel L1, LSGAN and
feature matching against the updated discriminator), its gradient clipped by
the global norm, and AdamW on both. Dropout is on at the recipe's rates:
its masks come from a generator seeded with the configuration's ``seed``,
drawn at the model's call sites in the order the autoencoder's forward
reaches them (per encoder and frame-decoder layer the attention weights, the
attention's output, the FFN's output; per quantizer stage the prior
predictor's gated activations, its output, the post-processor's output), each
as one ``bernoulli_`` over the whole batch: the rule the program's
``ops/dropout.py`` states for its trainer's generator.

Written from the model's equations with plain ``torch`` operations, autograd
for the gradients; it imports nothing of the program under test. Weights
come as the benchmark's dict (``autoencoder.*``, ``discriminator.*``), the
STFT is a product of frames with the windowed DFT basis, and the mel
filterbanks are built here from their published formulas (librosa's Slaney
bank for the loss, torchaudio's HTK matrix for the spectrogram
discriminators). ``precision="tf32"`` rounds the operands of every product,
the STFT's included, to TF32.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.tts import Reference, positions, weight_norm

DISC_SLOPE = 0.2
BUFFERS = ("embed", "cluster_size", "embed_avg")
EMA_DECAY, EMA_EPS = 0.99, 1e-5


def hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def dft_basis(n_fft: int, win: int) -> np.ndarray:
    """[2 * (n_fft // 2 + 1), n_fft]: cos rows then -sin rows, times the
    periodic Hann window of ``win`` centred in ``n_fft``."""
    w = np.zeros(n_fft)
    lpad = (n_fft - win) // 2
    w[lpad : lpad + win] = hann(win)
    k = np.arange(n_fft // 2 + 1)[:, None]
    angle = 2.0 * np.pi * k * np.arange(n_fft)[None, :] / n_fft
    return np.concatenate([np.cos(angle), -np.sin(angle)], axis=0) * w[None, :]


def slaney_mel(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """librosa.filters.mel(sr, n_fft, n_mels), Slaney scale and area norm: [n_mels, bins]."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        lin = f / (200.0 / 3)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0), lin)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), m * 200.0 / 3)

    freqs = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    hz = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0), n_mels + 2))
    ramps = hz[:, None] - freqs[None, :]
    fd = np.diff(hz)
    fb = np.maximum(0.0, np.minimum(-ramps[:-2] / fd[:-1, None], ramps[2:] / fd[1:, None]))
    return fb * (2.0 / (hz[2:] - hz[:-2]))[:, None]


def htk_mel(n_freqs: int, sr: int) -> np.ndarray:
    """torchaudio's create_fb_matrix(n_freqs, 0, sr / 2, n_mels=n_freqs, sr),
    clamped to [1e-6, 1]: [n_freqs, n_mels]."""
    all_freqs = np.linspace(0, sr // 2, n_freqs)
    m = np.linspace(0.0, 2595.0 * np.log10(1.0 + (sr / 2) / 700.0), n_freqs + 2)
    f = 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    slopes = f[None, :] - all_freqs[:, None]
    fd = np.diff(f)
    return np.clip(np.minimum(-slopes[:, :-2] / fd[None, :-1], slopes[:, 2:] / fd[None, 1:]), 1e-6, 1.0)


class TrainReference(Reference):
    """The autoencoder, the discriminator and both optimizers' state over the
    weight dict ``W``; :meth:`step` is one GAN-phase step."""

    def __init__(self, W: Dict[str, torch.Tensor], config: dict, precision: str = "fp32"):
        task = config["task"]
        super().__init__({}, {"predictor": None, "autoencoder": task["autoencoder"]}, precision)
        self.dcfg = task["discriminator"]
        self.tcfg = config["trainer"]
        self.ocfg = config["optimizer"]
        self.sched = config.get("lr_scheduler") or {}
        self.sr = config["dataset"]["samplerate"]
        fs = config["dataset"]["frameshift"]
        self.frameshift = fs[list(config["dataset"]["feature"]).index("mel")]
        self.W = {}
        for k, v in W.items():
            buffer = k.rsplit(".", 1)[-1] in BUFFERS
            self.W[k] = v.detach().clone().requires_grad_(not buffer)
        self.params = {g: [k for k in sorted(self.W) if k.startswith(g + ".") and self.W[k].requires_grad]
                       for g in ("autoencoder", "discriminator")}
        self.adam = {k: [torch.zeros_like(self.W[k]), torch.zeros_like(self.W[k])] for g in self.params
                     for k in self.params[g]}
        self.count = {"autoencoder": 0, "discriminator": 0}
        self.first_grads: Dict[str, torch.Tensor] = {}
        self._consts: Dict[tuple, torch.Tensor] = {}
        device = next(iter(W.values())).device
        self.gen = torch.Generator(device=device).manual_seed(int(config.get("seed", 1234)))

    def _const(self, key, make, device):
        if key not in self._consts:
            self._consts[key] = torch.as_tensor(make(), dtype=torch.float32, device=device)
        return self._consts[key]

    # ------------------------------------------------------------ spectra
    def stft(self, x, n_fft, hop, win, center):
        """Real and imaginary parts [B, bins, frames] of the STFT of [B, T]."""
        basis = self._const(("dft", n_fft, win), lambda: dft_basis(n_fft, win), x.device)
        if center:
            x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
        frames = x.unfold(-1, n_fft, hop)
        out = self.ops.einsum("btn,kn->bkt", frames, basis)
        bins = n_fft // 2 + 1
        return out[:, :bins], out[:, bins:]

    def log_mel(self, wav, n_fft, hop, win, n_mels):
        """HiFi-GAN's log-mel: reflect padding of (n_fft - hop) / 2, no centring."""
        pad = (n_fft - hop) // 2
        wav = F.pad(wav[:, None], (pad, pad), mode="reflect")[:, 0]
        re, im = self.stft(wav, n_fft, hop, win, center=False)
        mag = torch.sqrt(re * re + im * im + 1e-9)
        fb = self._const(("slaney", n_fft, n_mels), lambda: slaney_mel(self.sr, n_fft, n_mels), wav.device)
        return torch.log(torch.clamp(self.ops.einsum("mf,bft->bmt", fb, mag), min=1e-5))

    # ------------------------------------------------------- discriminator
    def _wnconv2d(self, x, p, stride, padding):
        w = weight_norm(self.W[p + ".weight_v"], self.W[p + ".weight_g"])
        return F.conv2d(self.ops.r(x), self.ops.r(w), self.W[p + ".bias"], stride=stride, padding=padding)

    @staticmethod
    def _reflect1(x):
        x = F.pad(x, (1, 1, 0, 0), mode="reflect" if x.shape[3] > 1 else "replicate")
        return F.pad(x, (0, 0, 1, 1), mode="reflect" if x.shape[2] > 1 else "replicate")

    def discriminate(self, wav):
        """wav [B, T] -> (scores, feature maps) of every sub-discriminator."""
        scores, fmaps = [], []
        mrd = self.dcfg["mrd_config"]
        for j, (hop, hc) in enumerate(zip(mrd["hop_lengths"], mrd["hidden_channels"])):
            n_fft = 4 * hop
            re, im = self.stft(wav, n_fft, hop, n_fft, center=True)
            re, im = re / math.sqrt(n_fft), im / math.sqrt(n_fft)
            mag = torch.sqrt(torch.clamp(re * re + im * im, min=1e-7))
            fb = self._const(("htk", n_fft), lambda: htk_mel(n_fft // 2 + 1, self.sr), wav.device)
            mag = self.ops.einsum("bft,fm->bmt", mag, fb)
            log_mag = torch.clamp((20.0 * torch.log10(mag) - 20.0 + 100.0) / 100.0, 0.0, 1.0)
            x = torch.stack([mag, log_mag], dim=1)
            feats = []
            strides = [1, 2, 1, 2, 1, 2, 1]
            for i, s in enumerate(strides):
                if i > 0:
                    x = F.leaky_relu(x, DISC_SLOPE)
                    feats.append(x)
                x = self._wnconv2d(self._reflect1(x), f"discriminator.mrd.discriminators.{j}.discriminator.{i}."
                                   f"{1 if i == 0 else 2}", s, 0)
            scores.append(x)
            fmaps.append(feats)
        for j, p in enumerate(self.dcfg["mpd_config"]["periods"]):
            q = f"discriminator.mpd.discriminators.{j}"
            B, T = wav.shape
            x = wav
            if T % p:
                x = F.pad(x[:, None], (0, p - T % p), mode="reflect")[:, 0]
            x = x.reshape(B, 1, -1, p)
            feats = []
            for i in range(5):
                x = self._wnconv2d(x, f"{q}.convs.{i}", (3, 1) if i < 4 else (1, 1), (2, 0))
                feats.append(x)
                x = F.leaky_relu(x, DISC_SLOPE)
            scores.append(self._wnconv2d(x, f"{q}.conv_post", 1, (1, 0)).reshape(B, -1))
            fmaps.append(feats)
        return scores, fmaps

    # --------------------------------------------------------- autoencoder
    def _quantize_train(self, x, length, stage):
        """EMA quantization of [B, T, D] in training: nearest codewords of the
        old codebook, the codebook's EMA over the valid frames, the
        straight-through output and the commitment term."""
        p = f"autoencoder.quantizer.quantizer.{stage}"
        E = self.W[p + ".embed"]
        H, d, K = E.shape
        B, T, D = x.shape
        with torch.no_grad():
            dist, _ = self.distances(x.detach(), stage)
            idx = torch.argmin(dist, dim=-1)  # [B, T, H]
            quant = self.lookup(idx, stage)
            mask = (torch.arange(T, device=x.device)[None] < length[:, None]).float().reshape(B * T, 1, 1)
            onehot = F.one_hot(idx.reshape(B * T, H), K).float() * mask  # [N, H, K]
            counts = onehot.sum(0)
            sums = torch.einsum("nhk,nhd->hdk", onehot, x.detach().reshape(B * T, H, d))
            cs = self.W[p + ".cluster_size"] * EMA_DECAY + (1 - EMA_DECAY) * counts
            ea = self.W[p + ".embed_avg"] * EMA_DECAY + (1 - EMA_DECAY) * sums
            n = cs.sum(-1, keepdim=True)
            smoothed = (cs + EMA_EPS) / (n + K * EMA_EPS) * n
            self.W[p + ".cluster_size"], self.W[p + ".embed_avg"] = cs, ea
            self.W[p + ".embed"] = ea / smoothed[:, None, :]
        diff = torch.square(quant - x)
        return x + (quant - x).detach(), diff

    def autoencoder(self, mel, mel_length, starts, window_frames):
        a = self.acfg
        enc, q = a["encoder_config"], a["quantizer_config"]
        q_drop = q.get("dropout", 0.1)
        x = self._lin(mel, "autoencoder.in_linear")
        states, feat, length = [], x, mel_length
        for i, s in enumerate(enc["downsample_scales"]):
            if s > 1:
                B, T, C = feat.shape
                feat = feat.reshape(B, T // s, s, C).mean(2)
                length = (length + s - 1) // s
            feat, _ = self.fft_blocks(feat, positions(length, feat.shape[1]), f"autoencoder.encoder.encoders.{i}", enc)
            states.append((feat, length))
        states = states[::-1]
        scales = list(enc["downsample_scales"])[::-1]
        residual, diffs, lengths, pred_loss = None, [], [], 0.0
        for i, (emb, length) in enumerate(states):
            T = emb.shape[1]
            mask = (torch.arange(T, device=emb.device)[None] < length[:, None]).float()[..., None]
            pred = None
            if residual is not None:
                h = self._res_stack(residual, mask, f"autoencoder.quantizer.predictor.{i}.enc", q["prior_config"])
                pred = self._conv1x1(h, f"autoencoder.quantizer.predictor.{i}.proj") * mask
                residual = residual + self._drop(h, q_drop)
            pre = f"autoencoder.quantizer.preprocessor.{i}"
            pre_in = emb if residual is None else torch.cat([emb, residual], dim=-1)
            q_in = self._conv1x1(torch.tanh(self._conv1x1(pre_in, pre + ".0")), pre + ".2")
            quant, diff = self._quantize_train(q_in, length, i)
            post = f"autoencoder.quantizer.postprocessor.{i}"
            post_in = quant if residual is None else torch.cat([residual, quant], dim=-1)
            h = self._drop(self._lin(torch.tanh(self._lin(post_in, post + ".0")), post + ".2"), q_drop)
            residual = h if residual is None else residual + h
            if pred is not None:
                denom = torch.clamp(length.float().sum(), min=1.0)
                pred_loss = pred_loss + torch.sum(torch.mean(torch.square(pred - quant.detach()), -1)
                                                  * mask[..., 0]) / denom
            diffs.append(diff)
            lengths.append(length)
            if scales[i] > 1:
                residual = torch.repeat_interleave(residual, scales[i], dim=1)
        dec_in, _ = self.fft_blocks(residual, positions(mel_length, residual.shape[1]), "autoencoder.frame_decoder",
                                    a["frame_decoder_config"])
        mel_out = self._lin(dec_in, "autoencoder.mel_predictor")
        T = dec_in.shape[1]
        starts = torch.clamp(starts.long(), 0, T - window_frames)
        index = starts[:, None] + torch.arange(window_frames, device=mel.device)[None]
        window = dec_in[torch.arange(dec_in.shape[0], device=mel.device)[:, None], index]
        return {"diffs": diffs, "lengths": lengths, "pred_loss": pred_loss, "mel_out": mel_out,
                "fake": self.decoder(window)}

    # ---------------------------------------------------------------- step
    @staticmethod
    def _masked(term, lengths):
        mask = (torch.arange(term.shape[1], device=term.device)[None] < lengths[:, None]).float()[..., None]
        return torch.sum(term * mask) / torch.clamp(lengths.float().sum(), min=1.0) / term.shape[2]

    def _update(self, group: str, clip):
        """clip by the global norm (scale clip / max(norm, clip)), then AdamW
        at the scheduled rate."""
        names = self.params[group]
        grads = [self.W[k].grad if self.W[k].grad is not None else torch.zeros_like(self.W[k]) for k in names]
        if clip:
            norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            grads = [g * (clip / torch.clamp(norm, min=clip)) for g in grads]
        o = dict(self.ocfg["_default"], **self.ocfg.get(group, {}))
        b1, b2 = (float(b) for b in o["betas"])
        eps, wd = float(o["eps"]), float(o.get("weight_decay", 0.0))
        lr = self._lr(float(o["learning_rate"]), self.count[group])
        self.count[group] += 1
        t = self.count[group]
        with torch.no_grad():
            for k, g in zip(names, grads):
                if t == 1:
                    self.first_grads[k] = g.clone()
                m, v = self.adam[k]
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                p = self.W[k]
                p.mul_(1 - lr * wd)
                denom = (v.sqrt() / math.sqrt(1 - b2**t)).add_(eps)
                p.addcdiv_(m, denom, value=-lr / (1 - b1**t))
                p.grad = None

    def _lr(self, base, step):
        """The exponential-decay schedule: 1 until ``warmup_steps`` updates,
        then ``decay_learning_rate`` per ``decay_scale`` updates, floored."""
        cfg = self.sched
        warm = float(cfg.get("warmup_steps", 0))
        scale = 1.0 if step < warm else float(cfg.get("decay_learning_rate", 1.0)) ** (
            (step - warm) / float(cfg.get("decay_scale", 1)))
        return max(base * scale, float(cfg.get("final_learning_rate", 0.0)))

    def step(self, mel, mel_length, wav, starts) -> Dict[str, float]:
        """One GAN-phase step on one batch; returns its losses."""
        t = self.tcfg
        frames = int(t["sample_lengths"]) // self.frameshift
        size = int(t["sample_lengths"])
        first = torch.clamp(starts.long() * self.frameshift, 0, wav.shape[1] - size)
        idx = first[:, None] + torch.arange(size, device=wav.device)
        target = wav[torch.arange(wav.shape[0], device=wav.device)[:, None], idx]
        out = self.autoencoder(mel, mel_length, starts, frames)
        fake = out["fake"]
        fs, _ = self.discriminate(fake.detach())
        rs, _ = self.discriminate(target)
        d_loss = sum(torch.mean(torch.square(s - 1.0)) for s in rs) + sum(torch.mean(torch.square(s)) for s in fs)
        d_loss.backward()
        self._update("discriminator", None)

        g = sum(float(t.get("lambda_vq", 1.0)) * self._masked(d, n) for d, n in zip(out["diffs"], out["lengths"]))
        g = g + float(t.get("lambda_pr", 1.0)) * out["pred_loss"]
        g = g + float(t.get("lambda_frame", 1.0)) * self._masked(torch.square(out["mel_out"] - mel), mel_length)
        k = {"win_size": self.sr // 20, "hop_size": self.sr // 80, "num_mels": 128, **t.get("stft_loss_config", {})}
        k.setdefault("fft_size", 2048 if k["win_size"] > 1024 else 1024)
        spec = (k["fft_size"], k["hop_size"], k["win_size"], k["num_mels"])
        mel_l = torch.mean(torch.abs(self.log_mel(fake, *spec) - self.log_mel(target, *spec)))
        g = g + float(t.get("lambda_stft", 45.0)) * mel_l
        disc_params = self.params["discriminator"]
        for k in disc_params:
            self.W[k].requires_grad_(False)
        fs, ff = self.discriminate(fake)
        with torch.no_grad():
            _, rf = self.discriminate(target)
        for k in disc_params:
            self.W[k].requires_grad_(True)
        adv = sum(torch.mean(torch.square(s - 1.0)) for s in fs)
        fm = sum(torch.mean(torch.abs(a - b)) for fa, fb in zip(ff, rf) for a, b in zip(fa, fb))
        g_total = g + adv + float(t.get("lambda_fm", 2.0)) * fm
        g_total.backward()
        self._update("autoencoder", float(t.get("grad_clip_thresh", 1.0)))
        return {"g_loss": g_total.item(), "d_loss": d_loss.item()}
