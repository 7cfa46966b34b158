"""Training logger (counterpart of ``msmctts_tpu/utils/logger.py``): a text
log, tensorboard scalars, images and audio.

``LossMeter`` averages each scalar over a window and writes the means every
``interval`` steps. ``Logger`` appends time-stamped lines to
``train_rank<rank>_<stamp>.log`` in the save dir and echoes them to stdout
(the port's trainers always have); on rank 0 it opens a ``tensorboardX``
writer where that package is installed, else ``writer`` is None and the
scalars go to the text log only, as in the JAX package. Audio that the
writer cannot take (``tensorboardX`` needs ``soundfile`` for it) or that
comes with no writer is written to ``eval_audio/<name>_<iteration>.wav``.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict

import numpy as np

from msmctts_tpu_torch.data.datasets import save_wav


class LossMeter:
    def __init__(self, writer, interval: int = 100):
        self.writer = writer
        self.interval = interval
        self.sums = defaultdict(float)
        self.counts = defaultdict(int)

    def update(self, iteration: int, scalars: dict):
        for k, v in scalars.items():
            self.sums[k] += float(v)
            self.counts[k] += 1
        if iteration % self.interval == 0 and self.writer is not None:
            for k in list(self.sums):
                self.writer.add_scalar(k, self.sums[k] / max(self.counts[k], 1), iteration)
            self.sums.clear()
            self.counts.clear()


class Logger:
    def __init__(self, log_dir: str, rank: int = 0, use_tensorboard: bool = True):
        self.rank = rank
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d-%H%M%S")
        self.log_path = os.path.join(log_dir, f"train_rank{rank}_{stamp}.log")
        self.writer = None
        if use_tensorboard and rank == 0:
            try:
                from tensorboardX import SummaryWriter

                self.writer = SummaryWriter(os.path.join(log_dir, f"events_{stamp}"))
            except Exception:
                self.writer = None
        self.meter = LossMeter(self.writer)

    def text(self, message: str):
        line = f"[{time.strftime('%H:%M:%S')}] {message}"
        with open(self.log_path, "a") as f:
            f.write(line + "\n")
        print(line, flush=True)

    def log_config(self, config: dict):
        with open(self.log_path, "a") as f:  # the log file only: a recipe is long
            f.write(f"[{time.strftime('%H:%M:%S')}] config: {json.dumps(config, default=str)}\n")

    def log(self, iteration: int, payload: dict):
        """payload keys: 'loss' (name -> scalar), 'image' (name -> HWC
        array), 'audio' (name -> (wav, sample rate))."""
        scalars = payload.get("loss", {})
        if scalars:
            self.meter.update(iteration, scalars)
        if self.writer is not None:
            for name, img in payload.get("image", {}).items():
                self.writer.add_image(name, np.asarray(img), iteration, dataformats="HWC")
        for name, (wav, sr) in payload.get("audio", {}).items():
            try:
                if self.writer is None:
                    raise RuntimeError("no tensorboard writer")
                self.writer.add_audio(name, np.asarray(wav)[None, :], iteration, sample_rate=sr)
            except Exception:
                out_dir = os.path.join(self.log_dir, "eval_audio")
                os.makedirs(out_dir, exist_ok=True)
                save_wav(os.path.join(out_dir, name.replace("/", "_") + f"_{iteration}.wav"), np.asarray(wav), sr)

    def close(self):
        if self.writer is not None:
            self.writer.close()
