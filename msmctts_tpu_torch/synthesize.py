"""One-shot synthesis: phone string in, waveform out, on the GPU.

    python -m msmctts_tpu_torch.synthesize -m <am_checkpoint> \\
        --text "1_0_0 33_4_0 17_4_0 1_0_0" -o out.wav [--device cpu]

The counterpart of the root ``synthesize.py``. The acoustic-model
checkpoint is a ``msmctts_tpu/v1`` file whose embedded config names the
frozen autoencoder (``task.autoencoder._checkpoint``). Phone tokens are
``id_tone_er`` triples (``utils/text.py``). Runs on ``cuda`` unless
``--device cpu`` is given; without a GPU it refuses to run.
"""

from __future__ import annotations

import argparse

import numpy as np

from msmctts_tpu_torch.config import Config
from msmctts_tpu_torch.data.datasets import save_wav
from msmctts_tpu_torch.tasks import build_task
from msmctts_tpu_torch.utils.checkpoint import load_checkpoint


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-m", "--model", required=True)
    p.add_argument("-c", "--config", default=None)
    p.add_argument("--text", required=True, help="id_tone_er phone tokens")
    p.add_argument("-o", "--output", default="out.wav")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    ckpt = load_checkpoint(args.model)
    config = Config(args.config) if args.config else Config(ckpt["config"])
    task = build_task(config, device=args.device)
    task.load_variables(ckpt["state"])

    tokens = [[int(x) for x in tok.split("_")] for tok in args.text.split() if tok]
    text = np.asarray(tokens, np.int64)[None]  # [1, L, n_streams]
    batch = {"text": text, "text_length": np.asarray([text.shape[1]], np.int64)}
    out = task.infer_step(batch)
    wav = np.asarray(out["wav"][0])
    sr = config.dataset["samplerate"]
    save_wav(args.output, wav, sr)
    print(f"{wav.shape[0] / sr:.2f}s of audio -> {args.output} ({task.device})")
    return wav


if __name__ == "__main__":
    main()
