"""Shared pieces of the benchmark's CPU tests: the repository's root on the
import path, and a tiny configuration of the CSMSC TTS recipe's shape
(every kind of layer present, widths cut) with a mix sized to it."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FFT = {"max_seq_len": 512, "n_layers": 1, "n_head": 2, "d_k": 8, "d_v": 8, "d_inner": 64,
       "fft_conv1d_kernel": 3, "fft_conv1d_padding": 1, "dropout": 0.1}
TINY_TASK = {
    "_name": "MSMCTTS",
    "_mode": "train_predictor",
    "predictor": {
        "_name": "MultiStagePredictor", "n_symbols": [10, 4, 2], "n_model_size": 32, "n_pred_size": 32,
        "n_pred_scale": [4, 1],
        "encoder_config": dict(FFT, max_seq_len=64, d_model=32),
        "adaptor_config": {"input_size": 32, "duration_predictor_filter_size": 16,
                           "duration_predictor_kernel_size": 3, "dropout": 0.1},
        "decoder_config": dict(FFT, d_model=32),
    },
    "autoencoder": {
        "_name": "MSMCVQGAN", "in_dim": 8, "n_model_size": 32,
        "encoder_config": dict(FFT, downsample_scales=[1, 4], attn_dropout=0.1),
        "quantizer_config": {"embedding_sizes": 8, "embedding_dims": 32, "n_heads": 4,
                             "prior_config": {"kernel_size": 5, "dilation_rate": 1, "n_layers": 1}, "norm": False},
        "frame_decoder_config": dict(FFT, attn_dropout=0.1),
        "pred_mel": True,
        "decoder_config": {"upsample_rates": [2, 2], "upsample_kernel_sizes": [4, 4], "upsample_initial_channel": 32,
                           "resblock_kernel_sizes": [3, 7, 11], "resblock_dilation_sizes": [[1, 3, 5]] * 3},
    },
}
TINY_CONFIG = {
    "weight_seed": 7,
    "overrides": {"predictor.upsampler.duration_predictor.linear_layer.bias": 4.2},
    "program": {"id": "tiny_tts", "task": TINY_TASK, "dataset": {"samplerate": 1600}, "precision": "float32"},
}
TINY_MIX = {
    "driver": "serve_closed_loop", "clients": 6, "request_timeout_s": 60,
    "engine": {"batch_size": 4, "window_ms": 5, "text_length": 16, "max_frames": 128},
    "min_phones": 4, "max_phones": 16, "max_rate": 1000, "trace_seconds": 1, "check": {"pool": 24, "requests": 12, "every": 4},
}
LIMITS = {"dur_gap": 1e-4, "snap_gap": 5e-5, "code_err": 0.0, "wav_err": 1e-4, "len_mismatch": 0, "missing": 0,
          "failed": 0, "cold_shapes": 0, "kernel_builds": 0}


@pytest.fixture
def tiny():
    return copy.deepcopy(TINY_CONFIG), copy.deepcopy(TINY_MIX)

TINY_TRAIN_PROGRAM = {
    "id": "tiny_ae",
    "task": {
        "_name": "MSMCTTS", "_mode": "train_autoencoder",
        "autoencoder": dict(TINY_TASK["autoencoder"],
                            encoder_config=dict(FFT, downsample_scales=[1, 4], dropout=0.2, attn_dropout=0.1),
                            frame_decoder_config=dict(FFT, dropout=0.2, attn_dropout=0.1),
                            quantizer_config=dict(TINY_TASK["autoencoder"]["quantizer_config"], dropout=0.1,
                                                  prior_config={"kernel_size": 5, "dilation_rate": 1, "n_layers": 1,
                                                                "p_dropout": 0.1})),
        "discriminator": {
            "_name": "UnivNetDiscriminator",
            "mrd_config": {"hop_lengths": [4, 8], "hidden_channels": [32, 32], "domain": "double", "mel_scale": True,
                           "sample_rate": 1600},
            "mpd_config": {"periods": [2, 3], "channels": 4, "max_channels": 16},
        },
    },
    "trainer": {"_name": "VQGANTrainer", "grad_clip_thresh": 1.0, "warmup_steps": 0, "sample_lengths": 32,
                "lambda_vq": 1, "lambda_pr": 0.1, "lambda_frame": 10, "lambda_fm": 2, "lambda_stft": 4.5,
                "stft_loss_config": {"fft_size": 64, "hop_size": 16, "win_size": 64, "num_mels": 8}},
    "optimizer": {"_default": {"_name": "AdamW", "learning_rate": 2e-4, "betas": [0.8, 0.99], "eps": 1e-8,
                               "weight_decay": 0.0}},
    "lr_scheduler": {"_name": "ExponentialDecayLRScheduler", "warmup_steps": 100, "decay_scale": 100,
                     "decay_learning_rate": 0.5, "final_learning_rate": 1e-5},
    "dataset": {"samplerate": 1600, "feature": ["mel", "wav"], "dimension": [8, 1], "frameshift": [4, 1],
                "padding_value": [-4, 0]},
    "precision": "float32", "seed": 1234,
}
TINY_TRAIN_CONFIG = {"weight_seed": 11, "overrides": {}, "program": TINY_TRAIN_PROGRAM}
TINY_TRAIN_MIX = {"driver": "train_step", "batch_size": 4, "pool": 3, "min_frames": 12, "max_frames": 40,
                  "frame_buckets": [64, 128], "checked_steps": 3, "trace_seconds": 1}
TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}


@pytest.fixture
def tiny_train():
    return copy.deepcopy(TINY_TRAIN_CONFIG), copy.deepcopy(TINY_TRAIN_MIX)
